// Fused bounce kernels on Hopper (sm_90a): intersect + shade in one pass,
// so the ray state makes one trip through device memory per bounce.
//
// tt_bounce_culled (K1) replaces the TPU kernel bounce_reflect_culled_pallas
// (tracer_tpu/kernels/pallas_intersect.py:2049, body
// _make_fused_kernel_culled :1884): each tile of TILE lanes regenerates
// its first `remaining` dead lanes from its equal-area source cell (a
// Buie or pillbox disk cell, or a rect cell in local metres whose rays
// leave along an oblique source's own direction frame), tests only the
// tile's candidate rows and shades the winner; K1_SPLIT blocks serve a
// tile, one sub-tile of contiguous lanes each (below).
// Three instances (bounce_culled_kernel<kGeneral, kExtra>): the NSTTF one
// <false, false> takes flat groups with AP_RECT / AP_NONE apertures and
// K_REFLECT optics with bivariate / radial / mixed slope error and the
// one-sided kill; <true, false> runs every quadric class and aperture kind
// through rows.cuh's scan_group, with the Lambertian lobe, spectral
// absorptance on a wavelength lane (drawn from the source's band on
// regeneration), ambient Beer-Lambert attenuation and the bifacial rows'
// backside_miss; <true, true> adds the Fresnel conductor and the IAM
// (K2's kExtra epilogue). Every instance takes aureole parking
// (park_aureole, :1967-1981, :2021-2026) as a run-time switch tested
// outside the row loop: a lane reborn into the sunshape's circumsolar
// aureole stores its hit as sid -(sid + 16), which the engine decodes and
// parks for the exact drain. Nothing of it is carried across the row
// loop, whose general instances sit at their register cap: at the store,
// a hit lane that entered dead was reborn this call, and its sampler's
// draw is made again (aureole_draw).
//
// tt_bounce (K2) replaces bounce_reflect_pallas (:1693, body
// _make_fused_kernel :1517), stages (a) to (e): one thread per lane, every
// lane traced and shaded (a dead one that is not regenerated too), a
// brute-force loop over every row of the scene with every quadric class
// and aperture kind (rows.cuh, shared with K1 and K3), then the shade
// epilogue (_make_shade_epilogue :679; shade<> in shade.cuh, which the K3
// epilogue of epilogue.cu shares): reflect with slope error, the
// one-sided kill, the pure-Lambertian lobe (:1181), spectral absorptance
// interpolated at the lane's wavelength (_interp_row_table :144, carried
// by _surface_body :430), Beer-Lambert attenuation of the travelled
// segment (:1245), and (stage c) K_REFRACTIVE interfaces on a per-lane
// index: Fresnel roulette about the flipped normal (:999), frosted rows'
// p2 sigma (:933), dispersive rows' n1(wl) and n2(wl) interpolated once
// for the winner (:444); Henyey-Greenstein scattering that preempts the
// hit when the lane's exponential free path is shorter (:863, sid -2);
// and per-lane medium ids toggled at the crossings of the refractive rows
// that bound the media (:849, :1009). Stages (d) and (e) shade the other
// kinds: Cook-Torrance microfacet reflection (:1074), Lambertian-specular
// and semi-Lambertian choices between the specular and the diffuse lobe
// (:945, :1181), transparent pass-through (:1223), the Fresnel conductor
// with n2(wl) and k2(wl) interpolated for the winner (:1124, :520), the
// Martin-Ruiz IAM with the scene's exponent c (:1155), the periodic
// teleport (:1231) and the piecewise Lambertian, whose absorptance and
// specular probability are interpolated at the winner's incidence angle
// (:1150, :483; bilinear in (theta, wl) through interp2_row). With
// refr_split (:1049, :1293), energy splitting: on an F_SPLIT refractive
// row the lane always crosses, and the reflected branch leaves through
// two more outputs with the share R of the energy left after the medium
// and the surface (all of it on total internal reflection), for the
// general streaming path's overflow slots; the roulette's uniform is
// still drawn, so no other draw moves. Refraction, scattering, media, the
// stage (d)/(e) kinds, backside_miss and splitting are template flags
// (bounce_kernel<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit>, 28
// instances: the stage (d)/(e) kinds run alone, in an ambient HG medium,
// or beside refraction and media ids; kSplit only beside refraction
// without scattering or media ids, which splitting scenes never take on
// the fused path), so the configurations without them keep stage (b)'s
// code. With regeneration
// on, dead lanes first draw a fresh ray from the un-celled disk or rect
// source (_sample_disk_buie :1413: Buie or pillbox polar angle, optional
// aureole, optional wavelength band) whose pose (centre, position
// rotation, direction rotation) is a device operand, and restart at index
// 1 in medium 0. Rows flagged F_BACKSIDE_MISS reject local +Z arrivals when
// the mode asks (bifacial scenes), on every class. The plain streaming
// megakernel runs it every round, the general streaming path every
// bounce, the culled trace's drain with regeneration off.
//
// What bounds them on this card: the per-lane row loop is float32
// arithmetic on rows that every lane of a block shares (about 50 flops
// per flat row, 100 per curved one), and each lane's state is read and
// written once (28-32 bytes in, 36-40 out; a lane that K2 regenerates
// reads only its 4-byte energy, while K1 stages every lane's ray). K1 and
// K2 test flat rect rows with rows.cuh's
// flat_rect_t, every other class with its row_hit. Both kernels stage
// their rows in shared memory once per block, so the loop reads no device
// memory and
// runs from registers; the ray state streams through with neighbouring
// threads on neighbouring lanes. Random numbers come from Philox4x32-10
// keyed per tile and counted per lane and draw call, so the plain PyTorch
// versions (kernels/bounce.py) draw the same uniforms and the two can be
// compared lane by lane.
//
// K1's cut for this card. The TPU ran its grid in order on one core, so
// one tile a grid step cost nothing; on 132 SMs one block a tile left the
// tiles with the most candidate rows (31 at the bench slab, where the
// median is 13 and a third have none) running almost alone at the end of
// the launch. So K1_SPLIT blocks serve a tile, each a sub-tile of
// TILE / K1_SPLIT contiguous lanes, and the grid walks the tiles in the
// culling's order, most candidate rows first (BlockCulling.order). The
// Philox key stays (seed, tile) and the counter (lane within the tile,
// call), so no draw moves. The rank that picks the dead lanes to reborn
// continues across sub-tiles: a block counts the dead lanes of its tile's
// earlier sub-tiles (16-byte loads of lines the tile's other blocks read
// too) and of each chunk of its own (warp ballots), and one barrier
// publishes the counts; a quota of 0 or of the whole tile needs no rank.
// Meanwhile cp.async copies the sub-tile's pos and dir (contiguous, 12
// bytes a lane) and the tile's candidate rows into shared memory, and the
// results leave through shared memory as 16-byte stores. The NSTTF
// instance stages its rows at a stride of whole 16-byte words and tests
// each candidate row against all of a thread's K1_PER lanes at once, so a
// row's coefficients come from shared memory 16 bytes at a time and once
// a thread. Each instance's __launch_bounds__ asks for the most resident
// blocks at which ptxas spills nothing (k1_min_blocks). No tensor cores:
// the row test is a 3x3 transform, a contraction of depth 3 where wgmma
// needs at least 8 (TF32), and TF32's 10-bit mantissa would move hit
// points by about 1e-3 relative, beyond the comparisons' 1e-4 and the
// 3e-4 self-hit guard. What bounds K1 then is its per-lane float32 work,
// the row tests above all, more than its bytes (PERF.md, k1_variants.py's
// diagnostics).
//
// K2's cut for this card. Its work is per-lane float32 latency (row
// tests, the Philox draws, the shade's branches), so what it needs is
// resident warps and fewer instructions a lane, not bytes: at 80
// registers a thread (three blocks of 256 a SM; five of 128 for the
// refractive instances that would spill there, K2Block) no instance
// spills. Blocks are persistent, as many as the SMs keep resident: each
// stages the rows (padded to whole 16-byte words, so a row comes out of
// shared memory in 16-byte reads), the spectral table, the pose and the
// media tables once, then walks chunks of one lane a thread in a grid
// stride; no block waits on another. A curved row solves its general
// quadratic (A and B nonzero) in a branch of its own rather than
// computing the linear and B == 0 roots' quotients and square root beside
// it, and takes no root where the discriminant admits none; a flat group
// whose only aperture is one rect is tested without the loop over the
// aperture slots, and rows with one aperture slot are scanned with the
// slot count a constant, so the aperture kinds stay in registers; a
// spectral table's segment is found by bisection. Each of these decides
// on the same values as the branch-free form, so the outputs equal the
// earlier design's bit for bit. Measured and left out (k2_variants.py, PERF.md): staging the
// rays and energies through shared memory by cp.async (it cost 8-16
// registers a thread), two lanes a thread, bounding flat rows with an
// approximate quotient or their signs before the exact test (the branch in
// the row loop), and 72-register bounds (every instance spills).
#include <cuda_pipeline_primitives.h>
#include <stdint.h>

#include "rows.cuh"
#include "shade.cuh"

namespace {

constexpr int TILE = 3072;            // lanes per tile (= TPU ray tile)
// K1's cut: K1_SPLIT blocks serve one tile, each a sub-tile of K1_SUB
// contiguous lanes, K1_PER a thread with neighbouring threads on
// neighbouring lanes
constexpr int K1_SPLIT = 4;
constexpr int K1_SUB = TILE / K1_SPLIT;
constexpr int K1_THREADS = 256;
constexpr int K1_PER = K1_SUB / K1_THREADS;
constexpr int K1_WARPS = K1_THREADS / 32;
constexpr int K1_RAY_FLOATS = 6 * K1_SUB;  // a sub-tile's staged pos, dir
static_assert(K1_SUB % K1_THREADS == 0 && K1_SUB % 4 == 0,
              "a sub-tile is whole chunks of threads and whole 16-byte "
              "copies");
constexpr int POSE_FLOATS = 21;       // centre, position rot, direction rot

// source parameter block (kernels/bounce.py:source_params)
constexpr int SP_RADIUS = 12, SP_ERAY = 13, SP_DISC_END = 14,
              SP_HAS_GAMMA = 15, SP_C_AUR = 16, SP_TT = 17, SP_INV_GP2 = 18,
              SP_COEFFS = 19, SP_NCOEFF = 11, SP_HAS_BAND = 30,
              SP_WL_LO = 31, SP_WL_HI = 32, SP_HAS_RECT = 33, SP_W = 34,
              SP_H = 35, SP_DROT = 36;

// Buie polar angle from u in (0, 1]: the polynomial inverse CDF of the
// solar disc (a pillbox cone when the spec was fitted to one), then the
// analytic circumsolar aureole past disc_end
__device__ __forceinline__ float buie_theta(const float* sp, float u) {
  const float uq = fminf(u / sp[SP_DISC_END], 1.0f);
  float acc = sp[SP_COEFFS];
  for (int i = 1; i < SP_NCOEFF; ++i) acc = acc * uq + sp[SP_COEFFS + i];
  float theta = sqrtf(uq) * acc;
  if (sp[SP_HAS_GAMMA] != 0.0f && u >= sp[SP_DISC_END]) {
    const float base = (u - 1.0f) * sp[SP_C_AUR] + u * sp[SP_TT];
    theta = expf(logf(fmaxf(base, 1e-30f)) * sp[SP_INV_GP2]);
  }
  return theta;
}

// a fresh ray from one equal-area cell of the source
// (pallas_intersect._sample_disk_buie with cell): a Buie disk cell
// [a0, a1, th0, th1] (area fractions, angles) or a rect cell
// [x0, x1, y0, y1] (local metres); positions in the source's rot frame,
// directions about its direction rotation (an oblique rect source's
// rays_rot)
__device__ __forceinline__ void sample_cell(const float* sp, const float* cb,
                                            uint32_t seed, uint32_t stream,
                                            uint32_t lane, float& px,
                                            float& py, float& pz, float& dx,
                                            float& dy, float& dz) {
  float u[4];
  uniforms4(seed, stream, lane, CALL_REGEN, u);
  float lx, ly;
  if (sp[SP_HAS_RECT] != 0.0f) {
    lx = cb[0] + u[0] * (cb[1] - cb[0]);
    ly = cb[2] + u[1] * (cb[3] - cb[2]);
  } else {
    const float a0 = cb[0], a1 = cb[1], th0 = cb[2], th1 = cb[3];
    const float rr = sp[SP_RADIUS] * sqrtf(a0 + u[0] * (a1 - a0));
    float s_v, c_v;
    sincosf(th0 + u[1] * (th1 - th0), &s_v, &c_v);
    lx = rr * c_v;
    ly = rr * s_v;
  }
  const float* rot = sp + 3;
  const float* drot = sp + SP_DROT;
  px = rot[0] * lx + rot[1] * ly + sp[0];
  py = rot[3] * lx + rot[4] * ly + sp[1];
  pz = rot[6] * lx + rot[7] * ly + sp[2];
  const float theta = buie_theta(sp, u[2]);
  float s_t, c_t, s_d, c_d;
  sincosf(theta, &s_t, &c_t);
  sincosf(TWO_PI * u[3], &s_d, &c_d);
  const float ax = s_t * c_d, ay = s_t * s_d, az = c_t;
  dx = drot[0] * ax + drot[1] * ay + drot[2] * az;
  dy = drot[3] * ax + drot[4] * ay + drot[5] * az;
  dz = drot[6] * ax + drot[7] * ay + drot[8] * az;
}

// whether a fresh ray of sample_cell drew its polar angle in the
// circumsolar aureole (u3 >= disc_end; never without an aureole): the
// sampler's draw made again
__device__ __forceinline__ bool aureole_draw(const float* sp, uint32_t seed,
                                             uint32_t stream, uint32_t lane) {
  float u[4];
  uniforms4(seed, stream, lane, CALL_REGEN, u);
  return sp[SP_HAS_GAMMA] != 0.0f && u[2] >= sp[SP_DISC_END];
}

// a fresh ray's wavelength, uniform in the source's band (its own draw)
__device__ __forceinline__ float band_wl(const float* sp, uint32_t seed,
                                         uint32_t stream, uint32_t lane) {
  float ub[4];
  uniforms4(seed, stream, lane, CALL_BAND, ub);
  return sp[SP_WL_LO] + ub[0] * (sp[SP_WL_HI] - sp[SP_WL_LO]);
}

// a fresh ray from the whole source (pallas_intersect._sample_disk_buie
// without cell, with the traced frame): on a disk radius sqrt(u1), angle
// u2 turns, on a w x h rect ((u1 - 0.5) w, (u2 - 0.5) h); polar angle from
// u3, azimuth u4 turns; the pose is POSE_FLOATS floats (centre, row-major
// position rotation, row-major direction rotation). With a band, the
// wavelength is uniform in it (the band's own draw).
__device__ __forceinline__ void sample_disk(const float* sp,
                                            const float* pose, uint32_t seed,
                                            uint32_t stream, uint32_t lane,
                                            float& px, float& py, float& pz,
                                            float& dx, float& dy, float& dz,
                                            float& wl) {
  float u[4];
  uniforms4(seed, stream, lane, CALL_REGEN, u);
  float lx, ly;
  if (sp[SP_HAS_RECT] != 0.0f) {
    lx = (u[0] - 0.5f) * sp[SP_W];
    ly = (u[1] - 0.5f) * sp[SP_H];
  } else {
    const float rr = sp[SP_RADIUS] * sqrtf(u[0]);
    float s_v, c_v;
    sincosf(TWO_PI * u[1], &s_v, &c_v);
    lx = rr * c_v;
    ly = rr * s_v;
  }
  const float* rot = pose + 3;
  const float* drot = pose + 12;
  px = rot[0] * lx + rot[1] * ly + pose[0];
  py = rot[3] * lx + rot[4] * ly + pose[1];
  pz = rot[6] * lx + rot[7] * ly + pose[2];
  const float theta = buie_theta(sp, u[2]);
  float s_t, c_t, s_d, c_d;
  sincosf(theta, &s_t, &c_t);
  sincosf(TWO_PI * u[3], &s_d, &c_d);
  const float ax = s_t * c_d, ay = s_t * s_d, az = c_t;
  dx = drot[0] * ax + drot[1] * ay + drot[2] * az;
  dy = drot[3] * ax + drot[4] * ay + drot[5] * az;
  dz = drot[6] * ax + drot[7] * ay + drot[8] * az;
  if (sp[SP_HAS_BAND] != 0.0f) wl = band_wl(sp, seed, stream, lane);
}

// shade on a flat winner row, whose normal is its row's R e_z (K1)
__device__ __forceinline__ Shaded shade_flat(const float* w, float t_b,
                                             const Lane& in, uint32_t seed,
                                             uint32_t stream, uint32_t lane,
                                             const Epi& ep) {
  if (w == nullptr)
    return shade<false, false, false, false>(w, -1, 0.0f, 0.0f, 0.0f, 0.0f,
                                             t_b, in, 0.0f, 1.0f, 0.0f, seed,
                                             stream, lane, ep);
  return shade<false, false, false, false>(
      w, -1, w[6], w[7], w[8], w[6] * in.dx + w[7] * in.dy + w[8] * in.dz,
      t_b, in, 0.0f, 1.0f, 0.0f, seed, stream, lane, ep);
}

// blocks of each K1 instance that __launch_bounds__ asks to keep
// resident on one SM: the most at which ptxas keeps every value in
// registers
template <bool kGeneral>
constexpr int k1_min_blocks() {
  return kGeneral ? 3 : 4;
}

// the float stride of K1's staged rows: the NSTTF instance pads each row
// to whole 16-byte words and reads it 16 bytes at a time (staged_row)
template <bool kGeneral>
__host__ __device__ __forceinline__ int k1_stride(int K) {
  return kGeneral ? K : (K + 3) & ~3;
}

__device__ __forceinline__ const float* staged_row(const float* rows_sm,
                                                   int slot, int Kp) {
  return static_cast<const float*>(
      __builtin_assume_aligned(rows_sm + slot * Kp, 16));
}

// copies from device to shared memory that complete asynchronously
// (cp.async): the block issues them, ranks its dead lanes, then waits
__device__ __forceinline__ void stage16(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 16);
}

__device__ __forceinline__ void stage4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

struct CulledArgs {
  const float* rows;
  int K, C;
  const int* lists;
  int W;
  const int* counts;
  int G;
  const int* gmeta;  // (G, meta_w): column offset, rect mask (-1: another
                     // aperture kind), quadric class, aperture kinds
  int meta_w;
  const int* cells;
  const float* cell_bounds;
  const int* remaining;
  const int* active;
  const int* order;  // the tiles, most candidate rows first
  const float* srcp;  // source parameters, or nullptr: no regeneration
  uint32_t seed;
  const float *pos, *dir, *e;
  float *npos, *ndir, *ne;
  int* sid;
  float* absorbed;
  const float* wl;   // per-lane wavelength in, or nullptr
  float* nwl;        // per-lane wavelength out (with wl)
  const float* tab;  // (n_tab, 2) spectral table
  int n_tab;
  float t_eps, disc_eps;
  Modes m;
};

// whether a lane of chunk j (K1_THREADS lanes) of the block's sub-tile is
// reborn this round: the tile's first `remaining` dead lanes in flat lane
// order are (the engine re-derives the same ranks). With `ranked`, its
// exclusive rank is the dead lanes of the chunks before (`running`, which
// moves past this chunk), of the warps before and of the lanes before in
// its warp; every thread of the block calls it for each chunk in turn
__device__ __forceinline__ bool k1_reborn(bool dead, int j, bool ranked,
                                          bool all_reborn, int remaining,
                                          const int (*warp_dead)[K1_WARPS],
                                          int& running) {
  if (!ranked) return dead && all_reborn;
  const int warp = threadIdx.x >> 5, wl_i = threadIdx.x & 31;
  const unsigned m = __ballot_sync(0xffffffffu, dead);
  int woff = 0, tot = 0;
  for (int w = 0; w < K1_WARPS; ++w) {
    const int c = warp_dead[1 + j][w];
    woff += w < warp ? c : 0;
    tot += c;
  }
  const bool reborn =
      dead && running + woff + __popc(m & ((1u << wl_i) - 1u)) < remaining;
  running += tot;
  return reborn;
}

// a lane's results: its ray back to its shared-memory slots (they leave
// in 16-byte stores), its energy, its row id and its absorbed energy
__device__ __forceinline__ void k1_store(const CulledArgs& a, float* pos_sm,
                                         float* dir_sm, int i_sm, size_t l,
                                         const Shaded& o, bool live, int sid,
                                         uint32_t stream, uint32_t t) {
  pos_sm[3 * i_sm] = o.px;
  pos_sm[3 * i_sm + 1] = o.py;
  pos_sm[3 * i_sm + 2] = o.pz;
  dir_sm[3 * i_sm] = o.dx;
  dir_sm[3 * i_sm + 1] = o.dy;
  dir_sm[3 * i_sm + 2] = o.dz;
  a.ne[l] = o.e;
  // park_aureole: the hit of a lane reborn this call (it entered dead
  // and is live) into the aureole is stored encoded
  const bool parks = a.m.park_aureole && sid >= 0 && a.e[l] <= 0.0f &&
                     aureole_draw(a.srcp, a.seed, stream, t);
  a.sid[l] = parks ? -sid - 16 : sid;
  a.absorbed[l] = live ? o.absorbed : 0.0f;
}

// the culled round: K1_SPLIT blocks per tile, dispatched heavy-first (block
// i serves sub-tile i % K1_SPLIT of tile order[i / K1_SPLIT]). kGeneral
// runs every quadric class and aperture kind through rows.cuh's scan_group
// and the epilogue's cullable modes (Lambertian, spectral with a
// wavelength lane, ambient attenuation, backside_miss), kExtra adds the
// conductor and IAM; the NSTTF instance <false, false> keeps the flat rect
// loop and the plain reflect epilogue, and tests each candidate row against
// all of a thread's lanes at once
template <bool kGeneral, bool kExtra>
__global__ void __launch_bounds__(K1_THREADS, k1_min_blocks<kGeneral>())
    bounce_culled_kernel(CulledArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // dead lanes counted by each warp: [0] in the tile's earlier sub-tiles,
  // [1 + j] in the block's chunk j of K1_THREADS lanes
  __shared__ int warp_dead[1 + K1_PER][K1_WARPS];
  const int b = a.order[blockIdx.x / K1_SPLIT];
  const int sub = blockIdx.x % K1_SPLIT;
  const int tid = threadIdx.x;
  const size_t tile0 = (size_t)b * TILE;
  const size_t base = tile0 + (size_t)sub * K1_SUB;  // the sub-tile's lane 0
  if (a.active[b] == 0) {
    // idle tile: state passes through, no hits, no absorption
    const float4* pos4 = reinterpret_cast<const float4*>(a.pos + 3 * base);
    const float4* dir4 = reinterpret_cast<const float4*>(a.dir + 3 * base);
    const float4* e4 = reinterpret_cast<const float4*>(a.e + base);
    float4* npos4 = reinterpret_cast<float4*>(a.npos + 3 * base);
    float4* ndir4 = reinterpret_cast<float4*>(a.ndir + 3 * base);
    float4* ne4 = reinterpret_cast<float4*>(a.ne + base);
    for (int i = tid; i < 3 * K1_SUB / 4; i += K1_THREADS) {
      npos4[i] = pos4[i];
      ndir4[i] = dir4[i];
    }
    for (int i = tid; i < K1_SUB / 4; i += K1_THREADS) ne4[i] = e4[i];
    for (int t = tid; t < K1_SUB; t += K1_THREADS) {
      const size_t l = base + t;
      if (kGeneral && a.nwl != nullptr) a.nwl[l] = a.wl[l];
      a.sid[l] = -1;
      a.absorbed[l] = 0.0f;
    }
    return;
  }
  // stage the sub-tile's rays, the tile's candidate rows (W slots of Kp
  // floats: the NSTTF instance pads each row to whole 16-byte words), their
  // ids and the spectral table; the copies run while the block ranks its
  // dead lanes
  const int Kp = k1_stride<kGeneral>(a.K);
  float* pos_sm = smem;
  float* dir_sm = smem + 3 * K1_SUB;
  float* rows_sm = smem + K1_RAY_FLOATS;
  int* ids_sm = reinterpret_cast<int*>(rows_sm + a.W * Kp);
  float* tab_sm = rows_sm + a.W * Kp + a.W;
  for (int i = tid; i < 3 * K1_SUB / 4; i += K1_THREADS) {
    stage16(pos_sm + 4 * i, a.pos + 3 * base + 4 * i);
    stage16(dir_sm + 4 * i, a.dir + 3 * base + 4 * i);
  }
  const int* list_b = a.lists + (size_t)b * a.W;
  for (int i = tid; i < a.W * Kp; i += K1_THREADS) {
    const int slot = i / Kp, k = i - slot * Kp;
    const int s = list_b[slot];
    if (s >= 0 && (kGeneral || k < a.K))
      stage4(rows_sm + i, a.rows + (size_t)s * a.K + k);
    else
      rows_sm[i] = 0.0f;
  }
  for (int i = tid; i < a.W; i += K1_THREADS) ids_sm[i] = list_b[i];
  if (kGeneral)
    for (int i = tid; i < 2 * a.n_tab; i += K1_THREADS)
      stage4(tab_sm + i, a.tab + i);
  __pipeline_commit();

  // ranks matter only when the quota ends inside the tile: then every warp
  // counts the dead lanes of the tile's earlier sub-tiles (16-byte loads of
  // lines the tile's other blocks read too) and of each chunk of its own (a
  // ballot), and one barrier publishes the counts
  const int remaining = a.remaining[b];
  const bool ranked = a.srcp != nullptr && remaining > 0 && remaining < TILE;
  const bool all_reborn = a.srcp != nullptr && remaining >= TILE;
  if (ranked) {
    const int warp = tid >> 5, wl_i = tid & 31;
    const float4* e4 = reinterpret_cast<const float4*>(a.e + tile0);
    int prior = 0;
    for (int i = tid; i < sub * (K1_SUB / 4); i += K1_THREADS) {
      const float4 v = e4[i];
      prior += (v.x <= 0.0f) + (v.y <= 0.0f) + (v.z <= 0.0f) + (v.w <= 0.0f);
    }
    prior = __reduce_add_sync(0xffffffffu, prior);
    if (wl_i == 0) warp_dead[0][warp] = prior;
    for (int j = 0; j < K1_PER; ++j) {
      const unsigned m =
          __ballot_sync(0xffffffffu, a.e[base + j * K1_THREADS + tid] <= 0.0f);
      if (wl_i == 0) warp_dead[1 + j][warp] = __popc(m);
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  const Modes& md = a.m;
  Epi ep = {md.bivar_mode, md.one_sided, md.slope, 0, nullptr, 0.0f};
  if (kGeneral) {
    ep.lambertian = md.lambertian;
    ep.tab = a.n_tab ? tab_sm : nullptr;
    ep.ambient_att = md.ambient_att;
    ep.spectral = a.wl != nullptr;
    ep.conductor = md.conductor;
    ep.iam_c = md.iam_c;
  }
  const uint32_t stream = (uint32_t)a.cells[b];
  const float* cb = a.cell_bounds + 4 * (size_t)b;
  int running = 0;  // dead lanes of the tile before the current chunk
  if (ranked)
    for (int w = 0; w < K1_WARPS; ++w) running += warp_dead[0][w];
  if (!kGeneral) {
    // the thread's K1_PER lanes (j * K1_THREADS + tid): reborn lanes draw
    // their ray into their staged slots; then every candidate row, read
    // once, meets all of them; then each is shaded
    unsigned born = 0u;
#pragma unroll 1
    for (int j = 0; j < K1_PER; ++j) {
      const int i_sm = j * K1_THREADS + tid;
      if (k1_reborn(a.e[base + i_sm] <= 0.0f, j, ranked, all_reborn,
                    remaining, warp_dead, running)) {
        born |= 1u << j;
        sample_cell(a.srcp, cb, a.seed, stream,
                    (uint32_t)(sub * K1_SUB + i_sm), pos_sm[3 * i_sm],
                    pos_sm[3 * i_sm + 1], pos_sm[3 * i_sm + 2],
                    dir_sm[3 * i_sm], dir_sm[3 * i_sm + 1],
                    dir_sm[3 * i_sm + 2]);
      }
    }
    Ray q[K1_PER];
    float t_best[K1_PER];
    int slot_best[K1_PER];
#pragma unroll
    for (int j = 0; j < K1_PER; ++j) {
      const int i_sm = j * K1_THREADS + tid;
      q[j] = {pos_sm[3 * i_sm], pos_sm[3 * i_sm + 1], pos_sm[3 * i_sm + 2],
              dir_sm[3 * i_sm], dir_sm[3 * i_sm + 1], dir_sm[3 * i_sm + 2]};
      t_best[j] = INFINITY;
      slot_best[j] = -1;
    }
    for (int g = 0; g < a.G; ++g) {
      const int off = a.gmeta[a.meta_w * g];
      const int mask = a.gmeta[a.meta_w * g + 1];
      const int cnt = a.counts[(size_t)b * a.G + g];
      for (int i = 0; i < cnt; ++i) {
        const float* r = staged_row(rows_sm, off + i, Kp);
#pragma unroll
        for (int j = 0; j < K1_PER; ++j) {
          const float th =
              flat_rect_t(r, mask, a.C, to_local(r, q[j]), a.t_eps);
          if (th < t_best[j]) {
            t_best[j] = th;
            slot_best[j] = off + i;
          }
        }
      }
    }
#pragma unroll 1
    for (int j = 0; j < K1_PER; ++j) {
      // lane j's winner out of the unrolled arrays, kept in registers
      float tb = INFINITY;
      int sb = -1;
#pragma unroll
      for (int k = 0; k < K1_PER; ++k) {
        tb = k == j ? t_best[k] : tb;
        sb = k == j ? slot_best[k] : sb;
      }
      const int i_sm = j * K1_THREADS + tid;
      const size_t l = base + i_sm;
      const uint32_t t = (uint32_t)(sub * K1_SUB + i_sm);
      Lane in;
      in.px = pos_sm[3 * i_sm];
      in.py = pos_sm[3 * i_sm + 1];
      in.pz = pos_sm[3 * i_sm + 2];
      in.dx = dir_sm[3 * i_sm];
      in.dy = dir_sm[3 * i_sm + 1];
      in.dz = dir_sm[3 * i_sm + 2];
      in.e = (born >> j) & 1u ? a.srcp[SP_ERAY] : a.e[l];
      const Shaded o = shade_flat(sb >= 0 ? rows_sm + sb * Kp : nullptr, tb,
                                  in, a.seed, stream, t, ep);
      const bool live = in.e > 0.0f;
      k1_store(a, pos_sm, dir_sm, i_sm, l, o, live,
               sb >= 0 && live ? ids_sm[sb] : -1, stream, t);
    }
  } else {
    const bool has_band = a.srcp != nullptr && a.srcp[SP_HAS_BAND] != 0.0f;
    for (int j = 0; j < K1_PER; ++j) {
      const int i_sm = j * K1_THREADS + tid;    // lane within the sub-tile
      const int t = sub * K1_SUB + i_sm;        // lane within the tile
      const size_t l = tile0 + t;
      Lane in;
      in.e = a.e[l];
      const bool reborn = k1_reborn(in.e <= 0.0f, j, ranked, all_reborn,
                                    remaining, warp_dead, running);
      float wl = a.wl != nullptr ? a.wl[l] : 0.0f;
      if (reborn) {
        sample_cell(a.srcp, cb, a.seed, stream, (uint32_t)t, in.px, in.py,
                    in.pz, in.dx, in.dy, in.dz);
        in.e = a.srcp[SP_ERAY];
        if (a.wl != nullptr && has_band)
          wl = band_wl(a.srcp, a.seed, stream, (uint32_t)t);
      } else {
        in.px = pos_sm[3 * i_sm];
        in.py = pos_sm[3 * i_sm + 1];
        in.pz = pos_sm[3 * i_sm + 2];
        in.dx = dir_sm[3 * i_sm];
        in.dy = dir_sm[3 * i_sm + 1];
        in.dz = dir_sm[3 * i_sm + 2];
      }
      const Ray q = {in.px, in.py, in.pz, in.dx, in.dy, in.dz};
      // each group's candidate slots [off, off + cnt) through the class's
      // row test; the winner is a slot, its normal the global gradient
      Best bb;
      best_init(bb);
      for (int g = 0; g < a.G; ++g) {
        const int* mg = a.gmeta + a.meta_w * g;
        int kinds[MAX_C];
        group_kinds(mg, a.C, kinds);
        scan_group(mg[2], rows_sm + mg[0] * a.K, mg[0],
                   a.counts[(size_t)b * a.G + g], a.K, kinds, mg[1], a.C, q,
                   a.t_eps, a.disc_eps, md.backside_miss != 0, bb);
      }
      const Shaded o = shade<false, false, false, kExtra>(
          bb.sid >= 0 ? rows_sm + bb.sid * a.K : nullptr, -1, bb.gx, bb.gy,
          bb.gz, bb.up, bb.t, in, wl, 1.0f, 0.0f, a.seed, stream,
          (uint32_t)t, ep);
      if (a.nwl != nullptr) a.nwl[l] = wl;
      const bool live = in.e > 0.0f;
      k1_store(a, pos_sm, dir_sm, i_sm, l, o, live,
               bb.sid >= 0 && live ? ids_sm[bb.sid] : -1, stream,
               (uint32_t)t);
    }
  }
  __syncthreads();
  float4* npos4 = reinterpret_cast<float4*>(a.npos + 3 * base);
  float4* ndir4 = reinterpret_cast<float4*>(a.ndir + 3 * base);
  for (int i = tid; i < 3 * K1_SUB / 4; i += K1_THREADS) {
    npos4[i] = reinterpret_cast<const float4*>(pos_sm)[i];
    ndir4[i] = reinterpret_cast<const float4*>(dir_sm)[i];
  }
}

struct PlainArgs {
  const float* rows;
  int S, K, C, G;
  const int* gmeta;  // (G, 3 + MAX_C): first row, end row, class, kinds
  int meta_w;
  uint32_t seed;
  const float *pos, *dir, *e;
  float *npos, *ndir, *ne;
  int* sid;
  float* absorbed;
  const float* wl;   // per-lane wavelength in, or nullptr
  float* nwl;        // per-lane wavelength out (with wl)
  const float* ri;   // per-lane refractive index in (kRefr)
  float* nri;
  const float* mid;  // per-lane medium id in (kMedia)
  float* nmid;
  float* s_e;        // the reflected branch's energy out (kSplit)
  float* s_dir;      // and its (n, 3) direction
  long long n;
  float t_eps, disc_eps;
  int regen;         // regenerate dead lanes from the source
  const float* srcp; // source parameters (kernels/bounce.py:source_params)
  const float* pose; // POSE_FLOATS source pose
  const float* tab;  // (n_tab, 2) spectral table
  int n_tab;
  Modes m;           // the epilogue's modes
  const float* media_tab;   // (n_media, 3) att, scat, g per medium id
  int n_media;
  const float* media_rows;  // (S, 2) side-1 and side-2 ids per row
};

// each K2 instance's block: its threads (one lane a thread) and the
// blocks that __launch_bounds__ asks to keep resident on one SM, the most
// warps at which ptxas keeps every value in registers. Three blocks of
// 256 hold 80 registers a thread. The refractive instances that spill
// there (beside the stage (d)/(e) kinds or media ids with backside_miss,
// and beside scattering, media ids and the stage (d)/(e) kinds) take up
// to 87, at which two blocks of 256 fit (16 warps) but five of 128 (20)
template <bool kRefr, bool kScat, bool kMedia, bool kExtra, bool kBmiss,
          bool kSplit>
struct K2Block {
  static constexpr bool narrow =
      kRefr && ((kBmiss && (kExtra || kMedia)) || (kScat && kMedia && kExtra));
  static constexpr int threads = narrow ? 128 : 256;
  static constexpr int min_blocks = narrow ? 5 : 3;
};

// the float stride of K2's staged rows: whole 16-byte words, so a row's
// coefficients come from shared memory 16 bytes at a time
__host__ __device__ __forceinline__ int k2_stride(int K) {
  return (K + 3) & ~3;
}

// the floats a K2 block stages in shared memory, in this order: the rows
// at k2_stride, the spectral table, the source pose, and in media mode the
// media table and the rows' side ids
inline size_t plain_stage_floats(const PlainArgs& a) {
  return (size_t)a.S * k2_stride(a.K) + 2 * (size_t)a.n_tab + POSE_FLOATS +
         3 * (size_t)a.n_media + (a.n_media ? 2 * (size_t)a.S : 0);
}

// the shared-memory stage of a K2 block
struct K2Stage {
  float *rows, *tab, *pose, *mtab, *mrows;
  int Kp;
};

// one lane l: regenerate it if it is dead and regeneration is on, find its
// nearest hit, shade it, and write its results
template <bool kRefr, bool kScat, bool kMedia, bool kExtra, bool kBmiss,
          bool kSplit>
__device__ __forceinline__ void k2_lane(const PlainArgs& a, int l,
                                        const K2Stage& st) {
  const uint32_t stream = (uint32_t)l / TILE, lane = (uint32_t)l % TILE;
  // a regenerated lane reads only its energy (and its wavelength when the
  // source has no band to draw one); it starts at index 1 in the ambient
  // medium
  Lane in;
  in.e = a.e[l];
  const bool reborn = a.regen && in.e <= 0.0f;
  const bool drawn_wl = reborn && a.srcp[SP_HAS_BAND] != 0.0f;
  float wl = a.wl != nullptr && !drawn_wl ? a.wl[l] : 0.0f;
  float ri = 1.0f, mid = 0.0f;
  if (reborn) {
    sample_disk(a.srcp, st.pose, a.seed, stream, lane, in.px, in.py, in.pz,
                in.dx, in.dy, in.dz, wl);
    in.e = a.srcp[SP_ERAY];
  } else {
    in.px = a.pos[3 * (size_t)l];
    in.py = a.pos[3 * (size_t)l + 1];
    in.pz = a.pos[3 * (size_t)l + 2];
    in.dx = a.dir[3 * (size_t)l];
    in.dy = a.dir[3 * (size_t)l + 1];
    in.dz = a.dir[3 * (size_t)l + 2];
    if (kRefr) ri = a.ri[l];
    if (kMedia) mid = a.mid[l];
  }
  const Ray q = {in.px, in.py, in.pz, in.dx, in.dy, in.dz};
  Best b;
  best_init(b);
  BestLane winner = {q, b};
  if (a.C == 1)
    scan_groups<true, false>(a.gmeta, a.G, a.meta_w, a.C, st.rows, st.Kp, 0,
                             a.S, a.t_eps, a.disc_eps, kBmiss, winner);
  else
    scan_groups<false, false>(a.gmeta, a.G, a.meta_w, a.C, st.rows, st.Kp,
                              0, a.S, a.t_eps, a.disc_eps, kBmiss, winner);
  const bool hit = b.sid >= 0;
  const Modes& md = a.m;
  Epi ep = {md.bivar_mode, md.one_sided, md.slope, md.lambertian,
            a.n_tab ? st.tab : nullptr, md.ambient_att, md.ambient_scat,
            md.ambient_g, md.refr_frost, md.refr_disp, st.mtab, st.mrows,
            a.wl != nullptr, md.cook_torrance, md.lam_specular,
            md.semi_lambertian, md.transparent, md.conductor, md.periodic,
            md.piecewise, md.iam_c};
  const Shaded o = shade<kRefr, kScat, kMedia, kExtra, kSplit>(
      hit ? st.rows + b.sid * st.Kp : nullptr, b.sid, b.gx, b.gy, b.gz, b.up,
      b.t, in, wl, ri, mid, a.seed, stream, lane, ep);
  a.npos[3 * (size_t)l] = o.px;
  a.npos[3 * (size_t)l + 1] = o.py;
  a.npos[3 * (size_t)l + 2] = o.pz;
  a.ndir[3 * (size_t)l] = o.dx;
  a.ndir[3 * (size_t)l + 1] = o.dy;
  a.ndir[3 * (size_t)l + 2] = o.dz;
  a.ne[l] = o.e;
  if (a.nwl != nullptr) a.nwl[l] = wl;
  if (kRefr) a.nri[l] = o.ri;
  if (kMedia) a.nmid[l] = o.mid;
  // stale lanes (no energy after regeneration) report no hit; live lanes
  // that scattered report -2 (alive, on no surface)
  const bool live = in.e > 0.0f;
  if (kSplit) {
    // the reflected branch; zero where no live lane split
    const bool sp = live && o.split;
    a.s_e[l] = sp ? o.s_e : 0.0f;
    a.s_dir[3 * (size_t)l] = sp ? o.sdx : 0.0f;
    a.s_dir[3 * (size_t)l + 1] = sp ? o.sdy : 0.0f;
    a.s_dir[3 * (size_t)l + 2] = sp ? o.sdz : 0.0f;
  }
  a.sid[l] = !live ? -1 : (o.scat ? -2 : (hit ? b.sid : -1));
  a.absorbed[l] = live ? o.absorbed : 0.0f;
}

// K2: persistent blocks, each staging the rows and tables once by cp.async
// and then walking the chunks of T lanes c = blockIdx.x, + gridDim.x, ...
// (no block waits on another), one lane a thread. Every lane is traced
// and shaded, a dead one that is not regenerated too (its sid -1, its
// absorbed 0), as bounce_reflect_pallas does
template <bool kRefr, bool kScat, bool kMedia, bool kExtra, bool kBmiss,
          bool kSplit>
__global__ void __launch_bounds__(
    (K2Block<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit>::threads),
    (K2Block<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit>::min_blocks))
    bounce_kernel(PlainArgs a) {
  constexpr int T =
      K2Block<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit>::threads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  K2Stage st;
  st.Kp = k2_stride(a.K);
  st.rows = smem;
  st.tab = st.rows + a.S * st.Kp;
  st.pose = st.tab + 2 * a.n_tab;
  st.mtab = st.pose + POSE_FLOATS;
  st.mrows = st.mtab + 3 * a.n_media;
  for (int i = tid; i < a.S * st.Kp; i += T) {
    const int s = i / st.Kp, k = i - s * st.Kp;
    if (k < a.K)
      stage4(st.rows + i, a.rows + (size_t)s * a.K + k);
    else
      st.rows[i] = 0.0f;
  }
  for (int i = tid; i < 2 * a.n_tab; i += T)
    stage4(st.tab + i, a.tab + i);
  if (a.regen)
    for (int i = tid; i < POSE_FLOATS; i += T)
      stage4(st.pose + i, a.pose + i);
  if (kMedia) {
    for (int i = tid; i < 3 * a.n_media; i += T)
      stage4(st.mtab + i, a.media_tab + i);
    for (int i = tid; i < 2 * a.S; i += T)
      stage4(st.mrows + i, a.media_rows + i);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int n_chunks = ((int)a.n + T - 1) / T;
  for (int c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int l = c * T + tid;
    if (l < (int)a.n)
      k2_lane<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit>(a, l, st);
  }
}

// K2's launch geometry for n lanes: out[0] blocks, out[1] threads a block,
// out[2] lanes a chunk, out[3] bytes of shared memory a block, out[4]
// blocks resident a SM (the occupancy calculator, registers and shared
// memory both counted), out[5] SMs
struct K2Geometry {
  int blocks, threads, chunk, smem, resident, sms;
};

// one launch of a K2 instance: as many blocks as the card keeps resident
// (fewer when there are fewer chunks), each walking its chunks
template <bool kRefr, bool kScat, bool kMedia, bool kExtra, bool kBmiss,
          bool kSplit>
int launch_plain(const PlainArgs& a, cudaStream_t st, K2Geometry* geo) {
  auto kernel = bounce_kernel<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit>;
  constexpr int T =
      K2Block<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit>::threads;
  const size_t smem = plain_stage_floats(a) * sizeof(float);
  // the occupancy of this instance, asked again only when the stage grows
  // or shrinks
  static size_t known_smem = (size_t)-1;
  static int resident = 0;
  if (smem != known_smem) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, T,
                                                        smem);
    if (err != cudaSuccess) return (int)err;
    known_smem = smem;
  }
  const int sms = sm_count();
  if (resident < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (int)((a.n + T - 1) / T);
  const int blocks = chunks < sms * resident ? chunks : sms * resident;
  if (geo != nullptr) {
    *geo = {blocks, T, T, (int)smem, resident, sms};
    return (int)cudaSuccess;
  }
  if (blocks > 0) kernel<<<blocks, T, smem, st>>>(a);
  return (int)cudaGetLastError();
}

using LaunchPlain = int (*)(const PlainArgs&, cudaStream_t, K2Geometry*);

using CulledKernel = void (*)(CulledArgs);

// K1's instance for these modes (flat_rect: every group flat with rect
// apertures; wl_lane: the lanes carry a wavelength) and the bytes of
// shared memory a block of it stages: the sub-tile's rays, the candidate
// rows and their ids, and in the general instances the spectral table
CulledKernel pick_culled(const Modes& m, bool flat_rect, bool wl_lane,
                         int W, int K, int n_tab, size_t& smem) {
  const bool extra = m.conductor || m.iam_c != 0.0f;
  const bool general = extra || !flat_rect || m.lambertian ||
                       m.ambient_att != 0.0f || wl_lane || m.backside_miss;
  smem = ((size_t)K1_RAY_FLOATS +
          (size_t)W * (general ? k1_stride<true>(K) : k1_stride<false>(K)) +
          (size_t)W +
          (general ? 2 * (size_t)n_tab : 0)) *
         sizeof(float);
  return extra     ? bounce_culled_kernel<true, true>
         : general ? bounce_culled_kernel<true, false>
                   : bounce_culled_kernel<false, false>;
}

// the instance with or without backside_miss: a compile-time switch, so
// scenes without bifacial rows keep a row loop without the test; the same
// for energy splitting (kSplit)
template <bool kRefr, bool kScat, bool kMedia, bool kExtra,
          bool kSplit = false>
LaunchPlain pick_plain(bool bmiss) {
  return bmiss ? launch_plain<kRefr, kScat, kMedia, kExtra, true, kSplit>
               : launch_plain<kRefr, kScat, kMedia, kExtra, false, kSplit>;
}

// K2's instance for these modes (refr, media: the lanes carry an index,
// a medium id), or nullptr for a combination no trace dispatches: media
// ride the refractive mode; the stage (d)/(e) kinds run alone, in an
// ambient HG medium, or beside refraction and media ids; splitting beside
// refraction alone; each with and without backside_miss
LaunchPlain pick_k2(const Modes& m, bool refr, bool media) {
  const bool extra = m.cook_torrance || m.lam_specular ||
                     m.semi_lambertian || m.transparent || m.conductor ||
                     m.periodic || m.piecewise || m.iam_c != 0.0f;
  const bool bm = m.backside_miss != 0;
  const bool split = m.refr_split != 0;
  switch ((refr ? 1 : 0) | (m.scat ? 2 : 0) | (media ? 4 : 0) |
          (extra ? 8 : 0)) {
    case 0: return pick_plain<false, false, false, false>(bm);
    case 1:
      return split ? pick_plain<true, false, false, false, true>(bm)
                   : pick_plain<true, false, false, false>(bm);
    case 2: return pick_plain<false, true, false, false>(bm);
    case 3: return pick_plain<true, true, false, false>(bm);
    case 5: return pick_plain<true, false, true, false>(bm);
    case 7: return pick_plain<true, true, true, false>(bm);
    case 8: return pick_plain<false, false, false, true>(bm);
    case 9:
      return split ? pick_plain<true, false, false, true, true>(bm)
                   : pick_plain<true, false, false, true>(bm);
    case 10: return pick_plain<false, true, false, true>(bm);
    case 11: return pick_plain<true, true, false, true>(bm);
    case 13: return pick_plain<true, false, true, true>(bm);
    case 15: return pick_plain<true, true, true, true>(bm);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

int tt_bounce_culled(const void* rows, int S, int K, const void* lists,
                     int W, const void* counts, int G, const void* gmeta,
                     int max_c, const void* cells, const void* cell_bounds,
                     const void* remaining, const void* active,
                     const void* order, const void* srcp, int seed,
                     const void* pos,
                     const void* dir, const void* e, void* npos, void* ndir,
                     void* ne, void* sid, void* absorbed, const void* wl,
                     void* nwl, const void* tab, int n_tab, int nb,
                     float t_eps, float disc_eps, int flat_rect,
                     const void* modes, void* stream) {
  (void)S;
  if (modes == nullptr || order == nullptr) return (int)cudaErrorInvalidValue;
  const Modes& m = *static_cast<const Modes*>(modes);
  const int C = (K - ROW_AP) / 6;
  // the culled kernel serves the cullable kinds only: no refraction,
  // scattering or stage (d)/(e) scatterers (the engine's cullable gate)
  if (max_c != MAX_C || C > MAX_C || (wl == nullptr) != (nwl == nullptr) ||
      (wl != nullptr && n_tab < 1) || (m.conductor && n_tab < 1) ||
      (n_tab > 0 && tab == nullptr) || m.refr_frost || m.refr_disp ||
      m.scat || m.cook_torrance || m.lam_specular || m.semi_lambertian ||
      m.transparent || m.periodic || m.piecewise || m.refr_split)
    return (int)cudaErrorInvalidValue;
  CulledArgs a;
  a.rows = static_cast<const float*>(rows);
  a.K = K;
  a.C = C;
  a.lists = static_cast<const int*>(lists);
  a.W = W;
  a.counts = static_cast<const int*>(counts);
  a.G = G;
  a.gmeta = static_cast<const int*>(gmeta);
  a.meta_w = 3 + max_c;
  a.cells = static_cast<const int*>(cells);
  a.cell_bounds = static_cast<const float*>(cell_bounds);
  a.remaining = static_cast<const int*>(remaining);
  a.active = static_cast<const int*>(active);
  a.order = static_cast<const int*>(order);
  a.srcp = static_cast<const float*>(srcp);
  a.seed = (uint32_t)seed;
  a.pos = static_cast<const float*>(pos);
  a.dir = static_cast<const float*>(dir);
  a.e = static_cast<const float*>(e);
  a.npos = static_cast<float*>(npos);
  a.ndir = static_cast<float*>(ndir);
  a.ne = static_cast<float*>(ne);
  a.sid = static_cast<int*>(sid);
  a.absorbed = static_cast<float*>(absorbed);
  a.wl = static_cast<const float*>(wl);
  a.nwl = static_cast<float*>(nwl);
  a.tab = static_cast<const float*>(tab);
  a.n_tab = n_tab;
  a.t_eps = t_eps;
  a.disc_eps = disc_eps;
  a.m = m;
  size_t smem;
  const CulledKernel kernel =
      pick_culled(m, flat_rect != 0, wl != nullptr, W, K, n_tab, smem);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    kernel<<<nb * K1_SPLIT, K1_THREADS, smem,
             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// K1's launch geometry for these modes: out[0] blocks per tile, out[1]
// threads per block, out[2] lanes per block, out[3] bytes of shared
// memory per block, out[4] blocks resident on one SM (the occupancy
// calculator, registers and shared memory both counted)
int tt_k1_geometry(int W, int K, int n_tab, int flat_rect, int wl_lane,
                   const void* modes, int* out) {
  if (modes == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  size_t smem;
  const CulledKernel kernel =
      pick_culled(*static_cast<const Modes*>(modes), flat_rect != 0,
                  wl_lane != 0, W, K, n_tab, smem);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                      K1_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = K1_SPLIT;
  out[1] = K1_THREADS;
  out[2] = K1_SUB;
  out[3] = (int)smem;
  out[4] = resident;
  return (int)cudaSuccess;
}

int tt_bounce(const void* rows, int S, int K, int G, const void* gmeta,
              int max_c, int seed, const void* pos, const void* dir,
              const void* e, void* npos, void* ndir, void* ne, void* sid,
              void* absorbed, const void* wl, void* nwl, const void* ri,
              void* nri, const void* mid, void* nmid, void* s_e,
              void* s_dir, int n, float t_eps,
              float disc_eps, int regen, const void* srcp, const void* pose,
              const void* tab, int n_tab, const void* modes,
              const void* media_tab, int n_media, const void* media_rows,
              void* stream) {
  const int C = (K - ROW_AP) / 6;
  const bool refr = ri != nullptr, media = mid != nullptr;
  if (modes == nullptr) return (int)cudaErrorInvalidValue;
  const Modes& m = *static_cast<const Modes*>(modes);
  if (max_c != MAX_C || C > MAX_C || (wl == nullptr) != (nwl == nullptr) ||
      (wl != nullptr && n_tab < 1) || (regen && (!srcp || !pose)) ||
      refr != (nri != nullptr) || media != (nmid != nullptr) ||
      (media && (!refr || !media_tab || !media_rows || n_media < 1)) ||
      (m.refr_disp && (!refr || wl == nullptr)) ||
      ((m.conductor || m.piecewise) && n_tab < 1) ||
      (n_tab > 0 && tab == nullptr) || (s_e == nullptr) != (s_dir == nullptr) ||
      (s_e != nullptr) != (m.refr_split != 0) ||
      (m.refr_split && (!refr || media || m.scat)))
    return (int)cudaErrorInvalidValue;
  PlainArgs a;
  a.rows = static_cast<const float*>(rows);
  a.S = S;
  a.K = K;
  a.C = C;
  a.G = G;
  a.gmeta = static_cast<const int*>(gmeta);
  a.meta_w = 3 + max_c;
  a.seed = (uint32_t)seed;
  a.pos = static_cast<const float*>(pos);
  a.dir = static_cast<const float*>(dir);
  a.e = static_cast<const float*>(e);
  a.npos = static_cast<float*>(npos);
  a.ndir = static_cast<float*>(ndir);
  a.ne = static_cast<float*>(ne);
  a.sid = static_cast<int*>(sid);
  a.absorbed = static_cast<float*>(absorbed);
  a.wl = static_cast<const float*>(wl);
  a.nwl = static_cast<float*>(nwl);
  a.ri = static_cast<const float*>(ri);
  a.nri = static_cast<float*>(nri);
  a.mid = static_cast<const float*>(mid);
  a.nmid = static_cast<float*>(nmid);
  a.s_e = static_cast<float*>(s_e);
  a.s_dir = static_cast<float*>(s_dir);
  a.n = n;
  a.t_eps = t_eps;
  a.disc_eps = disc_eps;
  a.regen = regen;
  a.srcp = static_cast<const float*>(srcp);
  a.pose = static_cast<const float*>(pose);
  a.tab = static_cast<const float*>(tab);
  a.n_tab = n_tab;
  a.m = m;
  a.media_tab = static_cast<const float*>(media_tab);
  a.n_media = media ? n_media : 0;
  a.media_rows = static_cast<const float*>(media_rows);
  const LaunchPlain launch = pick_k2(m, refr, media);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(a, static_cast<cudaStream_t>(stream), nullptr);
}

// K2's launch geometry for n lanes of a call with these modes, (S, K)
// rows, n_tab table rows and n_media media (refr, media: the lanes carry
// an index, a medium id): out[0] blocks, out[1] threads a block, out[2]
// lanes a chunk, out[3] bytes of shared memory a block, out[4] blocks
// resident a SM (the occupancy calculator, registers and shared memory
// both counted), out[5] SMs
int tt_k2_geometry(int S, int K, int n_tab, int n_media, int refr,
                   int media, const void* modes, long long n, int* out) {
  if (modes == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  const LaunchPlain launch =
      pick_k2(*static_cast<const Modes*>(modes), refr != 0, media != 0);
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  PlainArgs a = {};
  a.S = S;
  a.K = K;
  a.n = n;
  a.n_tab = n_tab;
  a.n_media = media ? n_media : 0;
  K2Geometry g;
  const int err = launch(a, nullptr, &g);
  if (err != 0) return err;
  out[0] = g.blocks;
  out[1] = g.threads;
  out[2] = g.chunk;
  out[3] = g.smem;
  out[4] = g.resident;
  out[5] = g.sms;
  return (int)cudaSuccess;
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
