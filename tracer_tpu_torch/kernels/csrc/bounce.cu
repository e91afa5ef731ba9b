// Fused bounce kernels on Hopper (sm_90a): intersect + shade in one pass,
// so the ray state makes one trip through device memory per bounce.
//
// tt_bounce_culled (K1) replaces the TPU kernel bounce_reflect_culled_pallas
// (tracer_tpu/kernels/pallas_intersect.py:2049, body
// _make_fused_kernel_culled :1884): one thread block serves one tile of
// TILE lanes, regenerates the tile's first `remaining` dead lanes from its
// equal-area source cell (Buie sunshape), tests only the tile's candidate
// rows and shades the winner. Supported subset (the wrapper checks it):
// flat quadric class with AP_RECT / AP_NONE apertures, K_REFLECT optics
// with bivariate / radial / mixed slope error and the one-sided kill, disk
// Buie sources.
//
// tt_bounce (K2) replaces bounce_reflect_pallas (:1693, body
// _make_fused_kernel :1517), stages (a) and (b): one thread per lane, a
// brute-force loop over every row of the scene with every quadric class
// and aperture kind (rows.cuh, shared with K1 and K3), then the shade
// epilogue (_make_shade_epilogue :679): reflect with slope error, the one-sided
// kill, the pure-Lambertian lobe (:1181), spectral absorptance
// interpolated at the lane's wavelength (_interp_row_table :144, carried
// by _surface_body :430) and Beer-Lambert attenuation of hit segments in
// an ambient medium (:1245). With regeneration on, dead lanes first draw a
// fresh ray from the un-celled disk source (_sample_disk_buie :1413: Buie
// or pillbox polar angle, optional aureole, optional wavelength band)
// whose pose (centre, position rotation, direction rotation) is a device
// operand. The plain streaming megakernel runs it every round, the culled
// trace's drain with regeneration off.
//
// What bounds them on this card: the per-lane row loop is float32
// arithmetic on rows that every lane of a block shares (about 50 flops
// per flat row, 100 per curved one), and each lane's state is read and
// written once (28-32 bytes in, 36-40 out; a lane that regenerates reads
// only its 4-byte energy). K1 and K2 test flat rect rows with rows.cuh's
// flat_rect_t, K2 every other class with its row_hit. Both kernels stage
// their rows in shared memory once per block, so the loop reads no device
// memory and
// runs from registers; the ray state streams through with neighbouring
// threads on neighbouring lanes. Random numbers come from Philox4x32-10
// keyed per tile and counted per lane and draw call, so the plain PyTorch
// versions (kernels/bounce.py) draw the same uniforms and the two can be
// compared lane by lane.
#include <stdint.h>

#include "rows.cuh"

namespace {

constexpr int TILE = 3072;            // lanes per tile (= TPU ray tile)
constexpr int K1_THREADS = 256;       // culled kernel: 12 lanes per thread
constexpr int K2_THREADS = 256;
constexpr int SMEM_DEFAULT = 48 * 1024;
constexpr int POSE_FLOATS = 21;       // centre, position rot, direction rot

// source parameter block (kernels/bounce.py:source_params)
constexpr int SP_RADIUS = 12, SP_ERAY = 13, SP_DISC_END = 14,
              SP_HAS_GAMMA = 15, SP_C_AUR = 16, SP_TT = 17, SP_INV_GP2 = 18,
              SP_COEFFS = 19, SP_NCOEFF = 11, SP_HAS_BAND = 30,
              SP_WL_LO = 31, SP_WL_HI = 32;

// Philox draw calls (kernels/philox.py): each has its own counter, so
// adding a draw never shifts another
constexpr uint32_t CALL_REGEN = 0u, CALL_SLOPE = 1u, CALL_LAMBERT = 2u,
                   CALL_BAND = 3u;

__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0,
                                       uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// four uniforms in (0, 1]: key (seed, stream), counter (lane, call, 0, 0)
__device__ __forceinline__ void uniforms4(uint32_t seed, uint32_t stream,
                                          uint32_t lane, uint32_t call,
                                          float u[4]) {
  uint32_t c[4] = {lane, call, 0u, 0u};
  philox(c, seed, stream);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    u[i] = (float)(c[i] >> 8) * (1.0f / 16777216.0f) + 1e-12f;
}

// rotate a +Z-sampled vector into the frame whose z is the given axis
__device__ __forceinline__ void rot_about(float ax, float ay, float az,
                                          float ex, float ey, float ez,
                                          float& ox, float& oy, float& oz) {
  const float pn = sqrtf(fmaxf(ax * ax + ay * ay, 1e-30f));
  const bool sing = pn < 1e-6f;
  const float perp_x = sing ? 1.0f : ay / pn;
  const float perp_y = sing ? 0.0f : -ax / pn;
  const float yc_x = -az * perp_y;
  const float yc_y = az * perp_x;
  const float yc_z = ax * perp_y - ay * perp_x;
  const float mx = ex * perp_x + ey * yc_x + ez * ax;
  const float my = ex * perp_y + ey * yc_y + ez * ay;
  const float mz = ey * yc_z + ez * az;
  const float mr = rsqrtf(fmaxf(mx * mx + my * my + mz * mz, 1e-30f));
  ox = mx * mr;
  oy = my * mr;
  oz = mz * mr;
}

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

// a fresh ray from one equal-area cell [a0, a1, th0, th1] of the Buie
// disk source (pallas_intersect._sample_disk_buie with cell)
__device__ __forceinline__ void sample_cell(const float* sp, const float* cb,
                                            uint32_t seed, uint32_t stream,
                                            uint32_t lane, float& px,
                                            float& py, float& pz, float& dx,
                                            float& dy, float& dz) {
  float u[4];
  uniforms4(seed, stream, lane, CALL_REGEN, u);
  const float a0 = cb[0], a1 = cb[1], th0 = cb[2], th1 = cb[3];
  const float rr = sp[SP_RADIUS] * sqrtf(a0 + u[0] * (a1 - a0));
  float s_v, c_v;
  sincosf(th0 + u[1] * (th1 - th0), &s_v, &c_v);
  const float lx = rr * c_v, ly = rr * s_v;
  const float* rot = sp + 3;
  px = rot[0] * lx + rot[1] * ly + sp[0];
  py = rot[3] * lx + rot[4] * ly + sp[1];
  pz = rot[6] * lx + rot[7] * ly + sp[2];
  const float theta = buie_theta(sp, u[2]);
  float s_t, c_t, s_d, c_d;
  sincosf(theta, &s_t, &c_t);
  sincosf(TWO_PI * u[3], &s_d, &c_d);
  const float ax = s_t * c_d, ay = s_t * s_d, az = c_t;
  dx = rot[0] * ax + rot[1] * ay + rot[2] * az;
  dy = rot[3] * ax + rot[4] * ay + rot[5] * az;
  dz = rot[6] * ax + rot[7] * ay + rot[8] * az;
}

// a fresh ray from the whole disk source (pallas_intersect._sample_disk_buie
// without cell, with the traced frame): radius sqrt(u1), angle u2 turns,
// polar angle from u3, azimuth u4 turns; the pose is POSE_FLOATS floats
// (centre, row-major position rotation, row-major direction rotation).
// With a band, the wavelength is uniform in it (the band's own draw).
__device__ __forceinline__ void sample_disk(const float* sp,
                                            const float* pose, uint32_t seed,
                                            uint32_t stream, uint32_t lane,
                                            float& px, float& py, float& pz,
                                            float& dx, float& dy, float& dz,
                                            float& wl) {
  float u[4];
  uniforms4(seed, stream, lane, CALL_REGEN, u);
  const float rr = sp[SP_RADIUS] * sqrtf(u[0]);
  float s_v, c_v;
  sincosf(TWO_PI * u[1], &s_v, &c_v);
  const float lx = rr * c_v, ly = rr * s_v;
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
  if (sp[SP_HAS_BAND] != 0.0f) {
    float ub[4];
    uniforms4(seed, stream, lane, CALL_BAND, ub);
    wl = sp[SP_WL_LO] + ub[0] * (sp[SP_WL_HI] - sp[SP_WL_LO]);
  }
}

// piecewise-linear value at wl of the table chunk [start, start + length)
// of (wavelength, absorptance) pairs, clamped to the chunk's edge values
// (pallas_intersect._interp_row_table)
__device__ __forceinline__ float interp_row(float wl, int start, int length,
                                            const float* tab) {
  const int hi = start + length - 1;
  if (wl < tab[2 * start]) return tab[2 * start + 1];
  if (wl >= tab[2 * hi]) return tab[2 * hi + 1];
  for (int k = start; k < hi; ++k) {
    const float x0 = tab[2 * k], x1 = tab[2 * k + 2];
    if (wl >= x0 && wl < x1) {
      const float w = (wl - x0) / (x1 == x0 ? 1.0f : x1 - x0);
      const float y0 = tab[2 * k + 1], y1 = tab[2 * k + 3];
      return y0 + fminf(fmaxf(w, 0.0f), 1.0f) * (y1 - y0);
    }
  }
  return 0.0f;
}

struct Lane {
  float px, py, pz, dx, dy, dz, e;
};

struct Shaded {
  float px, py, pz, dx, dy, dz, e, absorbed;
};

// the epilogue's static modes
struct Epi {
  int bivar_mode;      // 1 every slope row bivariate, 0 all radial, 2 per row
  int one_sided, slope, lambertian;
  const float* tab;    // (n, 2) spectral table, or nullptr: no spectral rows
  float ambient_att;   // Beer-Lambert coefficient of the ambient medium [1/m]
};

// shade the winner row `w` (nullptr on a miss) with the carried normal
// (unnormalised gradient) and local d_z: pallas_intersect
// _make_shade_epilogue's reflect, slope error, one-sided kill, Lambertian
// and ambient branches, and the spectral carry of _surface_body
__device__ __forceinline__ Shaded shade(const float* w, float ngx_w,
                                        float ngy_w, float ngz_w,
                                        float upd_w, float t_b,
                                        const Lane& in, float wl,
                                        uint32_t seed, uint32_t stream,
                                        uint32_t lane, const Epi& ep) {
  const bool hit = w != nullptr;
  const float ngx = hit ? ngx_w : 0.0f, ngy = hit ? ngy_w : 0.0f,
              ngz = hit ? ngz_w : 0.0f;
  const float upd_b = hit ? upd_w : 0.0f;
  const float kf = hit ? w[ROW_KIND] : 0.0f;
  const float kind = floorf(kf * (1.0f / 1024.0f));
  float q0 = hit ? w[ROW_P0] : 0.0f;
  float q1 = hit ? w[ROW_P0 + 1] : 0.0f;
  if (ep.tab != nullptr && kind == 5.0f) {
    // K_REFLECT_SPECTRAL: p0/p1 are the table chunk, sigma is p2
    q0 = interp_row(wl, static_cast<int>(w[ROW_P0]),
                    static_cast<int>(w[ROW_P0 + 1]), ep.tab);
    q1 = w[ROW_P0 + 2];
  }
  const float t_safe = hit ? t_b : 0.0f;
  const float hx = in.px + t_safe * in.dx;
  const float hy = in.py + t_safe * in.dy;
  const float hz = in.pz + t_safe * in.dz;
  // shading normal: the carried gradient, flipped against the ray
  const float g2 = ngx * ngx + ngy * ngy + ngz * ngz;
  const float rinv = rsqrtf(fmaxf(g2, 1e-30f));
  const float cos_g = in.dx * ngx + in.dy * ngy + in.dz * ngz;
  const float flip = cos_g > 0.0f ? -rinv : rinv;
  const float n0x = ngx * flip, n0y = ngy * flip, n0z = ngz * flip;
  float nx = n0x, ny = n0y, nz = n0z;
  if (ep.slope) {
    float u[4];
    uniforms4(seed, stream, lane, CALL_SLOPE, u);
    const float rr = sqrtf(-2.0f * logf(u[0]));
    float s_bm, c_bm;
    sincosf(TWO_PI * u[1], &s_bm, &c_bm);
    const float nrm1 = rr * c_bm;
    // Lambertian rows carry ang_range in q1, not a slope sigma
    const float sigma = ep.lambertian && kind == 2.0f ? 0.0f : q1;
    const bool is_bv = ep.bivar_mode == 1 ||
                       (ep.bivar_mode == 2 && fmodf(kf, 4.0f) >= 2.0f);
    float ex, ey, ez;
    if (is_bv) {
      float s_tx, c_tx, s_ty, c_ty;
      sincosf(nrm1 * sigma, &s_tx, &c_tx);
      sincosf(rr * s_bm * sigma, &s_ty, &c_ty);
      const float tx = fminf(fmaxf(s_tx / c_tx, -1e6f), 1e6f);
      const float ty = fminf(fmaxf(s_ty / c_ty, -1e6f), 1e6f);
      ez = rsqrtf(1.0f + tx * tx + ty * ty);
      ex = tx * ez;
      ey = ty * ez;
    } else {
      float s_th, c_th, s_ph, c_ph;
      sincosf(nrm1 * sigma, &s_th, &c_th);
      sincosf(TWO_PI * u[2], &s_ph, &c_ph);
      ex = s_th * c_ph;
      ey = s_th * s_ph;
      ez = c_th;
    }
    rot_about(nx, ny, nz, ex, ey, ez, nx, ny, nz);
  }
  const float dn = in.dx * nx + in.dy * ny + in.dz * nz;
  float rx = in.dx - 2.0f * dn * nx;
  float ry = in.dy - 2.0f * dn * ny;
  float rz = in.dz - 2.0f * dn * nz;
  if (ep.lambertian) {
    // K_LAMBERTIAN: cosine-weighted about the unperturbed normal within
    // ang_range (q1)
    float u[4];
    uniforms4(seed, stream, lane, CALL_LAMBERT, u);
    float sin_cap, cos_cap, s_pl, c_pl;
    sincosf(q1, &sin_cap, &cos_cap);
    const float sinsq = sin_cap * sqrtf(u[0]);
    sincosf(TWO_PI * u[1], &s_pl, &c_pl);
    const float lz = sqrtf(fmaxf(1.0f - sinsq * sinsq, 0.0f));
    float ldx, ldy, ldz;
    rot_about(n0x, n0y, n0z, sinsq * c_pl, sinsq * s_pl, lz, ldx, ldy, ldz);
    if (kind == 2.0f) {
      rx = ldx;
      ry = ldy;
      rz = ldz;
    }
  }
  // the ambient medium takes its share of the hit segment before the
  // surface does; escaping lanes keep their energy
  const float e_att = ep.ambient_att > 0.0f && hit
                          ? in.e * expf(-ep.ambient_att * t_safe)
                          : in.e;
  float e_out = e_att * (1.0f - q0);
  // F_ONE_SIDED is bit 0 of kind*1024 + flags: back-face hits die
  if (ep.one_sided && fmodf(kf, 2.0f) >= 1.0f && upd_b > 0.0f) e_out = 0.0f;
  Shaded o;
  o.px = hit ? hx : in.px;
  o.py = hit ? hy : in.py;
  o.pz = hit ? hz : in.pz;
  o.dx = hit ? rx : in.dx;
  o.dy = hit ? ry : in.dy;
  o.dz = hit ? rz : in.dz;
  o.e = hit ? e_out : in.e;
  o.absorbed = hit ? e_att - e_out : 0.0f;
  return o;
}

// shade on a flat winner row, whose normal is its row's R e_z (K1)
__device__ __forceinline__ Shaded shade_flat(const float* w, float t_b,
                                             const Lane& in, uint32_t seed,
                                             uint32_t stream, uint32_t lane,
                                             const Epi& ep) {
  if (w == nullptr)
    return shade(w, 0.0f, 0.0f, 0.0f, 0.0f, t_b, in, 0.0f, seed, stream,
                 lane, ep);
  return shade(w, w[6], w[7], w[8], w[6] * in.dx + w[7] * in.dy + w[8] * in.dz,
               t_b, in, 0.0f, seed, stream, lane, ep);
}

// the ray of lane l (its energy is loaded apart: a lane that is
// regenerated needs only that)
__device__ __forceinline__ void load_ray(const float* pos, const float* dir,
                                         size_t l, Lane& r) {
  r.px = pos[3 * l];
  r.py = pos[3 * l + 1];
  r.pz = pos[3 * l + 2];
  r.dx = dir[3 * l];
  r.dy = dir[3 * l + 1];
  r.dz = dir[3 * l + 2];
}

__device__ __forceinline__ Lane load_lane(const float* pos, const float* dir,
                                          const float* e, size_t l) {
  Lane r;
  load_ray(pos, dir, l, r);
  r.e = e[l];
  return r;
}

__device__ __forceinline__ void store_lane(float* npos, float* ndir,
                                           float* ne, size_t l,
                                           float px, float py, float pz,
                                           float dx, float dy, float dz,
                                           float e) {
  npos[3 * l] = px;
  npos[3 * l + 1] = py;
  npos[3 * l + 2] = pz;
  ndir[3 * l] = dx;
  ndir[3 * l + 1] = dy;
  ndir[3 * l + 2] = dz;
  ne[l] = e;
}

struct CulledArgs {
  const float* rows;
  int K, C;
  const int* lists;
  int W;
  const int* counts;
  int G;
  const int* gmeta;  // (G, 2): column offset, rect-constraint bit mask
  const int* cells;
  const float* cell_bounds;
  const int* remaining;
  const int* active;
  const float* srcp;
  int has_src;
  uint32_t seed;
  const float *pos, *dir, *e;
  float *npos, *ndir, *ne;
  int* sid;
  float* absorbed;
  float t_eps;
  int bivar_mode, one_sided, slope;
};

__global__ void __launch_bounds__(K1_THREADS)
    bounce_culled_kernel(CulledArgs a) {
  extern __shared__ float smem[];
  __shared__ int warp_tot[K1_THREADS / 32];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t base = (size_t)b * TILE;
  if (a.active[b] == 0) {
    // idle tile: state passes through, no hits, no absorption
    for (int t = tid; t < TILE; t += K1_THREADS) {
      const size_t l = base + t;
      const Lane in = load_lane(a.pos, a.dir, a.e, l);
      store_lane(a.npos, a.ndir, a.ne, l, in.px, in.py, in.pz, in.dx, in.dy,
                 in.dz, in.e);
      a.sid[l] = -1;
      a.absorbed[l] = 0.0f;
    }
    return;
  }
  // stage this tile's candidate rows (W slots of K floats) and their ids
  float* rows_sm = smem;
  int* ids_sm = reinterpret_cast<int*>(smem + a.W * a.K);
  const int* list_b = a.lists + (size_t)b * a.W;
  for (int i = tid; i < a.W * a.K; i += K1_THREADS) {
    const int slot = i / a.K;
    const int s = list_b[slot];
    rows_sm[i] = s >= 0 ? a.rows[(size_t)s * a.K + (i - slot * a.K)] : 0.0f;
  }
  for (int i = tid; i < a.W; i += K1_THREADS) ids_sm[i] = list_b[i];
  __syncthreads();

  const Epi ep = {a.bivar_mode, a.one_sided, a.slope, 0, nullptr, 0.0f};
  const int remaining = a.remaining[b];
  const uint32_t stream = (uint32_t)a.cells[b];
  const float* cb = a.cell_bounds + 4 * (size_t)b;
  const int warp = tid >> 5, wl = tid & 31;
  int running = 0;  // dead lanes in the chunks before this one
  for (int j = 0; j < TILE / K1_THREADS; ++j) {
    const int t = j * K1_THREADS + tid;  // lane within the tile
    const size_t l = base + t;
    Lane in;
    in.e = a.e[l];
    // exclusive rank of each dead lane in flat lane order: warp ballot +
    // a scan of the warp totals (the engine re-derives the same ranks)
    const bool dead = in.e <= 0.0f;
    const unsigned m = __ballot_sync(0xffffffffu, dead);
    const int before = __popc(m & ((1u << wl) - 1u));
    if (wl == 0) warp_tot[warp] = __popc(m);
    __syncthreads();
    int woff = 0, tot = 0;
    for (int w = 0; w < K1_THREADS / 32; ++w) {
      const int c = warp_tot[w];
      woff += w < warp ? c : 0;
      tot += c;
    }
    __syncthreads();
    const int rank = running + woff + before;
    running += tot;
    if (a.has_src && dead && rank < remaining) {
      sample_cell(a.srcp, cb, a.seed, stream, (uint32_t)t, in.px, in.py,
                  in.pz, in.dx, in.dy, in.dz);
      in.e = a.srcp[SP_ERAY];
    } else {
      load_ray(a.pos, a.dir, l, in);
    }
    const Ray q = {in.px, in.py, in.pz, in.dx, in.dy, in.dz};
    float t_best = INFINITY;
    int slot_best = -1;
    for (int g = 0; g < a.G; ++g) {
      const int off = a.gmeta[2 * g], mask = a.gmeta[2 * g + 1];
      const int cnt = a.counts[(size_t)b * a.G + g];
      for (int i = 0; i < cnt; ++i) {
        const float* r = rows_sm + (off + i) * a.K;
        const float th = flat_rect_t(r, mask, a.C, to_local(r, q), a.t_eps);
        if (th < t_best) {
          t_best = th;
          slot_best = off + i;
        }
      }
    }
    const bool hit = slot_best >= 0;
    const Shaded o = shade_flat(hit ? rows_sm + slot_best * a.K : nullptr,
                                t_best, in, a.seed, stream, (uint32_t)t, ep);
    store_lane(a.npos, a.ndir, a.ne, l, o.px, o.py, o.pz, o.dx, o.dy, o.dz,
               o.e);
    const bool live = in.e > 0.0f;
    a.sid[l] = hit && live ? ids_sm[slot_best] : -1;
    a.absorbed[l] = live ? o.absorbed : 0.0f;
  }
}

struct PlainArgs {
  const float* rows;
  int S, K, C, G;
  const int* gmeta;  // (G, 3 + MAX_C): first row, end row, class, kinds
  int meta_w;
  uint32_t seed;
  const float *pos, *dir, *e;
  const float* wl;   // per-lane wavelength in, or nullptr
  float *npos, *ndir, *ne;
  float* nwl;        // per-lane wavelength out (with wl)
  int* sid;
  float* absorbed;
  long long n;
  float t_eps, disc_eps;
  int regen;         // regenerate dead lanes from the source
  const float* srcp; // source parameters (kernels/bounce.py:source_params)
  const float* pose; // POSE_FLOATS source pose
  const float* tab;  // (n_tab, 2) spectral table
  int n_tab;
  int bivar_mode, one_sided, slope, lambertian;
  float ambient_att;
};

__global__ void __launch_bounds__(K2_THREADS) bounce_kernel(PlainArgs a) {
  // the block stages every row, the spectral table and the source pose
  extern __shared__ float smem[];
  float* rows_sm = smem;
  float* tab_sm = smem + a.S * a.K;
  float* pose_sm = tab_sm + 2 * a.n_tab;
  for (int i = threadIdx.x; i < a.S * a.K; i += K2_THREADS)
    rows_sm[i] = a.rows[i];
  for (int i = threadIdx.x; i < 2 * a.n_tab; i += K2_THREADS)
    tab_sm[i] = a.tab[i];
  if (a.regen)
    for (int i = threadIdx.x; i < POSE_FLOATS; i += K2_THREADS)
      pose_sm[i] = a.pose[i];
  __syncthreads();
  const size_t l = (size_t)blockIdx.x * K2_THREADS + threadIdx.x;
  if (l >= (size_t)a.n) return;
  const uint32_t stream = (uint32_t)(l / TILE), lane = (uint32_t)(l % TILE);
  // a regenerated lane reads only its energy (and its wavelength when the
  // source has no band to draw one from)
  Lane in;
  in.e = a.e[l];
  const bool reborn = a.regen && in.e <= 0.0f;
  const bool drawn_wl = reborn && a.srcp[SP_HAS_BAND] != 0.0f;
  float wl = a.wl != nullptr && !drawn_wl ? a.wl[l] : 0.0f;
  if (reborn) {
    sample_disk(a.srcp, pose_sm, a.seed, stream, lane, in.px, in.py, in.pz,
                in.dx, in.dy, in.dz, wl);
    in.e = a.srcp[SP_ERAY];
  } else {
    load_ray(a.pos, a.dir, l, in);
  }
  const Ray q = {in.px, in.py, in.pz, in.dx, in.dy, in.dz};
  Best b;
  best_init(b);
  for (int g = 0; g < a.G; ++g) {
    const int* m = a.gmeta + g * a.meta_w;
    int kinds[MAX_C];
    group_kinds(m, a.C, kinds);
    scan_group(m[2], rows_sm + m[0] * a.K, m[0], m[1] - m[0], a.K, kinds,
               rect_mask_of(m, a.C), a.C, q, a.t_eps, a.disc_eps, false, b);
  }
  const bool hit = b.sid >= 0;
  const Epi ep = {a.bivar_mode, a.one_sided, a.slope, a.lambertian,
                  a.wl != nullptr ? tab_sm : nullptr, a.ambient_att};
  const Shaded o = shade(hit ? rows_sm + b.sid * a.K : nullptr, b.gx, b.gy,
                         b.gz, b.up, b.t, in, wl, a.seed, stream, lane, ep);
  store_lane(a.npos, a.ndir, a.ne, l, o.px, o.py, o.pz, o.dx, o.dy, o.dz,
             o.e);
  if (a.nwl != nullptr) a.nwl[l] = wl;
  // stale lanes (no energy after regeneration) report no hit
  const bool live = in.e > 0.0f;
  a.sid[l] = hit && live ? b.sid : -1;
  a.absorbed[l] = live ? o.absorbed : 0.0f;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace

extern "C" {

int tt_bounce_culled(const void* rows, int S, int K, const void* lists,
                     int W, const void* counts, int G, const void* gmeta,
                     const void* cells, const void* cell_bounds,
                     const void* remaining, const void* active,
                     const void* srcp, int has_src, int seed, const void* pos,
                     const void* dir, const void* e, void* npos, void* ndir,
                     void* ne, void* sid, void* absorbed, int nb,
                     float t_eps, int bivar_mode, int one_sided, int slope,
                     void* stream) {
  (void)S;
  CulledArgs a;
  a.rows = static_cast<const float*>(rows);
  a.K = K;
  a.C = (K - ROW_AP) / 6;
  a.lists = static_cast<const int*>(lists);
  a.W = W;
  a.counts = static_cast<const int*>(counts);
  a.G = G;
  a.gmeta = static_cast<const int*>(gmeta);
  a.cells = static_cast<const int*>(cells);
  a.cell_bounds = static_cast<const float*>(cell_bounds);
  a.remaining = static_cast<const int*>(remaining);
  a.active = static_cast<const int*>(active);
  a.srcp = static_cast<const float*>(srcp);
  a.has_src = has_src;
  a.seed = (uint32_t)seed;
  a.pos = static_cast<const float*>(pos);
  a.dir = static_cast<const float*>(dir);
  a.e = static_cast<const float*>(e);
  a.npos = static_cast<float*>(npos);
  a.ndir = static_cast<float*>(ndir);
  a.ne = static_cast<float*>(ne);
  a.sid = static_cast<int*>(sid);
  a.absorbed = static_cast<float*>(absorbed);
  a.t_eps = t_eps;
  a.bivar_mode = bivar_mode;
  a.one_sided = one_sided;
  a.slope = slope;
  const size_t smem = (size_t)W * K * sizeof(float) + (size_t)W * sizeof(int);
  cudaError_t err = allow_smem(bounce_culled_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (nb > 0)
    bounce_culled_kernel<<<nb, K1_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int tt_bounce(const void* rows, int S, int K, int G, const void* gmeta,
              int max_c, int seed, const void* pos, const void* dir,
              const void* e, const void* wl, void* npos, void* ndir,
              void* ne, void* nwl, void* sid, void* absorbed, int n,
              float t_eps, float disc_eps, int regen, const void* srcp,
              const void* pose, const void* tab, int n_tab, int bivar_mode,
              int one_sided, int slope, int lambertian, float ambient_att,
              void* stream) {
  const int C = (K - ROW_AP) / 6;
  if (max_c != MAX_C || C > MAX_C || (wl == nullptr) != (nwl == nullptr) ||
      (wl != nullptr && n_tab < 1) || (regen && (!srcp || !pose)))
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
  a.wl = static_cast<const float*>(wl);
  a.npos = static_cast<float*>(npos);
  a.ndir = static_cast<float*>(ndir);
  a.ne = static_cast<float*>(ne);
  a.nwl = static_cast<float*>(nwl);
  a.sid = static_cast<int*>(sid);
  a.absorbed = static_cast<float*>(absorbed);
  a.n = n;
  a.t_eps = t_eps;
  a.disc_eps = disc_eps;
  a.regen = regen;
  a.srcp = static_cast<const float*>(srcp);
  a.pose = static_cast<const float*>(pose);
  a.tab = static_cast<const float*>(tab);
  a.n_tab = wl != nullptr ? n_tab : 0;
  a.bivar_mode = bivar_mode;
  a.one_sided = one_sided;
  a.slope = slope;
  a.lambertian = lambertian;
  a.ambient_att = ambient_att;
  const size_t smem =
      ((size_t)S * K + 2 * (size_t)a.n_tab + POSE_FLOATS) * sizeof(float);
  cudaError_t err = allow_smem(bounce_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n + K2_THREADS - 1) / K2_THREADS;
  if (blocks > 0)
    bounce_kernel<<<blocks, K2_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* tt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
