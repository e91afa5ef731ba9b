// The K3 epilogue on Hopper (sm_90a): everything trace_fused does in a
// bounce after K3 (nearest.cu), in one pass over the lanes.
//
// It replaces no TPU kernel: tracer_tpu shades K3's winners with jnp code
// that XLA fuses (tracer_tpu/engine.py:933, kernels/shade.py), which the
// port first ran as plain PyTorch (kernels/shade.py, engine._bounce_step,
// engine._account, analysis/device_fluxmap.accumulate): some eighty
// launches a bounce, each a full pass over the lanes. Per lane, here:
//
// - a lane that enters dead reads its alive flag (and its energy when the
//   flag is set) and, on the call's later bounces, writes nothing;
// - a live lane reads K3's distance, row, unnormalised normal and local
//   d_z, and its ray; the winner's row comes from the packed table in
//   device memory (every lane of a warp reads a few rows, which stay in
//   L1) and is shaded by shade<> (shade.cuh), the shading arithmetic of
//   K1 and K2, drawing from K2's Philox stream (key (seed, lane / TILE),
//   counter (lane % TILE, call));
// - it writes the next ray state: pos, dir, energy (0 at or below
//   min_energy), alive, and on refractive scenes the index and the medium
//   triple (zero after a crossing: the scenes this kernel takes have no
//   media, so both sides' coefficients are 0);
// - it adds its absorbed energy and one hit to its row, its energy to
//   `escaped` on a miss, the energy the min_energy cut drops to `culled`,
//   and its absorbed energy to the bin of every flux histogram whose
//   surface holds its row (device_fluxmap's (u, v) projections, the
//   row's inverse frame, the top edges inclusive, rounded like the plain
//   path's separate multiplies and adds, so a lane lands in the same bin).
//
// The sums: a warp's lanes with one row meet in one add (a match of their
// rows, the lowest such lane summing the others' values from shared
// memory) into the warp's own bins of the row; escaped and culled stay
// in registers; at the end the warps' bins are summed in warp order and
// escaped and culled in a tree, so the per-row and scalar sums come out
// the same in every run. Flux bins take each lane's atomic add in the
// block's shared memory. The block then adds its sums to its own row of
// the partial table (blocks, W), which the host sums once a call in
// float64. A float32 bin so takes a few hundred adds a bounce, not
// millions. The lane's first pass writes the call's
// own buffers (dead lanes then copy their state); later bounces update
// them in place, each thread reading its lane before writing it.
//
// What bounds it on this card: bytes. A live lane reads 53 bytes (K3's
// t, sid, normal and d_z; pos, dir, energy and the alive flag) and writes
// 29, a dead one reads 1; its arithmetic is the shade's, a few hundred
// float32 operations at most. So the design keeps every lane to one read
// and one write of each value, one thread a lane, neighbouring threads on
// neighbouring lanes, and its sums in shared memory and registers.
#include <stdint.h>

#include "rows.cuh"
#include "shade.cuh"

namespace {

constexpr int EPI_THREADS = 256;
constexpr int EPI_WARPS = EPI_THREADS / 32;
constexpr int EPI_BLOCKS = 2048;   // most blocks a launch: partial rows
constexpr int EPI_TILE = 3072;     // lanes a Philox stream (K2's TILE)

// the (u, v) projection of a flux histogram (device_fluxmap._uv)
enum { UV_CARTESIAN = 0, UV_POLAR = 1, UV_AXIAL = 2, UV_SPHERICAL = 3 };

struct EpiArgs {
  const float* rows;  // (S, K) packed rows (kernels/rows.py pack_rows)
  int S, K;
  // K3's results
  const float *t, *normal, *up;
  const int* sid;
  // the ray in; wl, or with kRefr ri and the medium triple, may be null
  const float *pos, *dir, *e, *wl, *ri, *att, *scat, *g;
  const uint8_t* alive;
  // the ray out (the inputs themselves after the call's first bounce)
  float *npos, *ndir, *ne, *nri, *natt, *nscat, *ng;
  uint8_t* nalive;
  int fresh;          // the outputs are not the inputs
  long long n;
  uint32_t seed;
  float min_energy;
  const float* tab;   // (n_tab, 2) spectral table, or null
  int n_tab;
  Modes m;
  int n_specs;
  const int* spec_i;    // (n_specs, 4) uv kind, nu, nv, first bin
  const float* spec_f;  // (n_specs, 5) u0, nu / (u1 - u0), v0, nv / ..., p0
  const int* member;    // (n_specs, S) 1 where the row bins into the spec
  int W;                // a block's sums: S absorbed, S hits, escaped,
                        // culled, then every spec's bins
  float* partial;       // (blocks, W): each block adds its sums to its row
};

// the bin of u on an axis of nb bins from u0 at `scale` bins a unit, or -1
// (device_fluxmap.accumulate: non-finite -> -1, clamp to [-1, nb], floor,
// the top edge inside)
__device__ __forceinline__ int bin_of(float u, float u0, float scale,
                                      int nb) {
  float s = __fmul_rn(__fsub_rn(u, u0), scale);
  if (!isfinite(s)) s = -1.0f;
  const float top = (float)nb;
  const float c = s < -1.0f ? -1.0f : (s > top ? top : s);
  int i = (int)floorf(c);
  if (i == nb && s <= top) i = nb - 1;
  return i >= 0 && i < nb ? i : -1;
}

// a lane's (u, v) on the surface from its local hit point
__device__ __forceinline__ void uv_of(int kind, float p0, float x, float y,
                                      float z, float& u, float& v) {
  if (kind == UV_CARTESIAN) {
    u = x;
    v = y;
    return;
  }
  float th = atan2f(y, x);
  if (th < 0.0f) th = __fadd_rn(th, TWO_PI);
  v = th;
  if (kind == UV_POLAR) {
    u = hypotf(x, y);
  } else if (kind == UV_AXIAL) {
    u = z;
  } else {
    // comparisons, not fminf / fmaxf, so a NaN stays one as in torch.clamp
    const float q = __fdiv_rn(z, p0);
    u = acosf(q < -1.0f ? -1.0f : (q > 1.0f ? 1.0f : q));
  }
}

// add the lane's absorbed energy to each histogram that bins its row s:
// the hit point pos + t dir and its local point under the row's inverse
// frame (the packed row's first 12 floats) rounded as the plain path's
// separate operations
__device__ __forceinline__ void bin_flux(const EpiArgs& a, float* bins,
                                         const float* w, int s,
                                         const Lane& in, float t,
                                         float val) {
  const float hx = __fadd_rn(in.px, __fmul_rn(t, in.dx));
  const float hy = __fadd_rn(in.py, __fmul_rn(t, in.dy));
  const float hz = __fadd_rn(in.pz, __fmul_rn(t, in.dz));
  float loc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    loc[i] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(w[3 * i], hx),
                            __fmul_rn(w[3 * i + 1], hy)),
                  __fmul_rn(w[3 * i + 2], hz)),
        w[9 + i]);
  for (int k = 0; k < a.n_specs; ++k) {
    if (!a.member[k * a.S + s]) continue;
    const int* si = a.spec_i + 4 * k;
    const float* sf = a.spec_f + 5 * k;
    float u, v;
    uv_of(si[0], sf[4], loc[0], loc[1], loc[2], u, v);
    const int iu = bin_of(u, sf[0], sf[1], si[1]);
    const int iv = bin_of(v, sf[2], sf[3], si[2]);
    if (iu >= 0 && iv >= 0) atomicAdd(bins + si[3] + iu * si[2] + iv, val);
  }
}

// one lane l: shade it, write its next state, and add its escaped and
// culled energy to the thread's sums and its histograms' bins; returns
// its row (-1: no hit) and its absorbed energy in key and val
template <bool kRefr, bool kExtra>
__device__ __forceinline__ void epi_lane(const EpiArgs& a, long long l,
                                         const Epi& ep, float* bins,
                                         int& key, float& val, float& esc,
                                         float& cul) {
  const bool flag = a.alive[l] != 0;
  const float e = flag ? a.e[l] : 0.0f;
  const bool live = flag && e > 0.0f;
  if (!live && !a.fresh) {
    // in place: a dead lane's state is already its last; a lane alive
    // without energy dies
    if (flag) {
      a.ne[l] = 0.0f;
      a.nalive[l] = 0;
    }
    return;
  }
  Lane in;
  in.px = a.pos[3 * l];
  in.py = a.pos[3 * l + 1];
  in.pz = a.pos[3 * l + 2];
  in.dx = a.dir[3 * l];
  in.dy = a.dir[3 * l + 1];
  in.dz = a.dir[3 * l + 2];
  in.e = e;
  const float ri = kRefr ? a.ri[l] : 1.0f;
  const int s = live ? a.sid[l] : -1;
  float ox = in.px, oy = in.py, oz = in.pz, odx = in.dx, ody = in.dy,
        odz = in.dz, ori = ri, e_next = 0.0f;
  bool alive_next = false, crossed = false;
  if (s >= 0) {
    const float* w = a.rows + (size_t)s * a.K;
    const float t = a.t[l];
    const float gx = a.normal[3 * l], gy = a.normal[3 * l + 1],
                gz = a.normal[3 * l + 2];
    const float wl = a.wl != nullptr ? a.wl[l] : 0.0f;
    const Shaded o = shade<kRefr, false, false, kExtra>(
        w, s, gx, gy, gz, a.up[l], t, in, wl, ri, 0.0f, a.seed,
        (uint32_t)(l / EPI_TILE), (uint32_t)(l % EPI_TILE), ep);
    ox = o.px;
    oy = o.py;
    oz = o.pz;
    odx = o.dx;
    ody = o.dy;
    odz = o.dz;
    alive_next = !(o.e <= a.min_energy);
    if (alive_next)
      e_next = o.e;
    else
      cul += o.e;
    key = s;
    val = o.absorbed;
    if (kRefr && floorf(w[ROW_KIND] * (1.0f / 1024.0f)) == 6.0f) {
      // a refractive row: the lane crossed where it took the other
      // side's index, or on an index-matched row where it kept going
      // the way it came
      const float q0 = w[ROW_P0], q1 = w[ROW_P0 + 1];
      crossed = q0 != q1 ? o.ri != ri
                         : ((odx * gx + ody * gy + odz * gz) > 0.0f) ==
                               ((in.dx * gx + in.dy * gy + in.dz * gz) >
                                0.0f);
      ori = o.ri;
    }
    if (val != 0.0f && a.n_specs > 0) bin_flux(a, bins, w, s, in, t, val);
  } else if (live) {
    esc += e;
  }
  if (s >= 0 || a.fresh) {
    a.npos[3 * l] = ox;
    a.npos[3 * l + 1] = oy;
    a.npos[3 * l + 2] = oz;
    a.ndir[3 * l] = odx;
    a.ndir[3 * l + 1] = ody;
    a.ndir[3 * l + 2] = odz;
    if (kRefr) a.nri[l] = ori;
  }
  if (kRefr && (crossed || a.fresh)) {
    a.natt[l] = crossed ? 0.0f : a.att[l];
    a.nscat[l] = crossed ? 0.0f : a.scat[l];
    a.ng[l] = crossed ? 0.0f : a.g[l];
  }
  a.ne[l] = e_next;
  a.nalive[l] = alive_next;
}

// a warp's lanes with one row add their absorbed energies and their count
// to the warp's own bins of the row in one add: `stage` holds the warp's
// 32 values, the lowest lane of each row sums them in lane order. No
// other warp writes these bins and no two lanes of one warp write the
// same one, so the sums are the same in every run
__device__ __forceinline__ void add_rows(float* wrows, int S, int key,
                                         float val, float* stage) {
  const int lane = threadIdx.x & 31;
  stage[lane] = val;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  __syncwarp();
  if (key >= 0 && lane == __ffs(peers) - 1) {
    float sum = 0.0f;
    for (unsigned p = peers; p != 0u; p &= p - 1u)
      sum += stage[__ffs(p) - 1];
    wrows[key] += sum;
    wrows[S + key] += (float)__popc(peers);
  }
  __syncwarp();
}

// the sum over a block's threads of one value each, in a fixed tree
__device__ __forceinline__ float block_sum(float v, float* stage) {
  const int tid = threadIdx.x;
  stage[tid] = v;
  __syncthreads();
  for (int h = EPI_THREADS / 2; h > 0; h >>= 1) {
    if (tid < h) stage[tid] += stage[tid + h];
    __syncthreads();
  }
  const float sum = stage[0];
  __syncthreads();
  return sum;
}

// the epilogue: blocks of EPI_THREADS, one lane a thread, each block
// walking chunks c = blockIdx.x, + gridDim.x, ... Shared memory: the
// block's W sums (the flux bins taking atomic adds), each warp's row
// bins, a staging float a thread. At the end the rows' bins are summed
// warp by warp, escaped and culled in a tree, and the block adds its sums
// to its row of the partial table
template <bool kRefr, bool kExtra>
__global__ void __launch_bounds__(EPI_THREADS)
    epilogue_kernel(EpiArgs a) {
  extern __shared__ float4 epi_smem[];
  float* bins = reinterpret_cast<float*>(epi_smem);
  float* wrows = bins + a.W;
  float* stage = wrows + EPI_WARPS * 2 * a.S;
  const int tid = threadIdx.x;
  for (int i = tid; i < a.W + EPI_WARPS * 2 * a.S; i += EPI_THREADS)
    bins[i] = 0.0f;
  __syncthreads();
  const Modes& m = a.m;
  const Epi ep = {m.bivar_mode, m.one_sided, m.slope, m.lambertian,
                  a.n_tab ? a.tab : nullptr, m.ambient_att, m.ambient_scat,
                  m.ambient_g, m.refr_frost, m.refr_disp, nullptr, nullptr,
                  a.wl != nullptr, m.cook_torrance, m.lam_specular,
                  m.semi_lambertian, m.transparent, m.conductor, m.periodic,
                  m.piecewise, m.iam_c};
  float esc = 0.0f, cul = 0.0f;
  float* my_rows = wrows + (tid >> 5) * 2 * a.S;
  const long long chunks = (a.n + EPI_THREADS - 1) / EPI_THREADS;
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const long long l = c * EPI_THREADS + tid;
    int key = -1;
    float val = 0.0f;
    if (l < a.n)
      epi_lane<kRefr, kExtra>(a, l, ep, bins, key, val, esc, cul);
    add_rows(my_rows, a.S, key, val, stage + (tid & ~31));
  }
  __syncthreads();
  for (int i = tid; i < 2 * a.S; i += EPI_THREADS) {
    float sum = 0.0f;
    for (int w = 0; w < EPI_WARPS; ++w) sum += wrows[w * 2 * a.S + i];
    bins[i] = sum;
  }
  esc = block_sum(esc, stage);
  cul = block_sum(cul, stage);
  if (tid == 0) {
    bins[2 * a.S] = esc;
    bins[2 * a.S + 1] = cul;
  }
  __syncthreads();
  float* out = a.partial + (size_t)blockIdx.x * a.W;
  for (int i = tid; i < a.W; i += EPI_THREADS) out[i] += bins[i];
}

// the epilogue's launch geometry for n lanes, S rows and W sums a block:
// blocks (at most EPI_BLOCKS, one partial row each), threads a block,
// bytes of shared memory a block
void epi_geometry(long long n, int S, int W, int* blocks, int* threads,
                  int* smem) {
  const long long chunks = (n + EPI_THREADS - 1) / EPI_THREADS;
  *blocks = (int)(chunks < EPI_BLOCKS ? chunks : EPI_BLOCKS);
  *threads = EPI_THREADS;
  *smem = (W + EPI_WARPS * 2 * S + EPI_THREADS) * (int)sizeof(float);
}

using EpiKernel = void (*)(EpiArgs);

}  // namespace

extern "C" {

// one epilogue launch (every pointer a device pointer; the optional ones
// null: wl without wavelength-reading rows, ri and the triple and their
// outputs without refractive rows, tab without a spectral table); blocks
// must be tt_epilogue_geometry's, the partial table (blocks, W)
int tt_epilogue(const void* rows, int S, int K, const void* t,
                const void* sid, const void* normal, const void* up,
                const void* pos, const void* dir, const void* e,
                const void* alive, const void* wl, const void* ri,
                const void* att, const void* scat, const void* g,
                void* npos, void* ndir, void* ne, void* nalive, void* nri,
                void* natt, void* nscat, void* ng, long long n, int seed,
                float min_energy, const void* tab, int n_tab,
                const void* modes, int n_specs, const void* spec_i,
                const void* spec_f, const void* member, int W,
                void* partial, int blocks, void* stream) {
  if (modes == nullptr) return (int)cudaErrorInvalidValue;
  const Modes& m = *static_cast<const Modes*>(modes);
  const bool refr = ri != nullptr;
  const bool extra = m.cook_torrance || m.lam_specular ||
                     m.semi_lambertian || m.transparent || m.conductor ||
                     m.periodic || m.piecewise || m.iam_c != 0.0f;
  int want, threads, smem;
  epi_geometry(n, S, W, &want, &threads, &smem);
  // media, dispersion and splitting are not this kernel's: the engine
  // keeps such scenes on the plain path
  if (blocks != want || W < 2 * S + 2 || m.scat || m.refr_disp ||
      m.refr_split || m.ambient_att != 0.0f ||
      (refr && (!att || !scat || !g || !nri || !natt || !nscat || !ng)) ||
      (!refr && (nri || natt || nscat || ng)) ||
      ((m.conductor || m.piecewise) && n_tab < 1) ||
      (n_tab > 0 && tab == nullptr) ||
      (n_specs > 0 && (!spec_i || !spec_f || !member)))
    return (int)cudaErrorInvalidValue;
  EpiArgs a;
  a.rows = static_cast<const float*>(rows);
  a.S = S;
  a.K = K;
  a.t = static_cast<const float*>(t);
  a.normal = static_cast<const float*>(normal);
  a.up = static_cast<const float*>(up);
  a.sid = static_cast<const int*>(sid);
  a.pos = static_cast<const float*>(pos);
  a.dir = static_cast<const float*>(dir);
  a.e = static_cast<const float*>(e);
  a.wl = static_cast<const float*>(wl);
  a.ri = static_cast<const float*>(ri);
  a.att = static_cast<const float*>(att);
  a.scat = static_cast<const float*>(scat);
  a.g = static_cast<const float*>(g);
  a.alive = static_cast<const uint8_t*>(alive);
  a.npos = static_cast<float*>(npos);
  a.ndir = static_cast<float*>(ndir);
  a.ne = static_cast<float*>(ne);
  a.nri = static_cast<float*>(nri);
  a.natt = static_cast<float*>(natt);
  a.nscat = static_cast<float*>(nscat);
  a.ng = static_cast<float*>(ng);
  a.nalive = static_cast<uint8_t*>(nalive);
  a.fresh = npos != pos;
  a.n = n;
  a.seed = (uint32_t)seed;
  a.min_energy = min_energy;
  a.tab = static_cast<const float*>(tab);
  a.n_tab = n_tab;
  a.m = m;
  a.n_specs = n_specs;
  a.spec_i = static_cast<const int*>(spec_i);
  a.spec_f = static_cast<const float*>(spec_f);
  a.member = static_cast<const int*>(member);
  a.W = W;
  a.partial = static_cast<float*>(partial);
  const EpiKernel kernel =
      refr ? (extra ? epilogue_kernel<true, true>
                    : epilogue_kernel<true, false>)
           : (extra ? epilogue_kernel<false, true>
                    : epilogue_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (blocks > 0)
    kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// the epilogue's launch geometry for n lanes, S rows and W sums a block:
// out[0] blocks, out[1] threads a block, out[2] bytes of shared memory a
// block
int tt_epilogue_geometry(long long n, int S, int W, int* out) {
  if (out == nullptr || n < 0 || S < 0 || W < 2 * S + 2)
    return (int)cudaErrorInvalidValue;
  epi_geometry(n, S, W, out, out + 1, out + 2);
  return (int)cudaSuccess;
}

}  // extern "C"
