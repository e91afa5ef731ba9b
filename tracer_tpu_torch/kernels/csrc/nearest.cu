// K3: nearest hit over every row of a compiled scene, with the winner's
// shading data, on Hopper (sm_90a).
//
// Replaces the TPU kernel nearest_hit_pallas
// (tracer_tpu/kernels/pallas_intersect.py:583, group kernel _make_kernel
// :556, per-row body _surface_body :232, apertures _ap_ok_static :92). The
// TPU version makes one pallas_call per aperture-signature group and
// carries the running minimum between calls through aliased buffers; here
// one launch walks every group, so the ray state is read once and the
// results are written once.
//
// Per lane: for each group (first row, end row, quadric class, aperture
// kinds), each row in ascending order folds into the running winner with
// a strict `<`, so ties keep the earlier row (rows.cuh, shared with K1 and
// K2). Outputs: t (+inf on a miss), sid (-1 on a miss), the winner's
// unnormalised global gradient (R e_z for flat rows), local hit point
// (zeros without need_local), local d_z, optics kind and flags, and its
// first two optics params. Lanes at or past n store nothing.
//
// What bounds it on this card: each lane reads 24 bytes of ray and writes
// 52 bytes of results. On the MiniDish (6 rows) a lane's arithmetic is
// about 600 float32 operations, so at millions of lanes the kernel is
// bound by device-memory bytes; on tables of hundreds of rows (NSTTF's
// 219) by its float32 operations. The design (k3_variants.py measured each
// lever against the others, PERF.md):
//
// - Persistent blocks of K3_THREADS threads, one lane a thread, as many as
//   the SMs keep resident (the occupancy calculator, with the block's
//   shared memory), each walking chunks of K3_THREADS lanes in a grid
//   stride. A table of up to K3_TABLE_FLOATS floats is staged once a
//   block, rows padded to whole 16-byte words (k3_stride), so a row's
//   coefficients come out of shared memory 16 bytes at a time; the shared
//   memory is sized to the table. A larger table streams through two
//   buffers of half that: part p + 1 arrives by cp.async while part p is
//   tested, and the lanes keep their rays and winners in registers across
//   the parts, so rows are still met in ascending order. It is streamed
//   again for every chunk, so there a block takes one chunk and the card's
//   scheduler balances the blocks.
// - Each warp stages its own lanes' rays by 16-byte cp.async into its
//   shared memory while it traces the chunk before (two buffers); only
//   the warp waits for them, so on a table staged whole no block barrier
//   follows the table's. The results leave from registers, each lane's
//   stores of a warp meeting in whole lines (16-byte stores through
//   shared memory measured slower).
// - The row tests are K2's (rows.cuh scan_groups, row_t_local): curved
//   rows solve the general quadratic in a branch of their own, a flat
//   group whose only aperture is one rect takes FLAT_RECT1, rows with one
//   aperture slot are scanned with the slot count a constant (kC1).
// - In the row loop a lane keeps only its winner's distance, row and
//   group (Near); the winner's data are made once after the scan from its
//   row and that distance by its class's arithmetic (row_aux, k3_aux), so
//   they are the row test's, bit for bit, and the loop runs at 52-56
//   registers, one block of 1024 a SM (two lanes a thread, each staged
//   row read once for both, and the whole winner kept row by row as K2
//   does, measured slower).
// - backside_miss and the one-slot rows are template flags; need_local is
//   a run-time switch (the local point costs a lane two or three
//   operations once) and without it the kernel writes the zeros itself,
//   so a call is one launch.
//
// No tensor cores: the row transform is a contraction of depth 3 where
// wgmma needs at least 8 (TF32), and TF32's 10-bit mantissa would move hit
// points by about 1e-3 relative, beyond the comparisons' 1e-5 and the
// 3e-4 self-hit guard. Compiled without fast math, like the plain PyTorch
// version (kernels/nearest.py) it is held against; the two differ only by
// FMA contraction.
#include <cuda_pipeline_primitives.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

// threads (lanes) a block, and the blocks that __launch_bounds__ asks to
// keep resident on one SM: the most at which ptxas keeps every value in
// registers (64 a thread)
constexpr int K3_THREADS = 1024;
constexpr int K3_MIN_BLOCKS = 1;
// floats of rows a block stages: a table up to this many (at k3_stride)
// whole, a larger one in two buffers of half as many
constexpr int K3_TABLE_FLOATS = 12 * 1024;
// floats of a warp's 32 lanes' rays (pos, then dir): each warp stages two
// such buffers
constexpr int RAY_SEG = 6 * 32;

// the float stride of K3's staged rows: whole 16-byte words
__host__ __device__ __forceinline__ int k3_stride(int K) {
  return (K + 3) & ~3;
}

struct Args {
  const float* rows;
  int S, K, C, G;
  const int* gmeta;  // (G, meta_w): first row, end row, class, kinds[C..]
  int meta_w;
  const float *pos, *dir;
  float *t, *normal, *local, *up, *p0, *p1;
  int *sid, *kind, *flags;
  int n;
  float t_eps, disc_eps;
  int need_local;
  int Kp;    // the staged rows' stride (k3_stride)
  int part;  // rows a streamed buffer holds; S when the table is staged whole
};

// K3's lane state: its ray q and the distance, row and group of its winner
// so far (the winner's aux are made after the scan, k3_aux)
struct Near {
  const Ray& q;
  float t, t_in;
  int sid, grp;
  __device__ __forceinline__ void enter(int) { t_in = t; }
  // the group that lowered the distance holds the winner
  __device__ __forceinline__ void leave(int g) { grp = t < t_in ? g : grp; }
  template <int CLS>
  __device__ __forceinline__ void fold(const float* r, int s,
                                       const int* kinds, int rect_mask,
                                       int C, float t_eps, float disc_eps,
                                       bool bmiss_on) {
    const float th = row_t_local<CLS, true>(r, kinds, rect_mask, C,
                                            to_local(r, q), t_eps, disc_eps,
                                            bmiss_on);
    if (th < t) {
      t = th;
      sid = s;
    }
  }
};

// a lane's winner data from its winning row (in the stage when the table
// is staged whole, else in device memory) hit at distance t, by its
// group's class: the arithmetic of the row test that found it (row_aux),
// so the same aux bit for bit
__device__ __forceinline__ void k3_aux(const Args& a, const float* rows_sm,
                                       bool whole, const Near& w, Best& b) {
  best_init(b);
  if (w.sid < 0) return;
  const float* r =
      whole ? rows_sm + w.sid * a.Kp : a.rows + (size_t)w.sid * a.K;
  const Local v = to_local(r, w.q);
  switch (a.gmeta[w.grp * a.meta_w + 2]) {
    case FLAT:
      row_aux<FLAT>(r, w.sid, v, w.t, b);
      break;
    case PARAB:
      row_aux<PARAB>(r, w.sid, v, w.t, b);
      break;
    case SPHERE:
      row_aux<SPHERE>(r, w.sid, v, w.t, b);
      break;
    default:
      row_aux<QUADRIC>(r, w.sid, v, w.t, b);
      break;
  }
}

// n_fl floats from device memory into a warp's stage, 16 bytes a copy
// where whole (src and dst 16-byte aligned), by cp.async; lane: the
// thread's lane in its warp
__device__ __forceinline__ void warp_in(float* dst, const float* src,
                                        int n_fl, int lane) {
  const int words = n_fl >> 2;
  for (int i = lane; i < words; i += 32)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  for (int i = 4 * words + lane; i < n_fl; i += 32)
    __pipeline_memcpy_async(dst + i, src + i, 4);
}

// rows [r0, r0 + cnt) into the stage at k3_stride (the padding zeroed)
__device__ __forceinline__ void stage_rows(const Args& a, float* dst, int r0,
                                           int cnt) {
  for (int i = threadIdx.x; i < cnt * a.Kp; i += K3_THREADS) {
    const int s = i / a.Kp, k = i - s * a.Kp;
    if (k < a.K)
      __pipeline_memcpy_async(dst + i, a.rows + (size_t)(r0 + s) * a.K + k,
                              4);
    else
      dst[i] = 0.0f;
  }
}

// a warp's 32 lanes of chunk c, from lane `first` (those below n), into
// the warp's ray buffer buf
__device__ __forceinline__ void stage_rays(const Args& a, float* buf,
                                           int first, int lane) {
  const int count = max(0, min(32, a.n - first));
  warp_in(buf, a.pos + 3 * (size_t)first, 3 * count, lane);
  warp_in(buf + 96, a.dir + 3 * (size_t)first, 3 * count, lane);
}

// K3: blocks walking chunks of K3_THREADS lanes, c = blockIdx.x,
// + gridDim.x, ... Each warp stages its own lanes' rays, so on a table
// staged whole no block barrier follows the table's; a streamed table's
// parts are the block's, and every thread reaches every barrier
template <bool kC1, bool kBmiss>
__global__ void __launch_bounds__(K3_THREADS, K3_MIN_BLOCKS)
    nearest_kernel(Args a) {
  constexpr int T = K3_THREADS;
  extern __shared__ float4 smem4[];
  // each warp's two ray buffers, then the rows: the table, or two buffers
  // of a.part rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* rays_sm = reinterpret_cast<float*>(smem4);
  float* wrays = rays_sm + warp * 2 * RAY_SEG;
  float* rows_sm = rays_sm + 12 * T;
  const bool whole = a.part >= a.S;
  if (whole) {
    stage_rows(a, rows_sm, 0, a.S);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
  }
  const int chunks = (int)(((long long)a.n + T - 1) / T);
  int c = blockIdx.x;
  if (c < chunks) stage_rays(a, wrays, c * T + 32 * warp, lane);
  __pipeline_commit();
  for (int it = 0; c < chunks; c += gridDim.x, ++it) {
    // the next chunk's rays arrive while this one is traced
    if (c + (int)gridDim.x < chunks)
      stage_rays(a, wrays + RAY_SEG * ((it + 1) & 1),
                 (c + gridDim.x) * T + 32 * warp, lane);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncwarp();
    const float* pos = wrays + RAY_SEG * (it & 1) + 3 * lane;
    const float* dir = pos + 96;
    const Ray q = {pos[0], pos[1], pos[2], dir[0], dir[1], dir[2]};
    Near w = {q, INFINITY, INFINITY, -1, 0};
    if (whole) {
      scan_groups<kC1, false>(a.gmeta, a.G, a.meta_w, a.C, rows_sm, a.Kp, 0,
                              a.S, a.t_eps, a.disc_eps, kBmiss, w);
    } else {
      // part p + 1 arrives while part p is tested
      const int parts = (a.S + a.part - 1) / a.part;
      stage_rows(a, rows_sm, 0, a.part);
      __pipeline_commit();
      for (int p = 0; p < parts; ++p) {
        const int r0 = p * a.part, r1 = min(r0 + a.part, a.S);
        if (p + 1 < parts)
          stage_rows(a, rows_sm + a.part * a.Kp * ((p + 1) & 1), r1,
                     min(a.part, a.S - r1));
        __pipeline_commit();
        __pipeline_wait_prior(1);
        __syncthreads();
        scan_groups<kC1, true>(a.gmeta, a.G, a.meta_w, a.C,
                               rows_sm + a.part * a.Kp * (p & 1), a.Kp, r0,
                               r1, a.t_eps, a.disc_eps, kBmiss, w);
        // every lane is done with the buffer before part p + 2 lands in it
        __syncthreads();
      }
    }
    // every lane of the warp has its ray before the buffer is staged again
    __syncwarp();
    const int l = c * T + tid;
    if (l >= a.n) continue;
    Best b;
    k3_aux(a, rows_sm, whole, w, b);
    const int kfi = static_cast<int>(b.kf);
    a.t[l] = w.t;
    a.sid[l] = w.sid;
    a.normal[3 * (size_t)l] = b.gx;
    a.normal[3 * (size_t)l + 1] = b.gy;
    a.normal[3 * (size_t)l + 2] = b.gz;
    a.local[3 * (size_t)l] = a.need_local ? b.lx : 0.0f;
    a.local[3 * (size_t)l + 1] = a.need_local ? b.ly : 0.0f;
    a.local[3 * (size_t)l + 2] = a.need_local ? b.lz : 0.0f;
    a.up[l] = b.up;
    a.kind[l] = kfi / 1024;
    a.flags[l] = kfi % 1024;
    a.p0[l] = b.p0;
    a.p1[l] = b.p1;
  }
}

// K3's launch geometry: blocks, threads a block (a lane each), bytes of
// shared memory a block, blocks resident a SM (the occupancy calculator,
// registers and shared memory both counted), SMs, rows a staged part (S
// when the table is staged whole)
struct K3Geometry {
  int blocks, threads, smem, resident, sms, part;
};

// one launch of a K3 instance: on a table staged whole as many blocks as
// the card keeps resident (fewer when there are fewer chunks), each
// walking its chunks; on a streamed table a block a chunk
template <bool kC1, bool kBmiss>
int launch_k3(const Args& a, cudaStream_t st, K3Geometry* geo) {
  auto kernel = nearest_kernel<kC1, kBmiss>;
  const size_t rows_fl = a.part >= a.S ? (size_t)a.S * a.Kp
                                       : 2 * (size_t)a.part * a.Kp;
  const size_t smem = (12 * (size_t)K3_THREADS + rows_fl) * sizeof(float);
  // the occupancy of this instance, asked again only when the stage grows
  // or shrinks
  static size_t known_smem = (size_t)-1;
  static int resident = 0;
  if (smem != known_smem) {
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        K3_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    known_smem = smem;
  }
  const int sms = sm_count();
  if (resident < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const int chunks = (int)(((long long)a.n + K3_THREADS - 1) / K3_THREADS);
  const int blocks =
      a.part >= a.S && chunks > sms * resident ? sms * resident : chunks;
  if (geo != nullptr) {
    *geo = {blocks, K3_THREADS, (int)smem, resident, sms, a.part};
    return (int)cudaSuccess;
  }
  if (blocks > 0) kernel<<<blocks, K3_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

using LaunchK3 = int (*)(const Args&, cudaStream_t, K3Geometry*);

// the instance for rows of C aperture slots, with or without backside_miss
LaunchK3 pick_k3(int C, bool bmiss) {
  if (C == 1) return bmiss ? launch_k3<true, true> : launch_k3<true, false>;
  return bmiss ? launch_k3<false, true> : launch_k3<false, false>;
}

// the table's stage: its stride, and the rows of a streamed part (S when
// the padded table fits K3_TABLE_FLOATS)
void table_stage(Args& a) {
  a.Kp = k3_stride(a.K);
  a.part = (size_t)a.S * a.Kp <= (size_t)K3_TABLE_FLOATS
               ? a.S
               : K3_TABLE_FLOATS / 2 / a.Kp;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

int tt_nearest(const void* rows, int S, int K, int G, const void* gmeta,
               int max_c, const void* pos, const void* dir, void* t,
               void* sid, void* normal, void* local, void* up, void* kind,
               void* flags, void* p0, void* p1, int n, float t_eps,
               float disc_eps, int need_local, int backside_miss,
               void* stream) {
  const int C = (K - ROW_AP) / 6;
  // the rays come in 16 bytes at a time
  if (!aligned16(pos) || !aligned16(dir) || max_c != MAX_C || C > MAX_C)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.rows = static_cast<const float*>(rows);
  a.S = S;
  a.K = K;
  a.C = C;
  a.G = G;
  a.gmeta = static_cast<const int*>(gmeta);
  a.meta_w = 3 + max_c;
  a.pos = static_cast<const float*>(pos);
  a.dir = static_cast<const float*>(dir);
  a.t = static_cast<float*>(t);
  a.sid = static_cast<int*>(sid);
  a.normal = static_cast<float*>(normal);
  a.local = static_cast<float*>(local);
  a.up = static_cast<float*>(up);
  a.kind = static_cast<int*>(kind);
  a.flags = static_cast<int*>(flags);
  a.p0 = static_cast<float*>(p0);
  a.p1 = static_cast<float*>(p1);
  a.n = n;
  a.t_eps = t_eps;
  a.disc_eps = disc_eps;
  a.need_local = need_local;
  table_stage(a);
  return pick_k3(C, backside_miss != 0)(a, static_cast<cudaStream_t>(stream),
                                        nullptr);
}

// K3's launch geometry for n lanes on (S, K) rows (K3Geometry's fields
// into out[0..5])
int tt_k3_geometry(int S, int K, int backside_miss, int n, int* out) {
  const int C = (K - ROW_AP) / 6;
  if (out == nullptr || C > MAX_C) return (int)cudaErrorInvalidValue;
  Args a = {};
  a.S = S;
  a.K = K;
  a.C = C;
  a.n = n;
  table_stage(a);
  K3Geometry g;
  const int err = pick_k3(C, backside_miss != 0)(a, nullptr, &g);
  if (err != 0) return err;
  const int vals[] = {g.blocks, g.threads, g.smem, g.resident, g.sms, g.part};
  for (int i = 0; i < 6; ++i) out[i] = vals[i];
  return (int)cudaSuccess;
}

}  // extern "C"
