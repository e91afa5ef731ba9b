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
// kinds), each row in ascending order folds into the running winner
// (rows.cuh, shared with K1 and K2). Outputs: t (+inf on a miss), sid (-1 on a
// miss), the winner's unnormalised global gradient (R e_z for flat rows),
// local hit point, local d_z, optics kind and flags, and its first two
// optics params.
//
// What bounds it on this card: each lane reads 24 bytes of ray and writes
// 52 bytes of results; on the MiniDish (6 rows) the arithmetic is about
// 300 float32 operations a lane, so at millions of lanes the kernel is
// bound by device-memory bytes, not by operations. The design keeps
// everything else off device memory: one thread per lane holds its ray
// and the running winner in registers, and the block stages the rows
// into shared memory in chunks (any number of rows, no shared-memory
// wall), where every thread of a warp reads the same row word as one
// broadcast. Group metadata is uniform across the block, so the class and
// aperture switches never diverge. Compiled without fast math, like the
// plain PyTorch version (kernels/nearest.py) it is held against; the two
// differ only by FMA contraction.
#include "rows.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int STAGE_FLOATS = 12 * 1024;   // 48 KB of staged rows

struct Args {
  const float* rows;
  int S, K, C, G;
  const int* gmeta;  // (G, meta_w): first row, end row, class, kinds[C..]
  int meta_w;
  const float *pos, *dir;
  float *t, *normal, *local, *up, *p0, *p1;
  int *sid, *kind, *flags;
  long long n;
  float t_eps, disc_eps;
  int need_local, backside_miss;
};

__global__ void __launch_bounds__(THREADS) nearest_kernel(Args a) {
  __shared__ float sm[STAGE_FLOATS];
  const long long l = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool valid = l < a.n;
  Ray q;
  // lanes past n trace a dummy ray and store nothing; they still help
  // stage rows, so every thread reaches every barrier
  q.px = valid ? a.pos[3 * l] : 1.0f;
  q.py = valid ? a.pos[3 * l + 1] : 1.0f;
  q.pz = valid ? a.pos[3 * l + 2] : 1.0f;
  q.dx = valid ? a.dir[3 * l] : 1.0f;
  q.dy = valid ? a.dir[3 * l + 1] : 1.0f;
  q.dz = valid ? a.dir[3 * l + 2] : 1.0f;
  Best b;
  best_init(b);
  const int chunk = STAGE_FLOATS / a.K;   // rows per staged chunk
  const bool bmiss_on = a.backside_miss != 0;
  for (int g = 0; g < a.G; ++g) {
    const int* m = a.gmeta + g * a.meta_w;
    const int first = m[0], end = m[1], cls = m[2];
    int kinds[MAX_C];
    group_kinds(m, a.C, kinds);
    const int rect_mask = rect_mask_of(m, a.C);
    for (int c0 = first; c0 < end; c0 += chunk) {
      const int count = min(chunk, end - c0);
      __syncthreads();  // the previous chunk is no longer read
      const float* src = a.rows + (size_t)c0 * a.K;
      for (int i = threadIdx.x; i < count * a.K; i += THREADS) sm[i] = src[i];
      __syncthreads();
      scan_group(cls, sm, c0, count, a.K, kinds, rect_mask, a.C, q,
                 a.t_eps, a.disc_eps, bmiss_on, b);
    }
  }
  if (!valid) return;
  const int kfi = static_cast<int>(b.kf);
  a.t[l] = b.t;
  a.sid[l] = b.sid;
  a.normal[3 * l] = b.gx;
  a.normal[3 * l + 1] = b.gy;
  a.normal[3 * l + 2] = b.gz;
  if (a.need_local) {
    a.local[3 * l] = b.lx;
    a.local[3 * l + 1] = b.ly;
    a.local[3 * l + 2] = b.lz;
  }
  a.up[l] = b.up;
  a.kind[l] = kfi / 1024;
  a.flags[l] = kfi % 1024;
  a.p0[l] = b.p0;
  a.p1[l] = b.p1;
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
  if (max_c != MAX_C || C > MAX_C || K > STAGE_FLOATS)
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
  a.backside_miss = backside_miss;
  const int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0)
    nearest_kernel<<<blocks, THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
