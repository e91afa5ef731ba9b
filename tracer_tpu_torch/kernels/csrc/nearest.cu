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
// kinds), for each row in ascending order, the hit distance of the
// group's class -- "flat" (t = -v_z/d_z, |d_z| > 1e-7, L1 self-hit guard
// t_eps (1 + |vx| + |vy| + |vz|)), "parab", "sphere" or "quadric" (stable
// q-formula, linear and B == 0 branches, disc >= disc_eps, L2 guard) --
// with every aperture kind of the signature, and F_BACKSIDE_MISS rows
// rejecting local +Z arrivals when backside_miss is on. The running
// minimum uses a strict `<`, so ties keep the earlier row. Outputs: t
// (+inf on a miss), sid (-1 on a miss), the winner's unnormalised global
// gradient (R e_z for flat rows), local hit point, local d_z, optics kind
// and flags, and its first two optics params.
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
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_C = 8;             // aperture slots (kernels/nearest.py)
constexpr int ROW_KIND = 22;
constexpr int ROW_P0 = 23;
constexpr int ROW_AP = 30;
constexpr int STAGE_FLOATS = 12 * 1024;   // 48 KB of staged rows
constexpr float TWO_PI = 6.283185307179586f;
constexpr float HEX_X = 0.8660254037844386f;   // sqrt(3) / 2
constexpr float HEX_T = 0.5773502691896257f;   // tan(pi / 6)

enum { FLAT = 0, PARAB = 1, SPHERE = 2, QUADRIC = 3 };

enum {
  AP_NONE = 0, AP_RECT = 1, AP_RADIAL = 2, AP_ZRANGE = 3, AP_ANGRANGE = 4,
  AP_XCUT = 5, AP_HEX = 6, AP_TRIANGLE = 7, AP_RECT_HOLE = 8,
  AP_CIRC_HOLE = 9, AP_CIRC = 10, AP_SPHERE = 11, AP_ABS_HALFPLANE = 12,
  AP_TRIANGLE_HOLE = 13
};

struct Ray {
  float px, py, pz, dx, dy, dz;
};

struct Best {
  float t;
  int sid;
  float gx, gy, gz, lx, ly, lz, up, kf, p0, p1;
};

// ANDed aperture predicates of the group's signature at local (x, y, z)
__device__ __forceinline__ bool ap_ok(const int* kinds, int C,
                                      const float* r, float x, float y,
                                      float z) {
  bool ok = true;
  for (int c = 0; c < C; ++c) {
    const float* p = r + ROW_AP + 6 * c;
    switch (kinds[c]) {
      case AP_RECT:
        ok = ok && fabsf(x) <= p[0] && fabsf(y) <= p[1];
        break;
      case AP_RADIAL: {
        const float r2 = x * x + y * y;
        ok = ok && r2 >= p[0] * p[0] && r2 <= p[1] * p[1];
        break;
      }
      case AP_ZRANGE:
        ok = ok && z >= p[0] && z <= p[1];
        break;
      case AP_ANGRANGE: {
        float ang = atan2f(y, x);
        if (ang < 0.0f) ang += TWO_PI;
        ok = ok && ang >= p[0] && ang <= p[1];
        break;
      }
      case AP_XCUT:
        ok = ok && x <= p[0];
        break;
      case AP_HEX:
        ok = ok && fabsf(x) <= HEX_X * p[0] &&
             fabsf(y) <= p[0] - HEX_T * fabsf(x);
        break;
      case AP_TRIANGLE:
      case AP_TRIANGLE_HOLE: {
        const float d1 = (p[2] - p[0]) * (y - p[1]) - (p[3] - p[1]) * (x - p[0]);
        const float d2 = (p[4] - p[2]) * (y - p[3]) - (p[5] - p[3]) * (x - p[2]);
        const float d3 = (p[0] - p[4]) * (y - p[5]) - (p[1] - p[5]) * (x - p[4]);
        const bool inside = !((d1 < 0.0f || d2 < 0.0f || d3 < 0.0f) &&
                              (d1 > 0.0f || d2 > 0.0f || d3 > 0.0f));
        ok = ok && (kinds[c] == AP_TRIANGLE ? inside : !inside);
        break;
      }
      case AP_RECT_HOLE:
        ok = ok && !(fabsf(x - p[0]) <= p[2] && fabsf(y - p[1]) <= p[3]);
        break;
      case AP_CIRC_HOLE: {
        const float ex = x - p[0], ey = y - p[1];
        ok = ok && ex * ex + ey * ey > p[2] * p[2];
        break;
      }
      case AP_CIRC: {
        const float ex = x - p[0], ey = y - p[1];
        ok = ok && ex * ex + ey * ey <= p[2] * p[2];
        break;
      }
      case AP_SPHERE: {
        const float ex = x - p[0], ey = y - p[1], ez = z - p[2];
        ok = ok && ex * ex + ey * ey + ez * ez <= p[3] * p[3];
        break;
      }
      case AP_ABS_HALFPLANE:
        ok = ok && fabsf(p[0] * x + p[1] * y) <= p[2];
        break;
      default:  // AP_NONE
        break;
    }
  }
  return ok;
}

// fold row s (packed row r, quadric class CLS) into the lane's winner
template <int CLS>
__device__ __forceinline__ void row_hit(const float* r, int s,
                                        const int* kinds, int C,
                                        const Ray& q, float t_eps,
                                        float disc_eps, bool bmiss_on,
                                        Best& b) {
  const float vx = r[0] * q.px + r[1] * q.py + r[2] * q.pz + r[9];
  const float vy = r[3] * q.px + r[4] * q.py + r[5] * q.pz + r[10];
  const float vz = r[6] * q.px + r[7] * q.py + r[8] * q.pz + r[11];
  const float ddx = r[0] * q.dx + r[1] * q.dy + r[2] * q.dz;
  const float ddy = r[3] * q.dx + r[4] * q.dy + r[5] * q.dz;
  const float ddz = r[6] * q.dx + r[7] * q.dy + r[8] * q.dz;
  float t_surf;
  if (CLS == FLAT) {
    const float t_hit = -vz / (ddz == 0.0f ? 1.0f : ddz);
    const float t_thr = t_eps * (1.0f + fabsf(vx) + fabsf(vy) + fabsf(vz));
    const bool ok = fabsf(ddz) > 1e-7f && t_hit > t_thr &&
                    ap_ok(kinds, C, r, vx + t_hit * ddx, vy + t_hit * ddy,
                          0.0f);
    t_surf = ok ? t_hit : INFINITY;
  } else {
    const float* qd = r + 12;
    const float axx = qd[0], ayy = qd[1], azz = qd[2], axy = qd[3],
                axz = qd[4], ayz = qd[5], bx = qd[6], by = qd[7],
                bz = qd[8], c0 = qd[9];
    float A, B, Cq;
    if (CLS == PARAB) {
      A = axx * ddx * ddx + ayy * ddy * ddy;
      B = 2.0f * (axx * ddx * vx + ayy * ddy * vy + bz * ddz);
      Cq = axx * vx * vx + ayy * vy * vy + 2.0f * bz * vz + c0;
    } else if (CLS == SPHERE) {
      A = axx * (ddx * ddx + ddy * ddy + ddz * ddz);
      B = 2.0f * axx * (ddx * vx + ddy * vy + ddz * vz);
      Cq = axx * (vx * vx + vy * vy + vz * vz) + c0;
    } else {
      A = axx * ddx * ddx + ayy * ddy * ddy + azz * ddz * ddz +
          2.0f * (axy * ddx * ddy + axz * ddx * ddz + ayz * ddy * ddz);
      B = 2.0f * (axx * ddx * vx + ayy * ddy * vy + azz * ddz * vz +
                  axy * (ddx * vy + ddy * vx) + axz * (ddx * vz + ddz * vx) +
                  ayz * (ddy * vz + ddz * vy) + bx * ddx + by * ddy +
                  bz * ddz);
      Cq = axx * vx * vx + ayy * vy * vy + azz * vz * vz +
           2.0f * (axy * vx * vy + axz * vx * vz + ayz * vy * vz) +
           2.0f * (bx * vx + by * vy + bz * vz) + c0;
    }
    const bool is_lin = A == 0.0f, is_b0 = B == 0.0f;
    const float disc = B * B - 4.0f * A * Cq;
    const float sq = sqrtf(fmaxf(disc, 0.0f));
    const float qq = -0.5f * (B + (B >= 0.0f ? 1.0f : -1.0f) * sq);
    const float safe_a = is_lin ? 1.0f : A;
    const float m_ca = -Cq / safe_a;
    const float sqrt_mca = sqrtf(fmaxf(m_ca, 0.0f));
    const float t_lin = -Cq / (is_b0 ? 1.0f : B);
    const float t0 = is_lin ? t_lin : (is_b0 ? -sqrt_mca : qq / safe_a);
    const float t1 =
        is_lin ? t_lin : (is_b0 ? sqrt_mca : Cq / (qq == 0.0f ? 1.0f : qq));
    const bool root_ok = is_lin ? fabsf(B) > 1e-7f
                                : (is_b0 ? m_ca >= 0.0f : disc >= disc_eps);
    const float t_thr = t_eps * (1.0f + sqrtf(vx * vx + vy * vy + vz * vz));
    const bool ok0 = root_ok && t0 > t_thr &&
                     ap_ok(kinds, C, r, vx + t0 * ddx, vy + t0 * ddy,
                           vz + t0 * ddz);
    const bool ok1 = root_ok && t1 > t_thr &&
                     ap_ok(kinds, C, r, vx + t1 * ddx, vy + t1 * ddy,
                           vz + t1 * ddz);
    t_surf = fminf(ok0 ? t0 : INFINITY, ok1 ? t1 : INFINITY);
  }
  // F_BACKSIDE_MISS is bit 4 of kind*1024 + flags
  if (bmiss_on && ((static_cast<int>(r[ROW_KIND]) >> 4) & 1) && ddz > 0.0f)
    t_surf = INFINITY;
  if (!(t_surf < b.t)) return;
  b.t = t_surf;
  b.sid = s;
  b.up = ddz;
  b.kf = r[ROW_KIND];
  b.p0 = r[ROW_P0];
  b.p1 = r[ROW_P0 + 1];
  if (CLS == FLAT) {
    b.lx = vx + t_surf * ddx;
    b.ly = vy + t_surf * ddy;
    b.lz = 0.0f;
    b.gx = r[6];
    b.gy = r[7];
    b.gz = r[8];
  } else {
    const float* qd = r + 12;
    const float hx = vx + t_surf * ddx, hy = vy + t_surf * ddy,
                hz = vz + t_surf * ddz;
    float glx, gly, glz;
    if (CLS == PARAB) {
      glx = qd[0] * hx;
      gly = qd[1] * hy;
      glz = qd[8];
    } else if (CLS == SPHERE) {
      glx = qd[0] * hx;
      gly = qd[0] * hy;
      glz = qd[0] * hz;
    } else {
      glx = qd[0] * hx + qd[3] * hy + qd[4] * hz + qd[6];
      gly = qd[3] * hx + qd[1] * hy + qd[5] * hz + qd[7];
      glz = qd[4] * hx + qd[5] * hy + qd[2] * hz + qd[8];
    }
    b.lx = hx;
    b.ly = hy;
    b.lz = hz;
    // local gradient -> global through R = (stored R^T)^T
    b.gx = r[0] * glx + r[3] * gly + r[6] * glz;
    b.gy = r[1] * glx + r[4] * gly + r[7] * glz;
    b.gz = r[2] * glx + r[5] * gly + r[8] * glz;
  }
}

template <int CLS>
__device__ __forceinline__ void scan_rows(const float* sm, int first,
                                          int count, int K,
                                          const int* kinds, int C,
                                          const Ray& q, float t_eps,
                                          float disc_eps, bool bmiss_on,
                                          Best& b) {
  for (int i = 0; i < count; ++i)
    row_hit<CLS>(sm + i * K, first + i, kinds, C, q, t_eps, disc_eps,
                 bmiss_on, b);
}

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
  b.t = INFINITY;
  b.sid = -1;
  b.gx = b.gy = b.gz = b.lx = b.ly = b.lz = b.up = b.kf = b.p0 = b.p1 =
      0.0f;
  const int chunk = STAGE_FLOATS / a.K;   // rows per staged chunk
  const bool bmiss_on = a.backside_miss != 0;
  for (int g = 0; g < a.G; ++g) {
    const int* m = a.gmeta + g * a.meta_w;
    const int first = m[0], end = m[1], cls = m[2];
    int kinds[MAX_C];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) kinds[c] = c < a.C ? m[3 + c] : AP_NONE;
    for (int c0 = first; c0 < end; c0 += chunk) {
      const int count = min(chunk, end - c0);
      __syncthreads();  // the previous chunk is no longer read
      const float* src = a.rows + (size_t)c0 * a.K;
      for (int i = threadIdx.x; i < count * a.K; i += THREADS) sm[i] = src[i];
      __syncthreads();
      switch (cls) {
        case FLAT:
          scan_rows<FLAT>(sm, c0, count, a.K, kinds, a.C, q, a.t_eps,
                          a.disc_eps, bmiss_on, b);
          break;
        case PARAB:
          scan_rows<PARAB>(sm, c0, count, a.K, kinds, a.C, q, a.t_eps,
                           a.disc_eps, bmiss_on, b);
          break;
        case SPHERE:
          scan_rows<SPHERE>(sm, c0, count, a.K, kinds, a.C, q, a.t_eps,
                            a.disc_eps, bmiss_on, b);
          break;
        default:
          scan_rows<QUADRIC>(sm, c0, count, a.K, kinds, a.C, q, a.t_eps,
                             a.disc_eps, bmiss_on, b);
          break;
      }
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
