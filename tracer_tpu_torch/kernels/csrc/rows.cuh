// The packed scene rows and the per-row intersection that K1 and K2
// (bounce.cu, tt_bounce_culled and tt_bounce) and K3 (nearest.cu,
// tt_nearest) share: the row layout of kernels/rows.py:pack_rows, every
// aperture kind of the TPU kernels' _ap_ok_static
// (tracer_tpu/kernels/pallas_intersect.py:92) and every quadric class of
// _surface_body (:232).
//
// Per row, the hit distance of its group's class -- "flat" (t = -v_z/d_z,
// |d_z| > 1e-7, L1 self-hit guard t_eps (1 + |vx| + |vy| + |vz|)),
// "parab", "sphere" or "quadric" (stable q-formula, linear and B == 0
// branches, disc >= disc_eps, L2 guard) -- with every aperture kind of
// the group's signature, and F_BACKSIDE_MISS rows rejecting local +Z
// arrivals when backside_miss is on (row_t_local); then the winner's data
// (row_aux). The running minimum uses a strict `<`, so ties keep the
// earlier row. A group's class and aperture kinds are uniform across a
// block, so the switches never diverge; each class is its own template
// instance. A flat group whose apertures are all rect or none (every
// NSTTF heliostat) takes its own instance, FLAT_RECT, whose aperture test
// is a bit mask in a register (flat_rect_t, which K1 uses too) rather
// than a switch over the kinds, and one whose only aperture is a rect in
// slot 0 FLAT_RECT1.
//
// K2 and K3 run the same group dispatch (scan_groups, rows_of_class) over
// rows staged at a stride of whole 16-byte words, each with its own lane
// state: K2 one ray and its whole winner (BestLane), K3 one ray and only
// its winner's distance, row and group (nearest.cu). K1 keeps its own
// loops (scan_group here, and its NSTTF instance's in bounce.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int MAX_C = 8;             // aperture slots (kernels/nearest.py)
constexpr int ROW_KIND = 22;         // optics kind*1024 + flags (as float)
constexpr int ROW_P0 = 23;           // first seven optics params
constexpr int ROW_AP = 30;           // C*6 aperture params follow
constexpr float TWO_PI = 6.283185307179586f;
constexpr float HEX_X = 0.8660254037844386f;   // sqrt(3) / 2
constexpr float HEX_T = 0.5773502691896257f;   // tan(pi / 6)

// the quadric classes of the group metadata; FLAT_RECT is the template
// instance of a flat group with rect-or-none apertures only, FLAT_RECT1
// (K2's) of one whose only aperture is a rect in slot 0
enum { FLAT = 0, PARAB = 1, SPHERE = 2, QUADRIC = 3, FLAT_RECT = 4,
       FLAT_RECT1 = 5 };

enum {
  AP_NONE = 0, AP_RECT = 1, AP_RADIAL = 2, AP_ZRANGE = 3, AP_ANGRANGE = 4,
  AP_XCUT = 5, AP_HEX = 6, AP_TRIANGLE = 7, AP_RECT_HOLE = 8,
  AP_CIRC_HOLE = 9, AP_CIRC = 10, AP_SPHERE = 11, AP_ABS_HALFPLANE = 12,
  AP_TRIANGLE_HOLE = 13
};

struct Ray {
  float px, py, pz, dx, dy, dz;
};

// the running winner: t, row, unnormalised global gradient, local hit
// point, local d_z, optics kind*1024 + flags, first two optics params
struct Best {
  float t;
  int sid;
  float gx, gy, gz, lx, ly, lz, up, kf, p0, p1;
};

__device__ __forceinline__ void best_init(Best& b) {
  b.t = INFINITY;
  b.sid = -1;
  b.gx = b.gy = b.gz = b.lx = b.ly = b.lz = b.up = b.kf = b.p0 = b.p1 =
      0.0f;
}

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

// bit c set: aperture slot c of the group (metadata row m) is AP_RECT;
// -1 when a slot holds a kind other than AP_RECT or AP_NONE
__device__ __forceinline__ int rect_mask_of(const int* m, int C) {
  int mask = 0;
  for (int c = 0; c < C; ++c) {
    if (m[3 + c] == AP_RECT) mask |= 1 << c;
    else if (m[3 + c] != AP_NONE) return -1;
  }
  return mask;
}

// the ray in row r's local frame: origin v, direction dd
struct Local {
  float vx, vy, vz, ddx, ddy, ddz;
};

__device__ __forceinline__ Local to_local(const float* r, const Ray& q) {
  Local v;
  v.vx = r[0] * q.px + r[1] * q.py + r[2] * q.pz + r[9];
  v.vy = r[3] * q.px + r[4] * q.py + r[5] * q.pz + r[10];
  v.vz = r[6] * q.px + r[7] * q.py + r[8] * q.pz + r[11];
  v.ddx = r[0] * q.dx + r[1] * q.dy + r[2] * q.dz;
  v.ddy = r[3] * q.dx + r[4] * q.dy + r[5] * q.dz;
  v.ddz = r[6] * q.dx + r[7] * q.dy + r[8] * q.dz;
  return v;
}

// hit distance on flat row r (local plane z = 0) whose apertures are rect
// or none (bit c of rect_mask: slot c is a rect); +inf on a miss
__device__ __forceinline__ float flat_rect_t(const float* r, int rect_mask,
                                             int C, const Local& v,
                                             float t_eps) {
  const float t_hit = -v.vz / (v.ddz == 0.0f ? 1.0f : v.ddz);
  const float t_thr =
      t_eps * (1.0f + fabsf(v.vx) + fabsf(v.vy) + fabsf(v.vz));
  const float hx = v.vx + t_hit * v.ddx, hy = v.vy + t_hit * v.ddy;
  bool ok = fabsf(v.ddz) > 1e-7f && t_hit > t_thr;
  for (int c = 0; c < C; ++c)
    if ((rect_mask >> c) & 1)
      ok = ok && fabsf(hx) <= r[ROW_AP + 6 * c] &&
           fabsf(hy) <= r[ROW_AP + 6 * c + 1];
  return ok ? t_hit : INFINITY;
}

// hit distance on row r (quadric class CLS) of the ray already in the
// row's local frame (v = to_local(r, q)), +inf on a miss. With kSolve a
// curved row solves the general quadratic (A and B nonzero: every row but
// a degenerate one) in a branch of its own, without the linear and B == 0
// roots' quotients and square root, and takes no root where its
// discriminant admits none; the values that decide are the branch-free
// form's, so is the distance, bit for bit
template <int CLS, bool kSolve = false>
__device__ __forceinline__ float row_t_local(const float* r,
                                             const int* kinds,
                                             int rect_mask, int C,
                                             const Local& v, float t_eps,
                                             float disc_eps,
                                             bool bmiss_on) {
  const float vx = v.vx, vy = v.vy, vz = v.vz, ddx = v.ddx, ddy = v.ddy,
              ddz = v.ddz;
  float t_surf;
  if (CLS == FLAT_RECT) {
    t_surf = flat_rect_t(r, rect_mask, C, v, t_eps);
  } else if (CLS == FLAT_RECT1) {
    t_surf = flat_rect_t(r, 1, 1, v, t_eps);
  } else if (CLS == FLAT) {
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
    float t0 = 0.0f, t1 = 0.0f;
    bool root_ok;
    if (kSolve && !is_lin && !is_b0) {
      root_ok = disc >= disc_eps;
      if (root_ok) {
        const float sq = sqrtf(fmaxf(disc, 0.0f));
        const float qq = -0.5f * (B + (B >= 0.0f ? 1.0f : -1.0f) * sq);
        t0 = qq / A;
        t1 = Cq / (qq == 0.0f ? 1.0f : qq);
      }
    } else {
      const float sq = sqrtf(fmaxf(disc, 0.0f));
      const float qq = -0.5f * (B + (B >= 0.0f ? 1.0f : -1.0f) * sq);
      const float safe_a = is_lin ? 1.0f : A;
      const float m_ca = -Cq / safe_a;
      const float sqrt_mca = sqrtf(fmaxf(m_ca, 0.0f));
      const float t_lin = -Cq / (is_b0 ? 1.0f : B);
      t0 = is_lin ? t_lin : (is_b0 ? -sqrt_mca : qq / safe_a);
      t1 = is_lin ? t_lin
                  : (is_b0 ? sqrt_mca : Cq / (qq == 0.0f ? 1.0f : qq));
      root_ok = is_lin ? fabsf(B) > 1e-7f
                       : (is_b0 ? m_ca >= 0.0f : disc >= disc_eps);
    }
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
  return t_surf;
}

// the winner's data when row s (packed row r, class CLS, the ray in its
// local frame v) is hit at t_surf: the hit, its row, local d_z, optics
// kind and params, local hit point and unnormalised global gradient
template <int CLS>
__device__ __forceinline__ void row_aux(const float* r, int s,
                                        const Local& v, float t_surf,
                                        Best& b) {
  const float vx = v.vx, vy = v.vy, vz = v.vz, ddx = v.ddx, ddy = v.ddy,
              ddz = v.ddz;
  b.t = t_surf;
  b.sid = s;
  b.up = ddz;
  b.kf = r[ROW_KIND];
  b.p0 = r[ROW_P0];
  b.p1 = r[ROW_P0 + 1];
  if (CLS == FLAT || CLS == FLAT_RECT || CLS == FLAT_RECT1) {
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

// fold row s (packed row r, quadric class CLS) into the lane's winner,
// the ray already in the row's local frame (v = to_local(r, q)); kSolve
// as row_t_local's
template <int CLS, bool kSolve = false>
__device__ __forceinline__ void row_hit_local(const float* r, int s,
                                              const int* kinds,
                                              int rect_mask, int C,
                                              const Local& v, float t_eps,
                                              float disc_eps, bool bmiss_on,
                                              Best& b) {
  const float t_surf = row_t_local<CLS, kSolve>(r, kinds, rect_mask, C, v,
                                                t_eps, disc_eps, bmiss_on);
  if (!(t_surf < b.t)) return;
  row_aux<CLS>(r, s, v, t_surf, b);
}

template <int CLS>
__device__ __forceinline__ void row_hit(const float* r, int s,
                                        const int* kinds, int rect_mask,
                                        int C, const Ray& q, float t_eps,
                                        float disc_eps, bool bmiss_on,
                                        Best& b) {
  row_hit_local<CLS>(r, s, kinds, rect_mask, C, to_local(r, q), t_eps,
                     disc_eps, bmiss_on, b);
}

template <int CLS>
__device__ __forceinline__ void scan_rows(const float* sm, int first,
                                          int count, int K,
                                          const int* kinds, int rect_mask,
                                          int C, const Ray& q, float t_eps,
                                          float disc_eps, bool bmiss_on,
                                          Best& b) {
  for (int i = 0; i < count; ++i)
    row_hit<CLS>(sm + i * K, first + i, kinds, rect_mask, C, q, t_eps,
                 disc_eps, bmiss_on, b);
}

// rows [first, first + count) of one group, staged at sm, into the winner
// (rect_mask: rect_mask_of the group)
__device__ __forceinline__ void scan_group(int cls, const float* sm,
                                           int first, int count, int K,
                                           const int* kinds, int rect_mask,
                                           int C, const Ray& q, float t_eps,
                                           float disc_eps, bool bmiss_on,
                                           Best& b) {
  switch (cls) {
    case FLAT:
      if (rect_mask >= 0)
        scan_rows<FLAT_RECT>(sm, first, count, K, kinds, rect_mask, C, q,
                             t_eps, disc_eps, bmiss_on, b);
      else
        scan_rows<FLAT>(sm, first, count, K, kinds, rect_mask, C, q, t_eps,
                        disc_eps, bmiss_on, b);
      break;
    case PARAB:
      scan_rows<PARAB>(sm, first, count, K, kinds, rect_mask, C, q, t_eps,
                       disc_eps, bmiss_on, b);
      break;
    case SPHERE:
      scan_rows<SPHERE>(sm, first, count, K, kinds, rect_mask, C, q, t_eps,
                        disc_eps, bmiss_on, b);
      break;
    default:
      scan_rows<QUADRIC>(sm, first, count, K, kinds, rect_mask, C, q, t_eps,
                         disc_eps, bmiss_on, b);
      break;
  }
}

// the group's aperture kinds from its metadata row (AP_NONE past C)
__device__ __forceinline__ void group_kinds(const int* m, int C,
                                            int kinds[MAX_C]) {
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) kinds[c] = c < C ? m[3 + c] : AP_NONE;
}

// rows [first, first + count) of one group (class CLS), staged at sm with
// a stride of Kp floats (whole 16-byte words), folded into the lane state
// ``lane`` (its fold<CLS>(row, row id, kinds, rect mask, C, t_eps,
// disc_eps, bmiss_on))
template <int CLS, class Lane>
__device__ __forceinline__ void rows_of_class(const float* sm, int first,
                                              int count, int Kp,
                                              const int* kinds,
                                              int rect_mask, int C,
                                              float t_eps, float disc_eps,
                                              bool bmiss_on, Lane& lane) {
  for (int i = 0; i < count; ++i) {
    const float* r =
        static_cast<const float*>(__builtin_assume_aligned(sm + i * Kp, 16));
    lane.template fold<CLS>(r, first + i, kinds, rect_mask, C, t_eps,
                            disc_eps, bmiss_on);
  }
}

// every group's rows (gmeta: G rows of meta_w ints, first row, end row,
// class, kinds) that the stage at sm holds, into the lane state: with
// kClip the stage holds rows [r0, r1) and each group is cut to them,
// without it the whole table from row 0. kC1: the rows hold one aperture
// slot (C is 1), so the aperture kinds stay in registers and their tests
// need no loop. The lane state hears of each group before and after its
// rows (enter(g), leave(g))
template <bool kC1, bool kClip, class Lane>
__device__ __forceinline__ void scan_groups(const int* gmeta, int G,
                                            int meta_w, int C_rows,
                                            const float* sm, int Kp, int r0,
                                            int r1, float t_eps,
                                            float disc_eps, bool bmiss_on,
                                            Lane& lane) {
  const int C = kC1 ? 1 : C_rows;
  for (int g = 0; g < G; ++g) {
    const int* m = gmeta + g * meta_w;
    int kinds[MAX_C];
    group_kinds(m, C, kinds);
    const int mask = rect_mask_of(m, C);
    const int first = kClip ? max(m[0], r0) : m[0];
    const int count = (kClip ? min(m[1], r1) : m[1]) - first;
    const float* at = sm + (first - r0) * Kp;
    lane.enter(g);
    // a flat group whose only aperture is a rect in slot 0 takes
    // FLAT_RECT1, one with rect or no apertures FLAT_RECT
    switch (m[2]) {
      case FLAT:
        if (mask == 1)
          rows_of_class<FLAT_RECT1>(at, first, count, Kp, kinds, mask, C,
                                    t_eps, disc_eps, bmiss_on, lane);
        else if (mask >= 0)
          rows_of_class<FLAT_RECT>(at, first, count, Kp, kinds, mask, C,
                                   t_eps, disc_eps, bmiss_on, lane);
        else
          rows_of_class<FLAT>(at, first, count, Kp, kinds, mask, C, t_eps,
                              disc_eps, bmiss_on, lane);
        break;
      case PARAB:
        rows_of_class<PARAB>(at, first, count, Kp, kinds, mask, C, t_eps,
                             disc_eps, bmiss_on, lane);
        break;
      case SPHERE:
        rows_of_class<SPHERE>(at, first, count, Kp, kinds, mask, C, t_eps,
                              disc_eps, bmiss_on, lane);
        break;
      default:
        rows_of_class<QUADRIC>(at, first, count, Kp, kinds, mask, C, t_eps,
                               disc_eps, bmiss_on, lane);
        break;
    }
    lane.leave(g);
  }
}

// K2's lane state: one ray and its whole winner (Best), updated row by row
struct BestLane {
  const Ray& q;
  Best& b;
  __device__ __forceinline__ void enter(int) {}
  __device__ __forceinline__ void leave(int) {}
  template <int CLS>
  __device__ __forceinline__ void fold(const float* r, int s,
                                       const int* kinds, int rect_mask,
                                       int C, float t_eps, float disc_eps,
                                       bool bmiss_on) {
    row_hit_local<CLS, true>(r, s, kinds, rect_mask, C, to_local(r, q),
                             t_eps, disc_eps, bmiss_on, b);
  }
};

// shared memory above 48 KB a block is dynamic and needs the attribute
constexpr int SMEM_DEFAULT = 48 * 1024;

template <typename Kernel>
cudaError_t allow_smem(Kernel k, size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// the card's SMs (asked once)
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

}  // namespace
