// The shade of a winning row that K1 and K2 (bounce.cu) and the K3
// epilogue (epilogue.cu) share, one copy of the shading arithmetic:
// pallas_intersect._make_shade_epilogue's twin (shade<>), with the Philox
// stream its draws come from (philox, uniforms4, the CALL_* draw ids of
// kernels/philox.py), the rotation of a +Z-sampled vector about an axis,
// the spectral table lookups and the conductor's Fresnel reflectance, the
// lane and result structs, and the host's mode struct (Modes) from which
// each kernel makes the shade's runtime modes (Epi).
#pragma once

#include <stdint.h>

#include "rows.cuh"

namespace {

// Philox draw calls (kernels/philox.py): each has its own counter, so
// adding a draw never shifts another
constexpr uint32_t CALL_REGEN = 0u, CALL_SLOPE = 1u, CALL_LAMBERT = 2u,
                   CALL_BAND = 3u, CALL_FRESNEL = 4u, CALL_SCATTER = 5u,
                   CALL_BECKMANN = 6u, CALL_SPECULAR = 7u,
                   CALL_PIECEWISE = 8u;

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


// piecewise-linear value at wl of the table chunk [start, start + length)
// of (wavelength, absorptance) pairs, clamped to the chunk's edge values
// (pallas_intersect._interp_row_table). The chunk's wavelengths ascend,
// so one segment holds wl, found by bisection in log2(length) steps
__device__ __forceinline__ float interp_row(float wl, int start, int length,
                                            const float* tab) {
  const int hi = start + length - 1;
  if (wl < tab[2 * start]) return tab[2 * start + 1];
  if (wl >= tab[2 * hi]) return tab[2 * hi + 1];
  int k = start, k1 = hi;  // tab[2 k] <= wl < tab[2 k1] where wl is a number
  while (k1 - k > 1) {
    const int mid = (k + k1) >> 1;
    if (tab[2 * mid] <= wl)
      k = mid;
    else
      k1 = mid;
  }
  const float x0 = tab[2 * k], x1 = tab[2 * k + 2];
  if (!(wl >= x0 && wl < x1)) return 0.0f;
  const float w = (wl - x0) / (x1 == x0 ? 1.0f : x1 - x0);
  const float y0 = tab[2 * k + 1], y1 = tab[2 * k + 3];
  return y0 + fminf(fmaxf(w, 0.0f), 1.0f) * (y1 - y0);
}

// bilinear value at (th, wl) of a (T, W) grid packed into the table
// (pallas_intersect._interp2_row_table): the axes' values in the first
// column at [th_start, th_start + T) and [wl_start, wl_start + W), the
// grid row-major (theta-major) in the second column from grid_start;
// queries clamp to the grid's edges, whose top cells close their upper
// bound
__device__ __forceinline__ float interp2_row(float th, float wl,
                                             int th_start, int T,
                                             int wl_start, int W,
                                             int grid_start,
                                             const float* tab) {
  const float th_hi = tab[2 * (th_start + T - 1)];
  const float wl_hi = tab[2 * (wl_start + W - 1)];
  const float th_q = fminf(fmaxf(th, tab[2 * th_start]), th_hi);
  const float wl_q = fminf(fmaxf(wl, tab[2 * wl_start]), wl_hi);
  float acc = 0.0f;
  for (int i = 0; i < T - 1; ++i) {
    const float tx0 = tab[2 * (th_start + i)];
    const float tx1 = tab[2 * (th_start + i + 1)];
    if (!(th_q >= tx0 && (th_q < tx1 || (tx1 == th_hi && th_q <= tx1))))
      continue;
    const float wt = fminf(
        fmaxf((th_q - tx0) / (tx1 == tx0 ? 1.0f : tx1 - tx0), 0.0f), 1.0f);
    const int base = grid_start + i * W;
    for (int j = 0; j < W - 1; ++j) {
      const float wx0 = tab[2 * (wl_start + j)];
      const float wx1 = tab[2 * (wl_start + j + 1)];
      if (!(wl_q >= wx0 && (wl_q < wx1 || (wx1 == wl_hi && wl_q <= wx1))))
        continue;
      const float ww = fminf(
          fmaxf((wl_q - wx0) / (wx1 == wx0 ? 1.0f : wx1 - wx0), 0.0f), 1.0f);
      const float g00 = tab[2 * (base + j) + 1];
      const float g01 = tab[2 * (base + j + 1) + 1];
      const float g10 = tab[2 * (base + W + j) + 1];
      const float g11 = tab[2 * (base + W + j + 1) + 1];
      acc += (1.0f - wt) * ((1.0f - ww) * g00 + ww * g01) +
             wt * ((1.0f - ww) * g10 + ww * g11);
    }
  }
  return acc;
}

// conductor Fresnel reflectance, randomly polarized, at incidence cosine
// c (clipped to [1e-6, 1]) from index n1 onto n2 + i k2: the real-
// arithmetic optics.fresnel_to_attenuating of _make_shade_epilogue
// (pallas_intersect.py:1101, :1132)
__device__ __forceinline__ float conductor_r(float c, float n1, float n2,
                                             float k2) {
  const float s1sq = n1 * n1 * (1.0f - c * c);
  const float bq = n2 * n2 - k2 * k2 - s1sq;
  const float nk = n2 * k2;
  const float aq = sqrtf(bq * bq + 4.0f * nk * nk);
  const float pq = sqrtf(fmaxf(0.5f * (aq + bq), 0.0f));
  const float qq = sqrtf(fmaxf(0.5f * (aq - bq), 0.0f));
  const float c1 = n1 * c;
  const float rs = ((c1 - pq) * (c1 - pq) + qq * qq) /
                   ((c1 + pq) * (c1 + pq) + qq * qq);
  const float st = s1sq / c1;
  const float rp = ((pq - st) * (pq - st) + qq * qq) /
                   ((pq + st) * (pq + st) + qq * qq) * rs;
  return 0.5f * (rp + rs);
}

struct Lane {
  float px, py, pz, dx, dy, dz, e;
};

struct Shaded {
  float px, py, pz, dx, dy, dz, e, absorbed;
  float ri, mid;  // the lane's index and medium id after the bounce
  bool scat;      // scattered in its medium before reaching a surface
  // kSplit: the reflected branch's energy and direction, on a lane
  // that split at an F_SPLIT interface (split)
  float s_e, sdx, sdy, sdz;
  bool split;
};

// K1's and K2's modes as the host passes them, one struct behind one
// pointer (kernels/bounce.py:_Modes has the same layout)
struct Modes {
  int bivar_mode, one_sided, slope, lambertian;
  float ambient_att;
  int refr_frost, refr_disp, scat;
  float ambient_scat, ambient_g;
  // stages (d) and (e): any of them selects a kExtra instance
  int cook_torrance, lam_specular, semi_lambertian, transparent;
  int conductor, periodic, piecewise;
  float iam_c;         // 0: no IAM rows; else the scene's exponent c
  int backside_miss;   // F_BACKSIDE_MISS rows reject local +Z arrivals
  int refr_split;      // F_SPLIT refractive rows split the energy (K2:
                       // a kSplit instance)
  int park_aureole;    // K1: hits of aureole-born lanes get encoded sids
};

// the epilogue's runtime modes (the template flags of shade pick the rest)
struct Epi {
  int bivar_mode;      // 1 every slope row bivariate, 0 all radial, 2 per row
  int one_sided, slope, lambertian;
  const float* tab;    // (n, 2) spectral table, or nullptr: no spectral rows
  float ambient_att;   // Beer-Lambert coefficient of the ambient medium [1/m]
  float ambient_scat;  // HG scattering coefficient of the ambient [1/m]
  float ambient_g;     // HG asymmetry of the ambient
  int refr_frost;      // refractive rows perturb their normal with p2
  int refr_disp;       // refractive rows with p5 > 0 interpolate n(wl)
  const float* media_tab;   // (M, 3) att, scat, g of each medium id
  const float* media_rows;  // (S, 2) side-1 and side-2 medium ids per row
  int spectral;        // lanes carry a wavelength: spectral rows interpolate
  int cook_torrance, lam_specular, semi_lambertian, transparent;
  int conductor, periodic, piecewise;
  float iam_c;
};

// shade the winner row `w` (row id sid; nullptr on a miss) with the
// carried normal (unnormalised gradient) and local d_z: pallas_intersect
// _make_shade_epilogue's reflect, slope error, one-sided kill, Lambertian
// and attenuation branches and the spectral carry of _surface_body; with
// kRefr the refractive interfaces on the lane's index ri, with kScat the
// HG scattering of the lane's medium (the ambient's, or with kMedia the
// medium id mid's row of the media table), with kExtra the kinds of
// stages (d) and (e), which read the winner's p2 and p3 (q2, q3) as
// _make_fused_kernel's four-parameter carry does; with kSplit (and kRefr)
// F_SPLIT rows split the energy instead of the roulette
template <bool kRefr, bool kScat, bool kMedia, bool kExtra,
          bool kSplit = false>
__device__ __forceinline__ Shaded shade(const float* w, int sid, float ngx_w,
                                        float ngy_w, float ngz_w,
                                        float upd_w, float t_b,
                                        const Lane& in, float wl, float ri,
                                        float mid, uint32_t seed,
                                        uint32_t stream, uint32_t lane,
                                        const Epi& ep) {
  const bool hit = w != nullptr;
  const float ngx = hit ? ngx_w : 0.0f, ngy = hit ? ngy_w : 0.0f,
              ngz = hit ? ngz_w : 0.0f;
  const float upd_b = hit ? upd_w : 0.0f;
  const float kf = hit ? w[ROW_KIND] : 0.0f;
  const float kind = floorf(kf * (1.0f / 1024.0f));
  float q0 = hit ? w[ROW_P0] : 0.0f;
  float q1 = hit ? w[ROW_P0 + 1] : 0.0f;
  if (ep.spectral && kind == 5.0f) {
    // K_REFLECT_SPECTRAL: p0/p1 are the table chunk, sigma is p2
    q0 = interp_row(wl, static_cast<int>(w[ROW_P0]),
                    static_cast<int>(w[ROW_P0 + 1]), ep.tab);
    q1 = w[ROW_P0 + 2];
  }
  const bool is_refr = kRefr && kind == 6.0f;
  if (is_refr && ep.refr_disp && w[ROW_P0 + 5] > 0.0f) {
    // dispersive K_REFRACTIVE: n1(wl) and n2(wl) from the table chunks
    // [p3, p3 + p4) and [p3 + p4, p3 + p4 + p5), for the winner only
    const int st = static_cast<int>(w[ROW_P0 + 3]);
    const int l1 = static_cast<int>(w[ROW_P0 + 4]);
    q0 = interp_row(wl, st, l1, ep.tab);
    q1 = interp_row(wl, st + l1, static_cast<int>(w[ROW_P0 + 5]), ep.tab);
  }
  // stages (d) and (e): the winner's p2 and p3; a conductor's n2(wl) and
  // k2(wl) from the chunks at p1 of length p2; a piecewise row's
  // absorptance and specular probability at the incidence angle on the
  // winner's own normal (pallas_intersect.py:474-543)
  float q2 = 0.0f, q3 = 0.0f;
  if (kExtra && hit) {
    q2 = w[ROW_P0 + 2];
    q3 = w[ROW_P0 + 3];
    if (ep.conductor && kind == 10.0f) {
      const int st = static_cast<int>(w[ROW_P0 + 1]);
      const int len = static_cast<int>(w[ROW_P0 + 2]);
      q2 = interp_row(wl, st, len, ep.tab);
      q3 = interp_row(wl, st + len, len, ep.tab);
    }
    if (ep.piecewise && kind == 11.0f) {
      const float gn =
          rsqrtf(fmaxf(ngx * ngx + ngy * ngy + ngz * ngz, 1e-30f));
      const float cosc = fminf(
          fmaxf(fabsf(in.dx * ngx + in.dy * ngy + in.dz * ngz) * gn, 0.0f),
          1.0f);
      const float th = acosf(cosc);
      const int th_st = static_cast<int>(w[ROW_P0]);
      const int len = static_cast<int>(w[ROW_P0 + 1]);
      const int n_wl = static_cast<int>(w[ROW_P0 + 5]);
      q2 = n_wl > 0 ? interp2_row(th, wl, th_st, len,
                                  static_cast<int>(w[ROW_P0 + 4]), n_wl,
                                  static_cast<int>(w[ROW_P0 + 6]), ep.tab)
                    : interp_row(th, th_st, len, ep.tab);
      q3 = w[ROW_P0 + 3] >= 0.0f
               ? interp_row(th, static_cast<int>(w[ROW_P0 + 3]), len, ep.tab)
               : w[ROW_P0 + 2];
    }
  }
  const float t_safe = hit ? t_b : 0.0f;
  float hx = in.px + t_safe * in.dx;
  float hy = in.py + t_safe * in.dy;
  float hz = in.pz + t_safe * in.dz;
  // shading normal: the carried gradient, flipped against the ray
  const float g2 = ngx * ngx + ngy * ngy + ngz * ngz;
  const float rinv = rsqrtf(fmaxf(g2, 1e-30f));
  const float cos_g = in.dx * ngx + in.dy * ngy + in.dz * ngz;
  const float flip = cos_g > 0.0f ? -rinv : rinv;
  const float n0x = ngx * flip, n0y = ngy * flip, n0z = ngz * flip;
  // the lane's medium
  float m_att = ep.ambient_att, m_scat = ep.ambient_scat,
        m_g = ep.ambient_g;
  if (kMedia) {
    const float* m = ep.media_tab + 3 * static_cast<int>(mid);
    m_att = m[0];
    m_scat = m[1];
    m_g = m[2];
  }
  bool scat = false;
  float free_path = 0.0f, sdx = 0.0f, sdy = 0.0f, sdz = 0.0f;
  if (kScat) {
    // exponential free path; a miss (t_b = inf) scatters too
    float u[4];
    uniforms4(seed, stream, lane, CALL_SCATTER, u);
    const float logu = -logf(fmaxf(u[0], 1e-12f));
    free_path = m_scat > 0.0f ? logu / m_scat : INFINITY;
    scat = free_path < t_b;
    if (scat) {
      // Henyey-Greenstein polar angle about the travel direction
      const float sg = 2.0f * u[1] - 1.0f;
      const bool iso = fabsf(m_g) < 1e-9f;
      const float frac = (1.0f - m_g * m_g) / (1.0f + m_g * sg);
      const float cos_sc =
          iso ? sg
              : fminf(fmaxf((1.0f + m_g * m_g - frac * frac) * (0.5f / m_g),
                            -1.0f),
                      1.0f);
      const float sin_sc = sqrtf(fmaxf(1.0f - cos_sc * cos_sc, 0.0f));
      float s_sp, c_sp;
      sincosf(TWO_PI * u[2], &s_sp, &c_sp);
      rot_about(in.dx, in.dy, in.dz, sin_sc * c_sp, sin_sc * s_sp, cos_sc,
                sdx, sdy, sdz);
    }
  }
  float nx = n0x, ny = n0y, nz = n0z;
  if (ep.slope) {
    float u[4];
    uniforms4(seed, stream, lane, CALL_SLOPE, u);
    const float rr = sqrtf(-2.0f * logf(u[0]));
    float s_bm, c_bm;
    sincosf(TWO_PI * u[1], &s_bm, &c_bm);
    const float nrm1 = rr * c_bm;
    // Lambertian rows carry ang_range in q1, not a slope sigma;
    // refractive rows carry n2 there, and a frosted one its sigma in p2
    float sigma = ep.lambertian && kind == 2.0f ? 0.0f : q1;
    if (is_refr) sigma = ep.refr_frost ? w[ROW_P0 + 2] : 0.0f;
    if (kExtra) {
      // Cook-Torrance rows carry m_n in q1, conductor rows their table
      // start and piecewise rows their table length; these and the
      // semi-Lambertian rows reflect without slope error; a
      // Lambertian-specular row's sigma is its q2
      if ((ep.cook_torrance && kind == 9.0f) ||
          (ep.semi_lambertian && kind == 4.0f) ||
          (ep.conductor && kind == 10.0f) || (ep.piecewise && kind == 11.0f))
        sigma = 0.0f;
      if (ep.lam_specular && kind == 3.0f) sigma = q2;
    }
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
  float nri = ri, nmid = mid;
  // kSplit: on an F_SPLIT row (flags bit 3) the lane always crosses,
  // and the reflected branch leaves with the share R of its energy
  bool split = false;
  float r_split = 0.0f, srx = 0.0f, sry = 0.0f, srz = 0.0f;
  if (is_refr) {
    // the side whose index is nearest the lane's is the one it comes
    // from (index-matched sides: the one whose medium id it carries)
    bool in1 = fabsf(ri - q0) <= fabsf(ri - q1);
    float mid1 = 0.0f, mid2 = 0.0f;
    if (kMedia) {
      mid1 = ep.media_rows[2 * sid];
      mid2 = ep.media_rows[2 * sid + 1];
      if (!(fabsf(q0 - q1) > 1e-9f)) in1 = mid == mid1;
    }
    const float n_next = in1 ? q1 : q0;
    const float safe_ri = ri == 0.0f ? 1.0f : ri;
    const float safe_nx = n_next == 0.0f ? 1.0f : n_next;
    const float nrat = safe_nx / safe_ri;
    const float c1 = dn;
    const bool refr_ok = c1 * c1 >= 1.0f - nrat * nrat;
    const float inv_nr = 1.0f / nrat;
    const float cos2 =
        sqrtf(fmaxf(1.0f - (1.0f - c1 * c1) * inv_nr * inv_nr, 0.0f));
    const float sgn = c1 < 0.0f ? -1.0f : 1.0f;
    // unpolarized Fresnel R; R = 1 on total internal reflection
    const float cos1a = fabsf(c1);
    const float ratio = safe_ri / safe_nx;
    const float under = 1.0f - ratio * ratio * (1.0f - cos1a * cos1a);
    const float bar = sqrtf(fmaxf(under, 0.0f));
    const float rs = (safe_ri * cos1a - safe_nx * bar) /
                     (safe_ri * cos1a + safe_nx * bar);
    const float rp = (safe_ri * bar - safe_nx * cos1a) /
                     (safe_ri * bar + safe_nx * cos1a);
    const float R =
        refr_ok && under >= 0.0f ? 0.5f * (rs * rs + rp * rp) : 1.0f;
    float u[4];
    uniforms4(seed, stream, lane, CALL_FRESNEL, u);
    if (kSplit && fmodf(kf, 16.0f) >= 8.0f) {
      // the reflected direction, saved before the crossing replaces it
      split = true;
      r_split = R;
      srx = rx;
      sry = ry;
      srz = rz;
    }
    if (split || !(u[0] <= R)) {
      // Snell about the same normal; the lane enters the other side
      rx = (in.dx - c1 * nx) * inv_nr + nx * cos2 * sgn;
      ry = (in.dy - c1 * ny) * inv_nr + ny * cos2 * sgn;
      rz = (in.dz - c1 * nz) * inv_nr + nz * cos2 * sgn;
      nri = n_next;
      if (kMedia) nmid = in1 ? mid2 : mid1;
    }
    q0 = 0.0f;  // Russian roulette keeps the full energy
  }
  if (!kExtra && ep.lambertian) {
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
  if (kExtra) {
    const float period = q0;
    const float cos_n = in.dx * n0x + in.dy * n0y + in.dz * n0z;
    if (ep.cook_torrance && kind == 9.0f) {
      // K_COOK_TORRANCE (alpha q0, m_n q1, m_k q2, R_lam q3): reflect
      // about a Beckmann half-vector drawn about the unperturbed normal,
      // weighted by R_lam F G |d.h| / (|n.d| |n.h|) clipped to [0, 1]
      // (the conductor F at |d.h|); below the surface it is absorbed
      float u[4];
      uniforms4(seed, stream, lane, CALL_BECKMANN, u);
      const float tan2 = -q0 * q0 * logf(u[0]);
      const float cos_h = rsqrtf(1.0f + tan2);
      const float sin_h = sqrtf(fmaxf(1.0f - cos_h * cos_h, 0.0f));
      float s_pc, c_pc, hvx, hvy, hvz;
      sincosf(TWO_PI * u[1], &s_pc, &c_pc);
      rot_about(n0x, n0y, n0z, sin_h * c_pc, sin_h * s_pc, cos_h, hvx, hvy,
                hvz);
      const float d_h = in.dx * hvx + in.dy * hvy + in.dz * hvz;
      rx = in.dx - 2.0f * d_h * hvx;
      ry = in.dy - 2.0f * d_h * hvy;
      rz = in.dz - 2.0f * d_h * hvz;
      const float v_dot_h = fabsf(d_h);
      const float n_dot_v = fmaxf(fabsf(cos_n), 1e-6f);
      const float n_dot_h =
          fmaxf(fabsf(hvx * n0x + hvy * n0y + hvz * n0z), 1e-6f);
      const float n_dot_l = rx * n0x + ry * n0y + rz * n0z;
      const float f =
          conductor_r(fminf(fmaxf(v_dot_h, 1e-6f), 1.0f), 1.0f, q1, q2);
      const float vh_s = fmaxf(v_dot_h, 1e-6f);
      const float g = fminf(1.0f, fminf(2.0f * n_dot_h * n_dot_v / vh_s,
                                        2.0f * n_dot_h * fabsf(n_dot_l) /
                                            vh_s));
      const float w_ct = q3 * f * g * v_dot_h / (n_dot_v * n_dot_h);
      q0 = 1.0f - (n_dot_l > 0.0f ? fminf(fmaxf(w_ct, 0.0f), 1.0f) : 0.0f);
    }
    if (ep.conductor && kind == 10.0f) {
      // K_FRESNEL_CONDUCTOR: specular, absorbs 1 - R(n1 = q0 or 1 onto
      // q2 + i q3) at the incidence angle on the unperturbed normal
      const float r = conductor_r(fminf(fmaxf(fabsf(cos_n), 1e-6f), 1.0f),
                                  q0 > 0.0f ? q0 : 1.0f, q2, q3);
      q0 = 1.0f - fminf(fmaxf(r, 0.0f), 1.0f);
    }
    if (ep.piecewise && kind == 11.0f) q0 = q2;
    if (ep.iam_c != 0.0f && fmodf(kf, 8.0f) >= 4.0f) {
      // F_IAM (bit 2): the Martin-Ruiz modifier with a_r in q2 (q3 on
      // Lambertian-specular rows) and cos^c baked as exp(c log cos)
      float cosi = fabsf(cos_n);
      if (ep.iam_c != 1.0f)
        cosi = expf(ep.iam_c * logf(fmaxf(cosi, 1e-30f)));
      const float a_raw = ep.lam_specular && kind == 3.0f ? q3 : q2;
      const float a_r = a_raw > 0.0f ? a_raw : 1.0f;
      q0 = q0 * ((1.0f - expf(-cosi / a_r)) / (1.0f - expf(-1.0f / a_r)));
    }
    // the diffuse lobe about the unperturbed normal: Lambertian rows
    // within ang_range (q1); Lambertian-specular rows over the hemisphere
    // unless a draw below the specularity q1 keeps the reflection;
    // semi-Lambertian rows when the incidence is within ang_range (q1);
    // piecewise rows over the hemisphere unless a draw below their
    // specular probability q3 keeps the reflection
    const bool lam_k = ep.lambertian && kind == 2.0f;
    const bool ls_k = ep.lam_specular && kind == 3.0f;
    const bool sl_k = ep.semi_lambertian && kind == 4.0f;
    const bool pw_k = ep.piecewise && kind == 11.0f;
    if (lam_k || ls_k || sl_k || pw_k) {
      float sin_cap, cos_cap;
      sincosf(q1, &sin_cap, &cos_cap);
      if (ls_k || pw_k) sin_cap = 1.0f;
      bool go_diff = lam_k || (sl_k && fabsf(cos_n) >= cos_cap);
      if (ls_k || pw_k) {
        float u[4];
        uniforms4(seed, stream, lane, ls_k ? CALL_SPECULAR : CALL_PIECEWISE,
                  u);
        go_diff = u[0] >= (ls_k ? q1 : q3);
      }
      if (go_diff) {
        float u[4], s_pl, c_pl;
        uniforms4(seed, stream, lane, CALL_LAMBERT, u);
        const float sinsq = sin_cap * sqrtf(u[0]);
        sincosf(TWO_PI * u[1], &s_pl, &c_pl);
        const float lz = sqrtf(fmaxf(1.0f - sinsq * sinsq, 0.0f));
        rot_about(n0x, n0y, n0z, sinsq * c_pl, sinsq * s_pl, lz, rx, ry, rz);
      }
    }
    if ((ep.transparent && hit && kind == 0.0f) ||
        (ep.periodic && kind == 7.0f)) {
      // K_TRANSPARENT passes through (q0 is 0); K_PERIODIC teleports by
      // its signed period along the unperturbed normal and absorbs
      // nothing
      rx = in.dx;
      ry = in.dy;
      rz = in.dz;
      if (kind == 7.0f) {
        hx += period * n0x;
        hy += period * n0y;
        hz += period * n0z;
        q0 = 0.0f;
      }
    }
  }
  // the medium takes its share of the travelled segment (to the
  // scattering event, else to the hit) before the surface does; escaping
  // lanes keep their energy
  const float travel = scat ? free_path : t_safe;
  const float e_att = (hit || scat) && m_att > 0.0f
                          ? in.e * expf(-m_att * travel)
                          : in.e;
  float e_out = e_att * (1.0f - q0);
  // F_ONE_SIDED is bit 0 of kind*1024 + flags: back-face hits die
  if (ep.one_sided && fmodf(kf, 2.0f) >= 1.0f && upd_b > 0.0f) e_out = 0.0f;
  Shaded o;
  o.scat = scat;
  o.ri = nri;
  o.mid = nmid;
  // the reflected branch takes R of the energy left after the medium and
  // the surface (all of it on total internal reflection, R = 1); a lane
  // that scattered before the surface emits none
  o.split = split && !scat;
  o.s_e = o.split ? e_out * r_split : 0.0f;
  o.sdx = srx;
  o.sdy = sry;
  o.sdz = srz;
  if (scat) {
    // the event point, the HG direction, the attenuated energy; no
    // surface absorbs, and the lane keeps its medium and index
    o.px = in.px + free_path * in.dx;
    o.py = in.py + free_path * in.dy;
    o.pz = in.pz + free_path * in.dz;
    o.dx = sdx;
    o.dy = sdy;
    o.dz = sdz;
    o.e = e_att;
    o.absorbed = 0.0f;
    o.ri = ri;
    o.mid = mid;
    return o;
  }
  o.px = hit ? hx : in.px;
  o.py = hit ? hy : in.py;
  o.pz = hit ? hz : in.pz;
  o.dx = hit ? rx : in.dx;
  o.dy = hit ? ry : in.dy;
  o.dz = hit ? rz : in.dz;
  o.e = hit ? e_out - o.s_e : in.e;
  o.absorbed = hit ? e_att - e_out : 0.0f;
  return o;
}

}  // namespace
