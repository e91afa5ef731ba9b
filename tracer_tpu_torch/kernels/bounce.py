"""Fused bounce kernels: wrappers of the CUDA kernels in csrc/bounce.cu and
their plain PyTorch versions.

* :func:`bounce_reflect_culled` (K1) — one round of the relevancy-culled
  trace over ``nb`` tiles of TILE lanes (port of
  tracer_tpu.kernels.pallas_intersect.bounce_reflect_culled_pallas): each
  tile's dead lanes regenerate from its disk or rect source cell, then
  the nearest hit over the tile's candidate rows (every quadric class and
  aperture kind) and the epilogue of every cullable kind: reflect with
  slope error and the one-sided kill, the Lambertian lobe, spectral
  absorptance on a wavelength lane, Beer-Lambert attenuation, Fresnel
  conductors, IAM, and the bifacial rows' backside_miss; with
  ``park_aureole``, the hits of lanes reborn into the sunshape's
  circumsolar aureole come back as encoded sids, -(sid + 16).
* :func:`bounce_reflect` (K2) — one brute-force bounce over all scene
  rows (port of bounce_reflect_pallas, stages a to e): every quadric
  class and aperture kind, reflect with slope error and the one-sided
  kill, the pure-Lambertian lobe, spectral absorptance at each lane's
  wavelength, Beer-Lambert attenuation, refractive interfaces (Fresnel
  roulette, frosted, dispersive) on a per-lane index, Henyey-Greenstein
  scattering in the ambient medium or, with per-lane medium ids, in the
  media that refractive rows bound, the stage (d) kinds (Cook-Torrance,
  Lambertian-specular, semi-Lambertian, transparent) and the stage (e)
  ones (Fresnel conductor, IAM with its exponent c, periodic teleport,
  piecewise Lambertian) alone, in an ambient HG medium or beside
  refraction and media ids, the bifacial rows' backside_miss, energy
  splitting at F_SPLIT interfaces (``refr_split``: the lane crosses and
  the reflected branch leaves through two more outputs), and optional
  regeneration of dead lanes from a disk or rect source. The plain
  streaming megakernel runs it every round, the general streaming path
  every bounce (with ``refr_split`` on a scene with energy-splitting
  interfaces), the culled trace's drain without regeneration.

A wrapper given CPU tensors runs the plain version (``*_ref``); given CUDA
tensors it launches the kernel or raises — it never falls back. Each
wrapper counts its kernel launches in its ``launches`` attribute. The
packed row table and the per-row intersection live in kernels/rows.py,
which K3 (kernels/nearest.py) shares; K2's plain version finds its
winners with K3's.

Both versions draw their uniforms from Philox4x32-10 (kernels/philox.py)
keyed by (round seed, tile stream) and counted by (lane within the tile,
draw call), so on the same inputs they agree lane by lane up to float32
rounding.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .. import geometry as G
from .nearest import (CLASSES, MAX_C, _group_meta as _k3_group_meta,
                      nearest_hit_ref)
from .philox import (CALL_BAND, CALL_BECKMANN, CALL_FRESNEL, CALL_LAMBERT,
                     CALL_PIECEWISE, CALL_REGEN, CALL_SCATTER, CALL_SLOPE,
                     CALL_SPECULAR, uniforms)
from .rows import (ROW_AP, ROW_KIND, ROW_P0, _check, _check_device, _rows_t,
                   pack_rows, row_width)  # noqa: F401 (re-exported)

TILE = 3072            # lanes per tile: one source cell and random stream
K1_SPLIT = 4           # K1's blocks per tile (csrc/bounce.cu), each
K1_RAY_FLOATS = 6 * TILE // K1_SPLIT    # staging its sub-tile's pos, dir
# the most floats a kernel stages in one block's shared memory (H100:
# 227 KB per block, less the culled kernel's row ids)
MAX_STAGE_FLOATS = (232448 - 4096) // 4
POSE_FLOATS = 21       # source pose: centre, position rot, direction rot
_N_COEFFS = 11         # Buie inverse-CDF polynomial, degree 10
SP_ERAY = 13           # source_params slot of the energy per ray
SP_RECT = 33           # source_params slots: has-rect, width, height
SP_DROT = 36           # source_params slots of the direction rotation
_BIVAR_MODE = {False: 0, True: 1, "mixed": 2}
_MODE_FLOATS = ("ambient_att", "ambient_scat", "ambient_g", "iam_c")


def _rect_mask(sig) -> int:
    """Bit c set when aperture slot c is AP_RECT; -1 when a slot holds a
    kind other than AP_RECT or AP_NONE (rows.cuh's rect_mask_of)."""
    if any(k not in (G.AP_NONE, G.AP_RECT) for k in sig):
        return -1
    return sum(1 << c for c, k in enumerate(sig) if k == G.AP_RECT)


@functools.lru_cache(maxsize=64)
def _group_meta(groups, group_offsets, device) -> tuple:
    """K1's (G, 3 + MAX_C) int32 group metadata: column offset of the
    group's candidate segment, rect mask (-1: another aperture kind),
    quadric class, the aperture kind of each constraint slot (AP_NONE past
    the signature); and whether every group is a flat one with rect (or
    no) apertures, which the NSTTF instance serves."""
    meta = []
    for (start, end, sig, tag), off in zip(groups, group_offsets):
        if len(sig) > MAX_C:
            raise NotImplementedError(
                f"{len(sig)} aperture slots > {MAX_C} in the K1 kernel")
        meta.append([off, _rect_mask(sig), CLASSES[tag]] + list(sig)
                    + [G.AP_NONE] * (MAX_C - len(sig)))
    flat_rect = all(tag == "flat" and _rect_mask(sig) >= 0
                    for _, _, sig, tag in groups)
    return torch.tensor(meta, dtype=torch.int32, device=device), flat_rect


def _direction_rot(spec) -> list:
    """Row-major rotation of the directions a spec's rays leave along:
    the rect marker's rays_rot for an oblique rect source, else rot."""
    rect = spec[15] if len(spec) > 15 else None
    drot = spec[3] if rect is None or rect[2] is None else rect[2]
    return [float(v) for v in np.asarray(drot).reshape(9)]


@functools.lru_cache(maxsize=16)
def source_params(spec) -> np.ndarray:
    """The float32 parameter block both versions sample a Buie (or
    pillbox) disk or rect source from (layout in csrc/bounce.cu): centre,
    row-major position rotation, radius, energy per ray, disc_end,
    has-aureole flag, the aureole constants, the 11 inverse-CDF polynomial
    coefficients, has-band, band low, band high, has-rect, width, height
    and the row-major direction rotation (rays_rot for an oblique rect
    source, else the position rotation). A spec whose pose slots hold None
    (engine._spec_frame_split) gets zeros in both rotations and the
    centre: K2 reads the pose from its own operand. The ambient medium
    (attenuation in slot 14, HG scattering in slot 16) is the epilogue's,
    not the sampler's."""
    (cx, cy, cz, rot, radius, e_ray, coeffs, disc_end, gamma, kappa,
     integ_sum, theta_tot, theta_dni) = spec[:13]
    band = spec[13] if len(spec) > 13 else None
    rect = spec[15] if len(spec) > 15 else None
    if len(coeffs) != _N_COEFFS:
        raise ValueError(f"expected {_N_COEFFS} inverse-CDF coefficients")
    c_aur = tt = inv = 0.0
    if gamma is not None:
        c_aur = float((gamma + 2.0) / (10.0 ** (3.0 * gamma)
                                       * float(np.exp(kappa))) * integ_sum
                      - theta_dni ** (gamma + 2.0))
        tt = float(theta_tot ** (gamma + 2.0))
        inv = 1.0 / (gamma + 2.0)
    pose = [0.0] * 12 if cx is None else [cx, cy, cz, *rot]
    drot = [0.0] * 9 if cx is None else _direction_rot(spec)
    lo, hi = (0.0, 0.0) if band is None else band
    w, h = (0.0, 0.0) if rect is None else rect[:2]
    out = np.array([*pose, radius, e_ray, disc_end,
                    0.0 if gamma is None else 1.0, c_aur, tt, inv, *coeffs,
                    0.0 if band is None else 1.0, lo, hi,
                    0.0 if rect is None else 1.0, w, h, *drot],
                   dtype=np.float32)
    out.setflags(write=False)
    return out


def source_pose(spec) -> np.ndarray:
    """(21,) float32 pose of a full spec: centre, row-major position
    rotation, row-major direction rotation (rays_rot for an oblique rect
    source, else the position rotation)."""
    rot = np.asarray(spec[3], dtype=np.float32).reshape(9)
    return np.concatenate([np.asarray(spec[:3], dtype=np.float32), rot,
                           np.asarray(_direction_rot(spec),
                                      dtype=np.float32)])


@functools.lru_cache(maxsize=16)
def _source_tensor(spec, device) -> torch.Tensor:
    return torch.tensor(source_params(spec), device=device)


@functools.lru_cache(maxsize=16)
def _pose_tensor(spec, device) -> torch.Tensor:
    """The spec's own pose on ``device``, uploaded once: a copy from
    pageable host memory on every call would wait for the stream."""
    return torch.tensor(source_pose(spec), device=device)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _nearest_listed(rows, lists, counts, groups, group_offsets, blk, rays,
                    t_eps: float, disc_eps: float, backside_miss: bool):
    """(t, sid, normal, up) of the nearest hit over each lane's tile
    candidate list, one candidate slot at a time (gathers (N, K) rows per
    slot, never an N x L x K tensor): the winner's unnormalised global
    gradient (R e_z for a flat row) and its local d_z."""
    t_best = torch.full_like(rays[0], math.inf)
    sid = torch.full(rays[0].shape, -1, dtype=torch.int32,
                     device=rays[0].device)
    best = [torch.zeros_like(t_best) for _ in range(4)]
    for g, ((_, _, sig, tag), off) in enumerate(zip(groups, group_offsets)):
        cnt = counts[blk, g]
        for i in range(int(counts[:, g].max()) if counts.numel() else 0):
            s = lists[blk, off + i]
            r = rows[s.clamp(min=0).long()].T      # (K, N)
            t, _, grad, up = _rows_t(r, tag, sig, rays, t_eps, disc_eps,
                                     backside_miss)
            upd = (i < cnt) & (t < t_best)
            t_best = torch.where(upd, t, t_best)
            sid = torch.where(upd, s, sid)
            best = [torch.where(upd, a, b)
                    for a, b in zip((*grad, up), best)]
    return t_best, sid, best[:3], best[3]


def _rot_about(ax, ay, az, ex, ey, ez):
    pn = torch.sqrt(torch.clamp(ax * ax + ay * ay, min=1e-30))
    sing = pn < 1e-6
    perp_x = torch.where(sing, 1.0, ay / pn)
    perp_y = torch.where(sing, 0.0, -ax / pn)
    yc_x = -az * perp_y
    yc_y = az * perp_x
    yc_z = ax * perp_y - ay * perp_x
    mx = ex * perp_x + ey * yc_x + ez * ax
    my = ex * perp_y + ey * yc_y + ez * ay
    mz = ey * yc_z + ez * az
    mr = torch.rsqrt(torch.clamp(mx * mx + my * my + mz * mz, min=1e-30))
    return mx * mr, my * mr, mz * mr


def _interp_row_table(wl, start, length, tab):
    """Piecewise-linear value at each lane's wavelength of its table chunk
    [start, start + length) of the (L, 2) (wavelength, absorptance) table,
    clamped to the chunk's edge values (pallas_intersect
    ._interp_row_table); ``start`` and ``length`` are per-lane int64."""
    x, y = tab[:, 0], tab[:, 1]
    n = x.shape[0]
    lo = start.clamp(0, n - 1)
    hi = (start + length - 1).clamp(0, n - 1)
    acc = torch.where(wl < x[lo], y[lo], torch.where(wl >= x[hi], y[hi], 0.0))
    for k in range(n - 1):
        x0, x1, y0, y1 = x[k], x[k + 1], y[k], y[k + 1]
        m = (k >= lo) & (k < hi) & (wl >= x0) & (wl < x1)
        w = (wl - x0) / torch.where(x1 == x0, 1.0, x1 - x0)
        acc = torch.where(m, y0 + torch.clamp(w, 0.0, 1.0) * (y1 - y0), acc)
    return acc


def _interp2_row_table(th, wl, th_start, T, wl_start, W, grid_start, tab,
                       on):
    """Bilinear value at each lane's (th, wl) of its (T, W) grid in the
    table (pallas_intersect._interp2_row_table, the kernels'
    interp2_row): axis values in the first column at [th_start, th_start
    + T) and [wl_start, wl_start + W), the grid row-major in the second
    column from grid_start; queries clamp to the grid's edges. Starts and
    lengths are per-lane int64; lanes outside ``on`` get 0."""
    x, y = tab[:, 0], tab[:, 1]
    last = x.shape[0] - 1
    acc = torch.zeros_like(th)
    if not bool(on.any()):
        return acc
    T, W = torch.where(on, T, 0), torch.where(on, W, 0)

    def xs(k):
        return x[k.clamp(0, last)]

    def ys(k):
        return y[k.clamp(0, last)]
    th_hi, wl_hi = xs(th_start + T - 1), xs(wl_start + W - 1)
    th_q = torch.minimum(torch.maximum(th, xs(th_start)), th_hi)
    wl_q = torch.minimum(torch.maximum(wl, xs(wl_start)), wl_hi)
    for i in range(int(T.max()) - 1):
        tx0, tx1 = xs(th_start + i), xs(th_start + i + 1)
        m_th = (on & (i < T - 1) & (th_q >= tx0)
                & ((th_q < tx1) | ((tx1 == th_hi) & (th_q <= tx1))))
        wt = torch.clamp((th_q - tx0) / torch.where(tx1 == tx0, 1.0,
                                                    tx1 - tx0), 0.0, 1.0)
        base = grid_start + i * W
        for j in range(int(W.max()) - 1):
            wx0, wx1 = xs(wl_start + j), xs(wl_start + j + 1)
            m = (m_th & (j < W - 1) & (wl_q >= wx0)
                 & ((wl_q < wx1) | ((wx1 == wl_hi) & (wl_q <= wx1))))
            ww = torch.clamp((wl_q - wx0) / torch.where(wx1 == wx0, 1.0,
                                                        wx1 - wx0), 0.0, 1.0)
            val = ((1.0 - wt) * ((1.0 - ww) * ys(base + j)
                                 + ww * ys(base + j + 1))
                   + wt * ((1.0 - ww) * ys(base + W + j)
                           + ww * ys(base + W + j + 1)))
            acc = acc + torch.where(m, val, 0.0)
    return acc


def _conductor_r(c, n1, n2, k2):
    """Randomly polarized conductor Fresnel reflectance at the incidence
    cosine ``c`` from index n1 onto n2 + i k2 (the kernels'
    conductor_r)."""
    s1sq = n1 * n1 * (1.0 - c * c)
    bq = n2 * n2 - k2 * k2 - s1sq
    nk = n2 * k2
    aq = torch.sqrt(bq * bq + 4.0 * nk * nk)
    pq = torch.sqrt(torch.clamp(0.5 * (aq + bq), min=0.0))
    qq = torch.sqrt(torch.clamp(0.5 * (aq - bq), min=0.0))
    c1 = n1 * c
    rs = ((c1 - pq) * (c1 - pq) + qq * qq) / ((c1 + pq) * (c1 + pq) + qq * qq)
    st = s1sq / c1
    rp = ((pq - st) * (pq - st) + qq * qq) / ((pq + st) * (pq + st)
                                              + qq * qq) * rs
    return 0.5 * (rp + rs)


# the switches of K2's stage (d) and (e) kinds (bounce_reflect_pallas's
# names), each False by default; ``iam`` is False or the scene's exponent c
EXTRA_MODES = ("cook_torrance", "lam_specular", "semi_lambertian",
               "transparent", "conductor", "iam", "periodic", "piecewise")


def _extra_q(w, hit, kind, normal, dirs, wl, spectral_tab,
             conductor: bool, piecewise: bool):
    """The winner's q2 and q3 of the stage (d)/(e) kinds (the kernels'
    four-parameter carry): p2 and p3, a conductor's n2(wl) and k2(wl), a
    piecewise row's absorptance and specular probability at the incidence
    angle on its own normal."""
    zero = torch.zeros_like(kind)
    q2 = torch.where(hit, w[:, ROW_P0 + 2], zero)
    q3 = torch.where(hit, w[:, ROW_P0 + 3], zero)
    wl_c = wl if wl is not None else zero
    if conductor:
        fc = kind == 10.0
        st, ln = w[:, ROW_P0 + 1].long(), w[:, ROW_P0 + 2].long()
        q2 = torch.where(fc, _interp_row_table(wl_c, st, ln, spectral_tab),
                         q2)
        q3 = torch.where(fc, _interp_row_table(wl_c, st + ln, ln,
                                               spectral_tab), q3)
    if piecewise:
        pw = kind == 11.0
        ngx, ngy, ngz = normal
        dx, dy, dz = dirs
        gn = torch.rsqrt(torch.clamp(ngx * ngx + ngy * ngy + ngz * ngz,
                                     min=1e-30))
        cosc = torch.clamp((dx * ngx + dy * ngy + dz * ngz).abs() * gn,
                           0.0, 1.0)
        th = torch.acos(cosc)
        th_st, ln, n_wl = (w[:, ROW_P0 + k].long() for k in (0, 1, 5))
        two = pw & (n_wl > 0)
        ab = torch.where(two, _interp2_row_table(
            th, wl_c, th_st, ln, w[:, ROW_P0 + 4].long(), n_wl,
            w[:, ROW_P0 + 6].long(), spectral_tab, two),
            _interp_row_table(th, th_st, ln, spectral_tab))
        p3 = w[:, ROW_P0 + 3]
        spec = torch.where(p3 >= 0.0, _interp_row_table(
            th, p3.long(), ln, spectral_tab), w[:, ROW_P0 + 2])
        q2 = torch.where(pw, ab, q2)
        q3 = torch.where(pw, spec, q3)
    return q2, q3


def _shade(rows, t_b, sid_b, normal, up, rays, e_in, wl, seed: int, stream,
           lane, bivar, one_sided: bool, slope: bool,
           lambertian: bool = False, spectral_tab=None,
           ambient_att: float = 0.0, ri=None, mid=None, media=None,
           refr_frost: bool = False, refr_disp: bool = False,
           ambient_scat: float = 0.0, ambient_g: float = 0.0,
           refr_split: bool = False, **extra):
    """The shade epilogue both kernels share, on each lane's winner row
    with its carried (unnormalised) normal and local d_z: reflect, slope
    error, the one-sided kill, the Lambertian lobe, spectral absorptance
    (with a wavelength lane ``wl`` and ``spectral_tab``), attenuation of
    the travelled segment, and with the lanes' index ``ri`` the
    refractive interfaces (roulette, frosted, dispersive with
    ``refr_disp``), a participating medium's HG scattering (the
    ambient's, or with ``mid`` and ``media`` the lane's own), the media
    ids, and the stage (d)/(e) kinds switched on in ``extra``
    (EXTRA_MODES; the conductor and piecewise rows read ``spectral_tab``
    at ``wl``, or at 0 without a lane); with ``refr_split`` the F_SPLIT
    refractive rows split the energy instead of the roulette. Returns
    (pos, dir, energy, absorbed, ri, mid, scattered, split) before the
    live-lane masking (None for the modes that are off); ``split`` is
    (the reflected branch's energy, the lanes that split, its three
    direction components)."""
    px, py, pz, dx, dy, dz = rays
    hit = sid_b >= 0
    w = rows[sid_b.clamp(min=0).long()]
    zero = torch.zeros_like(px)
    ngx, ngy, ngz = (torch.where(hit, g, zero) for g in normal)
    upd_b = torch.where(hit, up, zero)
    kf, q0, q1, q2 = (torch.where(hit, w[:, k], zero)
                      for k in (ROW_KIND, ROW_P0, ROW_P0 + 1, ROW_P0 + 2))
    kind = torch.floor(kf * (1.0 / 1024.0))
    x = {k: extra.get(k, False) for k in EXTRA_MODES}
    if any(x.values()):
        q2, q3 = _extra_q(w, hit, kind, (ngx, ngy, ngz), (dx, dy, dz), wl,
                          spectral_tab, x["conductor"], x["piecewise"])
    if spectral_tab is not None and wl is not None:
        # K_REFLECT_SPECTRAL: p0/p1 are the table chunk, sigma is p2
        spec = kind == 5.0
        q0 = torch.where(spec, _interp_row_table(
            wl, w[:, ROW_P0].long(), w[:, ROW_P0 + 1].long(), spectral_tab),
            q0)
        q1 = torch.where(spec, w[:, ROW_P0 + 2], q1)
    refractive = ri is not None
    is_refr = kind == 6.0
    if refractive and refr_disp:
        # dispersive K_REFRACTIVE rows: n1(wl) and n2(wl) from the table
        # chunks [p3, p3 + p4) and [p3 + p4, p3 + p4 + p5)
        rd = is_refr & (w[:, ROW_P0 + 5] > 0.0)
        st, l1, l2 = (w[:, ROW_P0 + k].long() for k in (3, 4, 5))
        q0 = torch.where(rd, _interp_row_table(wl, st, l1, spectral_tab), q0)
        q1 = torch.where(rd, _interp_row_table(wl, st + l1, l2,
                                               spectral_tab), q1)
    t_safe = torch.where(hit, t_b, zero)
    hx, hy, hz = px + t_safe * dx, py + t_safe * dy, pz + t_safe * dz
    rinv = torch.rsqrt(torch.clamp(ngx * ngx + ngy * ngy + ngz * ngz,
                                   min=1e-30))
    flip = torch.where(dx * ngx + dy * ngy + dz * ngz > 0.0, -rinv, rinv)
    n0x, n0y, n0z = ngx * flip, ngy * flip, ngz * flip
    nx, ny, nz = n0x, n0y, n0z
    # the lane's medium: attenuation on every segment it travels, and a
    # free path that preempts the surface when it is shorter
    att_on, scat_on = (media_flags(media) if media is not None
                       else (ambient_att > 0.0, ambient_scat > 0.0))
    if media is not None:
        tab = _media_tensors(media, rows.shape[0], px.device)[0]
        m_att, m_scat, m_g = tab[mid.long()].unbind(1)
    elif att_on or scat_on:
        m_att, m_scat, m_g = (torch.full_like(px, v) for v in (
            ambient_att, ambient_scat, ambient_g))
    scat = None
    if scat_on:
        u_f, u_s, u_p, _ = uniforms(seed, stream, lane, CALL_SCATTER)
        logu = -torch.log(torch.clamp(u_f, min=1e-12))
        able = m_scat > 0.0
        free = torch.where(able, logu / torch.where(able, m_scat, 1.0),
                           math.inf)
        # a miss has t_b = inf: a would-be escape scatters too
        scat = free < t_b
        # Henyey-Greenstein polar angle about the travel direction
        sg = 2.0 * u_s - 1.0
        iso = m_g.abs() < 1e-9
        frac = (1.0 - m_g * m_g) / (1.0 + m_g * sg)
        cos_sc = torch.where(iso, sg, torch.clamp(
            (1.0 + m_g * m_g - frac * frac)
            * (0.5 / torch.where(iso, 1.0, m_g)), -1.0, 1.0))
        sin_sc = torch.sqrt(torch.clamp(1.0 - cos_sc * cos_sc, min=0.0))
        a_sp = (2.0 * math.pi) * u_p
        sdir = _rot_about(dx, dy, dz, sin_sc * torch.cos(a_sp),
                          sin_sc * torch.sin(a_sp), cos_sc)
    if slope:
        u1, u2, u3, _ = uniforms(seed, stream, lane, CALL_SLOPE)
        rr = torch.sqrt(-2.0 * torch.log(u1))
        a_bm = (2.0 * math.pi) * u2
        nrm1 = rr * torch.cos(a_bm)
        # Lambertian rows carry ang_range in q1, not a slope sigma;
        # refractive rows carry n2 there, and a frosted one its sigma in p2
        sigma = torch.where(kind == 2.0, 0.0, q1) if lambertian else q1
        if refractive:
            sigma = torch.where(is_refr, q2 if refr_frost else 0.0, sigma)
        if any(x.values()):
            # Cook-Torrance, semi-Lambertian, conductor and piecewise rows
            # reflect without slope error; a Lambertian-specular row's
            # sigma is its q2
            flat = torch.zeros_like(hit)
            for name, k in (("cook_torrance", 9.0), ("semi_lambertian", 4.0),
                            ("conductor", 10.0), ("piecewise", 11.0)):
                if x[name]:
                    flat = flat | (kind == k)
            sigma = torch.where(flat, 0.0, sigma)
            if x["lam_specular"]:
                sigma = torch.where(kind == 3.0, q2, sigma)
        mode = _BIVAR_MODE[bivar]
        if mode:
            tx = torch.clamp(torch.sin(nrm1 * sigma) / torch.cos(nrm1 * sigma),
                             -1e6, 1e6)
            nrm2s = rr * torch.sin(a_bm) * sigma
            ty = torch.clamp(torch.sin(nrm2s) / torch.cos(nrm2s), -1e6, 1e6)
            bvz = torch.rsqrt(1.0 + tx * tx + ty * ty)
            ex, ey, ez = tx * bvz, ty * bvz, bvz
        if mode != 1:
            th = nrm1 * sigma
            a_ph = (2.0 * math.pi) * u3
            rdx = torch.sin(th) * torch.cos(a_ph)
            rdy = torch.sin(th) * torch.sin(a_ph)
            rdz = torch.cos(th)
            if mode == 2:
                is_bv = torch.fmod(kf, 4.0) >= 2.0
                ex = torch.where(is_bv, ex, rdx)
                ey = torch.where(is_bv, ey, rdy)
                ez = torch.where(is_bv, ez, rdz)
            else:
                ex, ey, ez = rdx, rdy, rdz
        nx, ny, nz = _rot_about(nx, ny, nz, ex, ey, ez)
    dn = dx * nx + dy * ny + dz * nz
    rx, ry, rz = dx - 2.0 * dn * nx, dy - 2.0 * dn * ny, dz - 2.0 * dn * nz
    nri, nmid = ri, mid
    if refractive:
        # K_REFRACTIVE: the side whose index is nearest the lane's is the
        # one it comes from; Snell about the (frosted: perturbed) flipped
        # normal, unpolarized Fresnel R (1 on total internal reflection),
        # reflect when u <= R, no interface absorption
        in1 = (ri - q0).abs() <= (ri - q1).abs()
        if media is not None:
            # index-matched interfaces toggle by the lane's medium id
            side = _media_tensors(media, rows.shape[0], px.device)[1]
            mid1, mid2 = torch.where(hit[:, None], side[sid_b.clamp(
                min=0).long()], 0.0).unbind(1)
            in1 = torch.where((q0 - q1).abs() > 1e-9, in1, mid == mid1)
        n_next = torch.where(in1, q1, q0)
        safe_ri = torch.where(ri == 0.0, 1.0, ri)
        safe_nx = torch.where(n_next == 0.0, 1.0, n_next)
        nrat = safe_nx / safe_ri
        c1 = dn
        refr_ok = c1 * c1 >= 1.0 - nrat * nrat
        inv_nr = 1.0 / nrat
        cos2 = torch.sqrt(torch.clamp(
            1.0 - (1.0 - c1 * c1) * inv_nr * inv_nr, min=0.0))
        sgn = torch.where(c1 < 0.0, -1.0, 1.0)
        tdx = (dx - c1 * nx) * inv_nr + nx * cos2 * sgn
        tdy = (dy - c1 * ny) * inv_nr + ny * cos2 * sgn
        tdz = (dz - c1 * nz) * inv_nr + nz * cos2 * sgn
        cos1a = c1.abs()
        ratio = safe_ri / safe_nx
        under = 1.0 - ratio * ratio * (1.0 - cos1a * cos1a)
        bar = torch.sqrt(torch.clamp(under, min=0.0))
        rs = ((safe_ri * cos1a - safe_nx * bar)
              / (safe_ri * cos1a + safe_nx * bar))
        rp = ((safe_ri * bar - safe_nx * cos1a)
              / (safe_ri * bar + safe_nx * cos1a))
        R = torch.where(refr_ok & (under >= 0.0), 0.5 * (rs * rs + rp * rp),
                        1.0)
        u_r = uniforms(seed, stream, lane, CALL_FRESNEL)[0]
        go_reflect = u_r <= R
        if refr_split:
            # F_SPLIT rows (flags bit 3) always cross; the reflected
            # direction is saved before the crossing replaces it
            split_b = is_refr & hit & (torch.fmod(kf, 16.0) >= 8.0)
            s_rd = (rx, ry, rz)
            r_split = torch.where(split_b, R, 0.0)
            go_reflect = go_reflect & ~split_b
        crossed = is_refr & hit & ~go_reflect
        rx = torch.where(crossed, tdx, rx)
        ry = torch.where(crossed, tdy, ry)
        rz = torch.where(crossed, tdz, rz)
        nri = torch.where(crossed, n_next, ri)
        if media is not None:
            nmid = torch.where(crossed, torch.where(in1, mid2, mid1), mid)
        q0 = torch.where(is_refr, 0.0, q0)
    if any(x.values()):
        (rx, ry, rz), q0, (hx, hy, hz) = _stage_d_e_shade(
            x, lambertian, hit, kind, kf, q0, q1, q2, q3, (n0x, n0y, n0z),
            (dx, dy, dz), (rx, ry, rz), (hx, hy, hz), seed, stream, lane)
    elif lambertian:
        # K_LAMBERTIAN: cosine-weighted about the unperturbed normal
        # within ang_range (q1)
        ld = _lobe(seed, stream, lane, torch.sin(q1), (n0x, n0y, n0z))
        lam = kind == 2.0
        rx, ry, rz = (torch.where(lam, a, b) for a, b in zip(ld, (rx, ry, rz)))
    # the medium takes its share of the travelled segment first (up to the
    # scattering event, else the hit); escaping lanes keep their energy
    e_att = e_in
    if att_on:
        travel, on = t_safe, hit
        if scat is not None:
            travel, on = torch.where(scat, free, t_safe), hit | scat
        e_att = torch.where(on, e_in * torch.exp(-m_att * travel), e_in)
    e_out = e_att * (1.0 - q0)
    if one_sided:
        kill = (torch.fmod(kf, 2.0) >= 1.0) & (upd_b > 0.0)
        e_out = torch.where(kill, 0.0, e_out)
    npos = [torch.where(hit, h, p) for h, p in ((hx, px), (hy, py), (hz, pz))]
    ndir = [torch.where(hit, r, d) for r, d in ((rx, dx), (ry, dy), (rz, dz))]
    ne = torch.where(hit, e_out, e_in)
    absorbed = torch.where(hit, e_att - e_out, zero)
    if scat is not None:
        # scattering preempts the surface: the lane moves to the event
        # point, takes the HG direction, keeps its attenuated energy and
        # its medium and index
        npos = [torch.where(scat, p + free * d, q)
                for p, d, q in zip((px, py, pz), (dx, dy, dz), npos)]
        ndir = [torch.where(scat, s, q) for s, q in zip(sdir, ndir)]
        ne = torch.where(scat, e_att, ne)
        absorbed = torch.where(scat, 0.0, absorbed)
        if refractive:
            nri = torch.where(scat, ri, nri)
        if media is not None:
            nmid = torch.where(scat, mid, nmid)
    split = None
    if refr_split:
        # the reflected branch takes R of the energy left after the medium
        # and the surface (all of it on total internal reflection); a lane
        # that scattered before the surface emits none
        on = split_b if scat is None else split_b & ~scat
        s_e = torch.where(on, ne * r_split, 0.0)
        ne = ne - s_e
        split = (s_e, on, s_rd)
    return (torch.stack(npos, dim=1), torch.stack(ndir, dim=1), ne, absorbed,
            nri, nmid, scat, split)


def _lobe(seed: int, stream, lane, sin_cap, n0):
    """Cosine-weighted directions about the unit normal ``n0`` within
    the cap whose sine is ``sin_cap`` (Philox call 2)."""
    ul1, ul2, _, _ = uniforms(seed, stream, lane, CALL_LAMBERT)
    sinsq = sin_cap * torch.sqrt(ul1)
    a_pl = (2.0 * math.pi) * ul2
    lz = torch.sqrt(torch.clamp(1.0 - sinsq * sinsq, min=0.0))
    return _rot_about(*n0, sinsq * torch.cos(a_pl), sinsq * torch.sin(a_pl),
                      lz)


def _stage_d_e_shade(x, lambertian: bool, hit, kind, kf, q0, q1, q2, q3,
                     n0, d, r, h, seed: int, stream, lane):
    """The epilogue's stage (d) and (e) branches on the switches ``x``
    (EXTRA_MODES), in the kernels' order: Cook-Torrance, conductor,
    piecewise absorptance, IAM, the diffuse lobes (with the Lambertian
    one), transparent and periodic rows. Returns the outgoing direction,
    the effective absorptance and the hit point."""
    n0x, n0y, n0z = n0
    dx, dy, dz = d
    rx, ry, rz = r
    hx, hy, hz = h
    cos_n = dx * n0x + dy * n0y + dz * n0z
    period = q0
    if x["cook_torrance"]:
        # Beckmann half-vector about n0, reflection about it, weight
        # R_lam F G |d.h| / (|n.d| |n.h|) clipped to [0, 1]; absorbed below
        # the surface (alpha q0, m_n q1, m_k q2, R_lam q3)
        ct = kind == 9.0
        u1, u2, _, _ = uniforms(seed, stream, lane, CALL_BECKMANN)
        tan2 = -q0 * q0 * torch.log(u1)
        cos_h = torch.rsqrt(1.0 + tan2)
        sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
        a_pc = (2.0 * math.pi) * u2
        hv = _rot_about(n0x, n0y, n0z, sin_h * torch.cos(a_pc),
                        sin_h * torch.sin(a_pc), cos_h)
        d_h = dx * hv[0] + dy * hv[1] + dz * hv[2]
        cd = [a - 2.0 * d_h * b for a, b in zip(d, hv)]
        v_dot_h = d_h.abs()
        n_dot_v = torch.clamp(cos_n.abs(), min=1e-6)
        n_dot_h = torch.clamp((hv[0] * n0x + hv[1] * n0y + hv[2] * n0z).abs(),
                              min=1e-6)
        n_dot_l = cd[0] * n0x + cd[1] * n0y + cd[2] * n0z
        f = _conductor_r(torch.clamp(v_dot_h, 1e-6, 1.0), 1.0, q1, q2)
        vh_s = torch.clamp(v_dot_h, min=1e-6)
        g = torch.clamp(torch.minimum(2.0 * n_dot_h * n_dot_v / vh_s,
                                      2.0 * n_dot_h * n_dot_l.abs() / vh_s),
                        max=1.0)
        w_ct = q3 * f * g * v_dot_h / (n_dot_v * n_dot_h)
        w_ct = torch.where(n_dot_l > 0.0, torch.clamp(w_ct, 0.0, 1.0), 0.0)
        rx, ry, rz = (torch.where(ct, a, b) for a, b in zip(cd, (rx, ry, rz)))
        q0 = torch.where(ct, 1.0 - w_ct, q0)
    if x["conductor"]:
        # specular, absorbs 1 - R(n1 = q0 or 1 onto q2 + i q3)
        r_c = _conductor_r(torch.clamp(cos_n.abs(), 1e-6, 1.0),
                           torch.where(q0 > 0.0, q0, 1.0), q2, q3)
        q0 = torch.where(kind == 10.0, 1.0 - torch.clamp(r_c, 0.0, 1.0), q0)
    if x["piecewise"]:
        q0 = torch.where(kind == 11.0, q2, q0)
    if x["iam"]:
        # the Martin-Ruiz modifier on F_IAM rows (bit 2), a_r in q2 (q3 on
        # Lambertian-specular rows), cos^c as exp(c log cos)
        c = 1.0 if x["iam"] is True else float(x["iam"])
        cosi = cos_n.abs()
        if c != 1.0:
            cosi = torch.exp(c * torch.log(torch.clamp(cosi, min=1e-30)))
        a_raw = torch.where(kind == 3.0, q3, q2) if x["lam_specular"] else q2
        a_r = torch.where(a_raw > 0.0, a_raw, 1.0)
        f_iam = (1.0 - torch.exp(-cosi / a_r)) / (1.0 - torch.exp(-1.0 / a_r))
        q0 = torch.where(torch.fmod(kf, 8.0) >= 4.0, q0 * f_iam, q0)
    # the diffuse lobes about the unperturbed normal
    lam_k = (kind == 2.0) & lambertian
    ls_k = (kind == 3.0) & x["lam_specular"]
    sl_k = (kind == 4.0) & x["semi_lambertian"]
    pw_k = (kind == 11.0) & x["piecewise"]
    if lambertian or x["lam_specular"] or x["semi_lambertian"] \
            or x["piecewise"]:
        sin_cap = torch.where(ls_k | pw_k, 1.0, torch.sin(q1))
        go = lam_k | (sl_k & (cos_n.abs() >= torch.cos(q1)))
        if x["lam_specular"]:
            u_ch = uniforms(seed, stream, lane, CALL_SPECULAR)[0]
            go = go | (ls_k & (u_ch >= q1))
        if x["piecewise"]:
            u_pw = uniforms(seed, stream, lane, CALL_PIECEWISE)[0]
            go = go | (pw_k & (u_pw >= q3))
        ld = _lobe(seed, stream, lane, sin_cap, n0)
        rx, ry, rz = (torch.where(go, a, b) for a, b in zip(ld, (rx, ry, rz)))
    through = torch.zeros_like(hit)
    if x["transparent"]:
        through = hit & (kind == 0.0)
    if x["periodic"]:
        # teleport by the signed period along n0, absorbing nothing
        pd = kind == 7.0
        through = through | pd
        hx, hy, hz = (torch.where(pd, a + period * n, a)
                      for a, n in zip((hx, hy, hz), n0))
        q0 = torch.where(pd, 0.0, q0)
    rx, ry, rz = (torch.where(through, a, b) for a, b in zip(d, (rx, ry, rz)))
    return (rx, ry, rz), q0, (hx, hy, hz)


def _buie_theta(p, u):
    """Buie (or pillbox) polar angle from u: the inverse-CDF polynomial
    of the disc, then the aureole past disc_end (the kernels'
    buie_theta); ``p`` is source_params as Python floats."""
    disc_end, has_gamma, c_aur, tt, inv = p[14:19]
    coeffs = p[19:19 + _N_COEFFS]
    uq = torch.clamp(u / disc_end, max=1.0)
    acc = torch.full_like(uq, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * uq + c
    theta = torch.sqrt(uq) * acc
    if has_gamma:
        base = (u - 1.0) * c_aur + u * tt
        th_aur = torch.exp(torch.log(torch.clamp(base, min=1e-30)) * inv)
        theta = torch.where(u >= disc_end, th_aur, theta)
    return theta


def _source_ray(p, centre, rot, drot, lx, ly, u3, u4, seed: int, stream,
                lane):
    """The fresh ray at local source point (lx, ly): positions in the
    ``rot`` frame about ``centre``, Buie (or pillbox) directions about
    ``drot``'s +z, and the wavelength uniform in the band (None without
    one). Returns six ray components and the wavelength."""
    fp = [rot[3 * i] * lx + rot[3 * i + 1] * ly + centre[i]
          for i in range(3)]
    theta = _buie_theta(p, u3)
    a_d = (2.0 * math.pi) * u4
    ax = torch.sin(theta) * torch.cos(a_d)
    ay = torch.sin(theta) * torch.sin(a_d)
    az = torch.cos(theta)
    fd = [drot[3 * i] * ax + drot[3 * i + 1] * ay + drot[3 * i + 2] * az
          for i in range(3)]
    wl = None
    if p[30]:
        ub = uniforms(seed, stream, lane, CALL_BAND)[0]
        wl = p[31] + ub * (p[32] - p[31])
    return fp + fd + [wl]


def _sample_cell(spec, seed: int, stream, lane, cb):
    """Fresh rays from each lane's equal-area source cell (the kernels'
    sample_cell): a Buie disk cell [a0, a1, th0, th1] (area fractions,
    angles) or a rect cell [x0, x1, y0, y1] (local metres). Six ray
    components, the wavelength (None without a band) and whether the
    polar angle fell in the circumsolar aureole (u3 >= disc_end, never
    without one)."""
    p = [float(v) for v in source_params(spec)]
    u1, u2, u3, u4 = uniforms(seed, stream, lane, CALL_REGEN)
    c0, c1, c2, c3 = cb.unbind(1)
    if p[SP_RECT]:
        lx = c0 + u1 * (c1 - c0)
        ly = c2 + u2 * (c3 - c2)
    else:
        rr = p[12] * torch.sqrt(c0 + u1 * (c1 - c0))
        ang = c2 + u2 * (c3 - c2)
        lx, ly = rr * torch.cos(ang), rr * torch.sin(ang)
    aureole = ((u3 >= p[14]) if p[15]
               else torch.zeros_like(u3, dtype=torch.bool))
    return _source_ray(p, p[0:3], p[3:12], p[SP_DROT:SP_DROT + 9], lx, ly,
                       u3, u4, seed, stream, lane) + [aureole]


def _sample_disk(spec, pose, seed: int, stream, lane):
    """Fresh rays from the whole disk or rect source at the (21,)
    ``pose`` (the kernels' sample_disk): six ray components and the
    wavelength (None without a band)."""
    p = [float(v) for v in source_params(spec)]
    f = [float(v) for v in pose]
    u1, u2, u3, u4 = uniforms(seed, stream, lane, CALL_REGEN)
    if p[SP_RECT]:
        lx = (u1 - 0.5) * p[SP_RECT + 1]
        ly = (u2 - 0.5) * p[SP_RECT + 2]
    else:
        rr = p[12] * torch.sqrt(u1)
        a_v = (2.0 * math.pi) * u2
        lx, ly = rr * torch.cos(a_v), rr * torch.sin(a_v)
    return _source_ray(p, f[0:3], f[3:12], f[12:21], lx, ly, u3, u4, seed,
                       stream, lane)


# the switches of K1's epilogue (bounce_reflect_culled_pallas's names), of
# its candidate loop and of its sid store, each False by default; ``iam``
# is False or the scene's exponent c
CULLED_MODES = ("lambertian", "ambient_att", "conductor", "iam",
                "backside_miss", "park_aureole")


def _check_culled_modes(wavelength, spectral_tab, modes):
    if set(modes) - set(CULLED_MODES):
        raise TypeError(f"unknown K1 modes "
                        f"{sorted(set(modes) - set(CULLED_MODES))}")
    if wavelength is not None and spectral_tab is None:
        raise ValueError("a wavelength lane needs the spectral_tab")
    if modes.get("conductor") and spectral_tab is None:
        raise ValueError("conductor rows read the spectral_tab")


def bounce_reflect_culled_ref(rows, lists, counts, cells, cell_bounds,
                              seed: int, remaining, active, pos, dirs,
                              energy, groups, group_offsets, t_eps: float,
                              bivar=True, one_sided: bool = True,
                              slope: bool = True, source_spec=None,
                              wavelength=None, spectral_tab=None,
                              disc_eps: float = 1e-6, **modes):
    """Plain PyTorch version of :func:`bounce_reflect_culled`."""
    _check_culled_modes(wavelength, spectral_tab, modes)
    n, nb = pos.shape[0], lists.shape[0]
    dev = pos.device
    idx = torch.arange(n, device=dev)
    blk, lane = idx // TILE, idx % TILE
    act = (active != 0)[blk]
    dead = energy <= 0.0
    d_t = dead.view(nb, TILE).to(torch.int32)
    rank = (torch.cumsum(d_t, dim=1) - d_t).view(n)       # exclusive
    rays = list(pos.unbind(1)) + list(dirs.unbind(1))
    e, wl = energy, wavelength
    stream = cells[blk]
    aureole = torch.zeros_like(dead)
    if source_spec is not None:
        do = dead & act & (rank < remaining[blk])
        fresh = _sample_cell(source_spec, seed, stream, lane,
                             cell_bounds[blk])
        rays = [torch.where(do, f, r) for f, r in zip(fresh, rays)]
        e = torch.where(do, float(source_params(source_spec)[SP_ERAY]), e)
        if wl is not None and fresh[6] is not None:
            wl = torch.where(do, fresh[6], wl)
        if modes.get("park_aureole"):
            aureole = do & fresh[7]
    t_b, sid_b, normal, up = _nearest_listed(
        rows, lists, counts, groups, group_offsets, blk, rays, t_eps,
        disc_eps, modes.get("backside_miss", False))
    extra = {k: modes[k] for k in ("conductor", "iam") if k in modes}
    npos, ndir, ne, absorbed = _shade(
        rows, t_b, sid_b, normal, up, rays, e, wl, seed, stream, lane, bivar,
        one_sided, slope, lambertian=modes.get("lambertian", False),
        spectral_tab=spectral_tab,
        ambient_att=modes.get("ambient_att", 0.0), **extra)[:4]
    live = e > 0.0
    sid = torch.where(live & (sid_b >= 0), sid_b, -1)
    # a hit of a lane reborn into the aureole: the engine decodes it and
    # parks the survivor
    sid = torch.where(aureole & (sid >= 0), -sid - 16, sid)
    absorbed = torch.where(live, absorbed, 0.0)
    # idle tiles pass their state through
    npos = torch.where(act[:, None], npos, pos)
    ndir = torch.where(act[:, None], ndir, dirs)
    ne = torch.where(act, ne, energy)
    sid = torch.where(act, sid, -1).to(torch.int32)
    absorbed = torch.where(act, absorbed, 0.0)
    out = (npos, ndir, ne, sid, absorbed)
    if wavelength is not None:
        out = out + (torch.where(act, wl, wavelength),)
    return out


def media_flags(media):
    """(any attenuation, any scattering) of a static media pair
    (tracer_tpu's pallas_intersect.media_flags)."""
    if media is None:
        return False, False
    return (any(a > 0.0 for a, _, _ in media[0]),
            any(s > 0.0 for _, s, _ in media[0]))


@functools.lru_cache(maxsize=16)
def _media_tensors(media, n_rows: int, device):
    """The static media pair ``(media_tab, media_rows)`` as K2 reads it:
    (M, 3) float32 (att, scat, g) of each medium id, and a dense (S, 2)
    float32 map of each row's side-1 and side-2 ids (0 off the
    K_REFRACTIVE rows)."""
    tab = torch.tensor(media[0], dtype=torch.float32).reshape(-1, 3)
    side = torch.zeros((n_rows, 2), dtype=torch.float32)
    for s, i1, i2 in media[1]:
        side[s, 0], side[s, 1] = float(i1), float(i2)
    return tab.to(device), side.to(device)


def _check_modes(source_spec, regen, wavelength, spectral_tab, src_frame,
                 ref_index=None, refr_disp=False, medium_id=None, media=None,
                 refr_split=False, extra=None, ambient_scat=0.0):
    extra = extra or {}
    if set(extra) - set(EXTRA_MODES):
        raise TypeError(f"unknown K2 modes "
                        f"{sorted(set(extra) - set(EXTRA_MODES))}")
    if (extra.get("conductor") or extra.get("piecewise")) \
            and spectral_tab is None:
        raise ValueError("conductor and piecewise rows read the "
                         "spectral_tab")
    if refr_split and ref_index is None:
        raise ValueError("refr_split rides the refractive mode: pass "
                         "ref_index")
    if refr_split and (media is not None or ambient_scat > 0.0):
        raise NotImplementedError(
            "energy splitting beside scattering or media ids is not K2's: "
            "the engine sends splitting scenes with volumetric media to "
            "K3 and the shade (engine._bounce_step)")
    if regen and source_spec is None:
        raise ValueError("regeneration needs a source_spec")
    if regen and src_frame is None and source_spec[0] is None:
        raise ValueError("a spec without its pose needs the src_frame")
    if wavelength is not None and spectral_tab is None:
        raise ValueError("a wavelength lane needs the spectral_tab")
    if (medium_id is None) != (media is None):
        raise ValueError("medium_id and media must be passed together")
    if media is not None and ref_index is None:
        raise ValueError("the media mode rides the refractive mode: pass "
                         "ref_index")
    if refr_disp and (ref_index is None or wavelength is None):
        raise ValueError("refr_disp needs ref_index and wavelength lanes")


def _lane_outputs(out, wl, ri, mid, wavelength, ref_index, medium_id,
                  split=None):
    """The wrappers' return order: (pos, dir, energy, sid, absorbed[, wl]
    [, ri][, mid][, s_e, s_dir])."""
    for lane_in, lane_out in ((wavelength, wl), (ref_index, ri),
                              (medium_id, mid)):
        if lane_in is not None:
            out = out + (lane_out,)
    return out if split is None else out + tuple(split)


def bounce_reflect_ref(rows, seed: int, pos, dirs, energy, groups,
                       t_eps: float, disc_eps: float = 1e-6, bivar=True,
                       one_sided: bool = True, slope: bool = True,
                       lambertian: bool = False, source_spec=None,
                       regen: bool = False, wavelength=None,
                       spectral_tab=None, ambient_att: float = 0.0,
                       src_frame=None, ref_index=None,
                       refr_frost: bool = False, refr_disp: bool = False,
                       ambient_scat: float = 0.0, ambient_g: float = 0.0,
                       medium_id=None, media=None, refr_split: bool = False,
                       backside_miss: bool = False, **extra):
    """Plain PyTorch version of :func:`bounce_reflect` (same arguments and
    results)."""
    _check_modes(source_spec, regen, wavelength, spectral_tab, src_frame,
                 ref_index, refr_disp, medium_id, media, refr_split, extra,
                 ambient_scat)
    n = pos.shape[0]
    idx = torch.arange(n, device=pos.device)
    stream, lane = idx // TILE, idx % TILE
    e, wl, ri, mid = energy, wavelength, ref_index, medium_id
    if regen:
        do = e <= 0.0
        pose = (source_pose(source_spec) if src_frame is None
                else src_frame.cpu())
        fresh = _sample_disk(source_spec, pose, seed, stream, lane)
        pos = torch.where(do[:, None], torch.stack(fresh[0:3], dim=1), pos)
        dirs = torch.where(do[:, None], torch.stack(fresh[3:6], dim=1), dirs)
        e = torch.where(do, float(source_params(source_spec)[SP_ERAY]), e)
        if wl is not None and fresh[6] is not None:
            wl = torch.where(do, fresh[6], wl)
        # fresh rays start in air, in the ambient medium (id 0)
        if ri is not None:
            ri = torch.where(do, 1.0, ri)
        if mid is not None:
            mid = torch.where(do, 0.0, mid)
    t_b, sid_b, aux = nearest_hit_ref(rows, pos, dirs, groups, t_eps,
                                      disc_eps, need_local=False,
                                      backside_miss=backside_miss)
    rays = list(pos.unbind(1)) + list(dirs.unbind(1))
    npos, ndir, ne, absorbed, nri, nmid, scat, split = _shade(
        rows, t_b, sid_b, aux["normal"].unbind(1), aux["up_dot"], rays, e,
        wl, seed, stream, lane, bivar, one_sided, slope,
        lambertian=lambertian, spectral_tab=spectral_tab,
        ambient_att=ambient_att, ri=ri, mid=mid, media=media,
        refr_frost=refr_frost, refr_disp=refr_disp,
        ambient_scat=ambient_scat, ambient_g=ambient_g,
        refr_split=refr_split, **extra)
    # stale lanes (no energy after regeneration) report no hit; live
    # scattered lanes report -2: alive, on no surface
    live = e > 0.0
    sid = torch.where(live & (sid_b >= 0), sid_b, -1)
    if scat is not None:
        sid = torch.where(live & scat, -2, sid)
    out = (npos, ndir, ne, sid.to(torch.int32),
           torch.where(live, absorbed, 0.0))
    if split is not None:
        # the reflected branch, zero where no live lane split
        s_e, on, s_rd = split
        on = on & live
        split = (torch.where(on, s_e, 0.0),
                 torch.where(on[:, None], torch.stack(s_rd, dim=1), 0.0))
    return _lane_outputs(out, wl, nri, nmid, wavelength, ref_index,
                         medium_id, split)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

class _Modes(ctypes.Structure):
    """K1's and K2's modes as csrc/bounce.cu's ``Modes`` lays them out:
    one host struct behind one pointer instead of a ctypes argument each."""
    _fields_ = [(name, ctypes.c_float if name in _MODE_FLOATS
                 else ctypes.c_int) for name in (
        "bivar_mode", "one_sided", "slope", "lambertian", "ambient_att",
        "refr_frost", "refr_disp", "scat", "ambient_scat", "ambient_g",
        "cook_torrance", "lam_specular", "semi_lambertian", "transparent",
        "conductor", "periodic", "piecewise", "iam_c", "backside_miss",
        "refr_split", "park_aureole")]


@functools.lru_cache(maxsize=64)
def _modes(bivar, one_sided, slope, lambertian, ambient_att, refr_frost,
           refr_disp, scat, ambient_scat, ambient_g, backside_miss,
           extra, refr_split=False, park_aureole=False) -> _Modes:
    """The mode struct of these switches (``extra`` the EXTRA_MODES
    values in order), built once: the cache keeps it alive for the C
    call."""
    x = dict(zip(EXTRA_MODES, extra))
    iam_c = (0.0 if not x["iam"] else 1.0 if x["iam"] is True
             else float(x["iam"]))
    return _Modes(_BIVAR_MODE[bivar], bool(one_sided), bool(slope),
                  bool(lambertian), float(ambient_att), bool(refr_frost),
                  bool(refr_disp), bool(scat), float(ambient_scat),
                  float(ambient_g),
                  *(bool(x[k]) for k in EXTRA_MODES if k != "iam"), iam_c,
                  bool(backside_miss), bool(refr_split), bool(park_aureole))


def _culled_modes(bivar, one_sided, slope, lambertian, ambient_att,
                  conductor, iam, backside_miss, park_aureole) -> _Modes:
    """K1's mode struct: the K2 fields it does not take are off."""
    extra = tuple(conductor if k == "conductor" else iam if k == "iam"
                  else False for k in EXTRA_MODES)
    return _modes(bivar, one_sided, slope, lambertian, ambient_att, False,
                  False, False, 0.0, 0.0, backside_miss, extra,
                  park_aureole=park_aureole)


def tile_order(counts):
    """The order in which K1 dispatches the tiles: a stable argsort of
    their candidate rows, most first, as int32 on ``counts``' device
    (culling.BlockCulling.order holds it for a culling)."""
    return torch.argsort(-counts.sum(1), stable=True).to(torch.int32)


def k1_geometry(lists, rows, groups, group_offsets, wavelength=None,
                spectral_tab=None, bivar=True, one_sided: bool = True,
                slope: bool = True, lambertian=False,
                ambient_att: float = 0.0, conductor=False, iam=False,
                backside_miss=False, park_aureole=False, **_) -> dict:
    """K1's launch geometry on the card for a call with these arguments
    (bounce_reflect_culled's keywords): blocks (nb * split), threads,
    lanes per block (sub), shared bytes per block and the blocks resident
    on one SM (the CUDA occupancy calculator)."""
    from . import build
    lib = build.load()
    nb, W = lists.shape
    flat_rect = _group_meta(tuple(groups), tuple(group_offsets),
                            rows.device)[1]
    n_tab = spectral_tab.shape[0] if spectral_tab is not None else 0
    modes = _culled_modes(bivar, one_sided, slope, lambertian, ambient_att,
                          conductor, iam, backside_miss, park_aureole)
    out = (ctypes.c_int * 5)()
    rc = lib.tt_k1_geometry(W, rows.shape[1], n_tab, int(flat_rect),
                            int(wavelength is not None),
                            ctypes.addressof(modes), ctypes.addressof(out))
    build.check(lib, rc, "k1_geometry")
    split, threads, sub, smem, resident = out
    return dict(blocks=nb * split, threads=threads, split=split, sub=sub,
                smem=smem, resident=resident)


def _aligned16(t):
    """``t``, or a fresh contiguous copy of it when its data does not start
    on a 16-byte boundary (K1 moves the ray state 16 bytes at a time)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def k2_stage_floats(S: int, K: int, n_tab: int = 0, n_media: int = 0) -> int:
    """The floats a K2 block stages in shared memory (csrc/bounce.cu
    plain_stage_floats): the rows at a stride of whole 16-byte words, the
    spectral table, the source pose and, with media, the media table and
    the rows' side ids."""
    return (S * (-(-K // 4) * 4) + 2 * n_tab
            + POSE_FLOATS + 3 * n_media + (2 * S if n_media else 0))


def k2_geometry(rows, n: int, spectral_tab=None, ref_index=None,
                media=None, **modes) -> dict:
    """K2's launch geometry for a call of ``n`` lanes on ``rows`` with
    bounce_reflect's keywords (ref_index and media select the instance as
    the call would): blocks, threads a block, lanes a chunk, bytes of
    shared memory a block, blocks resident a SM, SMs."""
    from . import build
    S, K = rows.shape
    n_tab = spectral_tab.shape[0] if spectral_tab is not None else 0
    n_media = len(media[0]) if media is not None else 0
    scat_on = (media_flags(media)[1] if media is not None
               else modes.get("ambient_scat", 0.0) > 0.0)
    m = _modes(modes.get("bivar", True), modes.get("one_sided", True),
               modes.get("slope", True), modes.get("lambertian", False),
               modes.get("ambient_att", 0.0), modes.get("refr_frost", False),
               modes.get("refr_disp", False), scat_on,
               modes.get("ambient_scat", 0.0), modes.get("ambient_g", 0.0),
               modes.get("backside_miss", False),
               tuple(modes.get(k, False) for k in EXTRA_MODES),
               modes.get("refr_split", False))
    out = (ctypes.c_int * 6)()
    lib = build.load()
    rc = lib.tt_k2_geometry(S, K, n_tab, n_media, int(ref_index is not None),
                            int(media is not None), ctypes.addressof(m),
                            int(n), ctypes.addressof(out))
    build.check(lib, rc, "k2_geometry")
    return dict(zip(("blocks", "threads", "chunk", "smem", "resident",
                     "sms"), out))


def _ray_outputs(n, device):
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.empty((n, 3), **f32), torch.empty((n, 3), **f32),
            torch.empty((n,), **f32),
            torch.empty((n,), dtype=torch.int32, device=device),
            torch.empty((n,), **f32))


def bounce_reflect_culled(rows, lists, counts, cells, cell_bounds,
                          seed: int, remaining, active, pos, dirs, energy,
                          groups, group_offsets, t_eps: float, bivar=True,
                          one_sided: bool = True, slope: bool = True,
                          source_spec=None, wavelength=None,
                          spectral_tab=None, disc_eps: float = 1e-6,
                          order=None, **modes):
    """One round of the relevancy-culled bounce over nb = lists.shape[0]
    tiles of TILE lanes (port of bounce_reflect_culled_pallas).

    rows      (S, K) float32 packed table (pack_rows)
    lists     (nb, W) int32 candidate rows of each tile, one column segment
              per group from group_offsets[g], -1 padded
    counts    (nb, G) int32 candidates per tile per group
    cells     (nb,) int32 global tile ids (the tiles' random streams)
    cell_bounds (nb, 4) float32 source cell of each tile: [a0, a1, th0,
              th1] (area fractions, angles) of a disk source, [x0, x1, y0,
              y1] (local metres) of a rect source
    remaining (nb,) int32 emission quota left: the first remaining[b] dead
              lanes of tile b (flat lane order) regenerate from its cell
    active    (nb,) int32; 0 = the tile passes its state through
    pos, dirs (N, 3), energy (N,) float32 with N = nb * TILE
    groups    static tuple of (start, end, signature, quadric class): every
              class and aperture kind
    wavelength (N,) float32 per-lane wavelengths with ``spectral_tab`` (L,
              2) float32: regenerated lanes draw theirs from the spec's
              band, K_REFLECT_SPECTRAL rows absorb the table's value at it
    lambertian, ambient_att, conductor, iam, backside_miss  (CULLED_MODES,
              keywords) the Lambertian lobe, Beer-Lambert attenuation of
              the travelled segment, Fresnel conductors (reading the
              table; without a lane at wavelength 0), the Martin-Ruiz IAM
              (False or the scene's exponent c) and the bifacial rows'
              one-sided test
    park_aureole  (keyword) a lane regenerated this call into the
              sunshape's circumsolar aureole (its polar-angle uniform at
              or past disc_end) reports a hit on row s as sid -(s + 16);
              every other output is unchanged (culling.park_aureole)
    order     (nb,) int32 the order in which the kernel dispatches the
              tiles, most candidate rows first (culling.BlockCulling.order,
              which the culled trace passes); None derives it from
              ``counts``. It moves no result.

    The kernel serves each tile with K1_SPLIT blocks of TILE / K1_SPLIT
    lanes and stages and stores the rays 16 bytes at a time: pos, dirs or
    energy that do not start on a 16-byte boundary are copied first.

    The NSTTF's modes (flat rect rows, K_REFLECT) run the kernel's own
    instance; any other mode or class the general one, conductor and IAM
    its kExtra twin. Returns (pos, dir, energy, sid, absorbed[,
    wavelength]); sid is -1 on misses and on lanes without energy."""
    if pos.device.type == "cpu":
        return bounce_reflect_culled_ref(
            rows, lists, counts, cells, cell_bounds, seed, remaining,
            active, pos, dirs, energy, groups, group_offsets, t_eps,
            bivar=bivar, one_sided=one_sided, slope=slope,
            source_spec=source_spec, wavelength=wavelength,
            spectral_tab=spectral_tab, disc_eps=disc_eps, **modes)
    _check_culled_modes(wavelength, spectral_tab, modes)
    from . import build
    dev = pos.device
    nb, W = lists.shape
    n = nb * TILE
    S, K = rows.shape
    Gn = len(groups)
    args = dict(rows=rows, lists=lists, counts=counts, cells=cells,
                cell_bounds=cell_bounds, remaining=remaining, active=active,
                pos=pos, dirs=dirs, energy=energy)
    shapes = [("rows", torch.float32, (S, K)),
              ("lists", torch.int32, (nb, W)),
              ("counts", torch.int32, (nb, Gn)),
              ("cells", torch.int32, (nb,)),
              ("cell_bounds", torch.float32, (nb, 4)),
              ("remaining", torch.int32, (nb,)),
              ("active", torch.int32, (nb,)),
              ("pos", torch.float32, (n, 3)),
              ("dirs", torch.float32, (n, 3)),
              ("energy", torch.float32, (n,))]
    if wavelength is not None:
        args["wavelength"] = wavelength
        shapes.append(("wavelength", torch.float32, (n,)))
    if spectral_tab is not None:
        args["spectral_tab"] = spectral_tab
        shapes.append(("spectral_tab", torch.float32,
                       (spectral_tab.shape[0], 2)))
    _check_device(dev, args)
    for name, dt, shape in shapes:
        _check(name, args[name], dt, shape)
    if order is not None:
        _check_device(dev, {"order": order})
        _check("order", order, torch.int32, (nb,))
    pos, dirs, energy = (_aligned16(t) for t in (pos, dirs, energy))
    if (K - ROW_AP) % 6 or (K - ROW_AP) // 6 > MAX_C:
        raise ValueError(f"rows: {K} columns is not 30 + 6 * C with "
                         f"C <= {MAX_C}")
    n_tab = spectral_tab.shape[0] if spectral_tab is not None else 0
    # the NSTTF instance pads each staged row to whole 16-byte words
    if K1_RAY_FLOATS + W * (-(-K // 4) * 4) + W + 2 * n_tab \
            > MAX_STAGE_FLOATS:
        raise NotImplementedError("candidate lists exceed the shared-memory "
                                  "stage (ROADMAP B5)")
    lib = build.load()
    rc, outs = launch_k1(lib, rows, lists, counts, cells, cell_bounds, seed,
                         remaining, active, pos, dirs, energy, groups,
                         group_offsets, t_eps,
                         torch.cuda.current_stream(dev).cuda_stream,
                         bivar=bivar, one_sided=one_sided, slope=slope,
                         source_spec=source_spec, wavelength=wavelength,
                         spectral_tab=spectral_tab, disc_eps=disc_eps,
                         order=order, **modes)
    build.check(lib, rc, "bounce_reflect_culled")
    bounce_reflect_culled.launches += 1
    return outs


def launch_k1(lib, rows, lists, counts, cells, cell_bounds, seed: int,
              remaining, active, pos, dirs, energy, groups, group_offsets,
              t_eps: float, stream, bivar=True, one_sided: bool = True,
              slope: bool = True, source_spec=None, wavelength=None,
              spectral_tab=None, disc_eps: float = 1e-6, order=None,
              lambertian=False, ambient_att: float = 0.0, conductor=False,
              iam=False, backside_miss=False, park_aureole=False):
    """Marshal one call of the library's ``tt_bounce_culled`` (checked
    arguments, tensors on one device; ``stream`` the CUDA stream, None for
    the default; ``order`` None derives it as tile_order does). Returns
    (the C function's error code, bounce_reflect_culled's results)."""
    dev = pos.device
    nb, W = lists.shape
    S, K = rows.shape
    gmeta, flat_rect = _group_meta(tuple(groups), tuple(group_offsets), dev)
    srcp = (_source_tensor(source_spec, dev) if source_spec is not None
            else None)
    if order is None:
        order = tile_order(counts)
    modes = _culled_modes(bivar, one_sided, slope, lambertian, ambient_att,
                          conductor, iam, backside_miss, park_aureole)
    outs = _ray_outputs(nb * TILE, dev)
    nwl = None if wavelength is None else torch.empty_like(wavelength)
    n_tab = spectral_tab.shape[0] if spectral_tab is not None else 0

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = lib.tt_bounce_culled(
        rows.data_ptr(), S, K, lists.data_ptr(), W, counts.data_ptr(),
        len(groups), gmeta.data_ptr(), MAX_C, cells.data_ptr(),
        cell_bounds.data_ptr(), remaining.data_ptr(), active.data_ptr(),
        order.data_ptr(), ptr(srcp), int(seed), pos.data_ptr(),
        dirs.data_ptr(), energy.data_ptr(), *(o.data_ptr() for o in outs),
        ptr(wavelength), ptr(nwl), ptr(spectral_tab), n_tab, nb,
        float(t_eps), float(disc_eps), int(flat_rect),
        ctypes.addressof(modes), stream)
    return rc, outs if nwl is None else outs + (nwl,)


bounce_reflect_culled.launches = 0


def bounce_reflect(rows, seed: int, pos, dirs, energy, groups,
                   t_eps: float, disc_eps: float = 1e-6, bivar=True,
                   one_sided: bool = True, slope: bool = True,
                   lambertian: bool = False, source_spec=None,
                   regen: bool = False, wavelength=None, spectral_tab=None,
                   ambient_att: float = 0.0, src_frame=None, ref_index=None,
                   refr_frost: bool = False, refr_disp: bool = False,
                   ambient_scat: float = 0.0, ambient_g: float = 0.0,
                   medium_id=None, media=None, refr_split: bool = False,
                   backside_miss: bool = False, **extra):
    """One fused brute-force bounce of any number of lanes against every
    row (port of bounce_reflect_pallas, stages a to e). Lane l draws from
    the stream of tile l // TILE.

    rows      (S, K) float32 packed table (pack_rows)
    pos, dirs (N, 3), energy (N,) float32
    groups    static tuple of (start, end, signature, quadric class)
    lambertian compiles the K_LAMBERTIAN lobe; one_sided the back-face
              kill; slope the slope error (bivar: True, False or "mixed")
    source_spec, regen  with regen, lanes with energy <= 0 first draw a
              fresh ray (and a wavelength, if the spec has a band) from
              the disk source; ``src_frame`` (21,) float32 is its pose
              (centre, position rotation, direction rotation), else the
              spec's own (source_pose)
    wavelength (N,) float32 per-lane wavelengths with ``spectral_tab``
              (L, 2) float32 (wavelength, value): K_REFLECT_SPECTRAL rows
              absorb the table's value at the lane's wavelength; the
              conductor and piecewise rows read the table without a lane
              too, at wavelength 0 (a constant index's only sample)
    ambient_att  Beer-Lambert coefficient [1/m] of the ambient medium,
              applied to the travelled segments
    ref_index (N,) float32 per-lane refractive index: K_REFRACTIVE rows
              roulette between Fresnel reflection and Snell refraction
              (fresh rays start at 1); ``refr_frost`` perturbs their
              normal with their p2 sigma, ``refr_disp`` (with wavelength)
              takes their indices from the table chunks at p3
    ambient_scat, ambient_g  Henyey-Greenstein scattering coefficient
              [1/m] and asymmetry of the ambient medium: a lane whose
              exponential free path ends before its hit (or that would
              escape) scatters there instead, sid -2
    medium_id, media  (N,) float32 per-lane medium id and the static pair
              (media_tab, media_rows) of engine._bake_media: each lane
              scatters and attenuates in its own medium (id 0 is the
              ambient; the ambient_* arguments are then ignored) and takes
              the entered side's id on crossing a K_REFRACTIVE row; needs
              ref_index
    refr_split  energy splitting (needs ref_index): on an F_SPLIT
              refractive row the lane always crosses, with the share 1 - R
              of its energy after the medium (none on total internal
              reflection), and the reflected branch leaves with R of it
              through two more outputs, s_e (N,) and s_dir (N, 3), zero
              where no live lane split (a lane that scattered first does
              not); other refractive rows keep the roulette. Not beside
              scattering or media ids (raises: the engine traces
              splitting scenes with volumetric media on K3 and the
              shade)
    backside_miss  rows flagged F_BACKSIDE_MISS (bifacial pairs) reject
              rays arriving along their local +Z, on every class (the jnp
              semantics; tracer_tpu's Pallas kernels skip flat rows)
    cook_torrance, lam_specular, semi_lambertian, transparent, conductor,
    periodic, piecewise  (EXTRA_MODES, keywords, False by default) shade
              the stage (d) and (e) kinds; ``iam`` is False or the scene's
              Martin-Ruiz exponent c (True means 1). They run alone, in an
              ambient HG medium, or beside ref_index and medium_id

    Returns (pos, dir, energy, sid, absorbed[, wavelength][, ref_index]
    [, medium_id][, s_e, s_dir]); sid is -1 on misses and on lanes
    without energy, which pass their state through, and -2 on live lanes
    that scattered."""
    _check_modes(source_spec, regen, wavelength, spectral_tab, src_frame,
                 ref_index, refr_disp, medium_id, media, refr_split, extra,
                 ambient_scat)
    kw = dict(disc_eps=disc_eps, bivar=bivar, one_sided=one_sided,
              slope=slope, lambertian=lambertian, source_spec=source_spec,
              regen=regen, wavelength=wavelength, spectral_tab=spectral_tab,
              ambient_att=ambient_att, src_frame=src_frame,
              ref_index=ref_index, refr_frost=refr_frost,
              refr_disp=refr_disp, ambient_scat=ambient_scat,
              ambient_g=ambient_g, medium_id=medium_id, media=media,
              refr_split=refr_split, backside_miss=backside_miss, **extra)
    if pos.device.type == "cpu":
        return bounce_reflect_ref(rows, seed, pos, dirs, energy, groups,
                                  t_eps, **kw)
    from . import build
    dev = pos.device
    n = pos.shape[0]
    S, K = rows.shape
    args = dict(rows=rows, pos=pos, dirs=dirs, energy=energy)
    shapes = [("rows", torch.float32, (S, K)), ("pos", torch.float32, (n, 3)),
              ("dirs", torch.float32, (n, 3)),
              ("energy", torch.float32, (n,))]
    for name, t in (("wavelength", wavelength), ("ref_index", ref_index),
                    ("medium_id", medium_id)):
        if t is not None:
            args[name] = t
            shapes.append((name, torch.float32, (n,)))
    if spectral_tab is not None:
        args["spectral_tab"] = spectral_tab
        shapes.append(("spectral_tab", torch.float32,
                       (spectral_tab.shape[0], 2)))
    if regen and src_frame is not None:
        args["src_frame"] = src_frame
        shapes.append(("src_frame", torch.float32, (POSE_FLOATS,)))
    _check_device(dev, args)
    for name, dt, shape in shapes:
        _check(name, args[name], dt, shape)
    if (K - ROW_AP) % 6 or (K - ROW_AP) // 6 > MAX_C:
        raise ValueError(f"rows: {K} columns is not 30 + 6 * C with "
                         f"C <= {MAX_C}")
    for start, end, sig, _ in groups:
        if not 0 <= start <= end <= S or len(sig) > (K - ROW_AP) // 6:
            raise ValueError(f"group ({start}, {end}, {sig}) does not fit "
                             f"the ({S}, {K}) rows table")
    n_tab = spectral_tab.shape[0] if spectral_tab is not None else 0
    n_media = len(media[0]) if media is not None else 0
    if k2_stage_floats(S, K, n_tab, n_media) > MAX_STAGE_FLOATS:
        raise NotImplementedError("the rows table exceeds the shared-memory "
                                  "stage (ROADMAP B5)")
    lib = build.load()
    out = launch_k2(lib, rows, seed, pos, dirs, energy, groups, t_eps,
                    torch.cuda.current_stream(dev).cuda_stream, **kw)
    build.check(lib, out[0], "bounce_reflect")
    bounce_reflect.launches += 1
    return out[1]


bounce_reflect.launches = 0


def launch_k2(lib, rows, seed: int, pos, dirs, energy, groups,
              t_eps: float, stream, disc_eps: float = 1e-6, bivar=True,
              one_sided: bool = True, slope: bool = True,
              lambertian: bool = False, source_spec=None,
              regen: bool = False, wavelength=None, spectral_tab=None,
              ambient_att: float = 0.0, src_frame=None, ref_index=None,
              refr_frost: bool = False, refr_disp: bool = False,
              ambient_scat: float = 0.0, ambient_g: float = 0.0,
              medium_id=None, media=None, refr_split: bool = False,
              backside_miss: bool = False, **extra):
    """Marshal one call of the library's ``tt_bounce`` (checked arguments,
    tensors on one device; ``stream`` the CUDA stream, None for the
    default). Returns (the C function's error code, bounce_reflect's
    results)."""
    dev = pos.device
    n = pos.shape[0]
    S, K = rows.shape
    n_tab = spectral_tab.shape[0] if spectral_tab is not None else 0
    pose = None
    if regen:
        pose = (_pose_tensor(source_spec, dev) if src_frame is None
                else src_frame)
    gmeta = _k3_group_meta(tuple(groups), dev)
    srcp = _source_tensor(source_spec, dev) if regen else None
    scat_on = (media_flags(media)[1] if media is not None
               else ambient_scat > 0.0)
    modes = _modes(bivar, one_sided, slope, lambertian, ambient_att,
                   refr_frost, refr_disp, scat_on, ambient_scat, ambient_g,
                   backside_miss, tuple(extra.get(k, False)
                                        for k in EXTRA_MODES), refr_split)
    m_tab = m_rows = None
    if media is not None:
        m_tab, m_rows = _media_tensors(media, S, dev)
    outs = _ray_outputs(n, dev)
    lanes = [(t, None if t is None else torch.empty_like(t))
             for t in (wavelength, ref_index, medium_id)]
    split = ((torch.empty_like(energy), torch.empty_like(dirs))
             if refr_split else (None, None))

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = lib.tt_bounce(
        rows.data_ptr(), S, K, len(groups), gmeta.data_ptr(), MAX_C,
        int(seed), pos.data_ptr(), dirs.data_ptr(), energy.data_ptr(),
        *(o.data_ptr() for o in outs[:3]), outs[3].data_ptr(),
        outs[4].data_ptr(), *(ptr(t) for lane in lanes for t in lane),
        *(ptr(t) for t in split), n,
        float(t_eps), float(disc_eps), int(regen), ptr(srcp), ptr(pose),
        ptr(spectral_tab if n_tab else None), n_tab,
        ctypes.addressof(modes), ptr(m_tab),
        0 if m_tab is None else len(m_tab), ptr(m_rows), stream)
    return rc, _lane_outputs(tuple(outs), *(o for _, o in lanes),
                             wavelength, ref_index, medium_id,
                             split if refr_split else None)
