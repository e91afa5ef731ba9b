"""Fused bounce kernels: wrappers of the CUDA kernels in csrc/bounce.cu and
their plain PyTorch versions.

* :func:`bounce_reflect_culled` (K1) — one round of the relevancy-culled
  trace over ``nb`` tiles of TILE lanes (port of
  tracer_tpu.kernels.pallas_intersect.bounce_reflect_culled_pallas): flat
  rect rows, K_REFLECT optics.
* :func:`bounce_reflect` (K2) — one brute-force bounce over all scene
  rows (port of bounce_reflect_pallas, stages a to c): every quadric
  class and aperture kind, reflect with slope error and the one-sided
  kill, the pure-Lambertian lobe, spectral absorptance at each lane's
  wavelength, Beer-Lambert attenuation, refractive interfaces (Fresnel
  roulette, frosted, dispersive) on a per-lane index, Henyey-Greenstein
  scattering in the ambient medium or, with per-lane medium ids, in the
  media that refractive rows bound, and optional regeneration of dead
  lanes from a disk source. Energy-splitting refraction (ROADMAP A10)
  and the stage (d)/(e) kinds are not ported. The plain streaming
  megakernel runs it every round; the culled trace's drain runs it
  without regeneration.

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

import functools
import math

import numpy as np
import torch

from .. import geometry as G
from .nearest import MAX_C, _group_meta as _k3_group_meta, nearest_hit_ref
from .philox import (CALL_BAND, CALL_FRESNEL, CALL_LAMBERT, CALL_REGEN,
                     CALL_SCATTER, CALL_SLOPE, uniforms)
from .rows import (ROW_AP, ROW_KIND, ROW_P0, _check, _check_device, _rows_t,
                   pack_rows, row_width)  # noqa: F401 (re-exported)

TILE = 3072            # lanes per tile: one source cell, one CUDA block
# the most floats a kernel stages in one block's shared memory (H100:
# 227 KB per block, less the culled kernel's row ids)
MAX_STAGE_FLOATS = (232448 - 4096) // 4
POSE_FLOATS = 21       # source pose: centre, position rot, direction rot
_N_COEFFS = 11         # Buie inverse-CDF polynomial, degree 10
SP_ERAY = 13           # source_params slot of the energy per ray
_BIVAR_MODE = {False: 0, True: 1, "mixed": 2}


def _rect_mask(sig, tag) -> int:
    """Bit c set when aperture slot c is AP_RECT; K1 supports the flat
    quadric class with rect (or no) apertures."""
    if tag != "flat" or any(k not in (G.AP_NONE, G.AP_RECT) for k in sig):
        raise NotImplementedError(
            f"group class {tag!r} with apertures {sig} is not ported to the "
            "culled kernel yet (ROADMAP B1: its other quadric classes and "
            "aperture kinds)")
    return sum(1 << c for c, k in enumerate(sig) if k == G.AP_RECT)


@functools.lru_cache(maxsize=64)
def _group_meta(groups, group_offsets, device) -> torch.Tensor:
    """(G, 2) [column offset, rect mask] of each group for K1."""
    meta = [(off, _rect_mask(sig, tag))
            for (_, _, sig, tag), off in zip(groups, group_offsets)]
    return torch.tensor(meta, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=16)
def source_params(spec) -> np.ndarray:
    """The float32 parameter block both versions sample a Buie (or
    pillbox) disk source from (layout in csrc/bounce.cu): centre,
    row-major rotation, radius, energy per ray, disc_end, has-aureole
    flag, the aureole constants, the 11 inverse-CDF polynomial
    coefficients, and has-band, band low, band high. A spec whose pose
    slots hold None (engine._spec_frame_split) gets zeros there: K2 reads
    the pose from its own operand. The ambient medium (attenuation in
    slot 14, HG scattering in slot 16) is the epilogue's, not the
    sampler's."""
    (cx, cy, cz, rot, radius, e_ray, coeffs, disc_end, gamma, kappa,
     integ_sum, theta_tot, theta_dni) = spec[:13]
    band = spec[13] if len(spec) > 13 else None
    rect = spec[15] if len(spec) > 15 else None
    if rect is not None:
        raise NotImplementedError("rect sources are not ported yet "
                                  "(ROADMAP A3)")
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
    lo, hi = (0.0, 0.0) if band is None else band
    out = np.array([*pose, radius, e_ray, disc_end,
                    0.0 if gamma is None else 1.0, c_aur, tt, inv, *coeffs,
                    0.0 if band is None else 1.0, lo, hi], dtype=np.float32)
    out.setflags(write=False)
    return out


def source_pose(spec) -> np.ndarray:
    """(21,) float32 pose of a full disk spec: centre, row-major position
    rotation, row-major direction rotation (the same rotation for a
    disk)."""
    rot = np.asarray(spec[3], dtype=np.float32).reshape(9)
    return np.concatenate([np.asarray(spec[:3], dtype=np.float32), rot,
                           rot])


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
                    t_eps: float):
    """(t, sid) of the nearest hit over each lane's tile candidate list,
    one candidate slot at a time (gathers (N, K) rows per slot, never an
    N x L x K tensor)."""
    t_best = torch.full_like(rays[0], math.inf)
    sid = torch.full(rays[0].shape, -1, dtype=torch.int32,
                     device=rays[0].device)
    for g, ((_, _, sig, tag), off) in enumerate(zip(groups, group_offsets)):
        _rect_mask(sig, tag)                       # the kernel's subset
        cnt = counts[blk, g]
        for i in range(int(counts[:, g].max()) if counts.numel() else 0):
            s = lists[blk, off + i]
            r = rows[s.clamp(min=0).long()].T      # (K, N)
            t = _rows_t(r, tag, sig, rays, t_eps, 1e-6, False)[0]
            upd = (i < cnt) & (t < t_best)
            t_best = torch.where(upd, t, t_best)
            sid = torch.where(upd, s, sid)
    return t_best, sid


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


def _shade(rows, t_b, sid_b, normal, up, rays, e_in, wl, seed: int, stream,
           lane, bivar, one_sided: bool, slope: bool,
           lambertian: bool = False, spectral_tab=None,
           ambient_att: float = 0.0, ri=None, mid=None, media=None,
           refr_frost: bool = False, refr_disp: bool = False,
           ambient_scat: float = 0.0, ambient_g: float = 0.0):
    """The shade epilogue both kernels share, on each lane's winner row
    with its carried (unnormalised) normal and local d_z: reflect, slope
    error, the one-sided kill, the Lambertian lobe, spectral absorptance
    (with ``spectral_tab``), attenuation of the travelled segment, and with
    the lanes' index ``ri`` the refractive interfaces (roulette, frosted,
    dispersive with ``refr_disp``), a participating medium's HG scattering
    (the ambient's, or with ``mid`` and ``media`` the lane's own) and the
    media ids. Returns (pos, dir, energy, absorbed, ri, mid, scattered)
    before the live-lane masking (None for the modes that are off)."""
    px, py, pz, dx, dy, dz = rays
    hit = sid_b >= 0
    w = rows[sid_b.clamp(min=0).long()]
    zero = torch.zeros_like(px)
    ngx, ngy, ngz = (torch.where(hit, g, zero) for g in normal)
    upd_b = torch.where(hit, up, zero)
    kf, q0, q1, q2 = (torch.where(hit, w[:, k], zero)
                      for k in (ROW_KIND, ROW_P0, ROW_P0 + 1, ROW_P0 + 2))
    kind = torch.floor(kf * (1.0 / 1024.0))
    if spectral_tab is not None:
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
        crossed = is_refr & hit & ~(u_r <= R)
        rx = torch.where(crossed, tdx, rx)
        ry = torch.where(crossed, tdy, ry)
        rz = torch.where(crossed, tdz, rz)
        nri = torch.where(crossed, n_next, ri)
        if media is not None:
            nmid = torch.where(crossed, torch.where(in1, mid2, mid1), mid)
        q0 = torch.where(is_refr, 0.0, q0)
    if lambertian:
        # K_LAMBERTIAN: cosine-weighted about the unperturbed normal
        # within ang_range (q1)
        ul1, ul2, _, _ = uniforms(seed, stream, lane, CALL_LAMBERT)
        sinsq = torch.sin(q1) * torch.sqrt(ul1)
        a_pl = (2.0 * math.pi) * ul2
        lz = torch.sqrt(torch.clamp(1.0 - sinsq * sinsq, min=0.0))
        ld = _rot_about(n0x, n0y, n0z, sinsq * torch.cos(a_pl),
                        sinsq * torch.sin(a_pl), lz)
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
    return (torch.stack(npos, dim=1), torch.stack(ndir, dim=1), ne, absorbed,
            nri, nmid, scat)


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


def _sample_cell(spec, seed: int, stream, lane, cb):
    """Fresh rays from each lane's equal-area Buie disk cell
    [a0, a1, th0, th1] (the kernels' sample_cell)."""
    p = [float(v) for v in source_params(spec)]
    cx, cy, cz, rot = p[0], p[1], p[2], p[3:12]
    u1, u2, u3, u4 = uniforms(seed, stream, lane, CALL_REGEN)
    a0, a1, th0, th1 = cb.unbind(1)
    rr = p[12] * torch.sqrt(a0 + u1 * (a1 - a0))
    ang = th0 + u2 * (th1 - th0)
    lx, ly = rr * torch.cos(ang), rr * torch.sin(ang)
    fp = [rot[3 * i] * lx + rot[3 * i + 1] * ly + c
          for i, c in enumerate((cx, cy, cz))]
    theta = _buie_theta(p, u3)
    a_d = (2.0 * math.pi) * u4
    ax = torch.sin(theta) * torch.cos(a_d)
    ay = torch.sin(theta) * torch.sin(a_d)
    az = torch.cos(theta)
    fd = [rot[3 * i] * ax + rot[3 * i + 1] * ay + rot[3 * i + 2] * az
          for i in range(3)]
    return fp + fd


def _sample_disk(spec, pose, seed: int, stream, lane):
    """Fresh rays from the whole disk source at the (21,) ``pose`` (the
    kernels' sample_disk): six ray components and the wavelength (None
    without a band)."""
    p = [float(v) for v in source_params(spec)]
    f = [float(v) for v in pose]
    rot, drot = f[3:12], f[12:21]
    u1, u2, u3, u4 = uniforms(seed, stream, lane, CALL_REGEN)
    rr = p[12] * torch.sqrt(u1)
    a_v = (2.0 * math.pi) * u2
    lx, ly = rr * torch.cos(a_v), rr * torch.sin(a_v)
    fp = [rot[3 * i] * lx + rot[3 * i + 1] * ly + f[i] for i in range(3)]
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


def bounce_reflect_culled_ref(rows, lists, counts, cells, cell_bounds,
                              seed: int, remaining, active, pos, dirs,
                              energy, groups, group_offsets, t_eps: float,
                              bivar=True, one_sided: bool = True,
                              slope: bool = True, source_spec=None):
    """Plain PyTorch version of :func:`bounce_reflect_culled`."""
    n, nb = pos.shape[0], lists.shape[0]
    dev = pos.device
    idx = torch.arange(n, device=dev)
    blk, lane = idx // TILE, idx % TILE
    act = (active != 0)[blk]
    dead = energy <= 0.0
    d_t = dead.view(nb, TILE).to(torch.int32)
    rank = (torch.cumsum(d_t, dim=1) - d_t).view(n)       # exclusive
    rays = list(pos.unbind(1)) + list(dirs.unbind(1))
    e = energy
    stream = cells[blk]
    if source_spec is not None:
        do = dead & act & (rank < remaining[blk])
        fresh = _sample_cell(source_spec, seed, stream, lane,
                             cell_bounds[blk])
        rays = [torch.where(do, f, r) for f, r in zip(fresh, rays)]
        e = torch.where(do, float(source_params(source_spec)[SP_ERAY]), e)
    t_b, sid_b = _nearest_listed(rows, lists, counts, groups, group_offsets,
                                 blk, rays, t_eps)
    # a flat winner's normal is its row's R e_z
    w = rows[sid_b.clamp(min=0).long()]
    normal = (w[:, 6], w[:, 7], w[:, 8])
    up = w[:, 6] * rays[3] + w[:, 7] * rays[4] + w[:, 8] * rays[5]
    npos, ndir, ne, absorbed = _shade(rows, t_b, sid_b, normal, up, rays, e,
                                      None, seed, stream, lane, bivar,
                                      one_sided, slope)[:4]
    live = e > 0.0
    sid = torch.where(live & (sid_b >= 0), sid_b, -1)
    absorbed = torch.where(live, absorbed, 0.0)
    # idle tiles pass their state through
    npos = torch.where(act[:, None], npos, pos)
    ndir = torch.where(act[:, None], ndir, dirs)
    ne = torch.where(act, ne, energy)
    sid = torch.where(act, sid, -1).to(torch.int32)
    absorbed = torch.where(act, absorbed, 0.0)
    return npos, ndir, ne, sid, absorbed


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
                 refr_split=False):
    if refr_split:
        raise NotImplementedError(
            "energy-splitting refraction (refr_split) serves the general "
            "streaming path, not ported yet (ROADMAP A10)")
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


def _lane_outputs(out, wl, ri, mid, wavelength, ref_index, medium_id):
    """The wrappers' return order: (pos, dir, energy, sid, absorbed[, wl]
    [, ri][, mid])."""
    for lane_in, lane_out in ((wavelength, wl), (ref_index, ri),
                              (medium_id, mid)):
        if lane_in is not None:
            out = out + (lane_out,)
    return out


def bounce_reflect_ref(rows, seed: int, pos, dirs, energy, groups,
                       t_eps: float, disc_eps: float = 1e-6, bivar=True,
                       one_sided: bool = True, slope: bool = True,
                       lambertian: bool = False, source_spec=None,
                       regen: bool = False, wavelength=None,
                       spectral_tab=None, ambient_att: float = 0.0,
                       src_frame=None, ref_index=None,
                       refr_frost: bool = False, refr_disp: bool = False,
                       ambient_scat: float = 0.0, ambient_g: float = 0.0,
                       medium_id=None, media=None, refr_split: bool = False):
    """Plain PyTorch version of :func:`bounce_reflect` (same arguments and
    results)."""
    _check_modes(source_spec, regen, wavelength, spectral_tab, src_frame,
                 ref_index, refr_disp, medium_id, media, refr_split)
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
                                      disc_eps, need_local=False)
    rays = list(pos.unbind(1)) + list(dirs.unbind(1))
    npos, ndir, ne, absorbed, nri, nmid, scat = _shade(
        rows, t_b, sid_b, aux["normal"].unbind(1), aux["up_dot"], rays, e,
        wl, seed, stream, lane, bivar, one_sided, slope,
        lambertian=lambertian,
        spectral_tab=spectral_tab if wl is not None else None,
        ambient_att=ambient_att, ri=ri, mid=mid, media=media,
        refr_frost=refr_frost, refr_disp=refr_disp,
        ambient_scat=ambient_scat, ambient_g=ambient_g)
    # stale lanes (no energy after regeneration) report no hit; live
    # scattered lanes report -2: alive, on no surface
    live = e > 0.0
    sid = torch.where(live & (sid_b >= 0), sid_b, -1)
    if scat is not None:
        sid = torch.where(live & scat, -2, sid)
    out = (npos, ndir, ne, sid.to(torch.int32),
           torch.where(live, absorbed, 0.0))
    return _lane_outputs(out, wl, nri, nmid, wavelength, ref_index,
                         medium_id)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

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
                          source_spec=None):
    """One round of the relevancy-culled bounce over nb = lists.shape[0]
    tiles of TILE lanes (port of bounce_reflect_culled_pallas).

    rows      (S, K) float32 packed table (pack_rows)
    lists     (nb, W) int32 candidate rows of each tile, one column segment
              per group from group_offsets[g], -1 padded
    counts    (nb, G) int32 candidates per tile per group
    cells     (nb,) int32 global tile ids (the tiles' random streams)
    cell_bounds (nb, 4) float32 source cell [a0, a1, th0, th1] of each tile
    remaining (nb,) int32 emission quota left: the first remaining[b] dead
              lanes of tile b (flat lane order) regenerate from its cell
    active    (nb,) int32; 0 = the tile passes its state through
    pos, dirs (N, 3), energy (N,) float32 with N = nb * TILE

    Returns (pos, dir, energy, sid, absorbed); sid is -1 on misses and on
    lanes without energy."""
    if pos.device.type == "cpu":
        return bounce_reflect_culled_ref(
            rows, lists, counts, cells, cell_bounds, seed, remaining,
            active, pos, dirs, energy, groups, group_offsets, t_eps,
            bivar=bivar, one_sided=one_sided, slope=slope,
            source_spec=source_spec)
    from . import build
    dev = pos.device
    nb, W = lists.shape
    n = nb * TILE
    S, K = rows.shape
    Gn = len(groups)
    args = dict(rows=rows, lists=lists, counts=counts, cells=cells,
                cell_bounds=cell_bounds, remaining=remaining, active=active,
                pos=pos, dirs=dirs, energy=energy)
    _check_device(dev, args)
    for name, dt, shape in (("rows", torch.float32, (S, K)),
                            ("lists", torch.int32, (nb, W)),
                            ("counts", torch.int32, (nb, Gn)),
                            ("cells", torch.int32, (nb,)),
                            ("cell_bounds", torch.float32, (nb, 4)),
                            ("remaining", torch.int32, (nb,)),
                            ("active", torch.int32, (nb,)),
                            ("pos", torch.float32, (n, 3)),
                            ("dirs", torch.float32, (n, 3)),
                            ("energy", torch.float32, (n,))):
        _check(name, args[name], dt, shape)
    if W * K + W > MAX_STAGE_FLOATS:
        raise NotImplementedError("candidate lists exceed the shared-memory "
                                  "stage (ROADMAP B5)")
    gmeta = _group_meta(tuple(groups), tuple(group_offsets), dev)
    srcp = (_source_tensor(source_spec, dev) if source_spec is not None
            else gmeta)
    outs = _ray_outputs(n, dev)
    lib = build.load()
    rc = lib.tt_bounce_culled(
        rows.data_ptr(), S, K, lists.data_ptr(), W, counts.data_ptr(), Gn,
        gmeta.data_ptr(), cells.data_ptr(), cell_bounds.data_ptr(),
        remaining.data_ptr(), active.data_ptr(), srcp.data_ptr(),
        int(source_spec is not None), int(seed), pos.data_ptr(),
        dirs.data_ptr(), energy.data_ptr(), *(o.data_ptr() for o in outs),
        nb, float(t_eps), _BIVAR_MODE[bivar], int(one_sided), int(slope),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "bounce_reflect_culled")
    bounce_reflect_culled.launches += 1
    return outs


bounce_reflect_culled.launches = 0


def bounce_reflect(rows, seed: int, pos, dirs, energy, groups,
                   t_eps: float, disc_eps: float = 1e-6, bivar=True,
                   one_sided: bool = True, slope: bool = True,
                   lambertian: bool = False, source_spec=None,
                   regen: bool = False, wavelength=None, spectral_tab=None,
                   ambient_att: float = 0.0, src_frame=None, ref_index=None,
                   refr_frost: bool = False, refr_disp: bool = False,
                   ambient_scat: float = 0.0, ambient_g: float = 0.0,
                   medium_id=None, media=None, refr_split: bool = False):
    """One fused brute-force bounce of any number of lanes against every
    row (port of bounce_reflect_pallas, stages a to c). Lane l draws from
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
              absorb the table's value at the lane's wavelength
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
    refr_split  energy splitting: not ported (raises, ROADMAP A10)

    Returns (pos, dir, energy, sid, absorbed[, wavelength][, ref_index]
    [, medium_id]); sid is -1 on misses and on lanes without energy, which
    pass their state through, and -2 on live lanes that scattered."""
    _check_modes(source_spec, regen, wavelength, spectral_tab, src_frame,
                 ref_index, refr_disp, medium_id, media, refr_split)
    kw = dict(disc_eps=disc_eps, bivar=bivar, one_sided=one_sided,
              slope=slope, lambertian=lambertian, source_spec=source_spec,
              regen=regen, wavelength=wavelength, spectral_tab=spectral_tab,
              ambient_att=ambient_att, src_frame=src_frame,
              ref_index=ref_index, refr_frost=refr_frost,
              refr_disp=refr_disp, ambient_scat=ambient_scat,
              ambient_g=ambient_g, medium_id=medium_id, media=media)
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
    if wavelength is not None:
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
    n_tab = spectral_tab.shape[0] if wavelength is not None else 0
    n_media = len(media[0]) if media is not None else 0
    if (S * K + 2 * n_tab + POSE_FLOATS + 3 * n_media
            + (2 * S if media is not None else 0)) > MAX_STAGE_FLOATS:
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
              medium_id=None, media=None):
    """Marshal one call of the library's ``tt_bounce`` (checked arguments,
    tensors on one device; ``stream`` the CUDA stream, None for the
    default). Returns (the C function's error code, bounce_reflect's
    results)."""
    dev = pos.device
    n = pos.shape[0]
    S, K = rows.shape
    n_tab = spectral_tab.shape[0] if wavelength is not None else 0
    pose = None
    if regen:
        pose = (_pose_tensor(source_spec, dev) if src_frame is None
                else src_frame)
    gmeta = _k3_group_meta(tuple(groups), dev)
    srcp = _source_tensor(source_spec, dev) if regen else None
    scat_on = (media_flags(media)[1] if media is not None
               else ambient_scat > 0.0)
    m_tab = m_rows = None
    if media is not None:
        m_tab, m_rows = _media_tensors(media, S, dev)
    outs = _ray_outputs(n, dev)
    lanes = [(t, None if t is None else torch.empty_like(t))
             for t in (wavelength, ref_index, medium_id)]

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = lib.tt_bounce(
        rows.data_ptr(), S, K, len(groups), gmeta.data_ptr(), MAX_C,
        int(seed), pos.data_ptr(), dirs.data_ptr(), energy.data_ptr(),
        *(o.data_ptr() for o in outs[:3]), outs[3].data_ptr(),
        outs[4].data_ptr(), *(ptr(t) for lane in lanes for t in lane), n,
        float(t_eps), float(disc_eps), int(regen), ptr(srcp), ptr(pose),
        ptr(spectral_tab if n_tab else None), n_tab, _BIVAR_MODE[bivar],
        int(one_sided), int(slope), int(lambertian), float(ambient_att),
        int(refr_frost), int(refr_disp), int(scat_on), float(ambient_scat),
        float(ambient_g), ptr(m_tab), 0 if m_tab is None else len(m_tab),
        ptr(m_rows), stream)
    return rc, _lane_outputs(tuple(outs), *(o for _, o in lanes),
                             wavelength, ref_index, medium_id)
