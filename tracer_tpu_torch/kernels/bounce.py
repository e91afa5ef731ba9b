"""Fused bounce kernels for specular heliostat-field scenes: wrappers of the
CUDA kernels in csrc/bounce.cu and their plain PyTorch versions.

* :func:`bounce_reflect_culled` — one round of the relevancy-culled trace
  over ``nb`` tiles of TILE lanes (port of
  tracer_tpu.kernels.pallas_intersect.bounce_reflect_culled_pallas).
* :func:`bounce_reflect` — one brute-force bounce over all scene rows, no
  regeneration (port of bounce_reflect_pallas, as the culled drain uses
  it).

A wrapper given CPU tensors runs the plain version (``*_ref``); given CUDA
tensors it launches the kernel or raises — it never falls back. Each
wrapper counts its kernel launches in its ``launches`` attribute. The
packed row table (:func:`pack_rows`) and the plain per-row intersection
(``_rows_t``: every quadric class and aperture kind) also serve K3's plain
version (kernels/nearest.py).

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
from .philox import CALL_REGEN, CALL_SLOPE, uniforms

TILE = 3072            # lanes per tile: one source cell, one CUDA block
ROW_KIND = 22          # optics kind*1024 + flags (as float)
ROW_P0 = 23            # first seven optics params
ROW_AP = 30            # C*6 aperture params follow
# the most floats a kernel stages in one block's shared memory (H100:
# 227 KB per block, less the culled kernel's row ids)
MAX_STAGE_FLOATS = (232448 - 4096) // 4
_N_COEFFS = 11         # Buie inverse-CDF polynomial, degree 10
_BIVAR_MODE = {False: 0, True: 1, "mixed": 2}


def row_width(scene) -> int:
    """Floats per packed row: 30 + 6 per aperture constraint slot."""
    return ROW_AP + 6 * scene.ap_params.shape[1]


def pack_rows(scene, dtype=torch.float32) -> torch.Tensor:
    """Pack per-surface data into one (S, 30 + 6*C) table, one row per
    surface, float32 for the kernels (tracer_tpu's pack_rows transposed:
    its (K, S) layout only served the TPU's scalar-memory padding). IAM
    rows mirror a_r (p4) into p2 (reflective / Lambertian /
    semi-Lambertian bases) or p3 (Lambertian-specular), as the JAX table
    does."""
    S = scene.num_rows
    p = scene.opt_params[:, 0:7].clone()
    f_iam = (scene.opt_flags & 4) != 0                   # F_IAM
    k = scene.opt_kind
    mirror2 = f_iam & ((k == 1) | (k == 2) | (k == 4))
    mirror3 = f_iam & (k == 3)
    p[:, 2] = torch.where(mirror2, scene.opt_params[:, 4], p[:, 2])
    p[:, 3] = torch.where(mirror3, scene.opt_params[:, 4], p[:, 3])
    return torch.cat([
        scene.inv_frame[:, :3, :3].reshape(S, 9),
        scene.inv_frame[:, :3, 3],
        scene.quadric,
        (scene.opt_kind * 1024 + scene.opt_flags)[:, None].to(dtype),
        p,
        scene.ap_params.reshape(S, -1),
    ], dim=1).to(dtype).contiguous()


def _rect_mask(sig, tag) -> int:
    """Bit c set when aperture slot c is AP_RECT; K1 and K2 support the
    flat quadric class with rect (or no) apertures."""
    if tag != "flat" or any(k not in (G.AP_NONE, G.AP_RECT) for k in sig):
        raise NotImplementedError(
            f"group class {tag!r} with apertures {sig} is not ported yet "
            "(ROADMAP B4: the other quadric classes and aperture kinds)")
    return sum(1 << c for c, k in enumerate(sig) if k == G.AP_RECT)


@functools.lru_cache(maxsize=64)
def _group_meta(groups, group_offsets, device) -> torch.Tensor:
    """(G, 2) [column offset, rect mask] for the culled kernel, or (G, 3)
    [start, end, rect mask] for the brute-force one (group_offsets
    None)."""
    if group_offsets is None:
        meta = [(s, e, _rect_mask(sig, tag)) for s, e, sig, tag in groups]
    else:
        meta = [(off, _rect_mask(sig, tag))
                for (_, _, sig, tag), off in zip(groups, group_offsets)]
    return torch.tensor(meta, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=16)
def source_params(spec) -> np.ndarray:
    """The float32 parameter block both versions sample a Buie disk cell
    from (layout in csrc/bounce.cu): center, row-major rotation, radius,
    energy per ray, disc_end, has-aureole flag, the aureole constants and
    the 11 inverse-CDF polynomial coefficients."""
    (cx, cy, cz, rot, radius, e_ray, coeffs, disc_end, gamma, kappa,
     integ_sum, theta_tot, theta_dni) = spec[:13]
    band = spec[13] if len(spec) > 13 else None
    att = float(spec[14]) if len(spec) > 14 else 0.0
    rect = spec[15] if len(spec) > 15 else None
    med = spec[16] if len(spec) > 16 else None
    if (band is not None or att or rect is not None
            or (med and any(float(v) for v in med))):
        raise NotImplementedError(
            "wavelength bands, ambient media and rect sources are not "
            "ported yet (ROADMAP B2 stage b)")
    if len(coeffs) != _N_COEFFS:
        raise ValueError(f"expected {_N_COEFFS} inverse-CDF coefficients")
    c_aur = tt = inv = 0.0
    if gamma is not None:
        c_aur = float((gamma + 2.0) / (10.0 ** (3.0 * gamma)
                                       * float(np.exp(kappa))) * integ_sum
                      - theta_dni ** (gamma + 2.0))
        tt = float(theta_tot ** (gamma + 2.0))
        inv = 1.0 / (gamma + 2.0)
    out = np.array([cx, cy, cz, *rot, radius, e_ray, disc_end,
                    0.0 if gamma is None else 1.0, c_aur, tt, inv, *coeffs],
                   dtype=np.float32)
    out.setflags(write=False)
    return out


@functools.lru_cache(maxsize=16)
def _source_tensor(spec, device) -> torch.Tensor:
    return torch.tensor(source_params(spec), device=device)


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

_HEX_X = math.sqrt(3.0) / 2.0
_HEX_T = math.tan(math.pi / 6.0)


def _ap_ok(sig, r, x, y, z):
    """ANDed aperture predicates of the static signature ``sig``; r[k] is
    packed-row column k, broadcast against the local hit point x, y, z
    (the Pallas kernel's _ap_ok_static)."""
    ok = None
    for c, kind in enumerate(sig):
        p = [r[ROW_AP + 6 * c + j] for j in range(6)]
        if kind == G.AP_NONE:
            continue
        if kind == G.AP_RECT:
            m = (x.abs() <= p[0]) & (y.abs() <= p[1])
        elif kind == G.AP_RADIAL:
            r2 = x * x + y * y
            m = (r2 >= p[0] * p[0]) & (r2 <= p[1] * p[1])
        elif kind == G.AP_ZRANGE:
            m = (z >= p[0]) & (z <= p[1])
        elif kind == G.AP_ANGRANGE:
            ang = torch.atan2(y, x)
            ang = torch.where(ang < 0.0, ang + 2.0 * math.pi, ang)
            m = (ang >= p[0]) & (ang <= p[1])
        elif kind == G.AP_XCUT:
            m = x <= p[0]
        elif kind == G.AP_HEX:
            m = ((x.abs() <= _HEX_X * p[0])
                 & (y.abs() <= p[0] - _HEX_T * x.abs()))
        elif kind in (G.AP_TRIANGLE, G.AP_TRIANGLE_HOLE):
            d1 = (p[2] - p[0]) * (y - p[1]) - (p[3] - p[1]) * (x - p[0])
            d2 = (p[4] - p[2]) * (y - p[3]) - (p[5] - p[3]) * (x - p[2])
            d3 = (p[0] - p[4]) * (y - p[5]) - (p[1] - p[5]) * (x - p[4])
            inside = ~(((d1 < 0) | (d2 < 0) | (d3 < 0))
                       & ((d1 > 0) | (d2 > 0) | (d3 > 0)))
            m = inside if kind == G.AP_TRIANGLE else ~inside
        elif kind == G.AP_RECT_HOLE:
            m = ~(((x - p[0]).abs() <= p[2]) & ((y - p[1]).abs() <= p[3]))
        elif kind == G.AP_CIRC_HOLE:
            ex, ey = x - p[0], y - p[1]
            m = ex * ex + ey * ey > p[2] * p[2]
        elif kind == G.AP_CIRC:
            ex, ey = x - p[0], y - p[1]
            m = ex * ex + ey * ey <= p[2] * p[2]
        elif kind == G.AP_SPHERE:
            ex, ey, ez = x - p[0], y - p[1], z - p[2]
            m = ex * ex + ey * ey + ez * ez <= p[3] * p[3]
        elif kind == G.AP_ABS_HALFPLANE:
            m = (p[0] * x + p[1] * y).abs() <= p[2]
        else:
            raise ValueError(f"unknown aperture constraint {kind}")
        ok = m if ok is None else ok & m
    return ok


def _rows_t(r, tag, sig, rays, t_eps: float, disc_eps: float,
            backside_miss: bool):
    """(t, local hit, global gradient, local d_z) of every ray against a
    block of rows of one group; r[k] is packed-row column k shaped (B, 1),
    the ray components (N,). Results are (B, N); t is +inf on a miss."""
    px, py, pz, dx, dy, dz = rays
    vx = r[0] * px + r[1] * py + r[2] * pz + r[9]
    vy = r[3] * px + r[4] * py + r[5] * pz + r[10]
    vz = r[6] * px + r[7] * py + r[8] * pz + r[11]
    ddx = r[0] * dx + r[1] * dy + r[2] * dz
    ddy = r[3] * dx + r[4] * dy + r[5] * dz
    ddz = r[6] * dx + r[7] * dy + r[8] * dz
    if tag == "flat":
        t_hit = -vz / torch.where(ddz == 0.0, 1.0, ddz)
        t_thr = t_eps * (1.0 + vx.abs() + vy.abs() + vz.abs())
        hx, hy = vx + t_hit * ddx, vy + t_hit * ddy
        hz = torch.zeros_like(hx)
        ok = (ddz.abs() > 1e-7) & (t_hit > t_thr)
        ap = _ap_ok(sig, r, hx, hy, hz)
        if ap is not None:
            ok = ok & ap
        t_surf = torch.where(ok, t_hit, math.inf)
        g = [r[k].expand_as(hx) for k in (6, 7, 8)]
    else:
        axx, ayy, azz, axy, axz, ayz, bx, by, bz, c0 = r[12:22]
        if tag == "parab":
            A = axx * ddx * ddx + ayy * ddy * ddy
            B = 2.0 * (axx * ddx * vx + ayy * ddy * vy + bz * ddz)
            C = axx * vx * vx + ayy * vy * vy + 2.0 * bz * vz + c0
        elif tag == "sphere":
            A = axx * (ddx * ddx + ddy * ddy + ddz * ddz)
            B = 2.0 * axx * (ddx * vx + ddy * vy + ddz * vz)
            C = axx * (vx * vx + vy * vy + vz * vz) + c0
        else:
            A = (axx * ddx * ddx + ayy * ddy * ddy + azz * ddz * ddz
                 + 2.0 * (axy * ddx * ddy + axz * ddx * ddz
                          + ayz * ddy * ddz))
            B = 2.0 * (axx * ddx * vx + ayy * ddy * vy + azz * ddz * vz
                       + axy * (ddx * vy + ddy * vx)
                       + axz * (ddx * vz + ddz * vx)
                       + ayz * (ddy * vz + ddz * vy)
                       + bx * ddx + by * ddy + bz * ddz)
            C = (axx * vx * vx + ayy * vy * vy + azz * vz * vz
                 + 2.0 * (axy * vx * vy + axz * vx * vz + ayz * vy * vz)
                 + 2.0 * (bx * vx + by * vy + bz * vz) + c0)
        is_lin, is_b0 = A == 0.0, B == 0.0
        disc = B * B - 4.0 * A * C
        sq = torch.sqrt(torch.clamp(disc, min=0.0))
        qq = -0.5 * (B + torch.where(B >= 0.0, 1.0, -1.0) * sq)
        safe_a = torch.where(is_lin, 1.0, A)
        m_ca = -C / safe_a
        sqrt_mca = torch.sqrt(torch.clamp(m_ca, min=0.0))
        t_lin = -C / torch.where(is_b0, 1.0, B)
        t0 = torch.where(is_lin, t_lin,
                         torch.where(is_b0, -sqrt_mca, qq / safe_a))
        t1 = torch.where(is_lin, t_lin,
                         torch.where(is_b0, sqrt_mca,
                                     C / torch.where(qq == 0.0, 1.0, qq)))
        root_ok = ((is_lin & (B.abs() > 1e-7))
                   | (~is_lin & is_b0 & (m_ca >= 0.0))
                   | (~is_lin & ~is_b0 & (disc >= disc_eps)))
        t_thr = t_eps * (1.0 + torch.sqrt(vx * vx + vy * vy + vz * vz))

        def root_t(t):
            ok = root_ok & (t > t_thr)
            ap = _ap_ok(sig, r, vx + t * ddx, vy + t * ddy, vz + t * ddz)
            if ap is not None:
                ok = ok & ap
            return torch.where(ok, t, math.inf)

        t_surf = torch.minimum(root_t(t0), root_t(t1))
        hx, hy, hz = vx + t_surf * ddx, vy + t_surf * ddy, vz + t_surf * ddz
        if tag == "parab":
            gl = (axx * hx, ayy * hy, bz.expand_as(hx))
        elif tag == "sphere":
            gl = (axx * hx, axx * hy, axx * hz)
        else:
            gl = (axx * hx + axy * hy + axz * hz + bx,
                  axy * hx + ayy * hy + ayz * hz + by,
                  axz * hx + ayz * hy + azz * hz + bz)
        g = [r[i] * gl[0] + r[3 + i] * gl[1] + r[6 + i] * gl[2]
             for i in range(3)]
    if backside_miss:
        bm = torch.remainder(torch.floor(r[ROW_KIND] / 16.0), 2.0) >= 1.0
        t_surf = torch.where(bm & (ddz > 0.0), math.inf, t_surf)
    return t_surf, (hx, hy, hz), g, ddz


def _nearest_all(rows, groups, rays, t_eps: float, block: int = 16):
    """(t, sid) of the nearest hit over every row, rows in order (ties
    keep the earlier row, like the kernels' strict `<`)."""
    t_best = torch.full_like(rays[0], math.inf)
    sid = torch.full(rays[0].shape, -1, dtype=torch.int32,
                     device=rays[0].device)
    for start, end, sig, tag in groups:
        _rect_mask(sig, tag)                       # the kernels' subset
        for s0 in range(start, end, block):
            s1 = min(s0 + block, end)
            r = rows[s0:s1].T[:, :, None]          # (K, B, 1)
            t_blk = _rows_t(r, tag, sig, rays, t_eps, 1e-6, False)[0]
            t_min, i_min = torch.min(t_blk, dim=0)
            upd = t_min < t_best
            t_best = torch.where(upd, t_min, t_best)
            sid = torch.where(upd, (i_min + s0).to(torch.int32), sid)
    return t_best, sid


def _nearest_listed(rows, lists, counts, groups, group_offsets, blk, rays,
                    t_eps: float):
    """(t, sid) of the nearest hit over each lane's tile candidate list,
    one candidate slot at a time (gathers (N, K) rows per slot, never an
    N x L x K tensor)."""
    t_best = torch.full_like(rays[0], math.inf)
    sid = torch.full(rays[0].shape, -1, dtype=torch.int32,
                     device=rays[0].device)
    for g, ((_, _, sig, tag), off) in enumerate(zip(groups, group_offsets)):
        _rect_mask(sig, tag)                       # the kernels' subset
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


def _shade(rows, t_b, sid_b, rays, e_in, seed: int, stream, lane, bivar,
           one_sided: bool, slope: bool):
    """Reflect + slope error + one-sided kill on each lane's winner row
    (the epilogue both kernels share). Returns (pos, dir, energy,
    absorbed) before the live-lane masking."""
    px, py, pz, dx, dy, dz = rays
    hit = sid_b >= 0
    w = rows[sid_b.clamp(min=0).long()]
    zero = torch.zeros_like(px)
    ngx, ngy, ngz, kf, q0, q1 = (torch.where(hit, w[:, k], zero)
                                 for k in (6, 7, 8, ROW_KIND, ROW_P0,
                                           ROW_P0 + 1))
    upd_b = torch.where(hit, w[:, 6] * dx + w[:, 7] * dy + w[:, 8] * dz,
                        zero)
    t_safe = torch.where(hit, t_b, zero)
    hx, hy, hz = px + t_safe * dx, py + t_safe * dy, pz + t_safe * dz
    rinv = torch.rsqrt(torch.clamp(ngx * ngx + ngy * ngy + ngz * ngz,
                                   min=1e-30))
    flip = torch.where(dx * ngx + dy * ngy + dz * ngz > 0.0, -rinv, rinv)
    nx, ny, nz = ngx * flip, ngy * flip, ngz * flip
    if slope:
        u1, u2, u3, _ = uniforms(seed, stream, lane, CALL_SLOPE)
        rr = torch.sqrt(-2.0 * torch.log(u1))
        a_bm = (2.0 * math.pi) * u2
        nrm1 = rr * torch.cos(a_bm)
        sigma = q1
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
    e_out = e_in * (1.0 - q0)
    if one_sided:
        kill = (torch.fmod(kf, 2.0) >= 1.0) & (upd_b > 0.0)
        e_out = torch.where(kill, 0.0, e_out)
    pos = torch.stack([torch.where(hit, hx, px), torch.where(hit, hy, py),
                       torch.where(hit, hz, pz)], dim=1)
    dirs = torch.stack([torch.where(hit, rx, dx), torch.where(hit, ry, dy),
                        torch.where(hit, rz, dz)], dim=1)
    return (pos, dirs, torch.where(hit, e_out, e_in),
            torch.where(hit, e_in - e_out, zero))


def _sample_cell(spec, seed: int, stream, lane, cb):
    """Fresh rays from each lane's equal-area Buie disk cell
    [a0, a1, th0, th1] (the kernels' sample_cell)."""
    p = [float(v) for v in source_params(spec)]
    cx, cy, cz, rot = p[0], p[1], p[2], p[3:12]
    radius, disc_end, has_gamma, c_aur, tt, inv = (p[12], p[14], p[15],
                                                   p[16], p[17], p[18])
    coeffs = p[19:19 + _N_COEFFS]
    u1, u2, u3, u4 = uniforms(seed, stream, lane, CALL_REGEN)
    a0, a1, th0, th1 = cb.unbind(1)
    rr = radius * torch.sqrt(a0 + u1 * (a1 - a0))
    ang = th0 + u2 * (th1 - th0)
    lx, ly = rr * torch.cos(ang), rr * torch.sin(ang)
    fp = [rot[3 * i] * lx + rot[3 * i + 1] * ly + c
          for i, c in enumerate((cx, cy, cz))]
    u = torch.clamp(u3 / disc_end, max=1.0)
    acc = torch.full_like(u, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * u + c
    theta = torch.sqrt(u) * acc
    if has_gamma:
        base = (u3 - 1.0) * c_aur + u3 * tt
        th_aur = torch.exp(torch.log(torch.clamp(base, min=1e-30)) * inv)
        theta = torch.where(u3 >= disc_end, th_aur, theta)
    a_d = (2.0 * math.pi) * u4
    ax = torch.sin(theta) * torch.cos(a_d)
    ay = torch.sin(theta) * torch.sin(a_d)
    az = torch.cos(theta)
    fd = [rot[3 * i] * ax + rot[3 * i + 1] * ay + rot[3 * i + 2] * az
          for i in range(3)]
    return fp + fd


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
        e = torch.where(do, float(source_params(source_spec)[13]), e)
    t_b, sid_b = _nearest_listed(rows, lists, counts, groups, group_offsets,
                                 blk, rays, t_eps)
    npos, ndir, ne, absorbed = _shade(rows, t_b, sid_b, rays, e, seed,
                                      stream, lane, bivar, one_sided, slope)
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


def bounce_reflect_ref(rows, seed: int, pos, dirs, energy, groups,
                       t_eps: float, bivar=True, one_sided: bool = True,
                       slope: bool = True):
    """Plain PyTorch version of :func:`bounce_reflect`."""
    n = pos.shape[0]
    idx = torch.arange(n, device=pos.device)
    rays = list(pos.unbind(1)) + list(dirs.unbind(1))
    t_b, sid_b = _nearest_all(rows, groups, rays, t_eps)
    npos, ndir, ne, absorbed = _shade(rows, t_b, sid_b, rays, energy, seed,
                                      idx // TILE, idx % TILE, bivar,
                                      one_sided, slope)
    live = energy > 0.0
    sid = torch.where(live & (sid_b >= 0), sid_b, -1).to(torch.int32)
    return npos, ndir, ne, sid, torch.where(live, absorbed, 0.0)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_device(device, tensors):
    if device.type != "cuda":
        raise RuntimeError(f"the CUDA kernels take CUDA tensors, got "
                           f"{device}")
    for name, t in tensors.items():
        if t.device != device:
            raise RuntimeError(f"{name} is on {t.device}, rays on {device}")


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
                   t_eps: float, bivar=True, one_sided: bool = True,
                   slope: bool = True):
    """One fused brute-force bounce of any number of lanes against every
    row (port of bounce_reflect_pallas without regeneration, as the
    culled trace's drain calls it). Lane l draws from the stream of tile
    l // TILE. Returns (pos, dir, energy, sid, absorbed)."""
    if pos.device.type == "cpu":
        return bounce_reflect_ref(rows, seed, pos, dirs, energy, groups,
                                  t_eps, bivar=bivar, one_sided=one_sided,
                                  slope=slope)
    from . import build
    dev = pos.device
    n = pos.shape[0]
    S, K = rows.shape
    args = dict(rows=rows, pos=pos, dirs=dirs, energy=energy)
    _check_device(dev, args)
    for name, dt, shape in (("rows", torch.float32, (S, K)),
                            ("pos", torch.float32, (n, 3)),
                            ("dirs", torch.float32, (n, 3)),
                            ("energy", torch.float32, (n,))):
        _check(name, args[name], dt, shape)
    if S * K > MAX_STAGE_FLOATS:
        raise NotImplementedError("the rows table exceeds the shared-memory "
                                  "stage (ROADMAP B5)")
    gmeta = _group_meta(tuple(groups), None, dev)
    outs = _ray_outputs(n, dev)
    lib = build.load()
    rc = lib.tt_bounce(
        rows.data_ptr(), S, K, len(groups), gmeta.data_ptr(), int(seed),
        pos.data_ptr(), dirs.data_ptr(), energy.data_ptr(),
        *(o.data_ptr() for o in outs), n, float(t_eps), _BIVAR_MODE[bivar],
        int(one_sided), int(slope),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "bounce_reflect")
    bounce_reflect.launches += 1
    return outs


bounce_reflect.launches = 0
