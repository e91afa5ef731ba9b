"""The packed scene-row table the CUDA kernels read, and its plain per-row
intersection (the Python twin of csrc/rows.cuh): every quadric class and
aperture kind of the TPU kernels' _surface_body / _ap_ok_static
(tracer_tpu/kernels/pallas_intersect.py:232, :92). K2 (kernels/bounce.py)
and K3 (kernels/nearest.py) share it, as their CUDA kernels share
rows.cuh."""
from __future__ import annotations

import math

import torch

from .. import geometry as G

ROW_KIND = 22          # optics kind*1024 + flags (as float)
ROW_P0 = 23            # first seven optics params
ROW_AP = 30            # C*6 aperture params follow


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


# the wrappers' checks of their tensor arguments

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
