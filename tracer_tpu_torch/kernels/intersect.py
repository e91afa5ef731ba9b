"""Nearest-hit intersection over a compiled scene (the PyTorch port of
tracer_tpu/kernels/intersect.py).

Two routes, chosen by dtype as tracer_tpu chooses between its jnp path and
its Pallas kernel:

* float32 goes through K3, the hand-written nearest-hit kernel
  (kernels/nearest.py): the CUDA kernel on CUDA tensors, its plain version
  on CPU tensors. It also returns the winner's shading data (``aux``).
* float64 goes through the oracle below, a dtype-generic transcription of
  tracer_tpu's jnp path: every quadric solved with the general
  10-coefficient formula, the L2 self-hit guard, apertures of each group's
  static signature. It runs on CPU tensors only; float64 on CUDA is not
  ported (ROADMAP A4).

Numerics follow the reference's: roots by the stable q-formula, the linear
(A == 0) and B == 0 branches, the discriminant threshold for grazing hits,
and a scale-relative positive-t threshold.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .. import geometry as G
from .. import materials as M
from ..mathutils import apply_rot, safe_sqrt

_F64_CUDA = ("float64 tracing on CUDA tensors is not ported yet (ROADMAP "
             "A4: the oracle runs on CPU tensors; the card's nearest-hit "
             "kernel is float32)")


def default_t_eps(dtype) -> float:
    """Relative positive-t threshold by precision: float32 needs a much
    larger self-intersection guard than float64's 1e-6."""
    return 3e-4 if torch.finfo(dtype).bits <= 32 else 1e-6


def _constraint_pred(kind: int, p, x, y, z):
    """Predicate of ONE statically known constraint type; p[..., j] are its
    parameters, broadcast against the ray-shaped x, y, z."""
    if kind == G.AP_NONE:
        return None
    if kind == G.AP_RECT:
        return (x.abs() <= p[..., 0]) & (y.abs() <= p[..., 1])
    if kind == G.AP_RADIAL:
        r2 = x * x + y * y
        return (r2 >= p[..., 0] ** 2) & (r2 <= p[..., 1] ** 2)
    if kind == G.AP_ZRANGE:
        return (z >= p[..., 0]) & (z <= p[..., 1])
    if kind == G.AP_ANGRANGE:
        ang = torch.atan2(y, x)
        ang = torch.where(ang < 0.0, ang + 2.0 * math.pi, ang)
        return (ang >= p[..., 0]) & (ang <= p[..., 1])
    if kind == G.AP_XCUT:
        return x <= p[..., 0]
    if kind == G.AP_HEX:
        return ((x.abs() <= math.sqrt(3.0) * p[..., 0] / 2.0)
                & (y.abs() <= p[..., 0] - math.tan(math.pi / 6.0) * x.abs()))
    if kind in (G.AP_TRIANGLE, G.AP_TRIANGLE_HOLE):
        d1 = ((p[..., 2] - p[..., 0]) * (y - p[..., 1])
              - (p[..., 3] - p[..., 1]) * (x - p[..., 0]))
        d2 = ((p[..., 4] - p[..., 2]) * (y - p[..., 3])
              - (p[..., 5] - p[..., 3]) * (x - p[..., 2]))
        d3 = ((p[..., 0] - p[..., 4]) * (y - p[..., 5])
              - (p[..., 1] - p[..., 5]) * (x - p[..., 4]))
        has_neg = (d1 < 0) | (d2 < 0) | (d3 < 0)
        has_pos = (d1 > 0) | (d2 > 0) | (d3 > 0)
        inside = ~(has_neg & has_pos)
        return inside if kind == G.AP_TRIANGLE else ~inside
    if kind == G.AP_RECT_HOLE:
        return ~(((x - p[..., 0]).abs() <= p[..., 2])
                 & ((y - p[..., 1]).abs() <= p[..., 3]))
    if kind == G.AP_CIRC_HOLE:
        return ((x - p[..., 0]) ** 2 + (y - p[..., 1]) ** 2) > p[..., 2] ** 2
    if kind == G.AP_CIRC:
        return ((x - p[..., 0]) ** 2 + (y - p[..., 1]) ** 2) <= p[..., 2] ** 2
    if kind == G.AP_SPHERE:
        return ((x - p[..., 0]) ** 2 + (y - p[..., 1]) ** 2
                + (z - p[..., 2]) ** 2) <= p[..., 3] ** 2
    if kind == G.AP_ABS_HALFPLANE:
        return (p[..., 0] * x + p[..., 1] * y).abs() <= p[..., 2]
    raise ValueError(f"unknown aperture constraint {kind}")


def aperture_mask_static(sig, ap_params, pt):
    """ANDed aperture constraints of a static signature. ap_params (...,
    C, 6) broadcast against the local points pt (..., 3)."""
    x, y, z = pt[..., 0], pt[..., 1], pt[..., 2]
    ok = None
    for c, kind in enumerate(sig):
        pred = _constraint_pred(kind, ap_params[..., c, :], x, y, z)
        if pred is None:
            continue
        ok = pred if ok is None else (ok & pred)
    if ok is None:
        return torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return ok


def _surface_t(inv_frame, quad, ap_params, pos, dirs, t_eps: float,
               disc_eps: float, sig, flags=None):
    """Hit distance of every ray against a block of B rows that share the
    static aperture signature ``sig``: inv_frame (B,4,4), quad (B,10),
    ap_params (B,C,6), flags (B,) or None; rays (N,3). Returns t (B, N),
    +inf on a miss. F_BACKSIDE_MISS rows reject rays arriving along local
    +Z (the bifacial face selector)."""
    rot = inv_frame[:, None, :3, :3]
    v = apply_rot(rot, pos) + inv_frame[:, None, :3, 3]     # (B, N, 3)
    d = apply_rot(rot, dirs)
    t_min = t_eps * (1.0 + torch.sqrt((v * v).sum(-1)))

    axx, ayy, azz, axy, axz, ayz, bx, by, bz, c0 = (quad[:, i, None]
                                                    for i in range(10))

    def q_form(p, q2):
        return (axx * p[..., 0] * q2[..., 0] + ayy * p[..., 1] * q2[..., 1]
                + azz * p[..., 2] * q2[..., 2]
                + axy * (p[..., 0] * q2[..., 1] + p[..., 1] * q2[..., 0])
                + axz * (p[..., 0] * q2[..., 2] + p[..., 2] * q2[..., 0])
                + ayz * (p[..., 1] * q2[..., 2] + p[..., 2] * q2[..., 1]))

    def b_dot(p):
        return bx * p[..., 0] + by * p[..., 1] + bz * p[..., 2]

    A = q_form(d, d)
    B = 2.0 * (q_form(d, v) + b_dot(d))
    C = q_form(v, v) + 2.0 * b_dot(v) + c0
    is_linear = A == 0.0
    is_b0 = B == 0.0
    disc = B * B - 4.0 * A * C
    sq = safe_sqrt(disc)
    q = -0.5 * (B + torch.where(B >= 0.0, 1.0, -1.0) * sq)
    safe_a = torch.where(is_linear, 1.0, A)
    safe_q = torch.where(q == 0.0, 1.0, q)
    m_ca = -C / safe_a
    sqrt_mca = safe_sqrt(m_ca)
    t_lin = -C / torch.where(is_b0, 1.0, B)
    t0 = torch.where(is_linear, t_lin,
                     torch.where(is_b0, -sqrt_mca, q / safe_a))
    t1 = torch.where(is_linear, t_lin,
                     torch.where(is_b0, sqrt_mca, C / safe_q))
    root_ok = torch.where(is_linear, B.abs() > 1e-7,
                          torch.where(is_b0, m_ca >= 0.0, disc >= disc_eps))
    ap = ap_params[:, None]                                 # (B, 1, C, 6)

    def root_t(t):
        ok = root_ok & (t > t_min) & torch.isfinite(t)
        if sig:
            ok = ok & aperture_mask_static(sig, ap, v + t[..., None] * d)
        return torch.where(ok, t, math.inf)

    t_best = torch.minimum(root_t(t0), root_t(t1))
    if flags is not None:
        bmiss = (flags & M.F_BACKSIDE_MISS) != 0
        t_best = torch.where(bmiss[:, None] & (d[..., 2] > 0.0), math.inf,
                             t_best)
    return t_best


def _oracle_nearest(scene, pos, dirs, t_eps: float, disc_eps: float,
                    block: int):
    if pos.device.type != "cpu":
        raise NotImplementedError(_F64_CUDA)
    if not scene.groups:
        raise ValueError("SceneTable.groups missing: compile with "
                         "scene.compile_scene")
    t_best = torch.full_like(pos[:, 0], math.inf)
    sid_best = torch.full(pos[:, 0].shape, -1, dtype=torch.int32)
    for start, end, sig, _tag in scene.groups:
        for s0 in range(start, end, block):
            s1 = min(s0 + block, end)
            t_blk = _surface_t(scene.inv_frame[s0:s1], scene.quadric[s0:s1],
                               scene.ap_params[s0:s1], pos, dirs, t_eps,
                               disc_eps, sig, flags=scene.opt_flags[s0:s1])
            t_min, i_min = torch.min(t_blk, dim=0)     # first row on ties
            upd = t_min < t_best
            t_best = torch.where(upd, t_min, t_best)
            sid_best = torch.where(upd, (i_min + s0).to(torch.int32),
                                   sid_best)
    return t_best, torch.where(torch.isfinite(t_best), sid_best, -1)


def nearest_hit(scene, pos, dirs, t_eps: Optional[float] = None,
                disc_eps: float = 1e-6, block: Optional[int] = None,
                use_pallas: Optional[bool] = None):
    """Nearest surface hit per ray over the whole scene table.

    Returns (t, sid): t (N,) hit distance (+inf = escaped), sid (N,) int32
    row of the hit surface (-1 = escaped). ``use_pallas`` None picks K3 for
    float32 rays and the oracle otherwise; False forces the oracle (CPU
    tensors only), True forces K3."""
    if t_eps is None:
        t_eps = default_t_eps(pos.dtype)
    if use_pallas is None:
        use_pallas = pos.dtype == torch.float32
    if use_pallas:
        t, sid, _ = _k3(scene, pos, dirs, t_eps, disc_eps, need_local=False)
        return t, sid
    return _oracle_nearest(scene, pos, dirs, t_eps, disc_eps, block or 16)


def _k3(scene, pos, dirs, t_eps, disc_eps, need_local: bool):
    from . import nearest
    from .bounce import pack_rows
    return nearest.nearest_hit(pack_rows(scene), pos, dirs, scene.groups,
                               t_eps, disc_eps, need_local=need_local,
                               backside_miss="bifacial" in scene.features)


def nearest_hit_aux(scene, pos, dirs, t_eps=None, disc_eps: float = 1e-6,
                    block=None, need_local: bool = True,
                    force_jnp: bool = False):
    """Like nearest_hit, but float32 rays (K3) also return the winner's
    shading data: dict(normal (N,3) unnormalised global gradient, local
    (N,3), up_dot, kind, flags, p0, p1), which lets the shade pass skip
    its row gather. Returns (t, sid, aux_or_None); the float64 oracle
    gives aux None. ``need_local=False`` skips the local hit point.
    ``force_jnp`` (tracer_tpu's switch for reverse-mode autodiff) is not
    ported: differentiable tracing is ROADMAP A12."""
    if force_jnp:
        raise NotImplementedError("differentiable tracing (force_jnp) is "
                                  "not ported yet (ROADMAP A12)")
    if t_eps is None:
        t_eps = default_t_eps(pos.dtype)
    if pos.dtype == torch.float32:
        return _k3(scene, pos, dirs, t_eps, disc_eps, need_local)
    t, sid = _oracle_nearest(scene, pos, dirs, t_eps, disc_eps, block or 16)
    return t, sid, None
