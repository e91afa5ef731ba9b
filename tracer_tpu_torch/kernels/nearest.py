"""K3, the nearest-hit kernel: wrapper of the CUDA kernel in
csrc/nearest.cu and its plain PyTorch version (port of
tracer_tpu.kernels.pallas_intersect.nearest_hit_pallas).

For every ray, the nearest hit over every row of every group, rows in
order (ties keep the earlier row), plus the winner's shading data (aux):
its unnormalised global gradient, the local hit point, the local d_z
(``up_dot``), its optics kind and flags and its first two optics params.
Each group's quadric class picks its solve, as in the Pallas kernel:
"flat" (t = -v_z/d_z with the L1 self-hit guard), "parab", "sphere" and
"quadric" (stable q-formula, linear and B == 0 branches, the L2 guard).
Every aperture kind of the group's static signature is tested.

``backside_miss`` makes rows flagged F_BACKSIDE_MISS reject rays arriving
along local +Z, for every class. tracer_tpu's Pallas kernel applies it to
curved rows only; its jnp path, which this follows, to every row (ROADMAP
C records the difference).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. ``nearest_hit.launches`` counts launches.
"""
from __future__ import annotations

import functools
import math

import torch

from .. import geometry as G
from .bounce import (ROW_AP, ROW_KIND, ROW_P0, _check, _check_device,
                     _rows_t)

CLASSES = {"flat": 0, "parab": 1, "sphere": 2, "quadric": 3}
MAX_C = 8                  # aperture slots per row the kernel takes
STAGE_FLOATS = 12 * 1024   # floats of rows staged per chunk (nearest.cu)

def nearest_hit_ref(rows, pos, dirs, groups, t_eps: float,
                    disc_eps: float = 1e-6, need_local: bool = True,
                    backside_miss: bool = False, block: int = 16):
    """Plain PyTorch version of :func:`nearest_hit` (same arguments and
    results), ``block`` rows at a time. It also runs in float64 (rows and
    rays both), which the tests use to build exact shading data."""
    n = pos.shape[0]
    dev = pos.device
    f = dict(dtype=pos.dtype, device=dev)
    rays = list(pos.unbind(1)) + list(dirs.unbind(1))
    t_best = torch.full((n,), math.inf, **f)
    sid = torch.full((n,), -1, dtype=torch.int32, device=dev)
    zero = torch.zeros((n,), **f)
    carry = [zero] * 6 + [zero, zero, zero, zero]  # g, local, up, kf, p0, p1
    lane = torch.arange(n, device=dev)
    for start, end, sig, tag in groups:
        for s0 in range(start, end, block):
            s1 = min(s0 + block, end)
            r = rows[s0:s1].T[:, :, None]                  # (K, B, 1)
            t, h, g, up = _rows_t(r, tag, sig, rays, t_eps, disc_eps,
                                  backside_miss)
            t_min, i_min = torch.min(t, dim=0)             # first on ties
            upd = t_min < t_best
            t_best = torch.where(upd, t_min, t_best)
            sid = torch.where(upd, (i_min + s0).to(torch.int32), sid)
            w = rows[s0:s1][i_min]                         # (N, K)
            new = ([a[i_min, lane] for a in (*g, *h)]
                   + [up[i_min, lane], w[:, ROW_KIND], w[:, ROW_P0],
                      w[:, ROW_P0 + 1]])
            carry = [torch.where(upd, a, b) for a, b in zip(new, carry)]
    kf = carry[7].to(torch.int32)
    local = (torch.stack(carry[3:6], dim=1) if need_local
             else torch.zeros((n, 3), **f))
    aux = dict(normal=torch.stack(carry[0:3], dim=1), local=local,
               up_dot=carry[6], kind=kf // 1024, flags=kf % 1024,
               p0=carry[8], p1=carry[9])
    return t_best, torch.where(torch.isfinite(t_best), sid, -1), aux


def nearest_two_t(rows, pos, dirs, groups, t_eps: float,
                  disc_eps: float = 1e-6, backside_miss: bool = False,
                  block: int = 16):
    """(t1, t2): the smallest and second-smallest hit distance of each ray
    over the rows, with the plain version's arithmetic. Lanes where the
    two are within rounding of each other are ties: the kernel and any
    other version may pick either row there."""
    rays = list(pos.unbind(1)) + list(dirs.unbind(1))
    t1 = torch.full((pos.shape[0],), math.inf, dtype=pos.dtype,
                    device=pos.device)
    t2 = t1.clone()
    for start, end, sig, tag in groups:
        for s0 in range(start, end, block):
            r = rows[s0:min(s0 + block, end)].T[:, :, None]
            t = _rows_t(r, tag, sig, rays, t_eps, disc_eps,
                        backside_miss)[0]
            t = torch.cat([t, torch.full_like(t[:1], math.inf)])
            b1, b2 = torch.topk(t, 2, dim=0, largest=False).values
            t1, t2 = (torch.minimum(t1, b1),
                      torch.minimum(torch.maximum(t1, b1),
                                    torch.minimum(t2, b2)))
    return t1, t2


@functools.lru_cache(maxsize=64)
def _group_meta(groups, device) -> torch.Tensor:
    """(G, 3 + MAX_C) int32: first row, end row, quadric class, aperture
    kind of each constraint slot (AP_NONE past the signature)."""
    meta = []
    for start, end, sig, tag in groups:
        if len(sig) > MAX_C:
            raise NotImplementedError(
                f"{len(sig)} aperture slots > {MAX_C} in the K3 kernel")
        meta.append([start, end, CLASSES[tag]] + list(sig)
                    + [G.AP_NONE] * (MAX_C - len(sig)))
    return torch.tensor(meta, dtype=torch.int32, device=device)


def nearest_hit(rows, pos, dirs, groups, t_eps: float,
                disc_eps: float = 1e-6, need_local: bool = True,
                backside_miss: bool = False):
    """Nearest hit over all surface groups (port of nearest_hit_pallas).

    rows   (S, K) float32 packed table (bounce.pack_rows)
    pos, dirs (N, 3) float32 rays
    groups static tuple of (start, end, signature, quadric class)

    Returns (t, sid, aux): t (N,) float32, +inf on a miss; sid (N,) int32,
    -1 where t is not finite; aux = dict(normal (N,3) unnormalised global
    gradient (R e_z for flat rows), local (N,3) local hit point (zeros
    without need_local), up_dot (N,) local d_z, kind, flags (N,) int32,
    p0, p1 (N,) float32) of the winning row."""
    if pos.device.type == "cpu":
        return nearest_hit_ref(rows, pos, dirs, groups, t_eps, disc_eps,
                               need_local=need_local,
                               backside_miss=backside_miss)
    from . import build
    dev = pos.device
    n = pos.shape[0]
    S, K = rows.shape
    _check_device(dev, dict(rows=rows, pos=pos, dirs=dirs))
    for name, t, shape in (("rows", rows, (S, K)), ("pos", pos, (n, 3)),
                           ("dirs", dirs, (n, 3))):
        _check(name, t, torch.float32, shape)
    if (K - ROW_AP) % 6 or (K - ROW_AP) // 6 > MAX_C:
        raise ValueError(f"rows: {K} columns is not 30 + 6 * C with "
                         f"C <= {MAX_C}")
    # the kernel reads rows [start, end) of every group
    for start, end, sig, _ in groups:
        if not 0 <= start <= end <= S or len(sig) > (K - ROW_AP) // 6:
            raise ValueError(f"group ({start}, {end}, {sig}) does not fit "
                             f"the ({S}, {K}) rows table")
    gmeta = _group_meta(tuple(groups), dev)
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    t = torch.empty((n,), **f32)
    sid = torch.empty((n,), **i32)
    normal = torch.empty((n, 3), **f32)
    local = (torch.empty((n, 3), **f32) if need_local
             else torch.zeros((n, 3), **f32))
    up, p0, p1 = (torch.empty((n,), **f32) for _ in range(3))
    kind, flags = torch.empty((n,), **i32), torch.empty((n,), **i32)
    lib = build.load()
    rc = lib.tt_nearest(
        rows.data_ptr(), S, K, len(groups), gmeta.data_ptr(), MAX_C,
        pos.data_ptr(), dirs.data_ptr(), t.data_ptr(), sid.data_ptr(),
        normal.data_ptr(), local.data_ptr(), up.data_ptr(),
        kind.data_ptr(), flags.data_ptr(), p0.data_ptr(), p1.data_ptr(), n,
        float(t_eps), float(disc_eps), int(need_local), int(backside_miss),
        torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "nearest_hit")
    nearest_hit.launches += 1
    return t, sid, dict(normal=normal, local=local, up_dot=up, kind=kind,
                        flags=flags, p0=p0, p1=p1)


nearest_hit.launches = 0
