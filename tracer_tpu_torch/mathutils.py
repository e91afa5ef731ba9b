"""Vector math on (N, 3) tensors used by the trace kernels' plain versions
and the shade pass (the PyTorch port of tracer_tpu/mathutils.py).

Small rotations are written out elementwise, as tracer_tpu does: the
results then round like the CUDA kernels', lane by lane, whatever the
matrix-product backend would do.
"""
from __future__ import annotations

import math

import torch


def normalize(v: torch.Tensor, dim: int = -1, eps: float = 0.0):
    """Unit vectors along ``dim``; zero vectors stay finite when eps > 0
    (their norm is taken as eps)."""
    n2 = (v * v).sum(dim=dim, keepdim=True)
    if eps:
        good = n2 > eps * eps
        n = torch.where(good, torch.sqrt(torch.where(good, n2, 1.0)),
                        torch.full_like(n2, eps))
    else:
        n = torch.sqrt(n2)
    return v / n


def dot(a: torch.Tensor, b: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return (a * b).sum(dim=dim)


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero gradient on the clamped lanes: the
    double-where form, since sqrt'(0) = inf times the zero cotangent of a
    masked miss or total-internal-reflection lane would give NaN in
    reverse mode (diff.trace_diff)."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def safe_arccos(c: torch.Tensor) -> torch.Tensor:
    """arccos(clip(c, -1, 1)) with a zero gradient at |c| >= 1 instead of
    the infinite one-sided derivative, so lanes at exactly normal
    incidence stay differentiable."""
    cc = torch.clamp(c, -1.0, 1.0)
    inner = cc.abs() < 1.0
    return torch.where(inner, torch.arccos(torch.where(inner, cc, 0.0)),
                       torch.where(cc > 0.0, torch.zeros_like(cc),
                                   torch.full_like(cc, math.pi)))


def rotation_to_z(vecs: torch.Tensor) -> torch.Tensor:
    """Frames (..., 3, 3) whose Z axis is ``vecs``: columns [perp, v x
    perp, v], with perp in the XY plane (x when v is along +-Z)."""
    vx, vy = vecs[..., 0], vecs[..., 1]
    perp = torch.stack([vy, -vx, torch.zeros_like(vx)], dim=-1)
    nrm2 = (perp * perp).sum(dim=-1, keepdim=True)
    singular = nrm2 < 1e-24
    fallback = torch.zeros_like(perp)
    fallback[..., 0] = 1.0
    perp = torch.where(singular, fallback,
                       perp / torch.sqrt(torch.where(singular, 1.0, nrm2)))
    ycol = torch.linalg.cross(vecs, perp, dim=-1)
    return torch.stack([perp, ycol, vecs], dim=-1)


def apply_rot(rot: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """rot @ v for rot (3,3) or (N,3,3) and vecs (N,3), elementwise."""
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    return torch.stack([
        rot[..., i, 0] * x + rot[..., i, 1] * y + rot[..., i, 2] * z
        for i in range(3)], dim=-1)


def rotate_to_normal(local_dirs: torch.Tensor,
                     normals: torch.Tensor) -> torch.Tensor:
    """Rotate directions sampled about +Z into frames whose Z is
    ``normals``; both (N,3)."""
    return apply_rot(rotation_to_z(normals), local_dirs)


def transform_points(frame: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Homogeneous ``frame`` (4, 4), or one per point (N, 4, 4), applied
    to points (N, 3)."""
    return apply_rot(frame[..., :3, :3], pts) + frame[..., :3, 3]


def transform_dirs(frame: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """The rotation part of ``frame`` applied to directions (N, 3)."""
    return apply_rot(frame[..., :3, :3], dirs)
