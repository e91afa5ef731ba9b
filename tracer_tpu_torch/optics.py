"""Stateless optics laws on (N, 3) tensors (the PyTorch port of
tracer_tpu/optics.py: reflection, vector Snell refraction and the
dielectric Fresnel reflectance)."""
from __future__ import annotations

import torch

from .mathutils import dot, safe_sqrt


def fresnel(ray_dirs, normals, n1, n2) -> torch.Tensor:
    """Unpolarized Fresnel reflectance of a dielectric interface; 1 under
    total internal reflection. n1, n2 are scalars or (N,)."""
    cos1 = dot(normals, ray_dirs).abs()
    sin1_sq = torch.clamp(1.0 - cos1 * cos1, 0.0, 1.0)
    ratio = n1 / n2
    under = 1.0 - ratio * ratio * sin1_sq
    bar = safe_sqrt(under)
    rs = ((n1 * cos1 - n2 * bar) / (n1 * cos1 + n2 * bar)) ** 2
    rp = ((n1 * bar - n2 * cos1) / (n1 * bar + n2 * cos1)) ** 2
    return torch.where(under < 0.0, 1.0, 0.5 * (rs + rp))


def reflections(ray_dirs, normals) -> torch.Tensor:
    """Mirror law d - 2 (d.n) n on (N,3) rows."""
    return ray_dirs - 2.0 * dot(ray_dirs, normals)[..., None] * normals


def refractions(n1, n2, ray_dirs, normals):
    """Vector Snell refraction. Returns (refracted mask, directions); the
    directions are valid only where the mask holds (TIR elsewhere). n1,
    n2 are scalars or (N,)."""
    n = torch.as_tensor(n2, dtype=ray_dirs.dtype,
                        device=ray_dirs.device) / n1
    cos1 = dot(normals, ray_dirs)
    refracted = cos1 ** 2 >= 1.0 - n ** 2
    safe_n = torch.where(n == 0.0, 1.0, n)
    t = (ray_dirs - cos1[..., None] * normals) / safe_n[..., None]
    cos2 = safe_sqrt(1.0 - (1.0 - cos1 ** 2) / safe_n ** 2)
    t = t + normals * (cos2 * torch.where(cos1 < 0.0, -1.0, 1.0))[..., None]
    return refracted, t
