"""Shading: apply each hit surface's optics to its rays (the PyTorch port
of tracer_tpu/kernels/shade.py, specular subset).

Ported: K_REFLECT rows (absorptivity p0), radial and bivariate slope
error (sigma p1), the one-sided kill, and both sources of per-ray surface
data: the winner's aux carried out of the nearest-hit kernel (K3), or a
gather of each ray's row from the table (the float64 oracle path). Every
other optics kind, spectral tables, the incidence-angle modifier, energy
splitting and participating media raise NotImplementedError with their
ROADMAP item.

Randomness comes from an explicit ``torch.Generator``; the same seed gives
other numbers than jax.random, so slope-error results compare with
tracer_tpu statistically.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import materials as M
from ..mathutils import dot, normalize, rotate_to_normal
from ..optics import reflections

_UNPORTED_FEATURES = {"spectral": "A9", "iam": "A9", "split": "A9",
                      "volumetric": "A9", "dispersive": "A9",
                      "refractive_slope": "A9"}


class ShadeResult(NamedTuple):
    out_pos: torch.Tensor       # (N,3) next-segment origin (global)
    out_dir: torch.Tensor       # (N,3) next-segment direction
    out_energy: torch.Tensor    # (N,)
    out_ref_index: torch.Tensor  # (N,)
    out_medium: tuple           # (att, scat, g) each (N,): entered medium
    absorbed: torch.Tensor      # (N,) energy deposited on the hit surface
    local_pt: torch.Tensor      # (N,3) hit point in surface-local coords
    normal: torch.Tensor        # (N,3) shading normal (global, against ray)
    backside: torch.Tensor      # (N,) bool, hit arrived along local +Z
    split: Optional[tuple] = None


def check_supported(scene) -> None:
    """Raise NotImplementedError for scene content the port's shade pass
    does not have yet."""
    kinds = set(scene.kinds_present) - {M.K_REFLECT}
    if kinds:
        raise NotImplementedError(
            f"optics kinds {sorted(kinds)} are not ported yet (ROADMAP A9; "
            "only K_REFLECT rows shade on the port)")
    for f in scene.features:
        if f in _UNPORTED_FEATURES:
            raise NotImplementedError(
                f"scene feature {f!r} is not ported yet (ROADMAP "
                f"{_UNPORTED_FEATURES[f]})")
    if getattr(scene, "ambient_medium", ()):
        raise NotImplementedError("scene-declared ambient media are not "
                                  "ported yet (ROADMAP A9)")


def _normals(n, generator, dtype, device):
    return torch.randn(n, generator=generator, dtype=dtype,
                       device=generator.device).to(device)


def shade(scene, sid, t, pos, dirs, energy, wavelength, ref_index,
          generator: torch.Generator, medium=None, aux=None,
          split_mode: bool = False) -> ShadeResult:
    """Shade every ray against its hit row (sid >= 0; other lanes get
    finite outputs that the engine masks). ``aux``, the winner's shading
    data from K3 (kernels/nearest.py), replaces the per-ray row gather.
    ``generator`` draws the slope-error normals and angles."""
    check_supported(scene)
    n = pos.shape[0]
    s = sid.clamp(min=0).long()
    features = set(scene.features)
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    hit_g = pos + t_safe[:, None] * dirs

    if aux is not None:
        p_l = aux["local"]
        n_geom = normalize(aux["normal"], eps=1e-30)
        kind, flags = aux["kind"], aux["flags"]
        backside = aux["up_dot"] > 0.0
        absorptivity, sigma = aux["p0"], aux["p1"]
    else:
        rot = scene.frame[s, :3, :3]                   # (N,3,3)
        trn = scene.frame[s, :3, 3]
        quad = scene.quadric[s]
        prm = scene.opt_params[s]
        kind, flags = scene.opt_kind[s], scene.opt_flags[s]
        # local coordinates p_l = R^T (p - t0)
        rel = hit_g - trn
        p_l = torch.stack([(rot[:, :, i] * rel).sum(1) for i in range(3)],
                          dim=1)
        x, y, z = p_l.unbind(1)
        # quadric gradient at the local hit point, (A p + b)
        grad = torch.stack([
            quad[:, 0] * x + quad[:, 3] * y + quad[:, 4] * z + quad[:, 6],
            quad[:, 3] * x + quad[:, 1] * y + quad[:, 5] * z + quad[:, 7],
            quad[:, 4] * x + quad[:, 5] * y + quad[:, 2] * z + quad[:, 8],
        ], dim=1)
        n_geom = torch.stack(
            [(rot[:, i, :] * normalize(grad, eps=1e-30)).sum(1)
             for i in range(3)], dim=1)
        backside = (dirs * rot[:, :, 2]).sum(1) > 0.0
        absorptivity, sigma = prm[:, 0], prm[:, 1]

    cos_geom = dot(dirs, n_geom)
    # the shading normal opposes the incoming ray
    ns = torch.where(cos_geom[:, None] > 0.0, -n_geom, n_geom)

    n_eff = ns
    if "slope_error" in features:
        # tracer_tpu draws phi, then the normals: same distribution
        phi = torch.rand(n, generator=generator, dtype=pos.dtype,
                         device=generator.device).to(pos.device)
        phi = phi * (2.0 * math.pi)
        nrm1 = _normals(n, generator, pos.dtype, pos.device)
        th = nrm1 * sigma
        err = torch.stack([torch.sin(th) * torch.cos(phi),
                           torch.sin(th) * torch.sin(phi),
                           torch.cos(th)], dim=1)
        if "bivar" in features:
            nrm2 = _normals(n, generator, pos.dtype, pos.device)
            tanx = torch.tan(nrm1 * sigma)
            tany = torch.tan(nrm2 * sigma)
            ez = 1.0 / torch.sqrt(1.0 + tanx ** 2 + tany ** 2)
            bivar_err = torch.stack([tanx * ez, tany * ez, ez], dim=1)
            err = torch.where(((flags & M.F_BIVAR) != 0)[:, None],
                              bivar_err, err)
        n_pert = normalize(rotate_to_normal(err, ns), eps=1e-30)
        n_eff = torch.where((sigma > 0.0)[:, None], n_pert, ns)

    out_dir = normalize(reflections(dirs, n_eff), eps=1e-30)
    out_energy = energy * (1.0 - absorptivity)
    if "one_sided" in features:
        out_energy = torch.where(((flags & M.F_ONE_SIDED) != 0) & backside,
                                 0.0, out_energy)
    if medium is None:
        zero = torch.zeros_like(ref_index)
        medium = (zero, zero, zero)
    return ShadeResult(hit_g, out_dir, out_energy, ref_index, medium,
                       energy - out_energy, p_l, ns, backside, None)
