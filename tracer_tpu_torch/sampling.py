"""Sampling helpers of the view-factor and emission sources (the PyTorch
port of the parts of tracer_tpu/sampling.py that sources.gray_source and
sources.spectral_band_axisymmetrical_thermal_emission_source use):
piecewise-linear inverse-CDF distributions, the shape samplers and
Lambertian directions about per-point normals; and the uniform draw and
the Lambertian directions about +Z that every source of sources.py
shares.

Distributions precompute a dense inverse-CDF table on the host (exact
per-interval quadratic inversion), so device sampling is two loads and a
lerp. Every sampler takes an explicit ``torch.Generator`` and returns
tensors on ``device`` (None means the GPU).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve
from .geometry import triangulate_polygon
from .mathutils import rotate_to_normal

_INV_N = 1 << 12  # dense inverse-CDF resolution


def _uniform(generator, n: int, dtype, device, lo: float = 0.0,
             hi: float = 1.0) -> torch.Tensor:
    u = torch.rand(n, generator=generator, dtype=dtype,
                   device=generator.device)
    if lo != 0.0 or hi != 1.0:
        u = lo + (hi - lo) * u
    return u.to(device)


def lambertian_directions(generator, num_rays: int, ang_range: float,
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """Cosine-weighted directions about +Z within ``ang_range``."""
    device = resolve(device)
    phi = _uniform(generator, num_rays, dtype, device, 0.0, 2.0 * np.pi)
    if ang_range == 0.0:
        return torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                            device=device).expand(num_rays, 3).clone()
    u = _uniform(generator, num_rays, dtype, device)
    sinsqrt = float(np.sin(ang_range)) * torch.sqrt(u)
    return torch.stack([torch.cos(phi) * sinsqrt, torch.sin(phi) * sinsqrt,
                        torch.sqrt(1.0 - sinsqrt ** 2)], dim=1)


def _dense_inverse_cdf(xs, a, b, cdf, tot_integ, n=_INV_N):
    """Invert a piecewise-linear-density CDF exactly on a dense quantile
    grid (host side). The density on [xs_i, xs_i+1] is a_i x + b_i."""
    r = np.linspace(0.0, 1.0, n + 1)
    i = np.clip(np.searchsorted(cdf, r, side="right") - 1, 0, len(xs) - 2)
    aa = a[i] / (2.0 * tot_integ)
    bb = b[i] / tot_integ
    cc = cdf[i] - aa * xs[i] ** 2 - bb * xs[i]
    with np.errstate(invalid="ignore", divide="ignore"):
        lin = xs[i] + (r - cdf[i]) / np.where(bb == 0.0, 1.0, bb)
        D = np.maximum(bb ** 2 - 4.0 * aa * (cc - r), 0.0)
        quad = (-bb + np.sqrt(D)) / np.where(aa == 0.0, 1.0, 2.0 * aa)
    out = np.where(aa == 0.0, lin, quad)
    out[0], out[-1] = xs[0], xs[-1]
    return np.clip(out, xs[0], xs[-1])


class PWLinearDistribution:
    """Piecewise-linear 1D density on nodes (xs, ys)."""

    def __init__(self, xs, ys):
        self.xs = np.round(np.asarray(xs, dtype=float), 8)
        self.ys = np.round(np.asarray(ys, dtype=float), 8)
        dx = self.xs[1:] - self.xs[:-1]
        self.a = (self.ys[1:] - self.ys[:-1]) / dx
        self.b = self.ys[:-1] - self.a * self.xs[:-1]
        self.integ = dx * (self.ys[1:] + self.ys[:-1]) / 2.0
        self.tot_integ = self.integ.sum()
        self.cdf_def = (np.concatenate([[0.0], np.cumsum(self.integ)])
                        / self.tot_integ)
        self._inv = _dense_inverse_cdf(self.xs, self.a, self.b,
                                       self.cdf_def, self.tot_integ)

    def _slice(self, x):
        """Interval index of each sample (torch)."""
        xs = torch.as_tensor(self.xs, dtype=x.dtype, device=x.device)
        return (torch.searchsorted(xs, x, right=True) - 1).clamp(
            0, len(self.xs) - 2)

    def _pdf_t(self, x):
        """The normalized density at torch samples ``x``."""
        loc = self._slice(x)
        f = dict(dtype=x.dtype, device=x.device)
        return (torch.as_tensor(self.a, **f)[loc] * x
                + torch.as_tensor(self.b, **f)[loc]) / self.tot_integ

    def sample(self, generator, ns: int, dtype=torch.float32, device=None):
        """(samples, weights), both (ns,) on ``device``."""
        device = resolve(device)
        u = _uniform(generator, ns, dtype, device) * _INV_N
        i0 = u.long().clamp(0, _INV_N - 1)
        frac = u - i0.to(dtype)
        inv = torch.as_tensor(self._inv, dtype=dtype, device=device)
        x = inv[i0] * (1.0 - frac) + inv[i0 + 1] * frac
        return x, torch.ones((ns,), dtype=dtype, device=device)


class PWLinCosSinDistribution(PWLinearDistribution):
    """Density ys(x) cos(x) sin(x), sampled from its piecewise-linear
    approximation with importance weights (mean 1)."""

    def __init__(self, xs, ys):
        xs = np.asarray(xs, dtype=float)
        ys = np.asarray(ys, dtype=float)
        super().__init__(xs, ys * np.cos(xs) * np.sin(xs))
        self.a_cs = (ys[1:] - ys[:-1]) / (xs[1:] - xs[:-1])
        self.b_cs = ys[:-1] - self.a_cs * xs[:-1]
        # per-segment exact integral of (a_i x + b_i) cos x sin x, each
        # segment's slope at both of its endpoints
        s2 = np.sin(xs) ** 2
        t = xs - np.sin(xs) * np.cos(xs)
        self.integ_cs = (ys[1:] / 2.0 * s2[1:] - ys[:-1] / 2.0 * s2[:-1]
                         - self.a_cs / 4.0 * (t[1:] - t[:-1]))
        self.tot_integ_cs = self.integ_cs.sum()

    def sample(self, generator, ns: int, dtype=torch.float32, device=None):
        x, w = super().sample(generator, ns, dtype, device)
        loc = self._slice(x)
        f = dict(dtype=x.dtype, device=x.device)
        f_cs = ((torch.as_tensor(self.a_cs, **f)[loc] * x
                 + torch.as_tensor(self.b_cs, **f)[loc])
                * torch.cos(x) * torch.sin(x))
        w = w * (f_cs / self.tot_integ_cs) / self._pdf_t(x).clamp(min=1e-300)
        return x, w * ns / w.sum()


# ---------------------------------------------------------------------------
# shape samplers: (positions, normals), (ns, 3) each in the shape's frame
# ---------------------------------------------------------------------------

def _up(ns, dtype, device):
    return torch.tensor([0.0, 0.0, 1.0], dtype=dtype,
                        device=device).expand(ns, 3).clone()


def disk_sampling(generator, r_ext: float, ns: int, r_int: float = 0.0,
                  dtype=torch.float32, device=None):
    device = resolve(device)
    ths = _uniform(generator, ns, dtype, device, 0.0, 2.0 * np.pi)
    rs = torch.sqrt(_uniform(generator, ns, dtype, device)
                    * (r_ext ** 2 - r_int ** 2) + r_int ** 2)
    pos = torch.stack([rs * torch.cos(ths), rs * torch.sin(ths),
                       torch.zeros_like(rs)], dim=1)
    return pos, _up(ns, dtype, device)


def rectangle_sampling(generator, lx: float, ly: float, ns: int,
                       dtype=torch.float32, device=None):
    device = resolve(device)
    u = _uniform(generator, ns, dtype, device)
    v = _uniform(generator, ns, dtype, device)
    pos = torch.stack([(u - 0.5) * lx, (v - 0.5) * ly, torch.zeros_like(u)],
                      dim=1)
    return pos, _up(ns, dtype, device)


def triangle_sampling(generator, A, B, C, ns: int, dtype=torch.float32,
                      device=None):
    device = resolve(device)
    A, B, C = (torch.as_tensor(np.asarray(v, dtype=float).reshape(3),
                               dtype=dtype, device=device)
               for v in (A, B, C))
    r1 = torch.sqrt(_uniform(generator, ns, dtype, device))
    r2 = _uniform(generator, ns, dtype, device)
    pos = (A[None] * (1 - r1)[:, None] + (r1 * (1 - r2))[:, None] * B[None]
           + (r1 * r2)[:, None] * C[None])
    n = torch.linalg.cross(B - A, C - A)
    return pos, (n / torch.linalg.norm(n)).expand(ns, 3).clone()


def polygon_sampling(generator, verts, ns: int, dtype=torch.float32,
                     device=None):
    """Uniform points in a simple polygon: triangulation, then
    area-weighted triangle picking."""
    device = resolve(device)
    verts = np.asarray(verts, dtype=float)
    p = verts[triangulate_polygon(verts)]                 # (m, 3, 2)
    areas = 0.5 * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 2, 0] - p[:, 0, 0]) * (p[:, 1, 1] - p[:, 0, 1]))
    cdf = torch.as_tensor(np.cumsum(areas / areas.sum())[:-1], dtype=dtype,
                          device=device)
    ti = torch.searchsorted(cdf, _uniform(generator, ns, dtype, device),
                            right=True)
    P = torch.as_tensor(np.concatenate([p, np.zeros((len(p), 3, 1))],
                                       axis=2), dtype=dtype, device=device)
    A, B, C = P[ti, 0], P[ti, 1], P[ti, 2]
    r1 = torch.sqrt(_uniform(generator, ns, dtype, device))
    r2 = _uniform(generator, ns, dtype, device)
    pos = (A * (1 - r1)[:, None] + (r1 * (1 - r2))[:, None] * B
           + (r1 * r2)[:, None] * C)
    return pos, _up(ns, dtype, device)


def cylinder_sampling(generator, radius: float, height: float, ns: int,
                      inward: bool = False, dtype=torch.float32,
                      device=None):
    device = resolve(device)
    phi = _uniform(generator, ns, dtype, device, 0.0, 2.0 * np.pi)
    z = _uniform(generator, ns, dtype, device, -height / 2, height / 2)
    pos = torch.stack([radius * torch.cos(phi), radius * torch.sin(phi), z],
                      dim=1)
    nrm = torch.stack([torch.cos(phi), torch.sin(phi), torch.zeros_like(z)],
                      dim=1)
    return pos, (-nrm if inward else nrm)


def frustum_sampling(generator, r0: float, r1: float, depth: float, ns: int,
                     inward: bool = False, dtype=torch.float32, device=None):
    device = resolve(device)
    u = _uniform(generator, ns, dtype, device)
    rs = torch.sqrt((r1 ** 2 - r0 ** 2) * u + r0 ** 2)
    zs = (rs - r0) * depth / (r1 - r0)
    phi = _uniform(generator, ns, dtype, device, 0.0, 2.0 * np.pi)
    pos = torch.stack([rs * torch.cos(phi), rs * torch.sin(phi), zs], dim=1)
    alpha = np.arctan2(r1 - r0, depth)
    nrm = torch.stack([torch.cos(phi) * np.cos(alpha),
                       torch.sin(phi) * np.cos(alpha),
                       torch.full_like(phi, -np.sin(alpha))], dim=1)
    return pos, (-nrm if inward else nrm)


def sphere_sampling(generator, radius: float, ns: int, inward: bool = False,
                    dtype=torch.float32, device=None):
    device = resolve(device)
    v = torch.randn((ns, 3), generator=generator, dtype=dtype,
                    device=generator.device).to(device)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True)
    return radius * v, (-v if inward else v)


def lambertian_directions_sampling(generator, ns: int, normals=None,
                                   ang_range: float = np.pi / 2,
                                   dtype=torch.float32, device=None):
    """Cosine-weighted directions, rotated onto per-point ``normals``
    (ns, 3) when given."""
    dirs = lambertian_directions(generator, ns, ang_range, dtype, device)
    if normals is not None:
        dirs = rotate_to_normal(dirs, torch.as_tensor(
            normals, dtype=dtype, device=dirs.device).expand(ns, 3))
    return dirs
