"""Sampling library (the PyTorch port of tracer_tpu/sampling.py):
piecewise-linear, -lincos, -lincossin and bilinear inverse-CDF
distributions, the Henyey-Greenstein phase function, importance sampling
through a piecewise-linear approximation, tabulated BDRFs, the shape
samplers and Lambertian directions about per-point normals; and the
uniform draw and the Lambertian directions about +Z that every source of
sources.py shares.

Distributions precompute a dense inverse-CDF table on the host (exact
per-interval quadratic inversion), so device sampling is two loads and a
lerp. Every sampler takes an explicit ``torch.Generator`` and returns
tensors on ``device`` (None means the GPU). Densities and CDFs
(``__call__``, ``pdf``, ``cdf``, ``f``) are evaluated in float64: on a
tensor's device for a tensor, in NumPy otherwise.
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


def _f64(x):
    """``x`` in float64: a tensor stays on its device, anything else
    becomes a NumPy array."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return np.asarray(x, dtype=float)


def _like(table, x):
    """A host node table in the kind of ``x``: a float64 tensor on x's
    device for a tensor, the NumPy table otherwise."""
    if isinstance(x, torch.Tensor):
        return torch.as_tensor(table, dtype=x.dtype, device=x.device)
    return table


def _segment(nodes, x):
    """Interval index of ``x`` among the sorted ``nodes``, clipped to the
    intervals (a tensor or NumPy, like x)."""
    if isinstance(x, torch.Tensor):
        return (torch.searchsorted(_like(nodes, x), x.contiguous(),
                                   right=True) - 1).clamp(0, len(nodes) - 2)
    return np.clip(np.searchsorted(nodes, x, side="right") - 1, 0,
                   len(nodes) - 2)


def _xp(x):
    return torch if isinstance(x, torch.Tensor) else np


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
        return _segment(self.xs, x)

    def _pdf_t(self, x):
        """The normalized density at torch samples ``x``, in their
        dtype."""
        loc = self._slice(x)
        return (_like(self.a, x)[loc] * x
                + _like(self.b, x)[loc]) / self.tot_integ

    def __call__(self, x):
        """The unnormalised density a_i x + b_i (float64)."""
        x = _f64(x)
        loc = _segment(self.xs, x)
        return _like(self.a, x)[loc] * x + _like(self.b, x)[loc]

    def pdf(self, x):
        return self(x) / self.tot_integ

    def cdf(self, x):
        x = _f64(x)
        loc = _segment(self.xs, x)
        return (_like(self.cdf_def, x)[loc]
                + (x - _like(self.xs, x)[loc])
                * (self.pdf(x) + _like(self.ys, x)[loc] / self.tot_integ)
                / 2.0)

    # the reference's names
    PDF = pdf
    CDF = cdf

    def sample(self, generator, ns: int, dtype=torch.float32, device=None):
        """(samples, weights), both (ns,) on ``device``."""
        device = resolve(device)
        u = _uniform(generator, ns, dtype, device) * _INV_N
        i0 = u.long().clamp(0, _INV_N - 1)
        frac = u - i0.to(dtype)
        inv = torch.as_tensor(self._inv, dtype=dtype, device=device)
        x = inv[i0] * (1.0 - frac) + inv[i0 + 1] * frac
        return x, torch.ones((ns,), dtype=dtype, device=device)


class _PWLinWeighted(PWLinearDistribution):
    """A density (a_i x + b_i) h(x), sampled from its piecewise-linear
    approximation ys(x) h(x) with importance weights renormalised to mean
    1; ``_h`` is h, ``_fa``/``_fb`` the per-segment a_i, b_i of ys and
    ``_tot`` the density's exact integral."""

    def f(self, x):
        """The density (a_i x + b_i) h(x) (float64)."""
        x = _f64(x)
        loc = _segment(self.xs, x)
        return (_like(self._fa, x)[loc] * x
                + _like(self._fb, x)[loc]) * self._h(x)

    def sample(self, generator, ns: int, dtype=torch.float32, device=None):
        x, w = super().sample(generator, ns, dtype, device)
        loc = self._slice(x)
        f = ((_like(self._fa, x)[loc] * x + _like(self._fb, x)[loc])
             * self._h(x))
        w = w * (f / self._tot) / self._pdf_t(x).clamp(min=1e-300)
        return x, w * ns / w.sum()


class PWLinCosDistribution(_PWLinWeighted):
    """Density ys(x) cos(x), sampled from its piecewise-linear
    approximation with importance weights (mean 1)."""

    def __init__(self, xs, ys):
        xs = np.asarray(xs, dtype=float)
        ys = np.asarray(ys, dtype=float)
        super().__init__(xs, ys * np.cos(xs))
        self.a_cos = (ys[1:] - ys[:-1]) / (xs[1:] - xs[:-1])
        self.b_cos = ys[:-1] - self.a_cos * xs[:-1]
        self.integ_cos = (ys[1:] * np.sin(xs[1:]) - ys[:-1] * np.sin(xs[:-1])
                          + self.a_cos * (np.cos(xs[1:]) - np.cos(xs[:-1])))
        self.tot_integ_cos = self.integ_cos.sum()
        self._fa, self._fb, self._tot = (self.a_cos, self.b_cos,
                                         self.tot_integ_cos)

    @staticmethod
    def _h(x):
        return _xp(x).cos(x)

    def pdf_cos(self, x):
        return self.f(x) / self.tot_integ_cos


class PWLinCosSinDistribution(_PWLinWeighted):
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
        self._fa, self._fb, self._tot = (self.a_cs, self.b_cs,
                                         self.tot_integ_cs)

    @staticmethod
    def _h(x):
        xp = _xp(x)
        return xp.cos(x) * xp.sin(x)

    def pdf_cossin(self, x):
        return self.f(x) / self.tot_integ_cs


class PWBilinearDistribution:
    """Bilinear density on a regular (xu, yu) grid. The conditional draw
    follows the reference's per-x-interval importance scheme: each
    interval's y distribution at its midpoint, inverted on the host."""

    def __init__(self, xu, yu, zs):
        self.xu = np.asarray(xu, dtype=float)
        self.yu = np.asarray(yu, dtype=float)
        self.zs = np.asarray(zs, dtype=float)
        f_x = np.array([PWLinearDistribution(self.yu, self.zs[i]).tot_integ
                        for i in range(len(self.xu))])
        self.dist_x = PWLinearDistribution(self.xu, f_x)
        self.tot_integ = self.dist_x.tot_integ
        self._y_dists = []
        for i in range(len(self.xu) - 1):
            x_mid = 0.5 * (self.xu[i] + self.xu[i + 1])
            self._y_dists.append(PWLinearDistribution(
                self.yu, self._interp_rows(x_mid)))
        self._y_inv = np.stack([d._inv for d in self._y_dists])
        self._y_a = np.stack([d.a for d in self._y_dists])
        self._y_b = np.stack([d.b for d in self._y_dists])
        self._y_tot = np.array([d.tot_integ for d in self._y_dists])

    def _interp_rows(self, x):
        i = np.clip(np.searchsorted(self.xu, x, side="right") - 1,
                    0, len(self.xu) - 2)
        w = (x - self.xu[i]) / (self.xu[i + 1] - self.xu[i])
        if np.ndim(x):
            w = np.asarray(w)[..., None]   # broadcast over the y axis
        return self.zs[i] * (1 - w) + self.zs[i + 1] * w

    def _bilinear_t(self, x, y):
        """The bilinear density at tensors x, y, in their dtype."""
        i, j = _segment(self.xu, x), _segment(self.yu, y)
        xu, yu, zs = (_like(a, x) for a in (self.xu, self.yu, self.zs))
        wx = (x - xu[i]) / (xu[i + 1] - xu[i])
        wy = (y - yu[j]) / (yu[j + 1] - yu[j])
        return (zs[i, j] * (1 - wx) * (1 - wy) + zs[i + 1, j] * wx * (1 - wy)
                + zs[i, j + 1] * (1 - wx) * wy + zs[i + 1, j + 1] * wx * wy)

    def __call__(self, x, y):
        """The unnormalised bilinear density (float64)."""
        if isinstance(x, torch.Tensor):
            return self._bilinear_t(_f64(x), _f64(y))
        x = np.asarray(x, dtype=float)
        y = np.asarray(y, dtype=float)
        rows = np.atleast_2d(self._interp_rows(x))
        j = np.atleast_1d(np.clip(np.searchsorted(self.yu, y, side="right")
                                  - 1, 0, len(self.yu) - 2))
        wy = (y - self.yu[j]) / (self.yu[j + 1] - self.yu[j])
        k = np.arange(len(j))
        pick = rows[k, j] * (1 - wy) + rows[k, j + 1] * wy
        return pick if np.ndim(x) else float(pick[0])

    def pdf(self, x, y):
        return self(x, y) / self.tot_integ

    def sample(self, generator, ns: int, dtype=torch.float32, device=None):
        """(x, y, weights) on ``device``: x from the marginal, y from its
        interval's midpoint conditional, the weights the true conditional
        density over the sampled one."""
        x, _ = self.dist_x.sample(generator, ns, dtype, device)
        i = _segment(self.xu, x)
        u = _uniform(generator, ns, dtype, x.device) * _INV_N
        j0 = u.long().clamp(0, _INV_N - 1)
        frac = u - j0.to(dtype)
        inv = _like(self._y_inv, x)
        y = inv[i, j0] * (1 - frac) + inv[i, j0 + 1] * frac
        j = _segment(self.yu, y)
        p_x = self.dist_x._pdf_t(x)
        p_cond = (self._bilinear_t(x, y) / self.tot_integ) \
            / p_x.clamp(min=1e-300)
        p_sample = ((_like(self._y_a, x)[i, j] * y
                     + _like(self._y_b, x)[i, j]) / _like(self._y_tot, x)[i])
        return x, y, p_cond / p_sample.clamp(min=1e-300)


class HenyeyGreenstein:
    """Henyey-Greenstein phase function with analytic inverse-CDF
    sampling."""

    def __init__(self, g: float):
        self.g = float(g)

    def __call__(self, th):
        """The phase function at polar angles ``th`` (a tensor or
        NumPy)."""
        g = self.g
        return (1.0 / (4.0 * np.pi) * (1.0 - g**2)
                / (1.0 + g**2 - 2.0 * g * _xp(th).cos(th)) ** 1.5)

    def sample(self, generator, ns: int, dtype=torch.float32, device=None):
        """(theta, phi), both (ns,) on ``device``."""
        device = resolve(device)
        s = 2.0 * _uniform(generator, ns, dtype, device) - 1.0
        phis = _uniform(generator, ns, dtype, device, 0.0, 2.0 * np.pi)
        g = self.g
        if g == 0.0:
            return torch.arccos(s), phis
        cos_th = (1.0 + g**2 - ((1.0 - g**2) / (1.0 + g * s)) ** 2) \
            / (2.0 * g)
        return torch.arccos(torch.clamp(cos_th, -1.0, 1.0)), phis


def pw_linear_importance_sampling(dist, generator, ns: int,
                                  dtype=torch.float32, device=None):
    """Sample a 1-D density ``dist`` (with ``xs``, ``__call__`` and
    ``pdf``) through its piecewise-linear approximation on ``dist.xs``:
    weights dist.pdf over the sampled density, renormalised to mean 1.
    ``dist.pdf`` is called on the samples' tensor."""
    sampling = PWLinearDistribution(dist.xs, np.asarray(dist(dist.xs)))
    x, w = sampling.sample(generator, ns, dtype, device)
    p = torch.as_tensor(dist.pdf(x), dtype=x.dtype, device=x.device)
    w = w * p / sampling._pdf_t(x).clamp(min=1e-300)
    return x, w / (w.sum() / ns)


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


def _cumtrapz(y, x):
    dx = np.diff(x)
    return np.concatenate([[0.0], np.cumsum(0.5 * (y[1:] + y[:-1]) * dx)])


def _invert_density(xs, ys, n_inv, refine):
    """Dense inverse CDF of a piecewise-linear density ys(xs) >= 0 (host
    side). Returns (inverse table (n_inv+1,), total integral)."""
    xf = np.linspace(xs[0], xs[-1], refine * (len(xs) - 1) + 1)
    yf = np.interp(xf, xs, ys)
    c = _cumtrapz(yf, xf)
    tot = float(c[-1])
    if tot <= 0.0:
        return np.full(n_inv + 1, xs[0]), 0.0
    q = np.linspace(0.0, 1.0, n_inv + 1) * tot
    return np.interp(q, c, xf), tot


def _interp_t(x, xp, fp):
    """np.interp of a tensor ``x`` on sorted nodes ``xp`` (held at the
    end values outside them), in x's dtype and on its device."""
    xp, fp = _like(xp, x), _like(fp, x)
    if xp.numel() == 1:
        return fp[0].expand_as(x)
    xc = torch.minimum(torch.maximum(x, xp[0]), xp[-1])
    i = _segment(xp, xc)
    w = (xc - xp[i]) / (xp[i + 1] - xp[i])
    return fp[i] + w * (fp[i + 1] - fp[i])


def _bilerp(tab, fi, fj):
    """tab (A, B) tensor; fi, fj fractional indices (n,): four gathers,
    bilinear."""
    A, B = tab.shape
    i0 = torch.floor(fi).long().clamp(0, A - 2)
    j0 = torch.floor(fj).long().clamp(0, B - 2)
    wi = (fi - i0).clamp(0.0, 1.0)
    wj = (fj - j0).clamp(0.0, 1.0)
    flat = tab.reshape(-1)

    def g(ii, jj):
        return flat[ii * B + jj]
    return ((1 - wi) * (1 - wj) * g(i0, j0) + (1 - wi) * wj * g(i0, j0 + 1)
            + wi * (1 - wj) * g(i0 + 1, j0) + wi * wj * g(i0 + 1, j0 + 1))


def _trilerp(tab, fi, fj, fk):
    """tab (A, B, C) tensor; fractional indices (n,): eight gathers,
    trilinear (an axis of length 1 is not interpolated)."""
    A, B, C = tab.shape
    i0 = torch.floor(fi).long().clamp(0, max(A - 2, 0))
    j0 = torch.floor(fj).long().clamp(0, max(B - 2, 0))
    k0 = torch.floor(fk).long().clamp(0, C - 2)
    wi = (fi - i0).clamp(0.0, 1.0) if A > 1 else torch.zeros_like(fi)
    wj = (fj - j0).clamp(0.0, 1.0) if B > 1 else torch.zeros_like(fj)
    wk = (fk - k0).clamp(0.0, 1.0)
    i1 = (i0 + 1).clamp(max=A - 1)
    j1 = (j0 + 1).clamp(max=B - 1)
    flat = tab.reshape(-1)

    def g(ii, jj, kk):
        return flat[(ii * B + jj) * C + kk]
    out = 0.0
    for ii, wii in ((i0, 1 - wi), (i1, wi)):
        for jj, wjj in ((j0, 1 - wj), (j1, wj)):
            out = out + wii * wjj * ((1 - wk) * g(ii, jj, k0)
                                     + wk * g(ii, jj, k0 + 1))
    return out


class BDRFDistribution:
    """Tabulated BDRF over reflected (theta_r, phi_r), optionally resolved
    in the incidence angle theta_i (axisymmetric incidence).

    bdrf - (Tr, Pr) array (incidence-independent) or (Ti, Tr, Pr) with
    thetas_i. The sampled density is bdrf(th, phi) cos(th) sin(th). Each
    incidence row's theta_r marginal and the per-theta_r phi conditionals
    are inverted once on the host into dense inverse-CDF tables, so a
    draw is a few gathers and lerps a ray, exact (no weights), and the
    directional-hemispherical reflectance DHR(theta_i), the reflected
    energy factor, falls out of the same integration. Between incidence
    rows the inverse CDFs are interpolated linearly."""

    def __init__(self, thetas_r, phis_r, bdrf, thetas_i=None,
                 n_inv: int = 256, refine: int = 8):
        th = np.asarray(thetas_r, dtype=float)
        ph = np.asarray(phis_r, dtype=float)
        B = np.asarray(bdrf, dtype=float)
        if B.ndim == 2:
            B = B[None]
            ti = np.zeros(1)
        else:
            ti = np.asarray(thetas_i, dtype=float)
        Ti, Tr, Pr = B.shape
        if (Ti, Tr, Pr) != (len(ti), len(th), len(ph)):
            raise ValueError("bdrf shape does not match the angle grids")
        thr_inv = np.zeros((Ti, n_inv + 1))
        phi_inv = np.zeros((Ti, Tr, n_inv + 1))
        dhr = np.zeros(Ti)
        for i in range(Ti):
            f_th = np.array([_cumtrapz(B[i, j], ph)[-1] for j in range(Tr)])
            thr_inv[i], dhr[i] = _invert_density(
                th, f_th * np.cos(th) * np.sin(th), n_inv, refine)
            for j in range(Tr):
                phi_inv[i, j], _ = _invert_density(ph, B[i, j], n_inv, refine)
        self.thetas_i = ti
        self.thetas_r = th
        self._thr_inv = thr_inv
        self._phi_inv = phi_inv
        self._dhr = dhr
        self._n_inv = n_inv

    def dhr(self, theta_i):
        """Directional-hemispherical reflectance at incidence theta_i (the
        energy factor of reflected rays): a tensor in its dtype on its
        device, NumPy otherwise."""
        if isinstance(theta_i, torch.Tensor):
            if len(self._dhr) == 1:
                return _like(self._dhr, theta_i)[0].expand_as(theta_i)
            return _interp_t(theta_i, self.thetas_i, self._dhr)
        theta_i = np.asarray(theta_i, dtype=float)
        if len(self._dhr) == 1:
            return np.broadcast_to(self._dhr[0], theta_i.shape)
        return np.interp(theta_i, self.thetas_i, self._dhr)

    def sample(self, generator, theta_i=0.0, ns: int = None,
               dtype=torch.float32, device=None):
        """Reflected (theta_r, phi_r) on ``device``; theta_i a scalar
        (with ``ns`` draws) or one per ray. Exact inverse-CDF draws: no
        weights."""
        device = resolve(device)
        theta_i = torch.as_tensor(theta_i, dtype=dtype, device=device)
        if theta_i.ndim == 0:
            theta_i = theta_i.expand(ns)
        n = theta_i.shape[0]
        u1 = _uniform(generator, n, dtype, device)
        u2 = _uniform(generator, n, dtype, device)
        Ti = self._thr_inv.shape[0]
        if Ti > 1:
            fi = _interp_t(theta_i, self.thetas_i, np.arange(Ti, dtype=float))
        else:
            fi = torch.zeros((n,), dtype=dtype, device=device)
        th = _bilerp(_like(self._thr_inv, theta_i), fi, u1 * self._n_inv)
        fj = _interp_t(th, self.thetas_r,
                       np.arange(len(self.thetas_r), dtype=float))
        phi = _trilerp(_like(self._phi_inv, theta_i), fi, fj,
                       u2 * self._n_inv)
        return th, phi
