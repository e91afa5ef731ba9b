"""Stateless optics laws on (N, 3) tensors (the PyTorch port of
tracer_tpu/optics.py): reflection, vector Snell refraction, the
dielectric and absorbing-medium Fresnel reflectances, Hartmann
dispersion, Beer-Lambert attenuation and exponential free paths."""
from __future__ import annotations

import math

import torch

from .mathutils import dot, safe_arccos, safe_sqrt


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


def fresnel_to_attenuating(n1, m2, theta1):
    """Dielectric -> absorbing-medium interface (Modest ch. 2). ``m2``, the
    absorbing side's complex index, is a complex number or tensor or a
    (real, imaginary) pair of real tensors; the shade passes the pair, so
    no complex tensor reaches the card. Returns (R_p, R_s, theta2)."""
    if isinstance(m2, tuple):
        n2r, k2 = (torch.as_tensor(v) for v in m2)
    else:
        m2 = torch.as_tensor(m2)
        n2r, k2 = ((m2.real, m2.imag) if m2.is_complex()
                   else (m2, torch.zeros_like(m2)))
    theta1 = torch.as_tensor(theta1)
    s1 = n1 * torch.sin(theta1)
    b = n2r ** 2 - k2 ** 2 - s1 ** 2
    a = safe_sqrt(b ** 2 + 4.0 * (n2r * k2) ** 2)
    p = safe_sqrt(0.5 * (a + b))
    q = safe_sqrt(0.5 * (a - b))
    theta2 = torch.atan2(s1, p)
    c1 = n1 * torch.cos(theta1)
    r_s = ((c1 - p) ** 2 + q ** 2) / ((c1 + p) ** 2 + q ** 2)
    st = s1 * torch.tan(theta1)
    r_p = ((p - st) ** 2 + q ** 2) / ((p + st) ** 2 + q ** 2) * r_s
    return r_p, r_s, theta2


def fresnel_conductor(ray_dirs, normals, m2, n1=1.0):
    """Fresnel reflectances (R_p, R_s, theta2) against a conductor of
    complex index ``m2`` (as fresnel_to_attenuating takes it)."""
    theta_in = safe_arccos(dot(normals, ray_dirs).abs())
    return fresnel_to_attenuating(n1, m2, theta_in)


def refr_idx_hartmann(wavelength, a, b, c, d, e):
    """Hartmann dispersion n(L) = a + b / (c - L) + d / (e - L)."""
    return a + b / (c - wavelength) + d / (e - wavelength)


def attenuations(path_lengths, k, lambda_0, energy):
    """Beer-Lambert attenuation of ``energy`` over ``path_lengths`` through
    a medium of absorption index k at vacuum wavelength lambda_0."""
    path_lengths = torch.as_tensor(path_lengths)
    return torch.exp(-4.0 * math.pi * path_lengths * k / lambda_0) * energy


def sample_scattering(generator, sigma, intersection_path_lengths):
    """Exponential free paths to a scattering event of coefficient
    ``sigma`` (N,), drawn from ``generator``. Returns (scattered mask,
    path lengths): a lane scatters where its free path ends before
    ``intersection_path_lengths``; where sigma <= 0 the path is the
    intersection's. The uniform is clamped to float32's smallest normal,
    so no draw of 0 makes an infinite path."""
    t = intersection_path_lengths
    u = torch.rand(t.shape, generator=generator, dtype=t.dtype,
                   device=generator.device).to(t.device)
    u = u.clamp(min=torch.finfo(torch.float32).tiny)
    s = -torch.log(u) / torch.where(sigma <= 0.0, 1.0, sigma)
    s = torch.where(sigma <= 0.0, t, s)
    return s < t, s


def R_from_n_k(n1, n2, thetas_in):
    """Unpolarized reflectance against the incidence angle for real
    indices."""
    thetas_in = torch.as_tensor(thetas_in)
    c = torch.cos(thetas_in)
    bar = torch.sqrt(torch.clamp(
        1.0 - (n1 / n2 * torch.sin(thetas_in)) ** 2, min=0.0))
    rs = ((n1 * c - n2 * bar) / (n1 * c + n2 * bar)) ** 2
    rp = ((n1 * bar - n2 * c) / (n1 * bar + n2 * c)) ** 2
    return 0.5 * (rs + rp)
