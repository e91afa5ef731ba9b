"""Light sources of the NSTTF and MiniDish traces: the Buie-sunshape disk
and the pillbox disk (the PyTorch port of the matching parts of
tracer_tpu/sources.py).

Every sampler takes an explicit ``torch.Generator`` and returns a
:class:`RayBundle` on ``device`` (None means the GPU,
device.default_device; the generator may live elsewhere). Energy
conventions and the host-side Buie tables are those of tracer_tpu; the
same seed gives other numbers than jax.random, so comparisons with the JAX
package are statistical.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .bundle import RayBundle
from .device import resolve
from . import spatial


def _as_row3(x) -> np.ndarray:
    return np.asarray(x, dtype=float).reshape(3)


def _rotate_rows(M, rows: torch.Tensor) -> torch.Tensor:
    """Apply a (3,3) rotation to (N,3) row vectors, elementwise."""
    M = np.asarray(M, dtype=float)
    x, y, z = rows.unbind(1)
    return torch.stack([float(M[i, 0]) * x + float(M[i, 1]) * y
                        + float(M[i, 2]) * z for i in range(3)], dim=1)


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


# ---------------------------------------------------------------------------
# Buie sunshape (ref sources.py:330-516)
# ---------------------------------------------------------------------------

_THETA_DNI = 4.65e-3   # solar-disc half angle [rad]
_THETA_TOT = 43.6e-3   # end of circumsolar aureole [rad]


def _buie_tables(CSR: float, pre_process_CSR: bool = True):
    """Host-side precompute of the discretized Buie solar-disc PDF/CDF and
    aureole parameters. Mirrors ref Buie_directions_sampling steps 1-2."""
    nelem = 210
    theta_int = np.linspace(0.0, _THETA_DNI, nelem + 1)
    phi_dni = np.cos(0.326 * theta_int * 1e3) / np.cos(0.308 * theta_int * 1e3)
    w = phi_dni * np.cos(theta_int) * np.sin(theta_int)
    integ = 0.5 * (w[:-1] + w[1:]) * np.diff(theta_int)

    kappa = gamma = 0.0
    if CSR == 0.0:
        integ_phi = integ.sum()
    else:
        if pre_process_CSR:
            if CSR <= 0.1:
                CSR = (-2.245e3 * CSR**4 + 5.207e2 * CSR**3
                       - 3.939e1 * CSR**2 + 1.891 * CSR + 8e-3)
            else:
                CSR = (1.973 * CSR**4 - 2.481 * CSR**3 + 0.607 * CSR**2
                       + 1.151 * CSR - 0.020)
        kappa = 0.9 * np.log(13.5 * CSR) * CSR ** (-0.3)
        gamma = 2.2 * np.log(0.52 * CSR) * CSR ** 0.43 - 0.1
        integ_csr = (1e-6 * np.exp(kappa) / (gamma + 2.0)
                     * ((_THETA_TOT * 1e3) ** (gamma + 2.0)
                        - (_THETA_DNI * 1e3) ** (gamma + 2.0)))
        integ_phi = integ.sum() + integ_csr

    pdf = integ / integ_phi
    cdf = np.concatenate([[0.0], np.cumsum(pdf)])
    return dict(theta=theta_int, w=w, integ_sum=integ.sum(), cdf=cdf,
                kappa=kappa, gamma=gamma, csr=CSR)


_BUIE_INV_N = 1 << 14  # dense inverse-CDF table resolution


def _buie_inverse_table(tb) -> np.ndarray:
    """Host-side dense inverse CDF of the solar-disc part: theta at
    _BUIE_INV_N+1 uniform quantiles of [0, cdf_disc_end]. Exact per-interval
    quadratic inversion (same math as ref Buie_directions_sampling step 3),
    evaluated once in NumPy."""
    theta, w, cdf = tb["theta"], tb["w"], tb["cdf"]
    disc_end = cdf[-1]
    r = np.linspace(0.0, disc_end, _BUIE_INV_N + 1)
    i = np.clip(np.searchsorted(cdf, r, side="right") - 1, 0, len(cdf) - 2)
    A, B = w[i], w[i + 1]
    t0, t1 = theta[i], theta[i + 1]
    C = 2.0 * tb["integ_sum"] * (r - cdf[i]) * (t1 - t0)
    with np.errstate(invalid="ignore", divide="ignore"):
        root = np.sqrt(np.maximum(((t0 - t1) * A) ** 2 + C * (B - A), 0.0))
        th_q = -(-A * t1 + B * t0 + root) / np.where(A == B, 1.0, A - B)
        th_lin = t0 + C / (2.0 * np.where(A == 0.0, 1.0, A) * (t1 - t0))
    th = np.where(A == B, th_lin, th_q)
    th[0] = 0.0
    return th


_BUIE_POLY_DEG = 10


def _buie_inverse_poly(tb) -> np.ndarray:
    """Polynomial fit of theta(u)/sqrt(u) over the solar-disc inverse CDF
    (u = normalized quantile). The disc radiance is within ~5% of uniform,
    so theta ~ sqrt(u) with a smooth degree-10 correction — max fit error
    ~1e-7 rad, far below MC noise. Device sampling is then a polynomial
    evaluation with no table gather."""
    inv = _buie_inverse_table(tb)
    u = np.linspace(0.0, 1.0, _BUIE_INV_N + 1)
    f = inv / np.where(u > 0, np.sqrt(u), 1.0)
    f[0] = f[1]
    return np.polyfit(u[1:], f[1:], _BUIE_POLY_DEG)


def buie_directions(generator, num_rays: int, CSR: float,
                    pre_process_CSR: bool = True, dtype=torch.float32,
                    device=None) -> torch.Tensor:
    """Sample ray directions from the Buie sunshape about +Z: the
    host-fitted polynomial inverse CDF of the solar disc plus the analytic
    circumsolar aureole (tracer_tpu/sources.py:149)."""
    device = resolve(device)
    tb = _buie_tables(CSR, pre_process_CSR)
    coeffs = _buie_inverse_poly(tb)
    disc_end = float(tb["cdf"][-1])
    r = _uniform(generator, num_rays, dtype, device)
    u = torch.clamp(r / disc_end, 0.0, 1.0)
    acc = torch.zeros_like(u) + float(coeffs[0])
    for c in coeffs[1:]:
        acc = acc * u + float(c)
    thetas = torch.sqrt(u) * acc
    if tb["csr"] > 0.0:
        gamma, kappa = tb["gamma"], tb["kappa"]
        c_aur = float((gamma + 2.0) / (10.0 ** (3.0 * gamma) * np.exp(kappa))
                      * tb["integ_sum"] - _THETA_DNI ** (gamma + 2.0))
        base = (r - 1.0) * c_aur + r * float(_THETA_TOT ** (gamma + 2.0))
        th_aur = torch.clamp(base, min=0.0) ** float(1.0 / (gamma + 2.0))
        thetas = torch.where(r >= disc_end, th_aur, thetas)
    phi = _uniform(generator, num_rays, dtype, device, 0.0, 2.0 * np.pi)
    s = torch.sin(thetas)
    return torch.stack([torch.cos(phi) * s, torch.sin(phi) * s,
                        torch.cos(thetas)], dim=1)


def buie_sunshape_pallas_spec(num_rays: int, center, direction,
                              radius: float, CSR: float, flux: float,
                              pre_process_CSR: bool = True,
                              wl_band=None, ambient_att: float = 0.0,
                              ambient_scat: float = 0.0,
                              ambient_g: float = 0.0) -> tuple:
    """Static (hashable) parameter tuple describing a buie_sunshape source
    for in-kernel regeneration by the culled bounce kernel
    (kernels/bounce.py); the same 17-field tuple as tracer_tpu's. Energies
    and geometry match buie_sunshape with rays_direction == direction.

    wl_band - optional (wl_lo, wl_hi): fresh rays get uniformly sampled
        per-ray wavelengths, enabling the spectral megakernel mode.
    ambient_att - homogeneous ambient attenuation coefficient [1/m] the
        trace runs in (the kernel Beer-Lamberts every hit segment); the
        source_fn's bundles must carry the same att_coeff so the general
        path agrees.
    ambient_scat / ambient_g - homogeneous ambient Henyey-Greenstein
        scattering coefficient [1/m] and asymmetry: the megakernel lowers
        exponential free-path sampling + HG phase draws (ref Scattering
        optics_callables.py:946); the source_fn's bundles must carry the
        same scat_coeff/scat_g so the general path agrees."""
    tb = _buie_tables(CSR, pre_process_CSR)
    coeffs = tuple(float(c) for c in _buie_inverse_poly(tb))
    center = _as_row3(center)
    rot = spatial.rotation_to_z(_as_row3(direction)).reshape(-1)
    e_ray = float(flux * np.pi * radius**2 / num_rays)
    gamma = float(tb["gamma"]) if tb["csr"] > 0.0 else None
    band = (None if wl_band is None
            else (float(wl_band[0]), float(wl_band[1])))
    return (float(center[0]), float(center[1]), float(center[2]),
            tuple(float(r) for r in rot), float(radius), e_ray, coeffs,
            float(tb["cdf"][-1]), gamma, float(tb["kappa"]),
            float(tb["integ_sum"]), float(_THETA_TOT), float(_THETA_DNI),
            band, float(ambient_att), None,
            (float(ambient_scat), float(ambient_g)))


def disk_bundle(generator, num_rays: int, center, direction,
                radius: float, ang_range: float,
                flux: Optional[float] = None, radius_in: float = 0.0,
                angular_span=(0.0, 2.0 * np.pi), rays_direction=None,
                procs: int = 1, dtype=torch.float32,
                device=None) -> RayBundle:
    """Uniform disk (or annular wedge) source with pillbox divergence
    (tracer_tpu/sources.py:432 without the chord cut). Energy per ray =
    flux * pi (R^2 - Ri^2) / n * cos(2 arcsin(|rays_dir - dir|/2))."""
    device = resolve(device)
    center = _as_row3(center)
    direction = _as_row3(direction)
    rays_direction = (direction if rays_direction is None
                      else _as_row3(rays_direction))
    a = lambertian_directions(generator, num_rays, ang_range, dtype, device)
    directions = _rotate_rows(spatial.rotation_to_z(rays_direction), a)
    u = _uniform(generator, num_rays, dtype, device)
    thetas = _uniform(generator, num_rays, dtype, device, *angular_span)
    rs = torch.sqrt(radius_in ** 2 + u * (radius ** 2 - radius_in ** 2))
    verts_local = torch.stack([rs * torch.cos(thetas), rs * torch.sin(thetas),
                               torch.zeros_like(rs)], dim=1)
    verts = (_rotate_rows(spatial.rotation_to_z(direction), verts_local)
             + torch.as_tensor(center, dtype=dtype, device=device))
    if flux is not None:
        cosangle = 2.0 * np.arcsin(
            0.5 * np.linalg.norm(rays_direction - direction))
        e = (np.pi * (radius ** 2 - radius_in ** 2) / num_rays * flux
             * np.cos(cosangle))
    else:
        e = 1.0 / num_rays / procs
    return RayBundle.create(pos=verts, dir=directions,
                            energy=torch.full((num_rays,), float(e),
                                              dtype=dtype, device=device),
                            device=device)


def buie_sunshape(generator, num_rays: int, center, direction,
                  radius: float, CSR: float, flux: Optional[float] = None,
                  pre_process_CSR: bool = True, rays_direction=None,
                  dtype=torch.float32, device=None) -> RayBundle:
    """Disk source with Buie sunshape directions
    (tracer_tpu/sources.py:588)."""
    device = resolve(device)
    center = _as_row3(center)
    direction = _as_row3(direction)
    rays_direction = (direction if rays_direction is None
                      else _as_row3(rays_direction))
    u = _uniform(generator, num_rays, dtype, device)
    phiv = _uniform(generator, num_rays, dtype, device, 0.0, 2.0 * np.pi)
    rs = radius * torch.sqrt(u)
    verts_local = torch.stack([rs * torch.cos(phiv), rs * torch.sin(phiv),
                               torch.zeros_like(rs)], dim=1)
    verts = (_rotate_rows(spatial.rotation_to_z(direction), verts_local)
             + torch.as_tensor(center, dtype=dtype, device=device))
    a = buie_directions(generator, num_rays, CSR, pre_process_CSR, dtype,
                        device)
    directions = _rotate_rows(spatial.rotation_to_z(rays_direction), a)
    energy = None
    if flux is not None:
        cosangle = 2.0 * np.arcsin(
            0.5 * np.linalg.norm(rays_direction - direction))
        energy = torch.full((num_rays,), float(flux * np.pi * radius ** 2
                                               / num_rays
                                               * np.cos(cosangle)),
                            dtype=dtype, device=device)
    return RayBundle.create(pos=verts, dir=directions, energy=energy,
                            device=device)


# The reference examples call this source by its older name.
solar_disk_bundle = disk_bundle
