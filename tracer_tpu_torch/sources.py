"""Light sources (the PyTorch port of tracer_tpu/sources.py): the
Buie-sunshape, pillbox and tabulated-sunshape disks and rectangles (the
rect ones optionally oblique: positions in one frame, directions about
another) with their static specs for in-kernel regeneration, edge rays, a
single ray, a regular square grid, triangle and trapezoid emitters, and
the view-factor and emission sources: Lambertian frustum and cylinder
walls, the gray shape composer and the band thermal emitter.

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

from .bundle import RayBundle, concatenate_rays
from .device import resolve
from . import sampling as smp
from . import spatial, telemetry
from .electromagnetics import planck
from .mathutils import rotate_to_normal
from .sampling import (PWLinCosSinDistribution, _uniform,
                       lambertian_directions)


def _as_row3(x) -> np.ndarray:
    return np.asarray(x, dtype=float).reshape(3)


def _rotate_rows(M, rows: torch.Tensor) -> torch.Tensor:
    """Apply a (3,3) rotation to (N,3) row vectors, elementwise."""
    M = np.asarray(M, dtype=float)
    x, y, z = rows.unbind(1)
    return torch.stack([float(M[i, 0]) * x + float(M[i, 1]) * y
                        + float(M[i, 2]) * z for i in range(3)], dim=1)


def pillbox_sunshape_directions(generator, num_rays: int, ang_range: float,
                                dtype=torch.float32,
                                device=None) -> torch.Tensor:
    """Pillbox sunshape: angularly uniform flux, the Lambertian sampler
    within ``ang_range``."""
    return lambertian_directions(generator, num_rays, ang_range, dtype,
                                 device)


def edge_rays_directions(generator, num_rays: int, ang_range: float,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """Directions all at exactly ``ang_range`` from +Z, azimuth uniform."""
    device = resolve(device)
    phi = _uniform(generator, num_rays, dtype, device, 0.0, 2.0 * np.pi)
    s = float(np.sin(ang_range))
    return torch.stack([torch.cos(phi) * s, torch.sin(phi) * s,
                        torch.full_like(phi, float(np.cos(ang_range)))],
                       dim=1)


def sunshape_to_ray_directions(generator, angles, norm_intensity,
                               num_rays: int, dtype=torch.float32,
                               device=None) -> torch.Tensor:
    """Directions about +Z from a tabulated radiance profile
    ``norm_intensity`` over polar ``angles``: the polar angle inverts the
    trapezoid CDF of intensity * cos * sin exactly within each interval
    (a quadratic root, linear where the weights are equal)."""
    device = resolve(device)
    angles = np.asarray(angles, dtype=float)
    inten = np.asarray(norm_intensity, dtype=float)
    w = inten * np.cos(angles) * np.sin(angles)
    integ = 0.5 * (w[:-1] + w[1:]) * np.diff(angles)
    cdf = np.concatenate([[0.0], np.cumsum(integ / integ.sum())])

    def tab(a):
        return torch.as_tensor(a, dtype=dtype, device=device)
    cdf_t, w_t, a_t = tab(cdf), tab(w), tab(angles)
    r = _uniform(generator, num_rays, dtype, device)
    i = (torch.searchsorted(cdf_t, r, right=True) - 1).clamp(0, len(cdf) - 2)
    A, B = w_t[i], w_t[i + 1]
    t0, t1 = a_t[i], a_t[i + 1]
    total = float(integ.sum())
    C = 2.0 * total * (r - cdf_t[i]) * (t1 - t0)
    root = torch.sqrt((((t0 - t1) * A) ** 2 + C * (B - A)).clamp(min=0.0))
    th_q = -(-A * t1 + B * t0 + root) / torch.where(A == B, 1.0, A - B)
    th_lin = t0 + total * (r - cdf_t[i]) / torch.where(A == 0, 1.0, A)
    thetas = torch.where(A == B, th_lin, th_q)
    phi = _uniform(generator, num_rays, dtype, device, 0.0, 2.0 * np.pi)
    s = torch.sin(thetas)
    return torch.stack([torch.cos(phi) * s, torch.sin(phi) * s,
                        torch.cos(thetas)], dim=1)


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
    for in-kernel regeneration by the bounce kernels (kernels/bounce.py);
    the same 17-field tuple as tracer_tpu's. Energies
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


def disk_pillbox_pallas_spec(num_rays: int, center, direction,
                             radius: float, ang_range: float,
                             flux: float, wl_band=None,
                             ambient_att: float = 0.0,
                             ambient_scat: float = 0.0,
                             ambient_g: float = 0.0) -> tuple:
    """Static spec for in-kernel regeneration of a plain pillbox disk
    source (disk_bundle with default options; tracer_tpu/sources.py:222).
    Reuses the Buie sampler's polynomial-inverse-CDF slot: for a pillbox,
    theta(u) = arcsin(sin(ang_range) * sqrt(u)), so theta/sqrt(u) is
    fitted the same way (max error ~1e-8 rad); there is no aureole
    (gamma=None), so the kernel's Buie branch reduces to exactly this
    sampling."""
    u = np.linspace(1e-9, 1.0, 4097)
    f = np.arcsin(np.sin(ang_range) * np.sqrt(u)) / np.sqrt(u)
    coeffs = tuple(float(c) for c in np.polyfit(u, f, _BUIE_POLY_DEG))
    center = _as_row3(center)
    rot = spatial.rotation_to_z(_as_row3(direction)).reshape(-1)
    e_ray = float(flux * np.pi * radius**2 / num_rays)
    band = (None if wl_band is None
            else (float(wl_band[0]), float(wl_band[1])))
    return (float(center[0]), float(center[1]), float(center[2]),
            tuple(float(r) for r in rot), float(radius), e_ray, coeffs,
            1.0, None, 0.0, 0.0, float(ang_range), float(ang_range),
            band, float(ambient_att), None,
            (float(ambient_scat), float(ambient_g)))


def tabulated_sunshape_pallas_spec(num_rays: int, center, direction,
                                   radius: float, angles, norm_intensity,
                                   flux: float, wl_band=None,
                                   ambient_att: float = 0.0,
                                   ambient_scat: float = 0.0,
                                   ambient_g: float = 0.0,
                                   fit_tol: float = 1e-5) -> tuple:
    """Static spec of a disk whose directions follow a tabulated radiance
    profile (the regenerating twin of sunshape_to_ray_directions): the
    numeric inverse CDF theta(u) of intensity * cos * sin is fitted as
    sqrt(u) * poly(u), the polynomial slot of the Buie disk branch, so the
    kernels draw it with no kernel of its own. A profile whose fit misses
    the exact inverse by more than ``fit_tol`` rad raises: trace it with
    the host-sampled source on the general path."""
    angles = np.asarray(angles, dtype=float)
    inten = np.asarray(norm_intensity, dtype=float)
    if abs(angles[0]) > 1e-12 or not (np.diff(angles) > 0).all():
        raise ValueError("angles must start at 0 and increase")
    if (not np.isfinite(inten).all()) or (inten < 0).any() \
            or not (inten > 0).any():
        raise ValueError("norm_intensity must be finite, non-negative "
                         "and not identically zero")
    th_d = np.linspace(0.0, angles[-1], 20001)
    w_d = np.interp(th_d, angles, inten) * np.cos(th_d) * np.sin(th_d)
    cdf_d = np.concatenate([[0.0], np.cumsum(
        0.5 * (w_d[:-1] + w_d[1:]) * np.diff(th_d))])
    cdf_d /= cdf_d[-1]
    u = np.linspace(1e-9, 1.0, 8193)
    theta_exact = np.interp(u, cdf_d, th_d)
    coeffs = tuple(float(c) for c in np.polyfit(
        u, theta_exact / np.sqrt(u), _BUIE_POLY_DEG))
    err = np.abs(np.sqrt(u) * np.polyval(coeffs, u) - theta_exact).max()
    if not err <= fit_tol:       # a NaN error rejects too
        raise ValueError(
            f"inverse-CDF polynomial fit error {err:.2e} rad exceeds "
            f"fit_tol={fit_tol:.0e}; this profile is too sharp for the "
            "baked sampler: trace it with the host-sampled source")
    center = _as_row3(center)
    rot = spatial.rotation_to_z(_as_row3(direction)).reshape(-1)
    e_ray = float(flux * np.pi * radius ** 2 / num_rays)
    band = (None if wl_band is None
            else (float(wl_band[0]), float(wl_band[1])))
    return (float(center[0]), float(center[1]), float(center[2]),
            tuple(float(r) for r in rot), float(radius), e_ray, coeffs,
            1.0, None, 0.0, 0.0, float(angles[-1]), float(angles[-1]),
            band, float(ambient_att), None,
            (float(ambient_scat), float(ambient_g)))


def _rays_frame(direction, rays_direction):
    """(rays_rot, cosine projection) of a rect spec: the direction frame
    of an oblique source and the cosine of its angle to the source plane's
    normal (exact chord -> angle inversion), or (None, 1) when the rays
    leave along ``direction``."""
    if rays_direction is None:
        return None, 1.0
    rays_direction = _as_row3(rays_direction)
    rays_rot = tuple(float(r) for r in
                     spatial.rotation_to_z(rays_direction).reshape(-1))
    return rays_rot, float(np.cos(2.0 * np.arcsin(
        0.5 * np.linalg.norm(rays_direction - direction))))


def rect_buie_sunshape_pallas_spec(num_rays: int, center, direction,
                                   width: float, height: float, CSR: float,
                                   flux: float, rays_direction=None,
                                   pre_process_CSR: bool = True,
                                   wl_band=None, ambient_att: float = 0.0,
                                   ambient_scat: float = 0.0,
                                   ambient_g: float = 0.0) -> tuple:
    """Static spec for in-kernel regeneration of a rect_buie_sunshape
    (oblique) source (tracer_tpu/sources.py:305): positions uniform on a
    width x height rectangle in the ``direction`` frame, Buie directions
    about ``rays_direction`` (default ``direction``; an oblique source's
    flux is cosine-projected into e_ray). The disk layout with radius 0
    and a 16th element (w, h, rays_rot), which the kernels and the culling
    build switch on."""
    tb = _buie_tables(CSR, pre_process_CSR)
    coeffs = tuple(float(c) for c in _buie_inverse_poly(tb))
    center = _as_row3(center)
    direction = _as_row3(direction)
    rot = spatial.rotation_to_z(direction).reshape(-1)
    rays_rot, cosang = _rays_frame(direction, rays_direction)
    e_ray = float(flux * width * height / num_rays * cosang)
    gamma = float(tb["gamma"]) if tb["csr"] > 0.0 else None
    band = (None if wl_band is None
            else (float(wl_band[0]), float(wl_band[1])))
    return (float(center[0]), float(center[1]), float(center[2]),
            tuple(float(r) for r in rot), 0.0, e_ray, coeffs,
            float(tb["cdf"][-1]), gamma, float(tb["kappa"]),
            float(tb["integ_sum"]), float(_THETA_TOT), float(_THETA_DNI),
            band, float(ambient_att),
            (float(width), float(height), rays_rot),
            (float(ambient_scat), float(ambient_g)))


def oblique_rect_pillbox_pallas_spec(num_rays: int, center,
                                     source_direction, rays_direction,
                                     width: float, height: float,
                                     ang_range: float, flux: float,
                                     wl_band=None, ambient_att: float = 0.0,
                                     ambient_scat: float = 0.0,
                                     ambient_g: float = 0.0) -> tuple:
    """Static spec of an oblique rect source with pillbox divergence
    (tracer_tpu/sources.py:350): the rect marker of
    rect_buie_sunshape_pallas_spec, the pillbox angle in the polynomial
    slot as disk_pillbox_pallas_spec puts it."""
    u = np.linspace(1e-9, 1.0, 4097)
    f = np.arcsin(np.sin(ang_range) * np.sqrt(u)) / np.sqrt(u)
    coeffs = tuple(float(c) for c in np.polyfit(u, f, _BUIE_POLY_DEG))
    center = _as_row3(center)
    source_direction = _as_row3(source_direction)
    rot = spatial.rotation_to_z(source_direction).reshape(-1)
    rays_rot, cosang = _rays_frame(source_direction, rays_direction)
    e_ray = float(flux * width * height / num_rays * cosang)
    band = (None if wl_band is None
            else (float(wl_band[0]), float(wl_band[1])))
    return (float(center[0]), float(center[1]), float(center[2]),
            tuple(float(r) for r in rot), 0.0, e_ray, coeffs,
            1.0, None, 0.0, 0.0, float(ang_range), float(ang_range),
            band, float(ambient_att),
            (float(width), float(height), rays_rot),
            (float(ambient_scat), float(ambient_g)))


@telemetry.draws
def disk_bundle(generator, num_rays: int, center, direction,
                radius: float, ang_range: float,
                flux: Optional[float] = None, radius_in: float = 0.0,
                angular_span=(0.0, 2.0 * np.pi),
                x_cut: Optional[float] = None, rays_direction=None,
                procs: int = 1, dtype=torch.float32,
                device=None) -> RayBundle:
    """Uniform disk (or annular wedge) source with pillbox divergence
    (tracer_tpu/sources.py:432). Energy per ray =
    flux * pi (R^2 - Ri^2) / n * cos(2 arcsin(|rays_dir - dir|/2)).

    x_cut - keep only x < x_cut (a chord-cut disc): x is drawn by the
    inverse CDF of the chord-length density 2 sqrt(R^2 - x^2) on
    [-R, min(x_cut, R)], tabulated on 4097 points and interpolated, and y
    uniform along the chord, as tracer_tpu draws them; it needs
    radius_in == 0 and the full angular span."""
    device = resolve(device)
    center = _as_row3(center)
    direction = _as_row3(direction)
    rays_direction = (direction if rays_direction is None
                      else _as_row3(rays_direction))
    if x_cut is not None and (radius_in != 0.0 or tuple(angular_span)
                              != (0.0, 2.0 * np.pi)):
        raise NotImplementedError("x_cut combines only with a plain disc")
    a = lambertian_directions(generator, num_rays, ang_range, dtype, device)
    directions = _rotate_rows(spatial.rotation_to_z(rays_direction), a)
    if x_cut is not None:
        xs_t = np.linspace(-radius, min(x_cut, radius), 4097)
        pdf = 2.0 * np.sqrt(np.maximum(radius ** 2 - xs_t ** 2, 0.0))
        cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) / 2.0
                                               * np.diff(xs_t))])
        inv = torch.as_tensor(np.interp(np.linspace(0.0, 1.0, 4097),
                                        cdf / cdf[-1], xs_t),
                              dtype=dtype, device=device)
        u = _uniform(generator, num_rays, dtype, device) * 4096
        i0 = u.long().clamp(0, 4095)
        fr = u - i0.to(dtype)
        xs = inv[i0] * (1 - fr) + inv[i0 + 1] * fr
        half = torch.sqrt((radius ** 2 - xs ** 2).clamp(min=0.0))
        ys = _uniform(generator, num_rays, dtype, device, -1.0, 1.0) * half
        verts_local = torch.stack([xs, ys, torch.zeros_like(xs)], dim=1)
    else:
        u = _uniform(generator, num_rays, dtype, device)
        thetas = _uniform(generator, num_rays, dtype, device, *angular_span)
        rs = torch.sqrt(radius_in ** 2 + u * (radius ** 2 - radius_in ** 2))
        verts_local = torch.stack([rs * torch.cos(thetas),
                                   rs * torch.sin(thetas),
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


@telemetry.draws
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


def _rect_verts(generator, num_rays: int, center, direction, x: float,
                y: float, dtype, device) -> torch.Tensor:
    """Positions uniform on an x by y rectangle in ``direction``'s frame,
    laid out as the reference's rect sources lay them: local (y, x, 0),
    the two swapped when the source faces straight down."""
    xs = _uniform(generator, num_rays, dtype, device, -x / 2, x / 2)
    ys = _uniform(generator, num_rays, dtype, device, -y / 2, y / 2)
    if np.allclose(direction, [0.0, 0.0, -1.0]):
        xs, ys = ys, xs
    local = torch.stack([ys, xs, torch.zeros_like(xs)], dim=1)
    return (_rotate_rows(spatial.rotation_to_z(direction), local)
            + torch.as_tensor(center, dtype=dtype, device=device))


def rect_bundle(generator, num_rays: int, center, direction, x: float,
                y: float, ang_range: float, flux: Optional[float] = None,
                procs: int = 1, dtype=torch.float32,
                device=None) -> RayBundle:
    """Rectangular source with pillbox divergence
    (tracer_tpu/sources.py:509)."""
    device = resolve(device)
    center = _as_row3(center)
    direction = _as_row3(direction)
    a = lambertian_directions(generator, num_rays, ang_range, dtype, device)
    directions = _rotate_rows(spatial.rotation_to_z(direction), a)
    verts = _rect_verts(generator, num_rays, center, direction, x, y, dtype,
                        device)
    e = x * y / num_rays * flux if flux is not None else \
        1.0 / num_rays / procs
    return RayBundle.create(pos=verts, dir=directions,
                            energy=torch.full((num_rays,), float(e),
                                              dtype=dtype, device=device),
                            device=device)


def oblique_solar_rect_bundle(generator, num_rays: int, center,
                              source_direction, rays_direction, x: float,
                              y: float, ang_range: float,
                              flux: Optional[float] = None, procs: int = 1,
                              wavelength=None, ref_index=None,
                              dtype=torch.float32, device=None) -> RayBundle:
    """Rect source whose pillbox rays leave obliquely, along
    ``rays_direction``; the flux is cosine-projected
    (tracer_tpu/sources.py:533)."""
    device = resolve(device)
    center = _as_row3(center)
    source_direction = _as_row3(source_direction)
    rays_direction = _as_row3(rays_direction)
    a = lambertian_directions(generator, num_rays, ang_range, dtype, device)
    directions = _rotate_rows(spatial.rotation_to_z(rays_direction), a)
    verts = _rect_verts(generator, num_rays, center, source_direction, x, y,
                        dtype, device)
    if flux is not None:
        cosangle = 2.0 * np.arcsin(
            0.5 * np.linalg.norm(rays_direction - source_direction))
        e = x * y / num_rays * flux * np.cos(cosangle)
    else:
        e = 1.0 / num_rays / procs
    return RayBundle.create(pos=verts, dir=directions,
                            energy=torch.full((num_rays,), float(e),
                                              dtype=dtype, device=device),
                            wavelength=wavelength, ref_index=ref_index,
                            device=device)


def rect_buie_sunshape(generator, num_rays: int, center, direction,
                       width: float, height: float, CSR: float,
                       flux: Optional[float] = None,
                       pre_process_CSR: bool = True, rays_direction=None,
                       dtype=torch.float32, device=None) -> RayBundle:
    """Rect source with Buie sunshape directions about ``rays_direction``
    (default ``direction``), the flux cosine-projected
    (tracer_tpu/sources.py:621)."""
    device = resolve(device)
    center = _as_row3(center)
    direction = _as_row3(direction)
    rays_direction = (direction if rays_direction is None
                      else _as_row3(rays_direction))
    xs = width * (_uniform(generator, num_rays, dtype, device) - 0.5)
    ys = height * (_uniform(generator, num_rays, dtype, device) - 0.5)
    local = torch.stack([xs, ys, torch.zeros_like(xs)], dim=1)
    verts = (_rotate_rows(spatial.rotation_to_z(direction), local)
             + torch.as_tensor(center, dtype=dtype, device=device))
    a = buie_directions(generator, num_rays, CSR, pre_process_CSR, dtype,
                        device)
    directions = _rotate_rows(spatial.rotation_to_z(rays_direction), a)
    energy = None
    if flux is not None:
        cosangle = 2.0 * np.arcsin(
            0.5 * np.linalg.norm(rays_direction - direction))
        energy = torch.full((num_rays,), float(flux * width * height
                                               / num_rays
                                               * np.cos(cosangle)),
                            dtype=dtype, device=device)
    return RayBundle.create(pos=verts, dir=directions, energy=energy,
                            device=device)


# The reference examples call this source by its older name.
solar_disk_bundle = disk_bundle


def edge_rays_bundle(generator, num_rays: int, center, direction,
                     radius: float, ang_range: float,
                     flux: Optional[float] = None, radius_in: float = 0.0,
                     dtype=torch.float32, device=None) -> RayBundle:
    """Disk (or annulus) source whose rays all leave at ``ang_range`` from
    its normal: the edge of a pillbox cone. Energy per ray flux * pi (R^2
    - Ri^2) / n with a flux, else 1."""
    device = resolve(device)
    center = _as_row3(center)
    perp_rot = spatial.rotation_to_z(_as_row3(direction))
    a = edge_rays_directions(generator, num_rays, ang_range, dtype, device)
    u = _uniform(generator, num_rays, dtype, device)
    thetas = _uniform(generator, num_rays, dtype, device, 0.0, 2.0 * np.pi)
    rs = torch.sqrt(radius_in ** 2 + u * (radius ** 2 - radius_in ** 2))
    verts_local = torch.stack([rs * torch.cos(thetas), rs * torch.sin(thetas),
                               torch.zeros_like(rs)], dim=1)
    energy = None
    if flux is not None:
        energy = torch.full((num_rays,), float(
            np.pi * (radius ** 2 - radius_in ** 2) / num_rays * flux),
            dtype=dtype, device=device)
    return RayBundle.create(
        pos=_rotate_rows(perp_rot, verts_local)
        + torch.as_tensor(center, dtype=dtype, device=device),
        dir=_rotate_rows(perp_rot, a), energy=energy, device=device)


def single_ray_source(position, direction, flux: float = 1.0,
                      dtype=torch.float32, device=None) -> RayBundle:
    """One ray of energy ``flux`` (direction normalised)."""
    d = _as_row3(direction)
    return RayBundle.create(pos=np.asarray(position, dtype=float).reshape(
        1, 3), dir=(d / np.linalg.norm(d)).reshape(1, 3),
        energy=np.array([flux]), dtype=dtype, device=device)


def regular_square_bundle(num_rays: int, center, direction, width: float,
                          dtype=torch.float32, device=None) -> RayBundle:
    """A square grid of floor(sqrt(num_rays))^2 parallel rays across
    ``width``, energy 1 / their count each (deterministic)."""
    center = _as_row3(center)
    direction = _as_row3(direction)
    per_side = int(np.sqrt(num_rays))
    xs = np.linspace(-width / 2, width / 2, per_side)
    x, y = np.meshgrid(xs, xs)
    verts_local = np.stack([x.ravel(), y.ravel(), np.zeros(per_side ** 2)],
                           axis=1)
    verts = verts_local @ spatial.rotation_to_z(direction).T + center
    return RayBundle.create(pos=verts, dir=np.tile(direction, (per_side ** 2,
                                                               1)),
                            energy=np.ones(per_side ** 2) / per_side ** 2,
                            dtype=dtype, device=device)


def triangular_bundle(generator, num_rays: int, A, B, C, direction=None,
                      ang_range: float = np.pi / 2,
                      flux: Optional[float] = None, procs: int = 1,
                      dtype=torch.float32, device=None) -> RayBundle:
    """Triangle source by uniform point picking, directions pillbox about
    the triangle's normal (B - A) x (C - A), or about ``direction``.
    Energy per ray flux * area / n with a flux, else 1 / n / procs."""
    device = resolve(device)
    A, B, C = _as_row3(A), _as_row3(B), _as_row3(C)
    normal = np.cross(B - A, C - A)
    area = 0.5 * np.linalg.norm(normal)
    if direction is None:
        direction = normal / (2.0 * area)
    r1 = torch.sqrt(_uniform(generator, num_rays, dtype, device))
    r2 = _uniform(generator, num_rays, dtype, device)

    def corner(v):
        return torch.as_tensor(v, dtype=dtype, device=device)[None, :]
    verts = (corner(A) * (1.0 - r1)[:, None]
             + (r1 * (1.0 - r2))[:, None] * corner(B)
             + (r1 * r2)[:, None] * corner(C))
    a = pillbox_sunshape_directions(generator, num_rays, ang_range, dtype,
                                    device)
    e = (flux * area / num_rays if flux is not None
         else 1.0 / num_rays / procs)
    return RayBundle.create(
        pos=verts, dir=_rotate_rows(spatial.rotation_to_z(
            _as_row3(direction)), a),
        energy=torch.full((num_rays,), float(e), dtype=dtype, device=device),
        device=device)


def trapezoid_bundle(generator, num_rays: int, A, B, C, direction=None,
                     ang_range: float = np.pi / 2,
                     flux: Optional[float] = None, procs: int = 1,
                     dtype=torch.float32, device=None) -> RayBundle:
    """Trapezoid source of two triangles: A and B the corners of one
    parallel side, C the corner beside B on the other, the fourth corner
    D = C + (A - B). The rays split between the triangles by area."""
    A, B, C = _as_row3(A), _as_row3(B), _as_row3(C)
    D = C + (A - B)
    area_1 = 0.5 * np.linalg.norm(np.cross(B - A, C - A))
    area_2 = 0.5 * np.linalg.norm(np.cross(C - A, D - A))
    n1 = int(round(num_rays * area_1 / (area_1 + area_2)))
    kw = dict(direction=direction, ang_range=ang_range, flux=flux,
              procs=procs, dtype=dtype, device=device)
    return concatenate_rays([
        triangular_bundle(generator, n1, A, B, C, **kw),
        triangular_bundle(generator, num_rays - n1, A, C, D, **kw)])


# ---------------------------------------------------------------------------
# view-factor and emission sources (tracer_tpu/sources.py:721-897): the
# Lambertian wall emitters of the view-factor subsystem
# (analysis/view_factors.py), the gray composer and the band emitter
# ---------------------------------------------------------------------------

def _rotz_rows(phi, rows):
    """Rotate (N,3) row vectors about z by per-ray angles phi."""
    c, s = torch.cos(phi), torch.sin(phi)
    x, y, z = rows.unbind(1)
    return torch.stack([c * x - s * y, s * x + c * y, z], dim=1)


def _wall_bundle(phi, rs, zs, local_unit, center, direction, energy,
                 dtype, device) -> RayBundle:
    """A wall emitter's bundle: points (rs cos phi, rs sin phi, zs) and
    directions ``local_unit`` in the frame whose z is ``direction``."""
    perp_rot = spatial.rotation_to_z(direction)
    verts = (_rotate_rows(perp_rot, torch.stack(
        [rs * torch.cos(phi), rs * torch.sin(phi), zs], dim=1))
        + torch.as_tensor(center, dtype=dtype, device=device))
    return RayBundle.create(pos=verts,
                            dir=_rotate_rows(perp_rot, local_unit),
                            energy=energy, device=device)


def vf_frustum_bundle(generator, num_rays: int, r0: float, r1: float,
                      depth: float, center, direction,
                      flux: Optional[float] = None, rays_in: bool = True,
                      angular_span=(0.0, 2.0 * np.pi),
                      angular_range: float = np.pi / 2,
                      dtype=torch.float32, device=None) -> RayBundle:
    """Lambertian emitter over a frustum wall from (z=0, r0) to
    (z=depth, r1), rays inward when ``rays_in``
    (tracer_tpu/sources.py:735). Total energy 1 unless ``flux`` is given
    (then flux times the wall's area)."""
    device = resolve(device)
    center, direction = _as_row3(center), _as_row3(direction)
    dir_flat = pillbox_sunshape_directions(generator, num_rays,
                                           angular_range, dtype, device)
    c = (r1 - r0) / depth
    u = _uniform(generator, num_rays, dtype, device)
    rs = torch.sqrt((r1 ** 2 - r0 ** 2) * u + r0 ** 2)
    zs = (rs - r0) / c
    phi = _uniform(generator, num_rays, dtype, device, *angular_span)
    # the pillbox about +z onto the inward wall normal: roty(-pi/2 +
    # atan(c)), then rotz(phi)
    local_unit = _rotz_rows(phi, _rotate_rows(
        spatial.roty(-np.pi / 2 + np.arctan(c))[:3, :3], dir_flat))
    if not rays_in:
        local_unit = -local_unit
    if flux is None:
        e = 1.0 / num_rays
    else:
        e = flux * ((angular_span[1] - angular_span[0]) * (r1 + r0) / 2.0
                    * np.sqrt(abs(r1 - r0) ** 2 + depth ** 2)) / num_rays
    return _wall_bundle(phi, rs, zs, local_unit, center, direction,
                        torch.full((num_rays,), float(e), dtype=dtype,
                                   device=device), dtype, device)


def vf_cylinder_bundle(generator, num_rays: int, rc: float, lc: float,
                       center, direction, flux: Optional[float] = None,
                       rays_in: bool = True,
                       angular_span=(0.0, 2.0 * np.pi),
                       ang_range: float = np.pi / 2, dtype=torch.float32,
                       device=None) -> RayBundle:
    """Lambertian emitter over a cylinder wall centred on the wall's mid
    height (tracer_tpu/sources.py:778)."""
    device = resolve(device)
    center, direction = _as_row3(center), _as_row3(direction)
    zs = lc * _uniform(generator, num_rays, dtype, device) - lc / 2.0
    phi = _uniform(generator, num_rays, dtype, device, *angular_span)
    dir_flat = pillbox_sunshape_directions(generator, num_rays, ang_range,
                                           dtype, device)
    local_unit = _rotz_rows(phi, _rotate_rows(
        spatial.roty(-np.pi / 2)[:3, :3], dir_flat))
    if not rays_in:
        local_unit = -local_unit
    if flux is None:
        e = 1.0 / num_rays
    else:
        e = flux * rc * (angular_span[1] - angular_span[0]) * lc / num_rays
    return _wall_bundle(phi, torch.full_like(zs, rc), zs, local_unit, center,
                        direction, torch.full((num_rays,), float(e),
                                              dtype=dtype, device=device),
                        dtype, device)


def gray_source(generator, shape: dict, location, direction, num_rays: int,
                directions_distribution: dict, energy: float,
                rays_direction=None, dtype=torch.float32,
                device=None) -> RayBundle:
    """General gray source composer (tracer_tpu/sources.py:813):
    ``shape`` and ``directions_distribution`` are {'type': name,
    'kwargs': {...}} dicts resolved against the shape samplers and
    direction distributions of :mod:`sampling`."""
    device = resolve(device)
    location, direction = _as_row3(location), _as_row3(direction)
    shape_fns = dict(disk=smp.disk_sampling, rectangle=smp.rectangle_sampling,
                     triangle=smp.triangle_sampling,
                     polygon=smp.polygon_sampling,
                     cylinder=smp.cylinder_sampling,
                     frustum=smp.frustum_sampling, sphere=smp.sphere_sampling)
    verts, normals = shape_fns[shape["type"]](
        generator, ns=num_rays, dtype=dtype, device=device,
        **shape["kwargs"])
    rot = spatial.rotation_to_z(direction)
    verts = (_rotate_rows(rot, verts)
             + torch.as_tensor(location, dtype=dtype, device=device))
    normals = _rotate_rows(rot, normals)
    dd = directions_distribution
    if dd["type"].lower() != "lambertian":
        raise ValueError(f"unknown directions distribution {dd['type']}")
    dirs = smp.lambertian_directions_sampling(
        generator, num_rays, normals=normals, dtype=dtype, device=device,
        **dd.get("kwargs", {}))
    e = energy / num_rays
    if rays_direction is not None:
        e = e * np.cos(float(np.dot(_as_row3(rays_direction), direction)))
    return RayBundle.create(pos=verts, dir=dirs,
                            energy=torch.full((num_rays,), float(e),
                                              dtype=dtype, device=device),
                            device=device)


def spectral_band_axisymmetrical_thermal_emission_source(
        generator, positions, normals, area, thetas, band_emittance,
        T: float, nrays: int, band, ref_index: float = 1.0,
        dtype=torch.float32, device=None) -> RayBundle:
    """Thermal emitter over a spectral band with a directional emittance
    (tracer_tpu/sources.py:852): the Planck-integrated band radiance,
    directions importance-sampled from emittance(theta) cos sin, energies
    summing to the exitance times ``area``, every ray at the band's
    Planck-weighted mean wavelength."""
    device = resolve(device)
    thetas = np.asarray(thetas, dtype=float)
    wls = np.linspace(band[0], band[1],
                      max(int((band[1] - band[0]) / 1e-9), 16))
    bb = np.asarray(planck(wls, T))
    radiance = (np.broadcast_to(np.asarray(band_emittance, dtype=float),
                                thetas.shape) * np.trapezoid(bb, wls))
    th_rays, weights = PWLinCosSinDistribution(thetas, radiance).sample(
        generator, nrays, dtype, device)
    exitance = 2.0 * np.pi * np.trapezoid(
        radiance * np.cos(thetas) * np.sin(thetas), thetas)
    phis = _uniform(generator, nrays, dtype, device, 0.0, 2.0 * np.pi)
    s = torch.sin(th_rays)
    local = torch.stack([s * torch.cos(phis), s * torch.sin(phis),
                         torch.cos(th_rays)], dim=1)
    nrm = torch.as_tensor(np.asarray(normals, dtype=float), dtype=dtype,
                          device=device).expand(nrays, 3)
    return RayBundle.create(
        pos=torch.as_tensor(np.asarray(positions, dtype=float), dtype=dtype,
                            device=device),
        dir=rotate_to_normal(local, nrm),
        energy=weights / weights.sum() * float(exitance * area),
        wavelength=float(np.sum(wls * bb) / np.sum(bb)),
        ref_index=ref_index, device=device)
