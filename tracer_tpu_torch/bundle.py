"""Ray bundle: a fixed-width struct of tensors (the PyTorch port of
tracer_tpu/bundle.py). All tensors share the leading ray axis N."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .device import resolve


@dataclasses.dataclass
class RayBundle:
    """pos (N,3) ray origin, dir (N,3) unit direction, energy (N,) power
    [W], wavelength (N,) (0 = unset), ref_index (N,) refractive index of
    the medium, att_coeff / scat_coeff / scat_g (N,) medium coefficients,
    alive (N,) bool, parent (N,) int32 index into the previous bounce.

    A polychromatic bundle also carries ``spectra`` (N, K), each ray's
    spectral power density [W/m of wavelength], over one shared
    ``spectral_grid`` (K,) of vacuum wavelengths (tracer_tpu/bundle.py
    :50-58); ``energy`` is the trapezoid integral of each spectrum
    (:meth:`with_spectra`), and the host-stepped ray_tracer keeps it so.
    None on a monochromatic bundle."""

    pos: torch.Tensor
    dir: torch.Tensor
    energy: torch.Tensor
    wavelength: torch.Tensor
    ref_index: torch.Tensor
    att_coeff: torch.Tensor
    scat_coeff: torch.Tensor
    scat_g: torch.Tensor
    alive: torch.Tensor
    parent: torch.Tensor
    spectra: Optional[torch.Tensor] = None
    spectral_grid: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, pos, dir, energy=None, wavelength=None, ref_index=None,
               att_coeff=None, scat_coeff=None, scat_g=None, alive=None,
               parent=None, dtype=None, device=None) -> "RayBundle":
        """A bundle on ``device`` (None means the GPU,
        device.default_device)."""
        pos = torch.as_tensor(pos, dtype=dtype, device=resolve(device))
        dir = torch.as_tensor(dir, dtype=pos.dtype, device=pos.device)
        if pos.ndim != 2 or pos.shape[1] != 3:
            raise ValueError(f"pos must be (N,3), got {tuple(pos.shape)}")
        n = pos.shape[0]

        def arr(x, fill):
            if x is None:
                return torch.full((n,), fill, dtype=pos.dtype,
                                  device=pos.device)
            return torch.broadcast_to(torch.as_tensor(
                x, dtype=pos.dtype, device=pos.device), (n,))

        if alive is None:
            alive = torch.ones((n,), dtype=torch.bool, device=pos.device)
        if parent is None:
            parent = torch.arange(n, dtype=torch.int32, device=pos.device)
        return cls(pos, dir, arr(energy, 1.0), arr(wavelength, 0.0),
                   arr(ref_index, 1.0), arr(att_coeff, 0.0),
                   arr(scat_coeff, 0.0), arr(scat_g, 0.0),
                   torch.as_tensor(alive, dtype=torch.bool,
                                   device=pos.device),
                   torch.as_tensor(parent, dtype=torch.int32,
                                   device=pos.device))

    def with_spectra(self, spectral_grid, spectra) -> "RayBundle":
        """The bundle with per-ray spectra (N, K) over the shared
        wavelength grid (K,), in the bundle's dtype and on its device;
        ``energy`` becomes the trapezoid integral of each spectrum
        (tracer_tpu/bundle.py:105-118)."""
        f = dict(dtype=self.pos.dtype, device=self.pos.device)
        grid = torch.as_tensor(spectral_grid, **f)
        spec = torch.as_tensor(spectra, **f)
        if tuple(spec.shape) != (self.num_rays, grid.shape[0]):
            raise ValueError(f"spectra must be (N, K) = ({self.num_rays}, "
                             f"{grid.shape[0]}), got {tuple(spec.shape)}")
        return self.replace(spectra=spec, spectral_grid=grid,
                            energy=torch.trapezoid(spec, grid, dim=1))

    @property
    def num_rays(self) -> int:
        return self.pos.shape[0]

    def total_energy(self) -> torch.Tensor:
        """Sum of the energy carried by live rays."""
        return torch.where(self.alive, self.energy, 0.0).sum()

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "RayBundle":
        """Every tensor of the bundle, the spectra too, on ``device``."""
        return self.replace(**{f: getattr(self, f).to(device)
                               for f in FIELDS + SPECTRAL_FIELDS
                               if getattr(self, f) is not None})

    def inherit(self, **overrides) -> "RayBundle":
        """A copy with ``overrides`` (the reference's inherit)."""
        return self.replace(**overrides)

    def select(self, mask) -> "RayBundle":
        """Rays where ``mask`` stay alive, the others become dead slots:
        the shape stays."""
        return self.replace(alive=self.alive & torch.as_tensor(
            mask, dtype=torch.bool, device=self.alive.device))

    def concat(self, other: "RayBundle") -> "RayBundle":
        """The two bundles' rays, ``self``'s first, along the ray axis."""
        return concatenate_rays([self, other])

    def compact_host(self) -> "RayBundle":
        """The live rays alone (a shape known only after a read of the
        device), on the bundle's device; a polychromatic bundle keeps its
        grid whole."""
        keep = torch.nonzero(self.alive).flatten()
        return self.replace(**{f: getattr(self, f).index_select(0, keep)
                               for f in FIELDS + ("spectra",)
                               if getattr(self, f) is not None})

    def pad_to(self, n: int) -> "RayBundle":
        """The bundle padded with dead zero rays up to ``n`` slots (for
        fixed-slab batching); a polychromatic bundle keeps its grid
        whole."""
        cur = self.num_rays
        if cur == n:
            return self
        if cur > n:
            raise ValueError(f"cannot pad {cur} rays down to {n}")

        def pad(a):
            return torch.cat([a, a.new_zeros((n - cur,) + a.shape[1:])])
        return self.replace(**{f: pad(getattr(self, f))
                               for f in FIELDS + ("spectra",)
                               if getattr(self, f) is not None})


# the per-ray fields every bundle has, and the polychromatic pair
FIELDS = ("pos", "dir", "energy", "wavelength", "ref_index", "att_coeff",
          "scat_coeff", "scat_g", "alive", "parent")
SPECTRAL_FIELDS = ("spectra", "spectral_grid")


def concatenate_rays(bundles) -> RayBundle:
    """Concatenate a sequence of bundles along the ray axis
    (tracer_tpu/bundle.py:168). Polychromatic bundles concatenate their
    spectra and keep the shared grid, which must be the same in all; a
    mix of polychromatic and monochromatic bundles is refused."""
    bundles = list(bundles)
    if not bundles:
        raise ValueError("no bundles to concatenate")
    out = {f: torch.cat([getattr(b, f) for b in bundles]) for f in FIELDS}
    poly = [b.spectra is not None for b in bundles]
    if any(poly):
        if not all(poly):
            raise ValueError("cannot concatenate polychromatic and "
                             "monochromatic bundles")
        grid = bundles[0].spectral_grid
        if not all(torch.equal(b.spectral_grid, grid) for b in bundles):
            raise ValueError("polychromatic bundles on different spectral "
                             "grids")
        out.update(spectra=torch.cat([b.spectra for b in bundles]),
                   spectral_grid=grid)
    return RayBundle(**out)


def bundle_from_jax(numpy_fields: dict, device=None,
                    dtype=None) -> RayBundle:
    """Carry a tracer_tpu RayBundle across: ``numpy_fields`` maps each
    field name to ``np.asarray`` of the JAX field (float fields keep their
    dtype unless ``dtype`` is given), and may hold the spectra and their
    grid. ``device`` None means the GPU."""
    device = resolve(device)
    out = {}
    for name in FIELDS:
        a = np.asarray(numpy_fields[name])
        dt = (dtype if dtype is not None and a.dtype.kind == "f"
              else None)
        out[name] = torch.tensor(a, device=device, dtype=dt)
    out["alive"] = out["alive"].to(torch.bool)
    out["parent"] = out["parent"].to(torch.int32)
    for name in SPECTRAL_FIELDS:
        if numpy_fields.get(name) is not None:
            out[name] = torch.tensor(np.asarray(numpy_fields[name]),
                                     device=device, dtype=dtype)
    return RayBundle(**out)
