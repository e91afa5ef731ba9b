"""Ray bundle: a fixed-width struct of tensors (the PyTorch port of
tracer_tpu/bundle.py). All tensors share the leading ray axis N."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import resolve


@dataclasses.dataclass
class RayBundle:
    """pos (N,3) ray origin, dir (N,3) unit direction, energy (N,) power
    [W], wavelength (N,) (0 = unset), ref_index (N,) refractive index of
    the medium, att_coeff / scat_coeff / scat_g (N,) medium coefficients,
    alive (N,) bool, parent (N,) int32 index into the previous bounce."""

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

    @property
    def num_rays(self) -> int:
        return self.pos.shape[0]

    def total_energy(self) -> torch.Tensor:
        """Sum of the energy carried by live rays."""
        return torch.where(self.alive, self.energy, 0.0).sum()

    def replace(self, **changes) -> "RayBundle":
        return dataclasses.replace(self, **changes)


FIELDS = tuple(f.name for f in dataclasses.fields(RayBundle))


def bundle_from_jax(numpy_fields: dict, device=None,
                    dtype=None) -> RayBundle:
    """Carry a tracer_tpu RayBundle across: ``numpy_fields`` maps each
    field name to ``np.asarray`` of the JAX field (float fields keep their
    dtype unless ``dtype`` is given). ``device`` None means the GPU."""
    device = resolve(device)
    out = {}
    for name in FIELDS:
        a = np.asarray(numpy_fields[name])
        dt = (dtype if dtype is not None and a.dtype.kind == "f"
              else None)
        out[name] = torch.tensor(a, device=device, dtype=dt)
    out["alive"] = out["alive"].to(torch.bool)
    out["parent"] = out["parent"].to(torch.int32)
    return RayBundle(**out)
