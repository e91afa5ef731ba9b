"""Device-side flux-map accumulation for the streaming trace (the PyTorch
port of tracer_tpu/analysis/device_fluxmap.py).

Each bounce, every hit lane's absorbed energy is added to a per-surface
(nu, nv) histogram over the surface's natural binning (fluxmap.edges_of —
uniform by construction, so binning is one floor() per axis). The add is a
float32 ``index_add_`` on the flattened bin; lanes that bin nowhere go to
spill slots past the histogram, spread over N_SPILL addresses so that no
single address takes millions of adds (``index_put_(accumulate=True)``
serialises the duplicates of each index, and a round's misses are
millions of duplicates).

Usage::

    spec = flux_plan(meta, "receiver", resolution=50)
    accum, emitted, src_e = trace_streaming(..., fluxspecs=(spec,))
    flux, (ue, ve) = finalize(spec, accum.flux[0], meta)
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve
from .fluxmap import _CARTESIAN, areas_of, edges_of


class FluxSpec(NamedTuple):
    """Static description of one device flux histogram.

    rows  - scene-table row ids of the logical surface (hits on any of
            them bin into the shared histogram, each through its own row
            frame)
    kind  - geometry kind (selects the (u, v) projection)
    nu/nv - bin counts; u0/u1/v0/v1 - uniform bin ranges
    p0    - sphere radius for the z->theta map (spherical kinds)
    resolution - the edges_of resolution that produced the ranges
    """

    rows: tuple
    kind: str
    nu: int
    nv: int
    u0: float
    u1: float
    v0: float
    v1: float
    p0: float
    resolution: int


def flux_plan(meta, surface, resolution: int = 40) -> FluxSpec:
    """Build the static FluxSpec for a logical surface of a compiled
    scene. ``surface`` is a name or logical index (SceneMeta)."""
    sidx = meta.index_of(surface) if isinstance(surface, str) else surface
    geom = meta.surfaces[sidx].geometries[0]
    rows = tuple(int(r) for r in np.nonzero(meta.row_logical == sidx)[0])
    if not rows:
        raise ValueError(f"surface {surface} has no scene rows")
    if geom.kind not in _CARTESIAN or len(rows) != 1:
        raise NotImplementedError(
            "device flux maps of curved or multi-row surfaces are not "
            "ported yet (ROADMAP A11)")
    ue, ve = edges_of(geom.kind, geom.extent, resolution)
    return FluxSpec(rows=rows, kind=geom.kind,
                    nu=len(ue) - 1, nv=len(ve) - 1,
                    u0=float(ue[0]), u1=float(ue[-1]),
                    v0=float(ve[0]), v1=float(ve[-1]),
                    p0=0.0, resolution=resolution)


N_SPILL = 1024


def spread_misses(valid, index, n_bins: int):
    """``index`` where ``valid``, else one of N_SPILL spill slots from
    n_bins on (chosen by lane), as int64 for index_add_."""
    lane = torch.arange(valid.shape[0], device=valid.device)
    return torch.where(valid, index.long(), n_bins + (lane % N_SPILL))


def zeros_for(fluxspecs, dtype=torch.float32, device=None) -> tuple:
    """Fresh (nu, nv) histograms for a tuple of specs on ``device`` (None
    means the GPU, device.default_device)."""
    device = resolve(device)
    return tuple(torch.zeros((s.nu, s.nv), dtype=dtype, device=device)
                 for s in fluxspecs)


def accumulate(flux: tuple, fluxspecs: tuple, scene, sid, hit_pts,
               absorbed) -> None:
    """One bounce's histogram update, in place. sid (n,) winning row or
    -1; hit_pts (n, 3) global hit points (garbage on non-hit lanes —
    masked by sid); absorbed (n,)."""
    for spec, hist in zip(fluxspecs, flux):
        # one flat row binned in its local (x, y) (flux_plan checks)
        inv = scene.inv_frame[spec.rows[0]]
        on_spec = sid == spec.rows[0]
        local = hit_pts.to(inv.dtype) @ inv[:3, :3].T + inv[:3, 3]
        u, v = local[:, 0], local[:, 1]
        su = (u - spec.u0) * (spec.nu / (spec.u1 - spec.u0))
        sv = (v - spec.v0) * (spec.nv / (spec.v1 - spec.v0))
        su = torch.where(torch.isfinite(su), su, -1.0)
        sv = torch.where(torch.isfinite(sv), sv, -1.0)
        iu = torch.floor(torch.clamp(su, -1.0, spec.nu)).to(torch.int64)
        iv = torch.floor(torch.clamp(sv, -1.0, spec.nv)).to(torch.int64)
        # top-edge inclusivity (matches np.histogram2d)
        iu = torch.where((iu == spec.nu) & (su <= spec.nu), spec.nu - 1, iu)
        iv = torch.where((iv == spec.nv) & (sv <= spec.nv), spec.nv - 1, iv)
        valid = (on_spec & (iu >= 0) & (iu < spec.nu)
                 & (iv >= 0) & (iv < spec.nv))
        n_bins = spec.nu * spec.nv
        idx = spread_misses(valid, iu * spec.nv + iv, n_bins)
        buf = torch.zeros(n_bins + N_SPILL, dtype=hist.dtype,
                          device=hist.device)
        buf.index_add_(0, idx, absorbed.to(hist.dtype))
        hist += buf[:n_bins].view(spec.nu, spec.nv)


def finalize(spec: FluxSpec, hist, meta):
    """Turn an accumulated (nu, nv) energy histogram into a flux map
    (W/m^2) on the surface's natural mesh. Returns (flux, (ue, ve))."""
    sidx = meta.row_logical[spec.rows[0]]
    geom = meta.surfaces[int(sidx)].geometries[0]
    ue, ve = edges_of(geom.kind, geom.extent, spec.resolution)
    areas = areas_of(geom.kind, geom.extent, spec.resolution)
    H = np.asarray(hist.detach().cpu(), dtype=float)
    with np.errstate(divide="ignore", invalid="ignore"):
        flux = np.where(areas > 0, H / np.maximum(areas, 1e-300), 0.0)
    return flux, (ue, ve)
