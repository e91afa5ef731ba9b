"""Device-side flux-map accumulation for the streaming trace (the PyTorch
port of tracer_tpu/analysis/device_fluxmap.py).

Each bounce, every hit lane's absorbed energy is added to a per-surface
(nu, nv) histogram over the surface's natural binning (fluxmap.edges_of —
uniform by construction, so binning is one floor() per axis): local (x, y)
on flat plates, (r, theta) on discs and dishes, (z, theta) on cylinders
and frusta, (theta, phi) on spheres. A surface of several rows (a mesh, a
bifacial plate) bins each hit through its own row's frame, found by one
gather: a table from row id to the row's slot in the spec, indexed by the
lane's sid. The add is a
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
from ..mathutils import transform_points
from .fluxmap import (_AXIAL, _CARTESIAN, _POLAR, _SPHERICAL, areas_of,
                      edges_of)


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
    ue, ve = edges_of(geom.kind, geom.extent, resolution)
    p0 = float(geom.extent["R"]) if geom.kind in _SPHERICAL else 0.0
    return FluxSpec(rows=rows, kind=geom.kind,
                    nu=len(ue) - 1, nv=len(ve) - 1,
                    u0=float(ue[0]), u1=float(ue[-1]),
                    v0=float(ve[0]), v1=float(ve[-1]),
                    p0=p0, resolution=resolution)


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


def _uv(spec: FluxSpec, local):
    """Torch twin of fluxmap.uv_project for one spec (local (n, 3))."""
    x, y, z = local[:, 0], local[:, 1], local[:, 2]
    if spec.kind in _CARTESIAN:
        return x, y
    theta = torch.atan2(y, x)
    theta = torch.where(theta < 0.0, theta + 2.0 * np.pi, theta)
    if spec.kind in _POLAR:
        return torch.hypot(x, y), theta
    if spec.kind in _AXIAL:
        return z, theta
    if spec.kind in _SPHERICAL:
        return torch.arccos(torch.clamp(z / spec.p0, -1.0, 1.0)), theta
    raise NotImplementedError(f"no device fluxmap for kind {spec.kind}")


def _row_frames(spec: FluxSpec, scene, sid):
    """(on_spec (n,) bool, each lane's inverse row frame): one (4, 4)
    frame for a one-row surface; for several rows, the top (n, 3, 4) of
    each lane's frame gathered through a table from row id to slot in
    ``spec.rows`` indexed by sid, so the work does not grow with the
    number of rows."""
    if len(spec.rows) == 1:
        return sid == spec.rows[0], scene.inv_frame[spec.rows[0]]
    rows = torch.as_tensor(spec.rows, dtype=torch.int64, device=sid.device)
    slot_of = torch.full((scene.num_rows + 1,), -1, dtype=torch.int64,
                         device=sid.device)
    slot_of[rows + 1] = torch.arange(len(spec.rows), device=sid.device)
    slot = slot_of[sid.long() + 1]          # sid -1 reads the -1 at 0
    inv = scene.inv_frame.index_select(0, rows)[:, :3].contiguous()
    return slot >= 0, inv.index_select(0, slot.clamp(min=0))


def accumulate(flux: tuple, fluxspecs: tuple, scene, sid, hit_pts,
               absorbed) -> None:
    """One bounce's histogram update, in place. sid (n,) winning row or
    -1; hit_pts (n, 3) global hit points (garbage on non-hit lanes —
    masked by sid); absorbed (n,)."""
    for spec, hist in zip(fluxspecs, flux):
        on_spec, inv = _row_frames(spec, scene, sid)
        # elementwise rotation (mathutils.apply_rot), rounded alike on
        # every device
        local = transform_points(inv, hit_pts.to(inv.dtype))
        u, v = _uv(spec, local)
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
