"""Annual optical-efficiency sweeps for heliostat fields (the port of
tracer_tpu/analysis/annual.py).

Beyond the reference: the reference traces ONE sun position per script run
(`examples/Sandia_NSTTF_field example.py`:96-112 fixes azimuth/zenith at
module top and `heliostat_field.track_sun` re-aims the field once); annual
performance studies — the bread-and-butter CSP workflow behind field layout
and aiming decisions — would re-run the whole script per sun position.
Here a sun-path grid sweeps through the same trace machinery:

- solar geometry (declination, hour angle -> azimuth/zenith) is the
  textbook Cooper/Duffie-Beckman formula set, matching
  ``models.heliostat_field.solar_vector``'s convention (azimuth measured
  from North, clockwise/toward East; zenith from vertical);
- ``annual_sun_grid`` builds a daylight-weighted grid of representative
  sun positions (each point carries the annual hours it represents);
- ``efficiency_sweep`` re-aims the field (host NumPy), compiles the scene
  table anew and traces each position with ``engine.trace_streaming``:
  the plain megakernel (K2) by default, the relevancy-culled trace (K1,
  with the K2 drain) with ``use_culling``.

Nothing is compiled per position here: the kernels are built once a
process, and each position rebuilds its table (and, culled, its culling)
on the host, in the time ``efficiency_sweep`` reports as ``build_s``.
"""
from __future__ import annotations

import math
from typing import Optional

import time

import numpy as np
import torch

from ..models.heliostat_field import solar_vector
from ..scene import compile_scene

__all__ = ["solar_declination", "solar_angles", "annual_sun_grid",
           "field_disk_source", "efficiency_sweep"]


def solar_declination(day_of_year) -> np.ndarray:
    """Solar declination (radians) by Cooper's equation:
    23.45 deg * sin(2 pi (284 + n) / 365)."""
    n = np.asarray(day_of_year, dtype=float)
    return np.deg2rad(23.45) * np.sin(2.0 * np.pi * (284.0 + n) / 365.0)


def solar_angles(latitude: float, day_of_year, solar_hour):
    """(azimuth, zenith) in radians for a latitude (radians, +N), day of
    year and LOCAL SOLAR hour (12.0 = solar noon).

    Azimuth follows ``solar_vector``'s convention: from North, clockwise
    (toward East) — at solar noon in the northern mid-latitudes the sun is
    due South (azimuth pi). Zenith is measured from vertical; values
    > pi/2 mean the sun is below the horizon.
    """
    phi = float(latitude)
    delta = solar_declination(day_of_year)
    omega = np.deg2rad(15.0) * (np.asarray(solar_hour, dtype=float) - 12.0)
    # sun unit vector in East/North/Up coordinates
    up = (np.sin(phi) * np.sin(delta)
          + np.cos(phi) * np.cos(delta) * np.cos(omega))
    east = -np.cos(delta) * np.sin(omega)
    north = (np.cos(phi) * np.sin(delta)
             - np.sin(phi) * np.cos(delta) * np.cos(omega))
    azimuth = np.arctan2(east, north) % (2.0 * np.pi)
    zenith = np.arccos(np.clip(up, -1.0, 1.0))
    return azimuth, zenith


def annual_sun_grid(latitude: float, n_days: int = 6, n_hours: int = 7,
                    min_elevation: float = np.deg2rad(3.0)) -> np.ndarray:
    """Daylight-weighted sun-position grid for annual studies.

    ``n_days`` representative days spread through the year x ``n_hours``
    hour-angle midpoints between sunrise and sunset. Returns (K, 3) rows
    ``[azimuth, zenith, weight_hours]`` where the weights of all points of
    a day sum to that day's daylight hours times the days it represents
    (365 / n_days) — so ``sum(weights) + excluded`` is the site's annual
    daylight hours. Points below ``min_elevation`` (unusable for a
    tracking field: near-grazing cosines, atmospheric extinction) are
    dropped from the grid; their hours are returned via the ``.excluded``
    attribute on the result so an annual average can count them as
    zero-production time.
    """
    phi = float(latitude)
    rows = []
    excluded = 0.0
    for i in range(n_days):
        day = (i + 0.5) * 365.0 / n_days
        delta = float(solar_declination(day))
        cos_ws = -math.tan(phi) * math.tan(delta)
        if cos_ws >= 1.0:      # polar night: no daylight on this day
            continue
        omega_s = math.acos(max(cos_ws, -1.0))   # sunrise hour angle
        day_hours = 2.0 * omega_s * 12.0 / math.pi
        w = (365.0 / n_days) * (day_hours / n_hours)
        for j in range(n_hours):
            frac = (j + 0.5) / n_hours           # 0..1 across daylight
            hour = 12.0 + (2.0 * frac - 1.0) * omega_s * 12.0 / math.pi
            az, zen = solar_angles(phi, day, hour)
            if zen < math.pi / 2.0 - min_elevation:
                rows.append([float(az), float(zen), w])
            else:
                excluded += w
    out = np.asarray(rows, dtype=float)

    class _Grid(np.ndarray):
        pass

    g = out.view(_Grid)
    g.excluded = excluded
    return g


def field_disk_source(positions: np.ndarray, sun_vec: np.ndarray, slab: int,
                      csr: float = 0.02, dni: float = 1000.0,
                      margin: float = 10.0, standoff: float = 300.0):
    """Buie-sunshape disk source covering a heliostat field, shining along
    ``-sun_vec`` (the reference example's gen_rays geometry,
    `Sandia_NSTTF_field example.py`:60-94). Returns a ``source_fn
    (generator, device=None)`` drawing a slab, with the ``pallas_spec``
    the kernels regenerate from, ``num_rays`` (the slab) and
    ``disk_power`` (Watts over the disk)."""
    from ..sources import buie_sunshape, buie_sunshape_pallas_spec
    positions = np.asarray(positions, dtype=float)
    sun_vec = np.asarray(sun_vec, dtype=float)
    center = positions.mean(axis=0)
    extent = float(np.max(np.hypot(*(positions[:, :2]
                                     - center[:2]).T))) + margin
    src_center = center + sun_vec * standoff

    def source_fn(generator, device=None):
        return buie_sunshape(generator, slab, center=src_center,
                             direction=-sun_vec, radius=extent, CSR=csr,
                             flux=dni, device=device)

    source_fn.pallas_spec = buie_sunshape_pallas_spec(
        slab, src_center, -sun_vec, extent, csr, dni)
    source_fn.num_rays = slab
    source_fn.disk_power = dni * math.pi * extent**2   # Watts over the disk
    return source_fn


def efficiency_sweep(assembly, field, angles, total_mirror_area: float,
                     receiver: str = "receiver",
                     rays_per_position: int = 1 << 22,
                     slab: Optional[int] = None,
                     dni: float = 1000.0, csr: float = 0.02,
                     aim_height: Optional[float] = None,
                     tracking: str = "azimuth_elevation",
                     use_culling: bool = False,
                     max_path: int = 6, dtype=torch.float32,
                     generator=None, device=None) -> dict:
    """Trace a field at every sun position of ``angles`` and return the
    optical-efficiency matrix.

    assembly  the full scene Assembly (field + receiver/tower)
    field     the HeliostatField inside it (re-aimed per position)
    angles    (K, >=2) rows [azimuth, zenith(, weight_hours)] — e.g. from
              ``annual_sun_grid``; an omitted weight column means equal
              weights
    total_mirror_area  sum of all mirror areas (m^2), the denominator of
              the standard optical efficiency eta = P_receiver / (DNI * A)
    generator  an int seed or a CPU torch.Generator (None: seed 0); each
              position draws its trace's generator from it
    device    where the tables live and the trace runs (None: the GPU)

    Per position: ``field.track_sun`` re-aims (host NumPy), the scene
    compiles to a fresh table on ``device`` and ``engine.trace_streaming``
    traces ``rays_per_position`` rays in ``dtype``: float32 on the plain
    megakernel, or with ``use_culling`` on the culled trace, whose culling
    (``culling.build_block_culling``) is built for each position on the
    host (its ``slab`` must then be a whole number of ray tiles); float64
    on the general streaming path, which ignores the culling, as
    tracer_tpu's does.

    Returns a dict with per-position arrays (azimuth, zenith, weight,
    receiver_kw, efficiency, cosine_eff, closure, and the walls build_s,
    the table and culling, and trace_s, the trace to its read-back) and
    scalars ``annual_efficiency`` (daylight-hour-weighted mean, counting
    any ``angles.excluded`` hours as zero production) and
    ``annual_receiver_mwh`` (DNI-constant annual energy estimate).
    """
    from ..engine import trace_streaming
    grid_excluded = float(getattr(angles, "excluded", 0.0))
    angles = np.asarray(angles, dtype=float)
    if angles.ndim != 2 or angles.shape[1] < 2:
        raise ValueError("angles must be (K, >=2) [azimuth, zenith(, w)]")
    weights = (angles[:, 2] if angles.shape[1] > 2
               else np.ones(len(angles)))
    if not isinstance(generator, torch.Generator):
        generator = torch.Generator().manual_seed(
            0 if generator is None else int(generator))
    if slab is None:
        slab = min(int(rays_per_position), 1 << 20)
    if aim_height is not None:
        field.set_aim_height(aim_height)

    positions = field.positions
    k = len(angles)
    out = dict(azimuth=angles[:, 0].copy(), zenith=angles[:, 1].copy(),
               weight=np.asarray(weights, dtype=float).copy(),
               receiver_kw=np.zeros(k), efficiency=np.zeros(k),
               cosine_eff=np.zeros(k), closure=np.zeros(k),
               build_s=np.zeros(k), trace_s=np.zeros(k))
    for i, (az, zen) in enumerate(angles[:, :2]):
        t0 = time.perf_counter()
        normals = field.track_sun(azimuth=float(az), zenith=float(zen),
                                  tracking=tracking)
        sun = solar_vector(float(az), float(zen))
        table, meta = compile_scene(assembly, dtype=dtype, device=device)
        source_fn = field_disk_source(positions, sun, slab, csr=csr,
                                      dni=dni)
        culling = None
        if use_culling:
            from ..culling import build_block_culling
            culling = build_block_culling(table, meta,
                                          source_fn.pallas_spec, slab)
        t1 = time.perf_counter()
        sub = torch.Generator().manual_seed(int(torch.randint(
            0, 1 << 62, (1,), generator=generator)))
        # emission pacing: each fill needs a round, and a lane is reused
        # only once its ray dies (~max_path rounds worst case) — derive a
        # generous bound the way the benchmark suite does
        rounds = 8 * (-(-int(rays_per_position) // slab)) + 4 * max_path
        accum, emitted, source_e = trace_streaming(
            table, source_fn, sub, total_rays=int(rays_per_position),
            max_rounds=rounds, max_path=max_path, culling=culling)
        ab = accum.absorbed.detach().double().cpu().numpy()
        se = float(source_e)
        out["trace_s"][i] = time.perf_counter() - t1
        out["build_s"][i] = t1 - t0
        rec_rows = np.nonzero(np.asarray(meta.row_logical)
                              == meta.index_of(receiver))[0]
        # absolute receiver power: the traced sample's interception-and-
        # absorption fraction (p_rec / source_e, unbiased at any emitted
        # count) times the full disk power (e_ray is normalized per slab,
        # not per emission budget, so source_e alone is not the disk)
        p_rec = (float(ab[rec_rows].sum()) / max(se, 1e-30)
                 * source_fn.disk_power)
        closure = (se - ab.sum() - float(accum.escaped)
                   - float(accum.culled) - float(accum.medium)
                   - float(accum.residual)) / max(se, 1e-30)
        out["receiver_kw"][i] = p_rec / 1e3
        out["efficiency"][i] = p_rec / (dni * total_mirror_area)
        out["cosine_eff"][i] = float(
            np.mean(np.maximum(normals @ sun, 0.0)))
        out["closure"][i] = closure

    w = out["weight"]
    denom_hours = w.sum() + grid_excluded
    out["annual_efficiency"] = float((out["efficiency"] * w).sum()
                                     / max(denom_hours, 1e-30))
    out["annual_receiver_mwh"] = float(
        (out["receiver_kw"] * w).sum() / 1e3)
    out["excluded_hours"] = grid_excluded
    return out
