"""The NSTTF heliostat-field scenes and their Buie sources: the main-path
workload of the port (twin of benchmarks/nsttf.py) and its two variants.

218 heliostats of 6.1 m on the as-built Sandia NSTTF pads, tracking the
sun onto an 11 x 11 m one-sided receiver on a 60 m tower, lit by a Buie
sunshape (CSR 0.02) disk source that covers the whole field
(:func:`build_scene`, :func:`make_source_fn`) or by the reference's
standard field source, a horizontal rectangle above the field whose rays
leave obliquely along -sun (:func:`make_rect_source_fn`). The curved field
(:func:`build_curved_scene`, twin of benchmarks/curved.py:32-50) focuses
every heliostat: slant-focused paraboloids aimed 60 m up, with the
receiver tilted toward (cx, cy, -45).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import spatial as sp
from ..scene import Assembly, compile_scene
from ..sources import (buie_sunshape, buie_sunshape_pallas_spec,
                       rect_buie_sunshape, rect_buie_sunshape_pallas_spec)
from .heliostat_field import (HeliostatField, load_heliostat_positions,
                              solar_vector)
from .one_sided_mirror import one_sided_receiver


def build_scene(n_heliostats: int = 218, sigma: float = 1.5e-3,
                tower_height: float = 60.0, azimuth: float = 0.0,
                zenith: float = np.pi / 6, dtype=torch.float32,
                device=None):
    """Returns (table, meta, field_info) for the tracked field + receiver
    (at most the 218 real heliostat pads); field_info holds the pads, the
    sun vector, the field's centre, the tower height, the mirrors' normals
    and the Assembly and HeliostatField it was compiled from (which
    analysis.annual.efficiency_sweep re-aims)."""
    positions = load_heliostat_positions()[:n_heliostats]
    field = HeliostatField(positions, width=6.1, height=6.1,
                           absorptivity=0.1, sigma=sigma, bi_var=True)
    field.set_aim_height(tower_height)
    normals = field.track_sun(azimuth=azimuth, zenith=zenith)

    # 11x11 m receiver aperture on the tower, tilted toward the field center
    _, rec = one_sided_receiver(11.0, 11.0)
    center = positions.mean(axis=0)
    aim_dir = np.array([center[0], center[1], -tower_height * 0.75])
    aim_dir /= np.linalg.norm(aim_dir)
    rec.set_transform(sp.translate(0, 0, tower_height)
                      @ sp._homog(sp.rotation_to_z(aim_dir)))

    asm = Assembly(objects=[rec], subassemblies=[field])
    table, meta = compile_scene(asm, dtype=dtype, device=device)
    info = dict(positions=positions, sun=solar_vector(azimuth, zenith),
                field_center=center, tower_height=tower_height,
                normals=normals, assembly=asm, field=field)
    return table, meta, info


def make_source_fn(info, slab: int, csr: float = 0.02, dni: float = 1000.0):
    """Buie-sunshape disk source covering the whole field, shining along
    -sun. ``source_fn(generator, device=None)`` draws a slab of rays; its
    ``pallas_spec`` is the static spec the culled kernel regenerates
    from, and ``num_rays`` the slab size."""
    positions = info["positions"]
    sun = info["sun"]
    center_xy = positions.mean(axis=0)
    extent = np.max(np.hypot(*(positions[:, :2] - center_xy[:2]).T)) + 10.0
    src_center = center_xy + sun * 300.0

    def source_fn(generator, device=None):
        return buie_sunshape(generator, slab, center=src_center,
                             direction=-sun, radius=extent, CSR=csr,
                             flux=dni, device=device)

    source_fn.pallas_spec = buie_sunshape_pallas_spec(
        slab, src_center, -sun, extent, csr, dni)
    source_fn.num_rays = slab
    return source_fn


def build_curved_scene(n_heliostats: int = 218, dtype=torch.float32,
                       device=None):
    """Returns (table, meta, field_info) of the curved-facet field
    (benchmarks/curved.py:32-50): the NSTTF pads with 6.1 m parabolic
    one-sided mirrors focused at each pad's slant range to the 60 m aim
    point, tracking the sun at zenith 30 deg, and the 11 x 11 m receiver
    tilted toward (cx, cy, -45) from the tower top: a parab group of
    mirrors and a flat receiver group."""
    positions = load_heliostat_positions()[:n_heliostats]
    slant = np.hypot(np.hypot(positions[:, 0], positions[:, 1]), 60.0)
    field = HeliostatField(positions, width=6.1, height=6.1,
                           absorptivity=0.1, sigma=1.5e-3, bi_var=True,
                           focal_lengths=slant)
    field.set_aim_height(60.0)
    field.track_sun(azimuth=0.0, zenith=np.pi / 6)
    _, rec = one_sided_receiver(11.0, 11.0)
    center = positions.mean(axis=0)
    aim = np.array([center[0], center[1], -45.0])
    aim /= np.linalg.norm(aim)
    rec.set_transform(sp.translate(0, 0, 60.0)
                      @ sp._homog(sp.rotation_to_z(aim)))
    table, meta = compile_scene(Assembly(objects=[rec],
                                         subassemblies=[field]),
                                dtype=dtype, device=device)
    info = dict(positions=positions, sun=solar_vector(0.0, np.pi / 6),
                field_center=center, tower_height=60.0)
    return table, meta, info


def make_rect_source_fn(info, slab: int, csr: float = 0.02,
                        dni: float = 1000.0, z0: float = 300.0):
    """The oblique rect Buie source (benchmarks/nsttf.py:93-118): a
    horizontal rectangle 12 m wider than the field on each side, at height
    ``z0`` along the sun ray through the field's centre, whose rays leave
    along -sun (the flux cosine-projected). ``source_fn(generator,
    device=None)`` draws a slab; ``pallas_spec`` carries the rect marker
    the culling build and both kernels regenerate from."""
    positions = info["positions"]
    sun = info["sun"]
    center_xy = positions[:, :2].mean(axis=0)
    half = (positions[:, :2].max(axis=0)
            - positions[:, :2].min(axis=0)) / 2.0 + 12.0
    w, h = 2.0 * float(half[0]), 2.0 * float(half[1])
    src_center = (np.array([center_xy[0], center_xy[1], 0.0])
                  + sun * (z0 / sun[2]))
    down = np.array([0.0, 0.0, -1.0])

    def source_fn(generator, device=None):
        return rect_buie_sunshape(generator, slab, center=src_center,
                                  direction=down, width=w, height=h,
                                  CSR=csr, flux=dni, rays_direction=-sun,
                                  device=device)

    source_fn.pallas_spec = rect_buie_sunshape_pallas_spec(
        slab, src_center, down, w, h, csr, dni, rays_direction=-sun)
    source_fn.num_rays = slab
    return source_fn
