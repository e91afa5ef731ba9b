"""Heliostat field with two-axis sun tracking aimed at a tower.

Capability parity with the reference's tracer/models/heliostat_field.py
(HeliostatField :28, track_sun :89, solar_vector :201, radial_stagger :222),
re-designed for the flat-scene-table architecture: tracking computes each
heliostat's composed frame directly (vectorized NumPy) instead of mutating a
nested assembly tree through RotationAxis objects; the engine recompiles the
frame columns of the surface table.

Coordinates: +x East, +y North, z up; the tower is at the origin.

Reference bug NOT replicated: the reference's 'tilt_roll' branch reads an
undefined variable (heliostat_field.py:169 ``hstat``); the intended tracking
vector ``trac`` is used here.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import spatial as sp
from ..scene import Assembly
from .one_sided_mirror import (flat_quad_one_sided_mirror,
                               rect_one_sided_mirror,
                               rect_para_one_sided_mirror)


def solar_vector(azimuth: float, zenith: float) -> np.ndarray:
    """Unit vector pointing TO the sun. azimuth in radians from North,
    clockwise (i.e. toward East); zenith from vertical
    (ref heliostat_field.py:201)."""
    az = np.pi / 2.0 - azimuth
    if az < 0.0:
        az += 2.0 * np.pi
    return np.array([np.sin(zenith) * np.cos(az),
                     np.sin(zenith) * np.sin(az),
                     np.cos(zenith)])


def radial_stagger(start_ang: float, end_ang: float, az_space: float,
                   rmin: float, rmax: float, r_space: float) -> np.ndarray:
    """Radial-stagger field layout; returns (n,2) x,y positions
    (ref heliostat_field.py:222)."""
    rs = np.arange(rmin, rmax, r_space)
    angs = np.arange(start_ang, end_ang, az_space / 2.0)
    xs1 = np.outer(rs[::2], np.cos(angs[::2])).ravel()
    ys1 = np.outer(rs[::2], np.sin(angs[::2])).ravel()
    xs2 = np.outer(rs[1::2], np.cos(angs[1::2])).ravel()
    ys2 = np.outer(rs[1::2], np.sin(angs[1::2])).ravel()
    return np.stack([np.concatenate([xs1, xs2]),
                     np.concatenate([ys1, ys2])], axis=1)


def load_heliostat_positions(path: Optional[str] = None) -> np.ndarray:
    """Heliostat positions (n, 3) from a site CSV with one ``x,y,z`` row
    per heliostat (the format of the reference's
    examples/sandia_hstat_coordinates.csv). With no path, returns the
    bundled real Sandia NSTTF field: the 218 as-built heliostat pad
    coordinates of the National Solar Thermal Test Facility
    (Albuquerque, NM) — public facility data."""
    if path is not None:
        return np.loadtxt(path, delimiter=",", dtype=float).reshape(-1, 3)
    import os
    data = np.load(os.path.join(os.path.dirname(__file__), "..", "data",
                                "sandia_nsttf_field.npz"))
    return data["positions"]


class HeliostatField(Assembly):
    """A field of rectangular one-sided mirrors (flat, parabolic or general
    quadric) on two-axis trackers (ref HeliostatField :28)."""

    def __init__(self, positions, width: float, height: float,
                 absorptivity=None, sigma: float = None,
                 bi_var: bool = True,
                 focal_lengths: Optional[Sequence] = None,
                 quad_params: Optional[Sequence] = None,
                 MCRT_option: str = "fast",
                 rotation_axes_pos=np.zeros((2, 3)),
                 rotation_axes_vec=np.array([[0.0, 0.0, 1.0],
                                             [1.0, 0.0, 0.0]]),
                 optics=None):
        positions = np.asarray(positions, dtype=float)
        if positions.shape[1] == 2:
            positions = np.concatenate(
                [positions, np.zeros((len(positions), 1))], axis=1)
        self._pos = positions
        n = positions.shape[0]
        if optics is None and (absorptivity is None or sigma is None):
            raise ValueError("give absorptivity and sigma (or a full "
                             "optics= spec) — silently lossless, "
                             "error-free mirrors would be a trap")
        absorptivity = np.broadcast_to(
            np.asarray(0.0 if absorptivity is None else absorptivity,
                       dtype=float), (n,))
        sigma = 0.0 if sigma is None else sigma
        self.rotation_axes_pos = np.asarray(rotation_axes_pos, dtype=float)
        self.rotation_axes_vec = np.asarray(rotation_axes_vec, dtype=float)
        self._axes_offset = (self.rotation_axes_pos[1]
                             - self.rotation_axes_pos[0])

        if focal_lengths is None:
            focal_lengths = [None] * n
        if quad_params is None:
            quad_params = [None] * n

        self._heliostats = []
        for p in range(n):
            if focal_lengths[p] is not None and quad_params[p] is not None:
                raise ValueError("give focal_lengths OR quad_params, not both")
            if optics is not None:
                # custom per-mirror OpticsSpec (e.g. measured spectral
                # coatings, materials.reflective_spectral) overrides the
                # constructed reflective; the geometry selection matches
                # the default path (flat / parabolic / general quadric)
                from ..scene import AssembledObject, Surface
                from .. import geometry as _G
                if focal_lengths[p] is not None:
                    geom = _G.rect_parabolic_dish(width, height,
                                                  focal_lengths[p])
                elif quad_params[p] is not None:
                    geom = _G.rect_flat_quadric(width, height,
                                                *quad_params[p])
                else:
                    geom = _G.rect_plate(width, height)
                mirror = AssembledObject(
                    surfs=[Surface(geom, optics, name=f"heliostat_{p}")])
            elif focal_lengths[p] is not None:
                mirror = rect_para_one_sided_mirror(
                    width, height, focal_lengths[p], absorptivity[p], sigma,
                    bi_var, MCRT_option, name=f"heliostat_{p}")
            elif quad_params[p] is not None:
                mirror = flat_quad_one_sided_mirror(
                    width, height, quad_params[p], absorptivity[p], sigma,
                    bi_var, MCRT_option, name=f"heliostat_{p}")
            else:
                mirror = rect_one_sided_mirror(
                    width, height, absorptivity[p], sigma, bi_var,
                    MCRT_option, name=f"heliostat_{p}")
            self._heliostats.append(mirror)
        Assembly.__init__(self, objects=self._heliostats)

    def get_heliostats(self):
        return self._heliostats

    @property
    def positions(self) -> np.ndarray:
        """(n, 3) heliostat pad positions."""
        return self._pos

    def set_aim_height(self, h: float) -> None:
        self._th = float(h)

    def track_sun(self, azimuth: float, zenith: float, aim_points=None,
                  aim_vectors=None, tracking: str = "azimuth_elevation",
                  tracking_error: Optional[float] = None,
                  tracking_limits_primary_axis=None,
                  tracking_limits_secondary_axis=None,
                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Orient every heliostat so reflected sunlight goes to its aim
        point/vector (ref track_sun :89). Sets each mirror object's frame to
        the composed two-axis actuation:

            T = translate(pos + axes_pos0) . R1(axis1, pi/2 + az)
                . translate(axes_offset) . R2(axis2, zenith)

        which is exactly the reference's nested facet rotations flattened.
        Returns the per-heliostat mirror normals (n,3).
        """
        if aim_points is None and aim_vectors is None:
            # default: aim at the tower top (origin at height _th)
            if not hasattr(self, "_th"):
                raise ValueError("set aim_points/aim_vectors or "
                                 "set_aim_height first")
            aim_points = np.tile([0.0, 0.0, self._th], (len(self._pos), 1))

        sun_vec = solar_vector(azimuth, zenith)
        if aim_points is not None:
            aim = (np.asarray(aim_points, dtype=float)
                   - (self._pos + self.rotation_axes_pos.sum(axis=0)))
        else:
            aim = np.asarray(aim_vectors, dtype=float).copy()
        aim /= np.linalg.norm(aim, axis=1, keepdims=True)
        trac = sun_vec + aim
        trac /= np.linalg.norm(trac, axis=1, keepdims=True)

        n = len(self._pos)
        if rng is None:
            rng = np.random.default_rng(0)
        err1 = (rng.normal(scale=tracking_error, size=n)
                if tracking_error else np.zeros(n))
        err2 = (rng.normal(scale=tracking_error, size=n)
                if tracking_error else np.zeros(n))
        lim1 = tracking_limits_primary_axis or [-np.pi, np.pi]
        lim2 = tracking_limits_secondary_axis or [-np.pi, np.pi]

        axis1, axis2 = self.rotation_axes_vec

        if tracking == "azimuth_elevation":
            ang1 = np.arctan2(trac[:, 1], trac[:, 0]) + err1
            ang2 = np.arccos(np.clip(trac[:, 2], -1.0, 1.0)) + err2
            # principal-branch wrap is +/- 2*pi; the reference wraps by
            # +/- pi (heliostat_field.py:136-139), flipping the azimuth
            # 180 deg whenever tracking error pushes ang1 past +/- pi —
            # a documented defect not replicated (SURVEY 2.11 policy)
            ang1 = np.where(ang1 < -np.pi, ang1 + 2.0 * np.pi, ang1)
            ang1 = np.where(ang1 > np.pi, ang1 - 2.0 * np.pi, ang1)
            primary = ang1 + np.pi / 2.0
        elif tracking == "tilt_roll":
            ang1 = np.arctan2(trac[:, 1], trac[:, 2]) + err1
            ang2 = np.arcsin(np.clip(trac[:, 0], -1.0, 1.0)) + err2
            primary = -ang1
            axis1, axis2 = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
        else:
            raise ValueError(f"unknown tracking mode {tracking}")

        normals = np.zeros((n, 3))
        for i, mirror in enumerate(self._heliostats):
            if not (lim1[0] <= ang1[i] <= lim1[1]) or \
               not (lim2[0] <= ang2[i] <= lim2[1]):
                continue  # outside actuation limits: leave as-is (ref :148)
            if tracking == "azimuth_elevation":
                R1 = sp.general_axis_rotation(axis1, primary[i])
                R2 = sp.general_axis_rotation(axis2, ang2[i])
            else:
                R1 = sp.general_axis_rotation(axis1, primary[i])
                R2 = sp.general_axis_rotation(axis2, ang2[i])
            T = (sp.translate(*(self._pos[i] + self.rotation_axes_pos[0]))
                 @ sp._homog(R1)
                 @ sp.translate(*self._axes_offset)
                 @ sp._homog(R2))
            mirror.set_transform(T)
            normals[i] = T[:3, 2]
        return normals

    def get_tracking_vectors(self) -> np.ndarray:
        return np.stack([m.get_transform()[:3, 2] for m in self._heliostats])
