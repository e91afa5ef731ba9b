"""Ready-made spherical lens (a copy of tracer_tpu/models/spherical_lens.py;
parity with the reference tracer/models/spherical_lens.py): two spherical
(or flat) refractive faces plus a bounding cylinder, positioned so the
back principal point sits at Z=0 per the lensmaker equation [Smith,
Modern Optical Engineering 4th ed., eq. 3.21a]."""
from __future__ import annotations

import numpy as np

from .. import geometry as G
from .. import materials as M
from ..scene import AssembledObject, Surface
from .. import spatial as sp

_FLAT_VALUES = (0, None, np.inf, -np.inf)


class SphericalLens(AssembledObject):
    def __init__(self, diameter, depth, R1, R2, refr_idx, transform=None,
                 single_ray=True):
        """diameter, depth - aperture and center thickness; R1, R2 - front /
        back radii of curvature (positive = center of curvature down the Z
        axis; 0/None/inf = flat); refr_idx - lens material: a constant
        index, OR a dispersive material — an optical_constants object
        (anything with .m(wl)), or an explicit (wavelengths, n) table —
        mirroring the reference's material-based Refractive manager
        (optics_callables.py:726). Dispersive faces evaluate n at each
        ray's wavelength; focal_length()/positioning use the table's mean
        index (call focal_length(wavelength=...) for a specific color).
        single_ray - False requests energy-splitting interfaces (the
        reference Refractive's single_ray, optics_callables.py:732)."""
        flip = sp.rotx(np.pi)[:3, :3]
        if np.isscalar(refr_idx):
            self._n_table = None
            refr = lambda n=refr_idx: M.refractive_homogenous(
                1.0, n, single_ray=single_ray)
            refr_out = lambda n=refr_idx: M.refractive_homogenous(
                n, 1.0, single_ray=single_ray)
        else:
            # build the n(wl) table ONCE and hand the same (wl, n) pair to
            # every face, so focal_length(wavelength) and the traced
            # interfaces always share one table (refractive_material
            # defaults would otherwise re-derive it independently)
            self._n_table = M._index_table(refr_idx,
                                           (300e-9, 2500e-9), 64)
            pair = (self._n_table[:, 0], self._n_table[:, 1])
            refr = lambda: M.refractive_material(
                1.0, pair, single_ray=single_ray)
            refr_out = lambda: M.refractive_material(
                pair, 1.0, single_ray=single_ray)
            # positioning + default focal length use the mean index
            refr_idx = float(self._n_table[:, 1].mean())
        surfs = []

        # face geometry: spherical cap cut at |z| = sqrt(R^2 - (D/2)^2)
        def cap(R):
            z_cut = np.sqrt(R**2 - diameter**2 / 4.0)
            if R > 0:
                return G.cut_sphere(abs(R), G.zrange(z_cut, abs(R)))
            return G.cut_sphere(abs(R), G.zrange(-abs(R), -z_cut))

        front_flat = R1 in _FLAT_VALUES
        back_flat = R2 in _FLAT_VALUES
        if front_flat:
            self._front = Surface(G.round_plate(diameter / 2.0), refr(),
                                  name="lens_front")
            R1 = np.inf
        else:
            self._front = Surface(cap(R1), refr(), name="lens_front")
        if back_flat:
            self._back = Surface(G.round_plate(diameter / 2.0), refr(),
                                 rotation=flip, name="lens_back")
            R2 = np.inf
        else:
            self._back = Surface(cap(R2), refr(), name="lens_back")

        # lensmaker equation; see module docstring
        opt_power = (refr_idx - 1.0) * (
            1.0 / R1 - 1.0 / R2
            + depth * (refr_idx - 1.0) / (R1 * R2 * refr_idx))
        f = 1.0 / opt_power
        # back principal plane sits f*d*(n-1)/(n*R1) toward the front of the
        # back vertex; placing the vertex at -pd puts H' exactly at Z=0 so
        # the focus is at Z=-f. (The reference places the vertex at +pd,
        # spherical_lens.py:92-96, which lands H' at +2pd — a small
        # positioning bug confirmed by tracing; not replicated.)
        pd = -f * depth * (refr_idx - 1.0) / (refr_idx * R1)

        # back vertex at z = pd, front vertex at z = pd + depth — flat
        # faces sit AT their vertex plane (they previously stayed at the
        # origin, collapsing plano lenses' center thickness)
        if R2 != np.inf:
            locb = pd - R2
            self._back.set_location([0.0, 0.0, locb])
            z_cut2 = np.sign(R2) * np.sqrt(R2**2 - diameter**2 / 4.0)
            edge_b = locb + z_cut2
        else:
            self._back.set_location([0.0, 0.0, pd])
            edge_b = pd
        if R1 != np.inf:
            locf = pd + depth - R1
            self._front.set_location([0.0, 0.0, locf])
            z_cut1 = np.sign(R1) * np.sqrt(R1**2 - diameter**2 / 4.0)
            edge_f = locf + z_cut1
        else:
            self._front.set_location([0.0, 0.0, pd + depth])
            edge_f = pd + depth
        cyl_loc = (edge_b + edge_f) / 2.0
        cyl_height = edge_f - edge_b

        surfs = [self._front, self._back]
        if cyl_height > 0:
            self._cyl = Surface(
                G.finite_cylinder(diameter, cyl_height),
                refr_out(),
                location=[0.0, 0.0, cyl_loc], name="lens_rim")
            surfs.append(self._cyl)

        AssembledObject.__init__(self, surfs=surfs, transform=transform)
        self._f = f
        self._lensmaker = (R1, R2, depth)

    def focal_length(self, wavelength=None) -> float:
        """Effective focal length from the back principal point at Z=0.
        For a dispersive lens, ``wavelength`` [m] gives the lensmaker
        focal length at that color (n interpolated from the table);
        default = the mean-index value the lens was positioned with."""
        if wavelength is None or self._n_table is None:
            return self._f
        R1, R2, depth = self._lensmaker
        n = float(np.interp(wavelength, self._n_table[:, 0],
                            self._n_table[:, 1]))
        return 1.0 / ((n - 1.0) * (1.0 / R1 - 1.0 / R2
                                   + depth * (n - 1.0) / (R1 * R2 * n)))
