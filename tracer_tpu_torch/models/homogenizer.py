"""Rectangular kaleidoscope homogenizer: four inward-facing one-sided
mirrors (parity with reference tracer/models/homogenizer.py)."""
from __future__ import annotations

import numpy as np

from .. import spatial as sp
from ..scene import Assembly
from .one_sided_mirror import rect_one_sided_mirror


def rect_homogenizer(aperture_xdim: float, aperture_ydim: float,
                     height: float, opt_eff: float) -> Assembly:
    """Four mirror walls forming a box from z=0 to z=height, aperture
    (aperture_xdim x aperture_ydim), each wall with optical efficiency
    ``opt_eff`` (ref homogenizer.py:11)."""
    absorb = 1.0 - opt_eff
    wall_xp = rect_one_sided_mirror(height, aperture_ydim, absorb,
                                    option="fast", name="homog_xp")
    wall_xp.set_transform(
        sp.translate(aperture_xdim / 2.0, 0, height / 2.0) @ sp.roty(-np.pi / 2))

    wall_xn = rect_one_sided_mirror(height, aperture_ydim, absorb,
                                    option="fast", name="homog_xn")
    wall_xn.set_transform(
        sp.translate(-aperture_xdim / 2.0, 0, height / 2.0) @ sp.roty(np.pi / 2))

    wall_yp = rect_one_sided_mirror(aperture_xdim, height, absorb,
                                    option="fast", name="homog_yp")
    wall_yp.set_transform(
        sp.translate(0, aperture_ydim / 2.0, height / 2.0) @ sp.rotx(np.pi / 2))

    wall_yn = rect_one_sided_mirror(aperture_xdim, height, absorb,
                                    option="fast", name="homog_yn")
    wall_yn.set_transform(
        sp.translate(0, -aperture_ydim / 2.0, height / 2.0) @ sp.rotx(-np.pi / 2))

    return Assembly(objects=[wall_xp, wall_xn, wall_yp, wall_yn])
