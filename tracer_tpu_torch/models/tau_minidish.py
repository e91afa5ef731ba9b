"""TAU mini-dish: parabolic dish + kaleidoscope homogenizer + PV receiver
(parity with reference tracer/models/tau_minidish.py)."""
from __future__ import annotations

from math import pi, sqrt

from .. import geometry as G
from .. import materials as M
from ..scene import Surface
from .homogenized_local_receiver import HomogenizedLocalReceiver


class MiniDish(HomogenizedLocalReceiver):
    """Arguments mirror the reference MiniDish (tau_minidish.py:22):
    (diameter, focal_length, dish_opt_eff, receiver_pos, receiver_side,
    homogenizer_depth, homog_opt_eff, receiver_aspect)."""

    def __init__(self, diameter, focal_length, dish_opt_eff, receiver_pos,
                 receiver_side, homogenizer_depth, homog_opt_eff,
                 receiver_aspect=1.0):
        dish_surf = Surface(G.parabolic_dish(diameter, focal_length),
                            M.reflective(1.0 - dish_opt_eff), name="dish",
                            fixed_color=(1.0, 0.0, 0.0))
        receiver_dims = (receiver_side, receiver_side * receiver_aspect)
        HomogenizedLocalReceiver.__init__(self, dish_surf, receiver_pos,
                                          receiver_dims, homogenizer_depth,
                                          homog_opt_eff)
        self._ext_dims = (diameter, receiver_pos)

    def get_external_dimensions(self):
        return self._ext_dims


def standard_minidish_measures(diameter, concentration, virt_sources):
    """Dimensioning rules for a 45-deg rim-angle dish (ref
    tau_minidish.py:59, after Ries et al. 1997)."""
    f = diameter / 4.0 / (sqrt(2) - 1)
    W = diameter / 2.0 * sqrt(pi / concentration)
    n = virt_sources + 1
    H = n * W * f / (diameter - n * W)
    return f, W, H


def standard_minidish(diameter, concentration, virt_sources,
                      dish_opt_eff=0.9, homog_opt_eff=0.9):
    """Standard-dimensioned minidish; returns (minidish, f, W, H)
    (ref tau_minidish.py:81)."""
    f, W, H = standard_minidish_measures(diameter, concentration, virt_sources)
    minidish = MiniDish(diameter, f, dish_opt_eff, f + H, W, H, homog_opt_eff)
    return minidish, f, W, H
