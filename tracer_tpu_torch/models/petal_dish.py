"""PETAL hexagonal dish (the PyTorch port of
tracer_tpu/models/petal_dish.py): a hexagonal-aperture paraboloid over a
square homogenizer and receiver."""
from __future__ import annotations

from .. import geometry as G
from .. import materials as M
from ..scene import Surface
from .homogenized_local_receiver import HomogenizedLocalReceiver


class PETAL(HomogenizedLocalReceiver):
    def __init__(self, diameter, focal_length, dish_opt_eff, receiver_pos,
                 receiver_side, homogenizer_depth, homog_opt_eff,
                 receiver_aspect=1.0):
        dish_surf = Surface(
            G.hexagonal_parabolic_dish(diameter, focal_length),
            M.reflective(1.0 - dish_opt_eff), name="dish")
        receiver_dims = (receiver_side, receiver_side * receiver_aspect)
        HomogenizedLocalReceiver.__init__(self, dish_surf, receiver_pos,
                                          receiver_dims, homogenizer_depth,
                                          homog_opt_eff)
        self._ext_dims = (diameter, receiver_pos)

    def get_external_dimensions(self):
        return self._ext_dims
