"""SG4 500 m^2 big dish (the PyTorch port of tracer_tpu/models/sg4.py):
two coaxial parabolic dish layers 0.1 mm apart with different slope
errors; the effective absorptivity folds the mirror-area / aperture-area
ratio."""
from __future__ import annotations

import numpy as np

from .. import geometry as G
from .. import materials as M
from .. import spatial as sp
from ..scene import Assembly, AssembledObject, Surface


class SG4(Assembly):
    def __init__(self, dishDiameter, dishFocus, absMirrors, sigma,
                 dishDiameter_in=20.0, sigma_in=1.95e-3):
        aperture_area = (dishDiameter / 2.0) ** 2 * np.pi
        effective_area = 489.0
        self.dishDiameter = dishDiameter
        self.dishFocus = dishFocus
        self.absDish = 1.0 - (1.0 - absMirrors) * effective_area / aperture_area
        self.sigma = sigma

        dish = AssembledObject(surfs=[Surface(
            G.parabolic_dish(dishDiameter, dishFocus),
            M.receiver(M.reflective(self.absDish, sigma)), name="dish_outer")])
        dish_in = AssembledObject(
            surfs=[Surface(G.parabolic_dish(dishDiameter_in, dishFocus),
                           M.receiver(M.reflective(self.absDish, sigma_in)),
                           name="dish_inner")],
            transform=sp.translate(z=1e-4))
        Assembly.__init__(self, objects=[dish, dish_in])

    def get_all_hits(self, result):
        """Hit points and absorbed energy over both layers, from a
        TraceResult; the total is kept in ``total_abs``."""
        h1 = result.hits_of("dish_outer", keys=("hit", "absorbed"))
        h2 = result.hits_of("dish_inner", keys=("hit", "absorbed"))
        hits = np.concatenate([h1["hit"], h2["hit"]], axis=0)
        absorbed = np.concatenate([h1["absorbed"], h2["absorbed"]])
        self.total_abs = absorbed.sum()
        return hits, absorbed
