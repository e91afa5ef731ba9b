"""Collector base: main reflector + square homogenizer + receiver plate
(parity with reference tracer/models/homogenized_local_receiver.py)."""
from __future__ import annotations

import numpy as np

from .. import spatial as sp
from ..scene import Assembly, AssembledObject, Surface
from .homogenizer import rect_homogenizer
from .one_sided_mirror import one_sided_receiver


class HomogenizedLocalReceiver(Assembly):
    def __init__(self, main_reflector: Surface, receiver_pos: float,
                 receiver_dims, homogenizer_depth: float,
                 homog_opt_eff: float):
        if not isinstance(receiver_dims, tuple):
            receiver_dims = (receiver_dims, receiver_dims)
        self._sides = receiver_dims
        self._rec_pos = receiver_pos

        self._rec_surf, self._rec = one_sided_receiver(*self._sides)
        receiver_frame = sp.translate(0, 0, receiver_pos) @ sp.rotx(np.pi)
        self._rec.set_transform(receiver_frame)

        self._hom = rect_homogenizer(self._sides[0], self._sides[1],
                                     homogenizer_depth, homog_opt_eff)
        self._hom.set_transform(receiver_frame)

        self._mr = main_reflector
        refl = AssembledObject(surfs=[main_reflector])
        Assembly.__init__(self, objects=[self._rec, refl],
                          subassemblies=[self._hom])

    def get_receiver_surf(self) -> Surface:
        return self._rec_surf

    def get_homogenizer(self) -> Assembly:
        return self._hom

    def get_main_reflector(self) -> Surface:
        return self._mr

    def histogram_hits(self, result, bins: int = 50):
        """2D histogram of energy absorbed on the receiver from a
        TraceResult (ref homogenized_local_receiver.py:59, which pulled the
        same data from the receiver's accountant).

        Returns (H, xbins, ybins)."""
        hits = result.hits_of(self._rec_surf.name)
        rngx, rngy = self._sides[0] / 2.0, self._sides[1] / 2.0
        if len(hits["absorbed"]) == 0:
            edges = (np.linspace(-rngx, rngx, bins + 1),
                     np.linspace(-rngy, rngy, bins + 1))
            return np.zeros((bins, bins)), edges[0], edges[1]
        x, y = hits["local"][:, 0], hits["local"][:, 1]
        H, xbins, ybins = np.histogram2d(
            x, y, bins, range=([-rngx, rngx], [-rngy, rngy]),
            weights=hits["absorbed"])
        return H, xbins, ybins
