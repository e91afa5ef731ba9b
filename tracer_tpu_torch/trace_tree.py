"""Ray genealogy over the engine's per-bounce records (the PyTorch port of
tracer_tpu/trace_tree.py).

The fixed-slab engine makes genealogy trivial: slot i at bounce b
descends from slot i at bounce b-1, so no parent bookkeeping is needed;
RayTree exposes the reference's queries (append / ordered_parents /
ray_history) on top of a TraceResult.
"""
from __future__ import annotations

from typing import List

import numpy as np


class RayTree:
    """Bounce-level view of a TraceResult."""

    def __init__(self, result):
        self._res = result

    @property
    def num_bunds(self) -> int:
        """Number of recorded bounce levels (+1 for the source)."""
        return len(self._res.records) + 1

    def ordered_parents(self, level: int) -> np.ndarray:
        """Parent indices of the rays at a bounce level: the identity in
        the fixed-slab design."""
        return np.arange(self._res.source.num_rays)

    def ray_history(self, slot: int, level: int = None) -> List[dict]:
        """One ray from the source through its bounces: per-bounce dicts
        with sid, hit point and energies, up to ``level`` if given."""
        hist = self._res.ray_history(slot)
        if level is not None:
            hist = hist[: level + 1]
        return hist

    def bounce(self, level: int):
        """The BounceRecord at a level."""
        return self._res.records[level]
