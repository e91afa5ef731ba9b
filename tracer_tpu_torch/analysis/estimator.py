"""Batched weighted Welford statistics and the trace-until-converged loop
(the port's NumPy copy of tracer_tpu/analysis/estimator.py).

Capability parity with the reference's ray_trace_utils/estimator.py
(Estimator :3, MCRT_to_CI :41). Host code: a batch function that traces
on the card returns its values to the host, and the statistics run
there.
"""
from __future__ import annotations

from typing import Callable

import numpy as np


class Estimator:
    """Streaming weighted mean/variance over batches of values (Welford),
    with an n-sigma confidence interval on the mean."""

    def __init__(self, n_sigma: float = 3.0):
        self.n_sigma = n_sigma
        self.count = 0
        self.wsum = None
        self.mean = None
        self.m2 = None

    def update(self, values, weights=None):
        values = np.asarray(values, dtype=float)
        if weights is None:
            weights = np.ones_like(values)
        weights = np.broadcast_to(np.asarray(weights, dtype=float),
                                  values.shape)
        if self.mean is None:
            self.wsum = np.zeros(values.shape[1:] if values.ndim > 1 else ())
            self.mean = np.zeros_like(self.wsum, dtype=float)
            self.m2 = np.zeros_like(self.mean)
        for v, w in zip(np.atleast_1d(values), np.atleast_1d(weights)):
            self.count += 1
            self.wsum = self.wsum + w
            delta = v - self.mean
            safe = np.where(self.wsum == 0.0, 1.0, self.wsum)
            self.mean = self.mean + (w / safe) * delta
            self.m2 = self.m2 + w * delta * (v - self.mean)
        return self

    @property
    def variance(self):
        safe = np.where(np.asarray(self.wsum) == 0.0, 1.0, self.wsum)
        return self.m2 / safe

    @property
    def std_of_mean(self):
        if self.count < 2:
            return np.full_like(np.asarray(self.mean, dtype=float), np.inf)
        return np.sqrt(self.variance / max(self.count - 1, 1))

    @property
    def ci(self):
        """Half-width of the n-sigma confidence interval on the mean."""
        return self.n_sigma * self.std_of_mean

    def converged(self, rel_tol: float) -> bool:
        mean = np.asarray(self.mean, dtype=float)
        scale = np.where(mean == 0.0, 1.0, np.abs(mean))
        return bool(np.all(self.ci / scale <= rel_tol))


def mcrt_to_ci(batch_fn: Callable[[int], np.ndarray], rel_tol: float = 0.01,
               n_sigma: float = 3.0, min_batches: int = 5,
               max_batches: int = 1000) -> Estimator:
    """Run ``batch_fn(batch_index) -> value(s)`` until the n-sigma CI of the
    mean is within rel_tol of the mean (ref MCRT_to_CI, estimator.py:41)."""
    est = Estimator(n_sigma=n_sigma)
    for b in range(max_batches):
        est.update(np.asarray(batch_fn(b))[None, ...])
        if b + 1 >= min_batches and est.converged(rel_tol):
            break
    return est
