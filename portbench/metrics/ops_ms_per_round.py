"""Shade and bookkeeping: device time of every profiled device event that
is not K1, K2 or K3, per round of the profiled slice."""
from ..kernels import KERNELS


def read(run):
    sl = run.slice
    if sl is None:
        return None
    rounds = sum(sl.counters.values())
    other = sum(t for name, t in sl.device_ops.items()
                if not any(k in name for k in KERNELS.values()))
    return 1e3 * other / rounds if rounds else None
