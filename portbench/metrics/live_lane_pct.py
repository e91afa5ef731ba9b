"""Kernels: the share of launched lanes that carry energy into their
launch (K1's unparked ones), over every K1, K2, K3 and oracle ``round``
span of the telemetry pass (spans.py): 100 x the sum of ``live`` over the
sum of ``lanes``."""
from .. import spans

KERNELS = ("k1", "k2", "k3", "oracle")


def read(run):
    p = spans.of(run)
    rounds = [] if p is None else [s for s in spans.rounds(p.spans)
                                   if s.attrs.get("kernel") in KERNELS]
    lanes = sum(s.attrs["lanes"] for s in rounds)
    if not lanes:
        return None
    return 100.0 * sum(s.attrs["live"] for s in rounds) / lanes
