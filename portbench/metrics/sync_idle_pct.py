"""Device: the share of the card's idle time that the host's waits make:
in the profiled slice of the telemetry pass (spans.py), 100 x the idle
gaps that open while the host is inside a ``sync`` span, over every idle
gap that opens inside a ``call`` span (gaps by their start, the end of
the device's busy interval, on the spans' clock)."""
from .. import spans


def read(run):
    p = spans.of(run)
    if p is None:
        return None
    calls = spans.Intervals(s for s in p.slice_spans if s.name == "call")
    syncs = spans.Intervals(s for s in p.slice_spans if s.name == "sync")
    idle = [(b - a, syncs.holds(a)) for a, b, _ in p.gaps
            if calls.holds(a)]
    total = sum(d for d, _ in idle)
    if not total:
        return None
    return 100.0 * sum(d for d, waiting in idle if waiting) / total
