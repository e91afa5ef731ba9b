"""Round loop: the share of the streaming calls' time spent draining
their survivors: 100 x the ``drain`` spans' time over the ``call`` spans'
time in the telemetry pass (spans.py); None where no call drains."""
from .. import spans


def read(run):
    p = spans.of(run)
    if p is None:
        return None
    drain = sum(s.ns for s in p.spans if s.name == "drain")
    call = sum(s.ns for s in p.spans if s.name == "call")
    return 100.0 * drain / call if drain and call else None
