"""Round loop: the host blocked on the card, a round: every ``sync`` span
inside a ``call`` in the telemetry pass (spans.py) (the round loops' flag
reads, the drains' checks), over the pass's ``round`` spans, in ms."""
from .. import spans


def read(run):
    p = spans.of(run)
    rounds = [] if p is None else spans.rounds(p.spans)
    if not rounds:
        return None
    wait = sum(s.ns for s in p.spans
               if s.name == "sync" and s.call is not None)
    return 1e-6 * wait / len(rounds)
