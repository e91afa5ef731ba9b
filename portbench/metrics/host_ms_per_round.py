"""Round loop: the host's own work a round, from the program's spans in
the telemetry pass (spans.py): the mean over the pass's ``round`` spans
(K1, K2, K3 or oracle launches and their bookkeeping) of each span's time
less the ``sync`` spans inside it, in ms."""
from .. import spans


def read(run):
    p = spans.of(run)
    rounds = [] if p is None else spans.rounds(p.spans)
    if not rounds:
        return None
    waits = spans.sync_ns_under(p.spans)
    return 1e-6 * sum(s.ns - waits[s.id] for s in rounds) / len(rounds)
