"""Round loop: rounds a call, from the port's launch counters over the
window's calls."""


def read(run):
    rounds = sum(run.counters.values())
    return rounds / run.n_calls if rounds and run.n_calls else None
