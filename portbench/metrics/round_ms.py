"""Round loop: the window's wall over its rounds (K1, K2 and oracle drain
launches on the streaming paths, K3 launches in trace_fused)."""


def read(run):
    rounds = sum(run.counters.values())
    return 1e3 * run.window_s / rounds if rounds else None
