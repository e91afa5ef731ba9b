"""Device: the share of a call's wall in which no device event ran: the
profiled slice's device-busy time a call (the union of its device events'
intervals) over the window's wall a call. The window runs without the
profiler, whose host cost would stretch the wall and read idle that is
not there."""


def read(run):
    sl = run.slice
    if sl is None or not run.slice_calls or not run.n_calls:
        return None
    busy = sl.busy_s / len(run.slice_calls)
    return 100.0 * (1.0 - busy / (run.window_s / run.n_calls))
