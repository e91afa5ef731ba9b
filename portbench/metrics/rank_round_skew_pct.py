"""Sharded layer: in each call of the window, the most rounds any rank ran
over the ranks' mean, less 1, from each rank's launch counters; the mean
over the calls, in percent."""


def read(run):
    calls = [r for r in run.rank_rounds if len(r) > 1 and sum(r)]
    if not calls:
        return None
    return 100.0 * sum(max(r) * len(r) / sum(r) - 1.0
                       for r in calls) / len(calls)
