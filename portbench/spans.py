"""The telemetry pass of a traced run: the program's own spans
(tracer_tpu_torch.telemetry), which the per-layer metrics
host_ms_per_round, sync_ms_per_round, live_lane_pct, drain_pct and
sync_idle_pct read.

The first of them that a run asks for builds the cell's study again (the
harness has freed its own by then), warms it up with one whole call, and
runs three times the traffic's ``profile_calls`` calls with the recorder on
(the pass: a single call of 0.3-0.6 s reads a host that wanders), in turns
with as many with it off (the recorder's cost, read in one process: the
window ran tens of seconds earlier), then ``profile_calls`` more under
torch.profiler with the recorder on (the slice). The window always runs with the recorder off.
``of(run)`` keeps the result on the run, so the readers share one pass.
It logs each kernel's round spans beside its launch counter, the pass's
call walls beside the window's mean, and the slice's device idle by the
program span open at the launch that ended each gap.

A program without the recorder (an older checkout), or a cell on several
cards (its ranks run only the harness's own calls), gets no pass: every
reader returns None and nothing is built.
"""
from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import sys
import time
import warnings

import numpy as np
import torch

from . import profile, system

ATTR = "telemetry_pass"


@dataclasses.dataclass
class Pass:
    spans: list             # the pass's spans (telemetry.Span)
    walls: list             # each recorded call's wall, seconds
    off_walls: list         # each unrecorded call's, in turns with them
    counters: dict          # launch-counter deltas over the pass
    slice_spans: list       # the profiled slice's spans
    # the slice's idle gaps: (start, end, host launch time of the device
    # event that ends it, or None), in ns of the spans' clock
    gaps: list


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def run_seed() -> int:
    """The run's ``--seed`` (the pass draws its calls from it), else 0."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_known_args(sys.argv[1:])[0].seed


def of(run):
    """The run's Pass, made on its first call; None without the program's
    recorder or on a cell of several cards."""
    if ATTR not in vars(run):
        setattr(run, ATTR, _make(run))
    return getattr(run, ATTR)


def _make(run):
    try:
        from tracer_tpu_torch import telemetry
    except ImportError:
        return None
    if run.cell.get("chips", 1) > 1:
        return None
    on_card = torch.cuda.is_available()
    device = (torch.device("cuda", torch.cuda.current_device()) if on_card
              else torch.device("cpu"))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)
    read = system.counters if on_card else (lambda: {})
    traffic, seed = run.traffic, run_seed()
    n = traffic["profile_calls"]
    if on_card:
        torch.cuda.empty_cache()
    study = system.build(run.config, traffic, device)
    warm = study.run(system.call_seed(seed, 4 * 10 ** 6))
    sync()
    del warm
    telemetry.collect()
    walls, off_walls = [], []
    counters = collections.Counter()
    try:
        # the recorded calls in turns with as many unrecorded ones (off,
        # on, on, off, ...): the recorder's cost, read in one process
        for k in range(3 * n):
            for on in ((False, True) if k % 2 == 0 else (True, False)):
                telemetry.enable(on)
                c0 = read()
                t = time.perf_counter()
                out = study.run(system.call_seed(seed, 5 * 10 ** 6 + k))
                sync()
                (walls if on else off_walls).append(time.perf_counter() - t)
                telemetry.enable(False)
                if on:
                    counters.update({c: v - c0[c] for c, v in read().items()})
                del out
    finally:
        telemetry.enable(False)
    spans = telemetry.collect()
    slice_spans, gaps = _profiled(study, telemetry, on_card, sync, [
        system.call_seed(seed, 6 * 10 ** 6 + k) for k in range(n)])
    del study
    if on_card:
        torch.cuda.empty_cache()
    p = Pass(spans, walls, off_walls, dict(counters), slice_spans, gaps)
    _report(run, p)
    return p


def _profiled(study, telemetry, on_card, sync, seeds):
    """(spans, idle gaps) of ``seeds``' calls under torch.profiler with
    the recorder on."""
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    sync()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        telemetry.enable()
        try:
            with torch.profiler.profile(activities=acts) as prof:
                outs = [study.run(s) for s in seeds]
                sync()
        finally:
            telemetry.enable(False)
        dev, launch, _ = profile._raw_events(prof)
    del outs
    return telemetry.collect(), gaps_of(dev, launch)


def gaps_of(dev, launch) -> list:
    """Each gap between the union of the device events' intervals: (its
    start, its end, the host launch time of the event that ends it)."""
    dev = sorted(dev)
    gaps = []
    if not dev:
        return gaps
    cur_e = dev[0][1]
    for s, e, _, corr in dev[1:]:
        if s > cur_e:
            gaps.append((cur_e, s, launch.get(corr)))
        cur_e = max(cur_e, e)
    return gaps


def rounds(spans) -> list:
    return [s for s in spans if s.name == "round"]


def sync_ns_under(spans) -> dict:
    """Each span's id -> the ns of the sync spans below it."""
    parent = {s.id: s.parent for s in spans}
    under = collections.Counter()
    for s in spans:
        if s.name == "sync":
            p = s.parent
            while p is not None:
                under[p] += s.ns
                p = parent.get(p)
    return under


class Intervals:
    """Spans' [start, end] intervals that do not overlap (one thread's
    spans of one name): ``holds(t)`` says whether one contains t."""

    def __init__(self, spans):
        iv = sorted((s.start, s.end) for s in spans)
        self.starts = [a for a, _ in iv]
        self.ends = [b for _, b in iv]

    def holds(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.ends[i]


def span_at(spans, t):
    """The innermost span open at ``t``, as its path of names below the
    call (a round with its kernel), or None."""
    if not spans:
        return None
    starts = np.array([s.start for s in spans])
    ends = np.array([s.end for s in spans])
    inside = np.nonzero((starts <= t) & (t <= ends))[0]
    if not len(inside):
        return None
    by_id = {s.id: s for s in spans}
    sp = spans[inside[np.argmax(starts[inside])]]
    path = []
    while sp is not None and sp.name != "call":
        path.append(sp.name + (f"({sp.attrs['kernel']})" if sp.name
                               == "round" else ""))
        sp = by_id.get(sp.parent)
    return "/".join(reversed(path)) or "call"


def idle_by_span(p: Pass) -> dict:
    """Seconds of the slice's device idle by the program span open at the
    launch that ends each gap."""
    out = collections.Counter()
    for a, b, t in p.gaps:
        name = ("no launch found" if t is None else
                span_at(p.slice_spans, t) or "outside the program's spans")
        out[name] += (b - a) * 1e-9
    return dict(out)


def _report(run, p: Pass) -> None:
    from .kernels import COUNTER
    kernels = collections.Counter(s.attrs.get("kernel")
                                  for s in rounds(p.spans))
    counter = dict(COUNTER, oracle="oracle_bounce")
    log("pass: round spans by kernel " + ", ".join(
        f"{k} {kernels.get(k, 0)} (launches {p.counters.get(c, 'n/a')})"
        for k, c in counter.items()))
    mean = run.window_s / run.n_calls if run.n_calls else float("nan")
    on, off = float(np.median(p.walls)), float(np.median(p.off_walls))
    log("pass: recorded call walls " + " ".join(
        f"{w:.4f}" for w in p.walls) + " s, unrecorded " + " ".join(
        f"{w:.4f}" for w in p.off_walls) + f" s: the recorder's cost "
        f"{on / off - 1.0:+.2%} (medians {on:.4f} and {off:.4f} s)")
    log(f"pass: recorded median {on:.4f} against the "
        f"window's mean {mean:.4f} s (recorder on/off "
        f"{on / mean - 1.0:+.2%})")
    calls = max(len([s for s in p.slice_spans if s.name == "call"]), 1)
    idle = sorted(idle_by_span(p).items(), key=lambda kv: -kv[1])
    log("idle by program span, ms a call: " + ", ".join(
        f"{k} {1e3 * v / calls:.2f}" for k, v in idle))
