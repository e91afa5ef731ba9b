"""The traced slice: a few whole calls under torch.profiler, read from the
profiler's raw device and host events (no event tree is built, so the
reading takes seconds, not minutes).

``Slice`` holds the slice's wall, the device-busy time (the union of the
device events' intervals), each device operation's total time and the
idle gaps between busy intervals, each named by the host operation that
launched the work the device waited for.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import time
import warnings

import torch


@dataclasses.dataclass
class Slice:
    wall_s: float
    busy_s: float
    device_ops: dict        # name -> seconds
    idle_gaps: dict         # host activity -> seconds of device idle
    calls: list             # the slice's call outputs
    counters: dict          # launch-counter deltas over the slice


def _raw_events(prof):
    """(device events as (start_ns, end_ns, name, correlation id), the
    host's CUDA API calls' start by correlation id, the host's aten
    operations as (start_ns, end_ns, name))."""
    from torch.autograd import DeviceType
    dev, launch, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        name = e.name()
        if e.device_type() == DeviceType.CUDA:
            dev.append((start, end, name, e.correlation_id()))
        elif name.startswith("cu"):
            launch[e.correlation_id()] = start
        elif name.startswith("aten::"):
            ops.append((start, end, name))
    return dev, launch, ops


def _idle_gaps(dev, launch, ops):
    """(busy seconds, seconds of device idle by host operation): the union
    of the device events' intervals, and each gap between them named by
    the innermost aten operation around the launch of the event that ends
    the gap (what the host was doing while the device waited)."""
    dev = sorted(dev)
    ops = sorted(ops)
    starts = [o[0] for o in ops]
    busy, gaps = 0, collections.Counter()
    cur_s, cur_e = dev[0][0], dev[0][1]
    for s, e, _, corr in dev[1:]:
        if s <= cur_e:
            cur_e = max(cur_e, e)
            continue
        busy += cur_e - cur_s
        gaps[_op_at(launch.get(corr), ops, starts)] += (s - cur_e) * 1e-9
        cur_s, cur_e = s, e
    busy += cur_e - cur_s
    return busy * 1e-9, gaps


def _op_at(t, ops, starts, depth: int = 64):
    if t is None:
        return "no launch found"
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - depth, -1), -1):
        if ops[j][1] >= t:
            return ops[j][2]
    return "host (no aten op)"


def profile_calls(study, seeds, read_counters) -> Slice:
    """Run ``seeds``' calls back to back under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    c0 = read_counters()
    with warnings.catch_warnings():
        # the profiler warns that it keeps one cycle's events: one is run
        warnings.simplefilter("ignore", UserWarning)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            calls = [study.run(s) for s in seeds]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev, launch, ops = _raw_events(prof)
    c1 = read_counters()
    dev_ops = collections.Counter()
    for start, end, name, _ in dev:
        dev_ops[name] += (end - start) * 1e-9
    busy, gaps = _idle_gaps(dev, launch, ops) if dev else (0.0, {})
    return Slice(wall, busy, dict(dev_ops), dict(gaps), calls,
                 {k: c1[k] - c0[k] for k in c0})


def breakdown(sl: Slice, top: int = 10) -> dict:
    return {"device_ops": [[k, v] for k, v in sorted(
                sl.device_ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[k, v] for k, v in sorted(
                sl.idle_gaps.items(), key=lambda kv: -kv[1])[:top]]}
