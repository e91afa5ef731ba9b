"""Spans of the program's layers, recorded in memory; off by default.

    from tracer_tpu_torch import telemetry
    telemetry.enable()
    accum, emitted, source_e = trace_streaming(...)
    spans = telemetry.collect()          # the spans since, then cleared
    telemetry.enable(False)

A span is a named interval of the host's clock, ``time.time_ns()``: on
Linux the clock of torch.profiler's host events, so a span can be laid
over a profiled trace. It has an id, its parent's id (the span open
around it on the same thread), the id of the entry call it belongs to,
and a few attributes. The names, each at one layer's boundary:

    call     an entry: trace_streaming, trace_fused, trace_sharded,
             trace_streaming_sharded (entry, rays; rank on the sharded
             ones); an entry called inside another opens no second call
    draw     a source draw: sources.solar_disk_bundle, buie_sunshape, the
             general streaming path's draw each round (rays)
    round    one kernel launch of a round loop and its bookkeeping: K1 or
             K2 in the streaming loops and their drains, K3 (or K2, or
             the oracle) a bounce (kernel: k1, k2, k3, oracle; lanes
             launched; live: lanes that carry energy into the launch,
             unparked ones for K1)
    launch   the kernel wrapper's call inside a round (the host's enqueue)
    shade    the shade after K3 or the oracle (kernel: True for the K3
             epilogue, which also accounts and bins, False for the plain
             shade)
    account  the per-surface accounting, the flux map and the selects
             after the kernel; on the K3 epilogue's path, the sum of its
             blocks' partial sums once a call
    sync     a read of the device by ``read``: the host waits for the
             queue to drain
    drain    a streaming trace's drain of its survivors (chunks)
    reduce   parallel.reduce_results' all-reduce (rank)
    build.*  compile_scene (build.compile_scene) and the culling build's
             phases (build.geometry, build.pilot_balance,
             build.reach_precompute, build.cell_lists, build.layout)

Off, ``span``, ``call``, ``read`` and ``count`` test one module flag: a
span is one shared no-op context, with no clock read, no allocation, no
device operation and no wait. The round loops read the device only
through ``read`` and ``count`` (their live lanes: a flag off, the count
on, in the flag's place), which on wrap the read in a ``sync`` span. A
count that only the device holds (K1's live lanes, each tile's counts)
stays on its span until ``collect`` sums and reads it, so the loop adds
no device operation and waits for nothing more.
"""
from __future__ import annotations

import functools
import itertools
import threading
import time

import torch

_on = False
_ids = itertools.count(1)
_done = []                      # finished spans, every thread's
_local = threading.local()      # each thread's stack of open spans


class Span:
    """One span; entered, it opens on this thread's stack, and left, it
    closes and joins the finished spans."""
    __slots__ = ("name", "id", "parent", "call", "start", "end", "attrs")

    def __init__(self, name: str, id: int, parent, call, start: int,
                 end: int, attrs: dict):
        self.name, self.id, self.attrs = name, id, attrs
        self.parent = parent        # the span open around it, or None
        self.call = call            # its entry call's id, or None
        self.start, self.end = start, end   # time.time_ns() in and out

    @property
    def ns(self) -> int:
        return self.end - self.start

    def __enter__(self):
        stack = _stack()
        if stack:
            top = stack[-1]
            self.parent, self.call = top.id, top.call
        if self.name == "call":
            self.call = self.id
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end = time.time_ns()
        _local.stack.pop()
        _done.append(self)
        return False

    def set(self, **attrs) -> None:
        """Attributes known only inside the span (a count left on the
        device stays there until ``collect``)."""
        self.attrs.update(attrs)


def enable(on: bool = True) -> None:
    """Turn the recorder on (or off with ``on=False``)."""
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def _stack() -> list:
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class _Noop:
    """The context every span is while the recorder is off."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NOOP = _Noop()


def _open(name: str, attrs: dict) -> Span:
    return Span(name, next(_ids), None, None, 0, 0, attrs)


def span(name: str, kernel=None, lanes=None, live=None, rays=None,
         chunks=None, rank=None):
    """A context that records the span ``name`` while the recorder is on,
    with the attributes given (None: left out)."""
    if not _on:
        return _NOOP
    attrs = {}
    if kernel is not None:
        attrs["kernel"] = kernel
    if lanes is not None:
        attrs["lanes"] = lanes
    if live is not None:
        attrs["live"] = live
    if rays is not None:
        attrs["rays"] = rays
    if chunks is not None:
        attrs["chunks"] = chunks
    if rank is not None:
        attrs["rank"] = rank
    return _open(name, attrs)


def call(entry: str, rays: int, rank=None):
    """The ``call`` span of the entry point ``entry``: a no-op inside
    another call, whose spans then hold the inner entry's."""
    if not _on or any(s.name == "call" for s in _stack()):
        return _NOOP
    attrs = {"entry": entry, "rays": int(rays)}
    if rank is not None:
        attrs["rank"] = rank
    return _open("call", attrs)


def draws(source):
    """Decorator of a source ``source(generator, num_rays, ...)``: each
    call is a ``draw`` span with its rays, unless a draw is open around
    it."""
    @functools.wraps(source)
    def drawn(generator, num_rays, *args, **kwargs):
        if not _on or any(s.name == "draw" for s in _stack()[-1:]):
            return source(generator, num_rays, *args, **kwargs)
        with _open("draw", {"rays": int(num_rays)}):
            return source(generator, num_rays, *args, **kwargs)
    return drawn


def read(x):
    """``x.tolist()``: a 0-d tensor's bool or int, or a list, read from
    its device; with the recorder on, inside a ``sync`` span."""
    if not _on:
        return x.tolist()
    with _open("sync", {}):
        return x.tolist()


def count(mask):
    """The round loops' read of their live lanes (a bool tensor): off,
    whether any is set (``any``, cheaper on the device than a count);
    on, how many are, inside a ``sync`` span."""
    if not _on:
        return mask.any().tolist()
    with _open("sync", {}):
        return mask.sum().tolist()


def collect() -> list:
    """The spans finished since the last collect, in the order they
    closed, and clear them. A count left on the device among the
    attributes (a tensor, or a tuple of tensors, whose elements sum to
    it) becomes an int: one read a device."""
    out = _done[:]
    del _done[:len(out)]
    pending = {}
    for sp in out:
        for k, v in sp.attrs.items():
            parts = v if isinstance(v, tuple) else (v,)
            if isinstance(parts[0], torch.Tensor):
                pending.setdefault(parts[0].device, []).append(
                    (sp, k, parts))
    for items in pending.values():
        values = torch.stack([sum(p.sum(dtype=torch.int64) for p in parts)
                              for _, _, parts in items]).tolist()
        for (sp, k, _), v in zip(items, values):
            sp.attrs[k] = v
    return out
