"""The span recorder (tracer_tpu_torch.telemetry) on the CPU, at tiny
sizes:

* off, it records nothing; on, a call's outputs are bit for bit those of
  the same call off, on the culled trace (K1, the drain on K2), the
  plain megakernel (K2) and trace_fused (K3);
* each kernel's ``round`` spans equal the calls of its wrapper (on the
  card, its ``.launches`` delta: tests/test_torch_gpu.py), every ``sync``
  lies inside a round, drain or call, ``live`` <= ``lanes``, and each
  path's syncs equal the reads its loop code makes, counted from the
  loop's structure;
* two gloo ranks of trace_streaming_sharded each record a ``reduce`` span
  inside their own call; the culling build's phases and compile_scene
  are ``build.*`` spans; threads recording at once keep their own stacks.
"""
import collections
import datetime
import sys
import threading

import pytest
import torch
import torch.distributed as dist

from tracer_tpu_torch import engine, parallel, telemetry
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.engine import trace_fused, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.models.bench_configs import bench_scene
from test_torch_gpu import k1_scene

torch.set_num_threads(1)

SLAB = 2 * kb.TILE
MAX_PATH = 20
MAX_BOUNCES = 50


def _spec_only(spec, slab):
    def source_fn(generator, device=None):
        raise AssertionError("the culled trace draws in K1")
    source_fn.pallas_spec, source_fn.num_rays = spec, slab
    return source_fn


def _culled():
    table, _, culling, spec = k1_scene("aureole", 40, SLAB, "cpu")
    return lambda: trace_streaming(
        table, _spec_only(spec, SLAB), torch.Generator().manual_seed(1),
        2 * SLAB, culling=culling, max_rounds=300, max_path=8)


def _megakernel():
    table, _, source_fn = bench_scene(1, SLAB, "cpu")
    return lambda: trace_streaming(
        table, source_fn, torch.Generator().manual_seed(1), 3 * SLAB,
        max_rounds=300, max_path=MAX_PATH)


def _fused():
    table, _, source_fn = bench_scene(1, 4096, "cpu")

    def run():
        gen = torch.Generator().manual_seed(3)
        final, accum = trace_fused(table, source_fn(gen, device="cpu"),
                                   generator=gen, max_bounces=MAX_BOUNCES)
        return accum, final.energy
    return run


PATHS = {"culled": _culled, "megakernel": _megakernel, "fused": _fused}
# each path's kernel wrappers, by the name its round spans give
WRAPPERS = {"k1": (engine, "bounce_reflect_culled"),
            "k2": (engine, "bounce_reflect"), "k3": (kn, "nearest_hit")}


def _tensors(out):
    """Every tensor of a call's outputs, in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    if isinstance(out, engine.TraceAccum):
        return [t for f in engine.dataclasses.fields(out)
                for t in _tensors(getattr(out, f.name))]
    return []


@pytest.fixture(scope="module")
def runs():
    """Each path run with the recorder off and then on, its kernel
    wrappers counting their calls: (outputs off, outputs on, spans, calls
    of each wrapper while on)."""
    mp = pytest.MonkeyPatch()
    calls = collections.Counter()
    for k, (mod, name) in WRAPPERS.items():
        def counted(*a, _fn=getattr(mod, name), _k=k, **kw):
            calls[_k] += 1
            return _fn(*a, **kw)
        mp.setattr(mod, name, counted)
    out = {}
    try:
        for path, make in PATHS.items():
            run = make()
            telemetry.enable(False)
            off = run()
            assert telemetry.collect() == []
            calls.clear()
            telemetry.enable()
            on = run()
            telemetry.enable(False)
            out[path] = (off, on, telemetry.collect(), dict(calls))
    finally:
        telemetry.enable(False)
        mp.undo()
    return out


def test_off_records_nothing():
    telemetry.enable(False)
    assert telemetry.span("round", kernel="k1") is telemetry.span("sync")
    with telemetry.call("trace_fused", 4):
        pass
    assert telemetry.read(torch.tensor(3)) == 3
    assert telemetry.count(torch.tensor([False, True, True])) is True
    _fused()()
    assert telemetry.collect() == []


@pytest.mark.parametrize("path", PATHS)
def test_outputs_bit_for_bit_with_the_recorder_on(runs, path):
    off, on, spans, _ = runs[path]
    a, b = _tensors(off), _tensors(on)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert [s.attrs["entry"] for s in spans if s.name == "call"] == [
        "trace_fused" if path == "fused" else "trace_streaming"]


@pytest.mark.parametrize("path", PATHS)
def test_round_spans_equal_kernel_calls(runs, path):
    _, _, spans, calls = runs[path]
    rounds = collections.Counter(s.attrs["kernel"] for s in spans
                                 if s.name == "round")
    assert rounds == collections.Counter(calls) and rounds
    call_id = next(s.id for s in spans if s.name == "call")
    assert all(s.call == call_id for s in spans if s.name != "draw")
    for s in spans:
        if s.name == "round":
            assert 0 < s.attrs["live"] <= s.attrs["lanes"]
            assert isinstance(s.attrs["live"], int)


@pytest.mark.parametrize("path", PATHS)
def test_syncs_nest_and_equal_the_loops_reads(runs, path):
    _, _, spans, _ = runs[path]
    by_id = {s.id: s for s in spans}
    syncs = [s for s in spans if s.name == "sync"]
    for s in syncs:
        parent = by_id[s.parent]
        assert parent.name in ("round", "drain", "call")
        assert parent.start <= s.start <= s.end <= parent.end
    drains = [s for s in spans if s.name == "drain"]

    def rounds(under=None, kernel=None):
        return sum(1 for s in spans if s.name == "round"
                   and (kernel is None or s.attrs["kernel"] == kernel)
                   and (under is None or s.parent == under.id))
    if path == "fused":
        # one read a bounce, and the one that finds the bundle dead
        expected = rounds() + 1
    elif path == "megakernel":
        # one read an emission round; in the drain one a chunk and the
        # last, and one before each of a chunk's rounds and the one that
        # finds it dead (its rays die inside the round budget)
        (drain,) = drains
        chunks = drain.attrs["chunks"]
        expected = (rounds(kernel="k2") - rounds(drain)
                    + chunks + 1 + rounds(drain) + chunks)
    else:
        # each emit -> drain cycle: the loop's test, one read before each
        # K1 round and the one that stops it, then the drain of the whole
        # slab (one chunk): a read before each round and the one that
        # finds it dead; and the loop's last test
        expected = 1 + sum(1 + 1 + rounds(d) + 1 for d in drains) + \
            rounds(kernel="k1")
        assert all(d.attrs["chunks"] == 1 for d in drains)
    assert len(syncs) == expected


def test_build_phases_are_spans():
    telemetry.enable()
    try:
        table, _, culling, _ = k1_scene("flat", 12, SLAB, "cpu")
    finally:
        telemetry.enable(False)
    names = [s.name for s in telemetry.collect()]
    assert names.count("build.compile_scene") == 1
    for phase in ("geometry", "pilot_balance", "reach_precompute",
                  "cell_lists", "layout"):
        assert names.count("build." + phase) == 1
    assert "t_phase" not in culling.stats
    assert {"L_mean", "L_max", "mesh_n_seg"} <= set(culling.stats)


def test_spans_nest_by_thread_and_group_by_call():
    telemetry.enable()
    try:
        with telemetry.call("trace_fused", 8) as outer:
            with telemetry.call("trace_streaming", 8):
                with telemetry.span("round", kernel="k3", lanes=8,
                                    live=torch.tensor(5)):
                    assert telemetry.read(torch.tensor([1, 2])) == [1, 2]
            assert telemetry.count(torch.tensor([False, True, True])) == 2
            outer.set(rank=0)
        with telemetry.span("draw", rays=4):
            pass
    finally:
        telemetry.enable(False)
    read, rnd, count, call, draw = telemetry.collect()
    assert [s.name for s in (read, rnd, count, call, draw)] == [
        "sync", "round", "sync", "call", "draw"]
    assert call.attrs == {"entry": "trace_fused", "rays": 8, "rank": 0}
    assert rnd.attrs["live"] == 5
    assert read.parent == rnd.id and rnd.parent == count.parent == call.id
    assert read.call == rnd.call == count.call == call.id == call.call
    assert draw.call is None and draw.parent is None
    assert telemetry.collect() == []


def test_two_gloo_ranks_each_record_a_reduce():
    table, _, source_fn = bench_scene(1, kb.TILE, "cpu")
    store, errors = dist.HashStore(), []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(store, r, 2,
                                       datetime.timedelta(seconds=60))
            parallel.trace_streaming_sharded(table, source_fn, 7,
                                             2 * kb.TILE, group=pg,
                                             max_path=MAX_PATH)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
    telemetry.enable()
    try:
        threads = [threading.Thread(target=rank, args=(r,))
                   for r in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        telemetry.enable(False)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    spans = telemetry.collect()
    calls = {s.id: s for s in spans if s.name == "call"}
    assert sorted(c.attrs["rank"] for c in calls.values()) == [0, 1]
    assert {c.attrs["entry"] for c in calls.values()} == {
        "trace_streaming_sharded"}
    reduces = [s for s in spans if s.name == "reduce"]
    assert sorted(s.attrs["rank"] for s in reduces) == [0, 1]
    for s in reduces:
        assert calls[s.call].attrs["rank"] == s.attrs["rank"]
        assert s.parent == s.call
    # each rank's rounds belong to its own call
    for s in spans:
        if s.name == "round":
            assert s.call in calls


def test_threads_keep_their_own_stacks():
    """More recording threads than cores, switching often: each span's
    parent is its own thread's, and no span is lost or shares an id."""
    n_threads, n = 16, 200
    errors = []

    def work(r):
        try:
            for _ in range(n):
                with telemetry.call("trace_fused", 1, rank=r):
                    with telemetry.span("round", rank=r):
                        pass
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    telemetry.enable()
    try:
        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        telemetry.enable(False)
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    spans = telemetry.collect()
    assert len(spans) == 2 * n_threads * n
    assert len({s.id for s in spans}) == len(spans)
    by_id = {s.id: s for s in spans}
    for s in spans:
        if s.name == "round":
            call = by_id[s.parent]
            assert call.name == "call" and s.call == call.id
            assert call.attrs["rank"] == s.attrs["rank"]
        else:
            assert s.parent is None and s.call == s.id
