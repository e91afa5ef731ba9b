"""The telemetry pass (spans.py) and the readers of the program's spans:
each reader on a hand-built span list and gap list with a known answer,
the pass on the CPU at a tiny size, and the harness on a program without
the recorder (an older checkout): the run stays correct, every metric is
printed, and the new readers return None."""
import sys

import pytest

from portbench import run, spans
from portbench.metrics import (drain_pct, host_ms_per_round, live_lane_pct,
                               sync_idle_pct, sync_ms_per_round)
from portbench.tests.conftest import small
from tracer_tpu_torch.telemetry import Span

READERS = (host_ms_per_round, sync_ms_per_round, live_lane_pct, drain_pct,
           sync_idle_pct)
MS = 10 ** 6


def _data(bench, cell, traffic=None):
    c = run.cell_of(bench, cell)
    cfg = run.load_json(f"portbench/configs/{c['config']}.json")
    traffic = traffic or run.load_json(f"portbench/traffic/{c['traffic']}"
                                       ".json")
    return run.RunData(c, cfg, traffic, None, None, 0.0, 2.0, 4, {}, None)


def _hand_pass():
    """One call of 100 ms: two K1 rounds (10 ms with a 2 ms sync, 20 ms
    with none), a sync of 4 ms between them, and a 30 ms drain holding a
    K2 round of 6 ms with a 1 ms sync; 8 ms of syncs in all. The slice:
    idle gaps of 3 ms opening in a sync, 5 ms opening elsewhere in the
    call, and 7 ms outside it."""
    def sp(name, i, parent, start, end, **attrs):
        return Span(name, i, parent, 1, start * MS, end * MS, attrs)
    pass_spans = [
        sp("call", 1, None, 0, 100, entry="trace_streaming", rays=10),
        sp("round", 2, 1, 5, 15, kernel="k1", lanes=100, live=40),
        sp("sync", 3, 2, 6, 8),
        sp("sync", 4, 1, 16, 20),
        sp("round", 5, 1, 20, 40, kernel="k1", lanes=100, live=60),
        sp("drain", 6, 1, 50, 80, chunks=1),
        sp("sync", 7, 6, 51, 52),
        sp("round", 8, 6, 52, 58, kernel="k2", lanes=100, live=50),
        sp("launch", 9, 8, 53, 54),
    ]
    gaps = [(7 * MS, 10 * MS, 14 * MS), (30 * MS, 35 * MS, 53.5 * MS),
            (120 * MS, 127 * MS, None)]
    return spans.Pass(pass_spans, [0.1], [0.1], {}, pass_spans, gaps)


def test_readers_on_hand_built_spans(bench):
    data = _data(bench, "nsttf-flux")
    setattr(data, spans.ATTR, _hand_pass())
    # (10 - 2) + 20 + 6: the rounds' own time less their syncs
    assert host_ms_per_round.read(data) == pytest.approx(34 / 3)
    assert sync_ms_per_round.read(data) == pytest.approx((2 + 4 + 1) / 3)
    assert live_lane_pct.read(data) == pytest.approx(150 / 3)
    assert drain_pct.read(data) == pytest.approx(30.0)
    # 3 ms of the 8 ms that open inside the call open in a sync
    assert sync_idle_pct.read(data) == pytest.approx(100 * 3 / 8)
    assert spans.idle_by_span(getattr(data, spans.ATTR)) == pytest.approx(
        {"round(k1)": 3e-3, "drain/round(k2)/launch": 5e-3,
         "no launch found": 7e-3})


def test_readers_find_nothing_to_read(bench):
    data = _data(bench, "minidish-bundle")
    setattr(data, spans.ATTR, spans.Pass([], [], [], {}, [], []))
    assert all(r.read(data) is None for r in READERS)
    setattr(data, spans.ATTR, None)
    assert all(r.read(data) is None for r in READERS)


def test_gaps_are_kept_one_by_one():
    dev = [(0, 10, "a", 1), (5, 20, "b", 2), (50, 60, "c", 3),
           (65, 70, "d", 4)]
    assert spans.gaps_of(dev, {1: 0, 3: 40}) == [(20, 50, 40),
                                                 (60, 65, None)]
    assert spans.gaps_of([], {}) == []


def test_the_pass_on_the_cpu(bench, cpu):
    traffic = dict(run.load_json("portbench/traffic/stream.json"),
                   **small(bench, "minidish-stream"))
    data = _data(bench, "minidish-stream", traffic)
    p = spans.of(data)
    assert spans.of(data) is p
    assert len(p.walls) == len(p.off_walls) == 3 * traffic["profile_calls"]
    assert [s.attrs["entry"] for s in p.spans if s.name == "call"] == [
        "trace_streaming"] * len(p.walls)
    for reader in READERS[:-1]:
        assert reader.read(data) > 0.0
    assert live_lane_pct.read(data) <= 100.0
    # the CPU's profiler records no device events: no idle to name
    assert p.gaps == [] and sync_idle_pct.read(data) is None


def test_a_program_without_the_recorder(bench, cpu, monkeypatch):
    import tracer_tpu_torch
    monkeypatch.delattr(tracer_tpu_torch, "telemetry")
    monkeypatch.setitem(sys.modules, "tracer_tpu_torch.telemetry", None)
    with pytest.raises(ImportError):
        from tracer_tpu_torch import telemetry  # noqa: F401
    data = _data(bench, "minidish-stream")
    assert all(r.read(data) is None for r in READERS)
    res = run.run(bench, "minidish-stream", 2 ** 33 + 5, 0.1, True, cpu,
                  small(bench, "minidish-stream"))
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"] for m in run.metrics_for(
        bench, "minidish-stream", "per_layer")}
