"""``correct`` holds sound runs, and fails the control (the reference in
bfloat16 in the program's place) and the timed path broken underneath: a
trace that returns its state unchanged, half of each call's rays left
out, and an answer altered where it is produced (the receiver's energy
reported as escaped)."""
import dataclasses
import json

import pytest
import torch
from tracer_tpu_torch import parallel

from portbench import check, control, run, system
from portbench.tests.conftest import small

CELLS = ("nsttf-flux", "minidish-stream", "minidish-bundle")


def _unchanged(out):
    zero = torch.zeros_like
    return dict(out, absorbed=zero(out["absorbed"]),
                escaped=zero(out["escaped"]), lost=zero(out["lost"]),
                flux=None if out["flux"] is None else zero(out["flux"]))


def _receiver_to_escaped(study):
    rec = study.meta.names.index("receiver")
    rows = torch.as_tensor(study.meta.row_logical == rec)

    def alter(out):
        moved = out["absorbed"][rows].sum()
        return dict(out, absorbed=torch.where(rows, 0.0, out["absorbed"]),
                    escaped=out["escaped"] + moved)
    return alter


def _broken_build(monkeypatch, fault):
    real = system.build

    def build(cfg, traffic, device):
        if fault == "half":
            traffic = dict(traffic)
            if traffic["entry"] == "trace_fused":
                traffic["rays"] //= 2
            else:
                traffic["slabs_per_call"] //= 2
        study = real(cfg, traffic, device)
        alter = (_unchanged if fault == "unchanged"
                 else _receiver_to_escaped(study) if fault == "altered"
                 else None)
        if alter is not None:
            run_ = study.run
            study.run = lambda seed, **kw: alter(run_(seed, **kw))
        return study
    monkeypatch.setattr(system, "build", build)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(bench, cpu, cell):
    for seed in (1, 2 ** 31 + 17):
        res = run.run(bench, cell, seed, 0.1, False, cpu, small(bench, cell))
        assert res["correct"] and res["failed"] == 0, res["checks"]


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
@pytest.mark.parametrize("cell", CELLS)
def test_broken_path_is_not_correct(bench, cpu, monkeypatch, cell, fault):
    _broken_build(monkeypatch, fault)
    res = run.run(bench, cell, 4, 0.1, False, cpu, small(bench, cell))
    assert not res["correct"] and res["failed"] == res["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(bench, cpu, cell):
    for seed in (1, 2):
        numbers = control.readings(bench, cell, seed, cpu,
                                   small(bench, cell))
        limits = check.limits_for(cell)
        assert any(numbers[k] > limits[k] for k in numbers), numbers


def _sharded(bench, tree):
    """The four-card field cell (its traffic and limits are in the tree;
    its runs on four cards spread too widely for a bound yet, PERF.md §7)
    as two gloo ranks on the CPU, in the copied tree, which the spawned
    rank reads its files from."""
    bench["workloads"].append({"name": "nsttf-flux-4chip", "config": "nsttf",
                               "traffic": "culled_flux_4", "chips": 2,
                               "why": "the sharded field study"})
    (tree / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = run.load_json("portbench/traffic/culled_flux_4.json")
    return dict(slab=2 * 3072, slabs_per_call=2, warmup_slabs=1,
                check=dict(traffic["check"], reference_rays=200_000))


@pytest.mark.parametrize("fault", (None, "exchange", "unchanged", "half",
                                   "altered"))
def test_sharded_cell(bench, cpu, tree, monkeypatch, fault):
    small_traffic = _sharded(bench, tree)
    if fault == "exchange":
        # rank 0 joins the all-reduce but keeps its own share
        real = parallel.reduce_results

        def keep_own(accum, emitted, source_e, group=None):
            copy = dataclasses.replace(
                accum, **{f.name: (tuple(h.clone() for h in v)
                                   if f.name == "flux" else v.clone())
                          for f in dataclasses.fields(accum)
                          for v in (getattr(accum, f.name),)})
            real(copy, emitted.clone(), source_e.clone(), group=group)
            return accum, emitted, source_e
        monkeypatch.setattr(parallel, "reduce_results", keep_own)
    elif fault:
        _broken_build(monkeypatch, fault)
    res = run.run(bench, "nsttf-flux-4chip", 6, 0.1, False, cpu,
                  small_traffic)
    assert res["correct"] is (fault is None), res["checks"]
