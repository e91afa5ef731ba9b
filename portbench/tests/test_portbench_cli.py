"""The command's refusals and the result line's shape."""
import json
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests.conftest import small

CMD = [sys.executable, "-m", "portbench.run", "--workload", "nsttf-flux",
       "--seed", "3000000001", "--seconds", "1", "--trace", "0"]


def _run(cwd):
    return subprocess.run(CMD, cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        return
    p = _run(run.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_refuses_without_the_program(tmp_path):
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_cpu_run_measures_nothing(bench, cpu):
    for trace in (False, True):
        res = run.run(bench, "minidish-stream", 9, 0.1, trace, cpu,
                      small(bench, "minidish-stream"))
        assert res["metrics"] and all(
            m["value"] == run.NOT_MEASURED for m in res["metrics"].values())
        assert res["device"]["platform"] == "cpu"
        assert res["device"]["memory_peak_bytes"] == run.NOT_MEASURED
        assert "busy_s" not in res["device"] and "breakdown" not in res


def test_result_line_shape(bench, cpu):
    res = json.loads(json.dumps(run.run(bench, "nsttf-flux", 2 ** 40 + 3,
                                        0.1, False, cpu,
                                        small(bench, "nsttf-flux"))))
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert isinstance(res["correct"], bool)
    assert res["attempted"] >= 1 and 0 <= res["failed"] <= res["attempted"]
    assert set(res["metrics"]) == {"field_rays_per_s", "setup_s"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}, name


def test_idle_gaps_are_named_by_the_launching_op():
    from portbench import profile
    dev = [(0, 10, "k1", 1), (5, 20, "k2", 2), (50, 60, "k3", 3),
           (65, 70, "k4", 4)]
    launch = {1: 0, 2: 1, 3: 40, 4: 62}
    ops = [(30, 45, "aten::nonzero"), (38, 42, "aten::where"),
           (61, 63, "aten::add")]
    busy, gaps = profile._idle_gaps(dev, launch, ops)
    assert busy == pytest.approx(35e-9)
    assert gaps == pytest.approx({"aten::where": 30e-9, "aten::add": 5e-9})
