"""Each cell once, briefly, on the card: python -m pytest portbench -m
cuda (skips without a CUDA card)."""
import json
import subprocess
import sys

import pytest

from portbench import run

CELLS = [c["name"] for c in run.load_json("BENCHMARK.json")["workloads"]]
CHIPS = {c["name"]: c["chips"]
         for c in run.load_json("BENCHMARK.json")["workloads"]}


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs the cells on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(card, cell):
    import torch
    if torch.cuda.device_count() < CHIPS[cell]:
        pytest.skip(f"{cell} needs {CHIPS[cell]} cards")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        cell, "--seed", "3141592653", "--seconds", "2",
                        "--trace", "0"], cwd=run.ROOT, capture_output=True,
                       text=True, timeout=1500)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert all(isinstance(m["value"], float)
               for m in res["metrics"].values())
