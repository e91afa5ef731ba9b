import json
import shutil

import pytest
import torch

from portbench import run
from portbench.reference import scene as ref_scene

# tiny versions of each cell's traffic that the CPU traces in seconds (the
# port's kernels run their plain PyTorch versions off the card)
SMALL = {"nsttf-flux": dict(slab=2 * 3072, slabs_per_call=2, warmup_slabs=1),
         "minidish-stream": dict(slab=2 * 3072, slabs_per_call=4,
                                 warmup_slabs=1),
         "minidish-bundle": dict(rays=40_000)}
REFERENCE_RAYS = 200_000


def small(bench, cell):
    traffic = run.load_json(
        f"portbench/traffic/{run.cell_of(bench, cell)['traffic']}.json")
    return dict(SMALL[cell], check=dict(traffic["check"],
                                        reference_rays=REFERENCE_RAYS))


@pytest.fixture
def bench():
    return run.load_json("BENCHMARK.json")


@pytest.fixture
def cpu():
    return torch.device("cpu")


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A copy of BENCHMARK.json and portbench/ that the harness reads
    instead of the repository's, so a test can add files to it."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(run.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(run, "ROOT", tmp_path)
    monkeypatch.setattr(ref_scene, "ROOT", tmp_path / "portbench")
    return tmp_path


def write_json(path, obj):
    path.write_text(json.dumps(obj, indent=1))
