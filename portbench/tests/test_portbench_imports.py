"""Nothing the harness loads is jax, jaxlib, flax or tracer_tpu (top-level
names compared whole), and the reference loads no part of the program."""
import ast
import subprocess
import sys
from pathlib import Path

from portbench import run

PB = Path(run.__file__).parent


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout
    return set(out.split())


def test_a_cpu_run_loads_no_jax():
    tops = _loaded(
        "import sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests.conftest import small\n"
        "bench = run.load_json('BENCHMARK.json')\n"
        "for cell in ('nsttf-flux', 'minidish-bundle'):\n"
        "    run.run(bench, cell, 3, 0.1, True, torch.device('cpu'),\n"
        "            small(bench, cell))\n"
        "print(' '.join(m.split('.')[0] for m in sys.modules))\n")
    assert "tracer_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "tracer_tpu"}


def test_the_reference_loads_no_part_of_the_program():
    tops = _loaded(
        "import sys\n"
        "from portbench.reference import scene, trace\n"
        "for name in ('nsttf', 'minidish'):\n"
        "    s = scene.build(scene.load_config(name))\n"
        "    trace.trace(s, 2000, 1, max_hits=8, min_energy=1e-6,\n"
        "                e_ray=1.0, flux_bins=50, coarse=10)\n"
        "print(' '.join(m.split('.')[0] for m in sys.modules))\n")
    assert not tops & {"jax", "jaxlib", "flax", "tracer_tpu",
                       "tracer_tpu_torch"}


def test_no_source_file_imports_jax():
    for path in PB.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            tops = {n.split(".")[0] for n in names}
            assert not tops & {"jax", "jaxlib", "flax", "tracer_tpu"}, path
            if path.parent.name == "reference":
                assert "tracer_tpu_torch" not in tops, path
