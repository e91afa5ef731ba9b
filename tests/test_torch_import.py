"""The PyTorch port imports without jax, and none of its files imports jax
or the JAX package."""
import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "tracer_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts)
    for p in PKG.rglob("*.py"))
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|tracer_tpu)\b", re.M)


def test_imports_with_jax_blocked():
    code = ("import sys\nsys.modules['jax'] = None\n"
            "sys.modules['tracer_tpu'] = None\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n"
                      for m in MODULES)
            + "assert 'jax' not in {k.split('.')[0] for k, v in "
            "sys.modules.items() if v is not None}\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]


@pytest.mark.parametrize("module", MODULES)
def test_no_jax_import_in_source(module):
    path = PKG.parent.joinpath(*module.split(".")).with_suffix(".py")
    assert not _FORBIDDEN.search(path.read_text()), module


def test_kernel_sources_are_package_data():
    for name in ("bounce.cu", "nearest.cu"):
        assert (PKG / "kernels" / "csrc" / name).is_file()
    assert (PKG / "data" / "sandia_nsttf_field.npz").is_file()


def test_no_file_of_the_jax_package_is_read():
    """No port module names the JAX package's folder in a path."""
    for p in PKG.rglob("*.py"):
        assert '"tracer_tpu"' not in p.read_text(), p
