"""The port's n,k database against tracer_tpu's: the bundled tables, the
loader and the two scripts that make them.

* tests/test_utils.py's bundled-database checks through the port's
  optical_constants (the generated tables against the analytic models,
  BK7 at the d-line, the SOPRA archive's breadth, measured=True);
* every file of tracer_tpu/data/nk, byte for byte in the port's copy, and
  from_sopra's table of each material equal to tracer_tpu's;
* the port's generate_nk regenerating the ten generated tables, and its
  convert_sopra rewriting archive tables, byte for byte as tracer_tpu's
  scripts write them.
"""
import filecmp
import os
import pathlib
import shutil

import numpy as np
import pytest

import tracer_tpu
from tracer_tpu import optical_constants as jax_oc
from tracer_tpu_torch import optical_constants as oc
from tracer_tpu_torch.data import convert_sopra, generate_nk

JAX_NK = pathlib.Path(tracer_tpu.__file__).parent / "data" / "nk"
PORT_NK = pathlib.Path(oc.builtin_nk_dir())
GENERATED = ["AG", "AL", "AU", "CU", "NI", "PT", "TI", "W", "SIO2", "BK7"]


def _files(root):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*.txt"))


def test_bundled_nk_database():
    """The generated tables load with no user files and match their
    analytic models (tests/test_utils.py:150)."""
    for name in GENERATED:
        assert (PORT_NK / f"{name}.txt").is_file()
        assert np.isfinite(oc.from_sopra(name).m(633e-9)[0]), name
    wl = np.linspace(400e-9, 2000e-9, 7)
    np.testing.assert_allclose(oc.from_sopra("AG").m(wl), oc.Ag().m(wl),
                               rtol=2e-3)
    np.testing.assert_allclose(oc.from_sopra("BK7").m(587.6e-9)[0].real,
                               1.5168, atol=2e-3)
    assert oc.from_sopra("BK7").m(587.6e-9)[0].imag == 0.0
    oc.BK7()


def test_bundled_sopra_archive_breadth():
    """The measured SOPRA archive resolves the materials the generated set
    lacks, measured=True prefers it, unknown names raise
    (tests/test_utils.py:170)."""
    sopra = PORT_NK / "sopra"
    assert len(list(sopra.glob("*.txt"))) >= 260
    m = oc.from_sopra("AL2O3").m(589e-9)[0]
    assert 1.6 < m.real < 1.8 and m.imag == 0.0
    si = oc.from_sopra("SI111")
    assert si.m(400e-9)[0].imag > 0.1
    assert abs(si.m(800e-9)[0].imag) < 1e-2
    assert si.m(800e-9)[0].real > 3.0
    gen = oc.from_sopra("AG").m(633e-9)[0]
    mea = oc.from_sopra("AG", measured=True).m(633e-9)[0]
    assert gen != mea
    np.testing.assert_allclose(mea.real, gen.real, atol=0.15)
    with pytest.raises(FileNotFoundError):
        oc.from_sopra("NOT_A_MATERIAL")


def test_every_table_is_tracer_tpus():
    """The port holds tracer_tpu's 277 tables byte for byte, and from_sopra
    reads each material's table as tracer_tpu's does, both orders."""
    names = _files(JAX_NK)
    assert len(names) >= 270 and names == _files(PORT_NK)
    for rel in names:
        assert filecmp.cmp(JAX_NK / rel, PORT_NK / rel, shallow=False), rel
    wl = np.geomspace(300e-9, 2e-6, 9)
    for rel in names:
        name = pathlib.PurePosixPath(rel).stem
        for measured in (False, True):
            a = oc.from_sopra(name, measured=measured)
            b = jax_oc.from_sopra(name, measured=measured)
            assert (a.l_min, a.l_max) == (b.l_min, b.l_max), rel
            np.testing.assert_array_equal(a.m(wl), b.m(wl), err_msg=rel)


def test_scripts_rewrite_the_tables(tmp_path):
    """generate_nk regenerates the ten generated tables byte for byte;
    convert_sopra rewrites archive tables as tracer_tpu's converter does,
    skipping files that are not n,k tables."""
    written = generate_nk.main(str(tmp_path / "gen"))
    assert sorted(pathlib.Path(p).stem for p in written) == sorted(GENERATED)
    for p in written:
        assert filecmp.cmp(p, PORT_NK / os.path.basename(p), shallow=False)
    src = tmp_path / "archive"
    src.mkdir()
    for name in ("AL2O3", "SI111", "AG"):
        shutil.copy(PORT_NK / "sopra" / f"{name}.txt", src / f"{name}.txt")
    (src / "notes.txt").write_text("not a table\nat all\n")
    from tracer_tpu.data import convert_sopra as jax_convert
    assert convert_sopra.convert_archive(str(src), str(tmp_path / "p")) == 3
    assert jax_convert.convert_archive(str(src), str(tmp_path / "j")) == 3
    for name in ("AL2O3", "SI111", "AG"):
        assert filecmp.cmp(tmp_path / "p" / f"{name}.txt",
                           tmp_path / "j" / f"{name}.txt", shallow=False)
