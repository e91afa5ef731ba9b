"""The frozen roofline arithmetic equals chip_smoke.py's at the shapes
chip_smoke.py recorded (PERF.md's kernel table)."""
import importlib.util

import pytest

from portbench import roofline
from portbench import run


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", run.ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_row_ops_equal_chip_smoke():
    cs = _chip_smoke()
    assert (cs.H100_BYTES_S, cs.H100_F32_S) == (roofline.H100_BYTES_S,
                                                roofline.H100_F32_S)
    for tag in roofline.ROW_OPS:
        for sig in ((), (1,), (3,), (1, 9)):
            assert roofline.row_ops(tag, sig) == cs.row_ops(tag, sig)
    for nbytes, nops in ((1e9, 1e9), (1e6, 1e12)):
        assert roofline.bound(nbytes, nops) == cs.bound(nbytes, nops)


def test_k1_bound_at_the_bench_slab():
    # phase 3's timed K1 call: 2,101,248 lanes, 684 tiles each with a
    # quota of 768 regenerated lanes; chip_smoke reads 0.0364 ms (bytes)
    lanes, regen = 2_101_248, 684 * 768
    ms, by = roofline.k1_bound(lanes, lanes - regen, regen, 0, 0.0)
    assert by == "bytes" and ms == pytest.approx(0.0364, abs=5e-5)


def test_k3_bound_on_the_minidish():
    # 4,194,304 MiniDish lanes: 0.0952 ms, set by bytes
    ops = roofline.scene_row_ops(["parab"] + ["rect"] * 5)
    ms, by = roofline.k3_bound(4_194_304, ops)
    assert by == "bytes" and ms == pytest.approx(0.0952, abs=5e-5)


def test_k2_bound_with_regeneration():
    # config 1's half-dead 700,416 lanes with regeneration: 0.0109 ms
    ms, by = roofline.k2_bound(700_416, 350_208, 6 * roofline.ROW_WORDS,
                               roofline.scene_row_ops(
                                   ["parab"] + ["rect"] * 5))
    assert by == "bytes" and ms == pytest.approx(0.0109, abs=5e-5)
