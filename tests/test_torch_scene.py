"""The port's NSTTF scene equals tracer_tpu's: every table array exactly
(float32), the static tuples, the host copies, and the packed rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import nsttf as jax_nsttf
from tracer_tpu.kernels.pallas_intersect import pack_rows as jax_pack_rows
from tracer_tpu_torch import scene_from_jax
from tracer_tpu_torch.kernels.bounce import pack_rows
from tracer_tpu_torch.models import nsttf

FIELDS = ("frame", "inv_frame", "quadric", "ap_type", "ap_params",
          "opt_kind", "opt_flags", "opt_params", "spectral_wl",
          "spectral_ab", "logical")
STATIC = ("groups", "kinds_present", "flags_present", "slope_flags_present",
          "features", "ambient_medium", "iam_c")


@pytest.fixture(scope="module", params=[1.5e-3, 0.0], ids=["sigma", "flat"])
def scenes(request):
    jt, jm, jinfo = jax_nsttf.build_scene(sigma=request.param,
                                          dtype=jnp.float32)
    pt, pm, pinfo = nsttf.build_scene(sigma=request.param,
                                      dtype=torch.float32, device="cpu")
    return jt, jm, pt, pm


@pytest.mark.parametrize("field", FIELDS)
def test_table_arrays_equal(scenes, field):
    jt, _, pt, _ = scenes
    j = np.asarray(getattr(jt, field))
    p = getattr(pt, field).numpy()
    assert p.dtype == (np.float32 if j.dtype.kind == "f" else np.int32)
    np.testing.assert_array_equal(p, j)


@pytest.mark.parametrize("field", STATIC)
def test_static_tuples_equal(scenes, field):
    jt, _, pt, _ = scenes
    assert getattr(pt, field) == getattr(jt, field)


def test_nsttf_slice_surface(scenes):
    """The slice's kernel surface: one flat rect group, K_REFLECT only."""
    _, _, pt, _ = scenes
    assert pt.groups == ((0, 219, (1,), "flat"),)
    assert pt.kinds_present == (1,)


@pytest.mark.parametrize("field", ("row_logical", "frames", "host_quadric",
                                   "host_opt_kind", "host_opt_params",
                                   "host_opt_flags"))
def test_meta_host_copies_equal(scenes, field):
    _, jm, _, pm = scenes
    np.testing.assert_array_equal(getattr(pm, field), getattr(jm, field))
    assert pm.names == jm.names


def test_pack_rows_matches_jax(scenes):
    jt, _, pt, _ = scenes
    p = pack_rows(pt)
    assert p.dtype == torch.float32 and p.is_contiguous()
    np.testing.assert_array_equal(p.numpy(), np.asarray(jax_pack_rows(jt)).T)


def test_scene_from_jax_reproduces_port_build(scenes):
    jt, _, pt, _ = scenes
    table_np = {f: np.asarray(getattr(jt, f)) for f in FIELDS}
    table_np.update({f: getattr(jt, f) for f in STATIC})
    carried = scene_from_jax(table_np, device="cpu")
    for f in FIELDS:
        a, b = getattr(carried, f), getattr(pt, f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    for f in STATIC:
        assert getattr(carried, f) == getattr(pt, f), f


def test_nsttf_positions_file_equals_jax_package():
    """The port reads its own copy of the NSTTF pad coordinates."""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    mine = np.load(root / "tracer_tpu_torch" / "data"
                   / "sandia_nsttf_field.npz")
    theirs = np.load(root / "tracer_tpu" / "data" / "sandia_nsttf_field.npz")
    assert sorted(mine.files) == sorted(theirs.files)
    for k in theirs.files:
        np.testing.assert_array_equal(mine[k], theirs[k])
    from tracer_tpu_torch.models.heliostat_field import \
        load_heliostat_positions
    np.testing.assert_array_equal(load_heliostat_positions(),
                                  theirs["positions"])


@pytest.mark.parametrize("entry", ("compile_scene", "build_scene",
                                   "disk_bundle", "TracerEngine",
                                   "TraceAccum"))
def test_entry_points_need_a_gpu_unless_asked_for_the_cpu(monkeypatch,
                                                          entry):
    """With no GPU and no device given, every entry point raises, naming
    device="cpu"; with device="cpu" it runs on the CPU."""
    import tracer_tpu_torch as ptt
    from tracer_tpu_torch.engine import TraceAccum, TracerEngine
    from tracer_tpu_torch.sources import disk_bundle
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def plate():
        G, M, sc = ptt.geometry, ptt.materials, ptt.scene
        return sc.Assembly([sc.AssembledObject([sc.Surface(
            G.rect_plate(1.0, 1.0), M.reflective(0.1))])])

    calls = {
        "compile_scene": lambda **kw: ptt.compile_scene(plate(), **kw),
        "build_scene": lambda **kw: nsttf.build_scene(n_heliostats=3, **kw),
        "disk_bundle": lambda **kw: disk_bundle(
            torch.Generator(), 8, [0, 0, 1], [0, 0, -1], 1.0, 0.0, **kw),
        "TracerEngine": lambda **kw: TracerEngine(plate(), **kw),
        "TraceAccum": lambda **kw: TraceAccum.zeros(3, **kw),
    }
    with pytest.raises(RuntimeError, match='device="cpu"'):
        calls[entry]()
    calls[entry](device="cpu")
