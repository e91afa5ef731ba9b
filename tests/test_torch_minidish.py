"""The slice as a whole: the TAU MiniDish (5 m dish, f = 6.25 m, 0.4 m
square homogenizer 0.7 m deep, rotated by -pi/4 about x) under the
examples' pillbox disk sun, traced by the port and by tracer_tpu from one
numpy ray bundle (16,384 rays, jax.random seed 42).

* the compiled tables are equal;
* TracerEngine.ray_tracer in float64 (the oracle path): sid equal on every
  lane of every bounce (ties counted, none expected), hit points to 1e-9,
  absorbed energy per logical surface to 1e-9 relative, energy closure to
  1e-12 of the source;
* the same in float32 (K3's plain version against tracer_tpu's jnp path),
  with tie and self-hit-guard lanes counted; per-surface absorbed energy
  within 1e-4 of the source energy (one flipped lane moves a whole ray's
  energy);
* trace_fused accumulators and the 50 x 50 receiver flux map against
  tracer_tpu's trace_fused;
* record="tags" against full records, histogram_hits, and the receiver
  fraction against bench config 1's 0.6008.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu.analysis.device_fluxmap import flux_plan as jax_flux_plan
from tracer_tpu.engine import TracerEngine as JaxEngine
from tracer_tpu.engine import trace_fused as jax_trace_fused
from tracer_tpu.models.tau_minidish import MiniDish as JaxMiniDish
from tracer_tpu.scene import compile_scene as jax_compile
from tracer_tpu.sources import solar_disk_bundle as jax_sun
from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
from tracer_tpu_torch.bundle import FIELDS, bundle_from_jax
from tracer_tpu_torch.engine import (TraceOptions, TracerEngine,
                                     trace_fused)
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.kernels.bounce import pack_rows
from tracer_tpu_torch.models.tau_minidish import MiniDish

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

N_RAYS = 16384
TABLE = ("frame", "inv_frame", "quadric", "ap_type", "ap_params",
         "opt_kind", "opt_flags", "opt_params", "logical")
STATIC = ("groups", "kinds_present", "flags_present", "slope_flags_present",
          "features", "ambient_medium", "iam_c")


def _assembly(cls, sp):
    asm = cls(5.0, 6.25, 0.9, 6.95, 0.4, 0.7, 0.9)
    asm.set_transform(sp.rotx(-np.pi / 4))
    return asm


def _jax_bundle(dtype):
    x = -1.0 / math.sqrt(2.0)
    b = jax_sun(jax.random.PRNGKey(42), N_RAYS, center=[0.0, 7.0, 7.0],
                direction=[0.0, x, x], radius=3.0, ang_range=0.005,
                flux=1000.0)
    return jax.tree.map(lambda a: a.astype(dtype)
                        if jnp.issubdtype(a.dtype, jnp.floating) else a, b)


_RUNS = {}


def _runs(precision):
    """(jax engine, its result, port assembly, port engine, its result)
    of one ray_tracer run per precision, made once."""
    if precision not in _RUNS:
        jdt, tdt = {"f64": (jnp.float64, torch.float64),
                    "f32": (jnp.float32, torch.float32)}[precision]
        jb = _jax_bundle(jdt)
        je = JaxEngine(_assembly(JaxMiniDish, tracer_tpu.spatial),
                       dtype=jdt)
        jr = je.ray_tracer(jb, reps=100)
        pa = _assembly(MiniDish, ptt.spatial)
        pe = TracerEngine(pa, dtype=tdt, device="cpu")
        pb = bundle_from_jax({f: np.asarray(getattr(jb, f))
                              for f in FIELDS}, device="cpu")
        pr = pe.ray_tracer(pb, reps=100)
        _RUNS[precision] = (je, jr, pa, pe, pr)
    return _RUNS[precision]


@pytest.mark.parametrize("field", TABLE + STATIC)
def test_tables_equal(field):
    jt, _ = jax_compile(_assembly(JaxMiniDish, tracer_tpu.spatial),
                        dtype=jnp.float32)
    pt, _ = ptt.compile_scene(_assembly(MiniDish, ptt.spatial),
                              device="cpu")
    if field in STATIC:
        assert getattr(pt, field) == getattr(jt, field)
    else:
        np.testing.assert_array_equal(getattr(pt, field).numpy(),
                                      np.asarray(getattr(jt, field)))


def test_minidish_groups():
    """Five flat rect rows (receiver, four walls) and the z-range
    paraboloid: the slice's K3 classes."""
    pt, _ = ptt.compile_scene(_assembly(MiniDish, ptt.spatial),
                              device="cpu")
    assert pt.groups == ((0, 5, (1,), "flat"), (5, 6, (3,), "parab"))


def _inputs(records, source_pos):
    """Each bounce's ray origins: the previous bounce's hit points."""
    pos = [source_pos]
    for rec in records[:-1]:
        pos.append(rec.hit.numpy())
    return pos


def test_ray_tracer_float64_lane_by_lane():
    je, jr, _, pe, pr = _runs("f64")
    assert len(pr.records) == len(jr.records) >= 3
    rows = pack_rows(pe.scene, torch.float64)
    ties = 0
    for rec, jrec, pos in zip(pr.records, jr.records,
                              _inputs(pr.records, pr.source.pos.numpy())):
        alive = rec.alive_in.numpy()
        np.testing.assert_array_equal(alive, np.asarray(jrec.alive_in))
        t1, t2 = kn.nearest_two_t(rows, torch.tensor(pos), rec.dir_in,
                                  pe.scene.groups, 1e-6)
        tie = ((t2 - t1) <= 1e-9 * t1).numpy() & alive
        ties += int(tie.sum())
        sid, jsid = rec.sid.numpy(), np.asarray(jrec.sid)
        np.testing.assert_array_equal(sid[~tie], jsid[~tie])
        hit = (sid >= 0) & ~tie
        np.testing.assert_allclose(rec.hit.numpy()[hit],
                                   np.asarray(jrec.hit)[hit], rtol=0,
                                   atol=1e-9)
        np.testing.assert_allclose(rec.absorbed.numpy(),
                                   np.asarray(jrec.absorbed), rtol=1e-9,
                                   atol=1e-12)
    assert ties == 0
    np.testing.assert_allclose(pr.absorbed_by_logical(),
                               jr.absorbed_by_logical(), rtol=1e-9)
    bal = pr.energy_balance()
    assert abs(bal["closure"]) < 1e-12 * bal["source"]
    assert bal["residual"] == 0.0


def test_ray_tracer_float32_against_jnp():
    """K3's plain version (L1 self-hit guard for flat rows) against
    tracer_tpu's float32 jnp path (L2 guard). A lane is followed while its
    history agrees; sid may differ only on ties (best and second-best t
    within 1e-5 of the ray's scale) and in the guard band."""
    je, jr, _, pe, pr = _runs("f32")
    rows = pack_rows(pe.scene)
    agree = np.ones(N_RAYS, dtype=bool)
    counted = 0
    for rec, jrec, pos in zip(pr.records, jr.records,
                              _inputs(pr.records, pr.source.pos.numpy())):
        tp = torch.tensor(pos)
        t1, t2 = kn.nearest_two_t(rows, tp, rec.dir_in, pe.scene.groups,
                                  3e-4)
        scale = 1.0 + tp.abs().amax(1)
        odd = (((t2 - t1) <= 1e-5 * (scale + t1))
               | (t1 <= 4 * 3e-4 * scale)).numpy()
        live = agree & rec.alive_in.numpy()
        same = rec.sid.numpy() == np.asarray(jrec.sid)
        assert (same | ~live | odd).all()
        counted += int((live & odd).sum())
        agree &= same
    # the walls meet at the homogenizer's edges: ~1% of the lanes hit
    # within 1e-5 of the ray's scale of an edge there
    assert counted < 0.02 * N_RAYS and agree.mean() > 0.999
    src = pr.energy_balance()["source"]
    np.testing.assert_allclose(pr.absorbed_by_logical(),
                               jr.absorbed_by_logical(), rtol=0,
                               atol=1e-4 * src)
    assert abs(pr.energy_balance()["closure"]) < 1e-4 * src


def test_receiver_fraction_and_histogram():
    """Receiver power over the source's against bench config 1's 0.6008
    (3 binomial sigma), and histogram_hits against tracer_tpu's."""
    je, jr, pa, pe, pr = _runs("f64")
    names = pr.meta.names
    frac = pr.absorbed_by_logical()[names.index("receiver")] \
        / pr.energy_balance()["source"]
    assert abs(frac - 0.6008) < 3 * math.sqrt(0.6 * 0.4 / N_RAYS), frac
    H, xb, yb = pa.histogram_hits(pr, bins=50)
    jH, jxb, jyb = _assembly(JaxMiniDish, tracer_tpu.spatial) \
        .histogram_hits(jr, bins=50)
    np.testing.assert_allclose(H, jH, rtol=1e-9, atol=1e-9)
    np.testing.assert_array_equal(xb, jxb)
    assert abs(H.sum() - pr.absorbed_by_logical()[names.index(
        "receiver")]) < 1e-9 * H.sum()


def test_tagged_records_equal_full_records():
    _, _, pa, pe, pr = _runs("f64")
    pb = pr.source
    tagged = pe.ray_tracer(pb, opts=TraceOptions(record="tags"))
    full, tag = pr.hits_of("receiver"), tagged.hits_of("receiver")
    assert len(full["absorbed"]) > 0.5 * N_RAYS
    for k in full:
        np.testing.assert_array_equal(tag[k], full[k], err_msg=k)
    # a tagged record holds only receiver hits, with their slab slots
    rec_rows = set(np.nonzero(pr.meta.row_logical
                              == pr.meta.index_of("receiver"))[0])
    for rec in tagged.records:
        live = rec.alive_in.numpy()
        assert set(rec.sid.numpy()[live]) <= rec_rows
        assert rec.slot is not None
    hist = tagged.ray_history(int(tagged.records[0].slot[0]))
    assert hist and hist[0]["sid"] in rec_rows
    np.testing.assert_allclose(tagged.absorbed_by_logical(),
                               pr.absorbed_by_logical(), rtol=0, atol=0)


@pytest.mark.parametrize("precision", ("f64", "f32"))
def test_trace_fused_matches_jax(precision):
    """trace_fused with the 50 x 50 receiver flux map, 20 bounces, against
    tracer_tpu's trace_fused in the same precision (float32 with x64 off,
    which its float32 trace needs). f64: accumulators to 1e-9 relative;
    f32: within 1e-4 of the source. The port's flux map sums to the
    receiver's absorbed energy; tracer_tpu rounds each hit's energy to
    bfloat16 (stochastically) before binning, so the bins agree within
    2^-7 relative."""
    jdt = jnp.float64 if precision == "f64" else jnp.float32
    with jax.enable_x64(precision == "f64"):
        jt, jm = jax_compile(_assembly(JaxMiniDish, tracer_tpu.spatial),
                             dtype=jdt)
        jb = _jax_bundle(jdt)
        _, ja = jax_trace_fused(
            jt, jb, jax.random.PRNGKey(0), max_bounces=20,
            fluxspecs=(jax_flux_plan(jm, "receiver", resolution=50),))
        ja = jax.device_get(ja)
    tdt = torch.float64 if precision == "f64" else torch.float32
    pt, pm = ptt.compile_scene(_assembly(MiniDish, ptt.spatial), dtype=tdt,
                               device="cpu")
    spec = flux_plan(pm, "receiver", resolution=50)
    pb = bundle_from_jax({f: np.asarray(getattr(jb, f)) for f in FIELDS},
                         device="cpu", dtype=tdt)
    final, pa = trace_fused(pt, pb, max_bounces=20, fluxspecs=(spec,))
    src = float(pb.total_energy())
    atol = 1e-4 * src if precision == "f32" else 0.0
    rtol = 1e-9 if precision == "f64" else 0.0
    np.testing.assert_allclose(pa.absorbed.numpy(), np.asarray(ja.absorbed),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(float(pa.escaped), float(ja.escaped),
                               rtol=rtol, atol=atol)
    hits = np.abs(pa.hits.numpy() - np.asarray(ja.hits))
    assert hits.sum() <= (0 if precision == "f64" else 20)
    assert not bool(final.alive.any())
    rec = float(pa.absorbed[spec.rows[0]])
    hist = pa.flux[0].double().numpy()
    assert hist.shape == (50, 50)
    # float32 bins and row sums add ~16k values each in other orders
    assert abs(hist.sum() - rec) <= (1e-9 if precision == "f64"
                                     else 1e-4) * rec
    jhist = np.asarray(ja.flux[0], np.float64)
    # f32: a lane that takes another path moves one ray's energy
    e_ray = src / N_RAYS if precision == "f32" else 0.0
    tol = 2.0 ** -7 * np.maximum(hist, jhist) + 2.0 * e_ray
    assert (np.abs(hist - jhist) <= tol).all()
    closure = (src - float(pa.absorbed.double().sum()) - float(pa.escaped)
               - float(pa.culled))
    assert abs(closure) < (1e-12 if precision == "f64" else 1e-4) * src


def test_generator_and_unported_options():
    """ray_tracer's accel, float64 on a missing device and unported optics
    raise; a None generator is one seeded with 0 (no randomness is drawn
    on the MiniDish, so the result does not depend on it)."""
    _, _, pa, pe, pr = _runs("f64")
    with pytest.raises(NotImplementedError, match="ROADMAP A10"):
        pe.ray_tracer(pr.source, accel=True)
    again = pe.ray_tracer(pr.source,
                          generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(again.absorbed_by_logical(),
                                  pr.absorbed_by_logical())
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    lam = sc.Assembly([sc.AssembledObject([sc.Surface(
        G.rect_plate(1.0, 1.0), M.lambertian(0.5))])])
    eng = TracerEngine(lam, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        eng.ray_tracer(ptt.RayBundle.create(torch.zeros((2, 3)),
                                            torch.ones((2, 3)),
                                            device="cpu"))
