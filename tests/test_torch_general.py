"""The general streaming path and _bounce_step's fused K2 branch against
tracer_tpu on the CPU:

* bench config 7 (benchmarks/suite.py:360: a Cook-Torrance target in a
  collection dome) at a 2-tile slab through the port's plain megakernel,
  the port's general path (its source without a spec) and tracer_tpu's
  general path: dome fractions within 3 sigma and 2% of each other,
  closures below 1e-5, the emission budget met exactly on the general
  path;
* the fused branch's record (t 0 on hits, no local point or normal) and
  its gate, tracer_tpu's _iam_mode, _where_ray_fields, the residual of a
  trace cut by max_rounds; mixed IAM exponents and a spec-less source
  over a scattering sheet trace on the general path's unfused bounce (K3
  and the shade), the mixed exponents within 3 sigma of tracer_tpu's
  trace_streaming; a float64 table streams on the general path within 3
  sigma of tracer_tpu's float64 trace. Energy splitting streams too
  (tests/test_torch_split.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import engine as jax_engine
from tracer_tpu import sources as jax_sources
from tracer_tpu_torch import engine
from tracer_tpu_torch.engine import (TraceAccum, energy_closure,
                                     trace_streaming)
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.models.bench_configs import (
    BENCH, bench_assembly, bench_scene, max_rounds, without_spec)
from test_torch_gpu import stage_de_assembly
from test_torch_refraction import _disk, _frac

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

SLAB = 2 * kb.TILE
TOTAL = 4 * SLAB


def config7(source, total=TOTAL, rounds=None):
    """The port's trace of config 7 at SLAB lanes through its spec'd
    source (the megakernel) or, with ``source`` "general", the same source
    without its spec: (dome fraction, emitted, accum, source energy)."""
    table, meta, source_fn = bench_scene(7, SLAB, "cpu")
    if source == "general":
        source_fn = without_spec(source_fn)
    acc, em, se = trace_streaming(
        table, source_fn, torch.Generator().manual_seed(0), total,
        max_rounds=rounds or max_rounds(7, 4),
        max_path=BENCH[7]["max_path"])
    f = acc.absorbed.double().numpy() / float(se)
    return _frac(meta, f, "dome"), int(em), acc, se


def test_config7_general_path_matches_megakernel_and_jax():
    """Config 7 at 4 slabs of 2 tiles: the port's megakernel, the port's
    general path and tracer_tpu's general path put the same share of the
    source on the dome (each pair within 3 combined binomial sigma and 2%
    of each other, the suite's check), above 0.4; every closure below
    1e-5; the general paths emit exactly TOTAL rays."""
    mk, em_mk, acc, se = config7("megakernel")
    assert abs(energy_closure(acc, se)) < 1e-5
    assert TOTAL <= em_mk <= TOTAL + SLAB
    gen, em_gen, acc, se = config7("general")
    assert abs(energy_closure(acc, se)) < 1e-5
    assert em_gen == TOTAL
    jt, jmeta = tracer_tpu.compile_scene(bench_assembly(tracer_tpu, 7)[0],
                                         dtype=jnp.float32)
    c = BENCH[7]

    def jax_source(key):
        return _disk(tracer_tpu, SLAB, c["center"], c["direction"],
                     c["radius"], c["ang_range"], key)
    ja, jem, jse = jax_engine.trace_streaming(
        jt, jax_source, jax.random.PRNGKey(0), total_rays=TOTAL,
        max_rounds=max_rounds(7, 4), max_path=c["max_path"])
    assert int(jem) == TOTAL
    jf = np.asarray(ja.absorbed, np.float64) / float(jse)
    tot = (np.asarray(ja.absorbed, np.float64).sum() + float(ja.escaped)
           + float(ja.culled) + float(ja.medium) + float(ja.residual))
    assert abs(tot - float(jse)) < 1e-5 * float(jse)
    jd = _frac(jmeta, jf, "dome")
    fracs = {"megakernel": (mk, em_mk), "general": (gen, em_gen),
             "tracer_tpu": (jd, int(jem))}
    for a, (p, n_p) in fracs.items():
        assert p > 0.4, (a, p)
        for b, (q, n_q) in fracs.items():
            sig = np.sqrt(q * (1 - q) * (1 / n_p + 1 / n_q))
            assert abs(p - q) <= 3 * sig, (a, b, p, q, sig)
            assert abs(p - q) < 0.02 * q, (a, b, p, q)


def test_general_path_residual_at_max_rounds():
    """Cut after 3 rounds, the general path still closes: the energy on
    live rays goes to the residual. Rounds after the first refill only
    the lanes that died."""
    _, em, acc, se = config7("general", rounds=3)
    assert SLAB < em < 3 * SLAB
    assert float(acc.residual) > 0.0
    assert abs(energy_closure(acc, se)) < 1e-5


def test_fused_step_record_and_gate():
    """_bounce_step without need_local takes the fused branch on a config-7
    scene: hits carry t 0, no local point or normal; ray_tracer's default
    need_local keeps the unfused branch, K3 and the shade, which shades
    the Cook-Torrance rows with their distance, local point and normal.
    Volumetric media and float64 tables fail the gate; bifacial rows pass
    it (K2 takes backside_miss)."""
    table, _, source_fn = bench_scene(7, SLAB, "cpu")
    assert engine._fused_ok(table)
    b = source_fn(torch.Generator().manual_seed(2), device="cpu")
    acc = TraceAccum.zeros(table.num_rows, device="cpu")
    nb, acc, rec = engine._bounce_step(
        table, b, acc, torch.Generator().manual_seed(3), 1e-6, None, 1e-6,
        64, need_local=False)
    hit = rec.sid >= 0
    assert hit.float().mean() > 0.5
    assert (rec.t[hit] == 0.0).all() and torch.isinf(rec.t[~hit]).all()
    assert not rec.local.any() and not rec.normal.any()
    assert torch.equal(nb.alive, hit & (rec.e_out > 1e-6))
    nb, acc, rec = engine._bounce_step(table, b, acc, torch.Generator(),
                                       1e-6, None, 1e-6, 64)
    hit_u = rec.sid >= 0
    assert abs(float(hit_u.float().mean()) - float(hit.float().mean())) \
        < 0.01
    assert torch.isfinite(rec.t[hit_u]).all() and (rec.t[hit_u] > 0).all()
    assert rec.local[hit_u].abs().sum(1).gt(0).all()
    np.testing.assert_allclose(rec.normal[hit_u].norm(dim=1).numpy(), 1.0,
                               rtol=1e-5)
    assert torch.equal(nb.alive, hit_u & (rec.e_out > 1e-6))
    G, M = ptt.geometry, ptt.materials

    def scene(optics, **kw):
        plate = ptt.Surface(G.round_plate(0.5), optics)
        return ptt.compile_scene(ptt.Assembly([ptt.AssembledObject([plate])]),
                                 device="cpu", **kw)[0]
    assert engine._fused_ok(scene(M.bifacial(M.reflective(0.1),
                                             M.reflective(0.9))))
    assert not engine._fused_ok(scene(M.scattering_periodic_boundary(
        1.0, 0.2)))
    assert not engine._fused_ok(scene(M.reflective(0.1),
                                      dtype=torch.float64))
    assert engine._fused_ok(scene(M.refractive_homogenous(1.0, 1.5)))
    assert not engine._fused_ok(scene(M.refractive_material(
        1.0, ([4e-7, 7e-7], [1.6, 1.4]))))


@pytest.mark.parametrize("name", ("iam", "iam_c2", "scatterers"))
def test_iam_mode_equals_jax(name):
    """The port's _iam_mode, on the IAM mirrors with c = 1 and 2 and on a
    scene without IAM rows, equals tracer_tpu's."""
    table, _ = ptt.compile_scene(stage_de_assembly(ptt, name), device="cpu")
    jt, _ = tracer_tpu.compile_scene(stage_de_assembly(tracer_tpu, name),
                                     dtype=jnp.float32)
    assert engine._iam_mode(table) == jax_engine._iam_mode(jt)


def test_where_ray_fields_moves_every_state_field():
    """_where_ray_fields takes every per-ray state field from ``new`` on
    the masked lanes and keeps ``old``'s elsewhere; alive and parent stay
    ``old``'s, and the field list is tracer_tpu's."""
    g = torch.Generator().manual_seed(0)
    n = 8

    def bundle(v):
        return ptt.RayBundle.create(
            torch.full((n, 3), v), torch.full((n, 3), v), energy=v,
            wavelength=v, ref_index=v, att_coeff=v, scat_coeff=v, scat_g=v,
            device="cpu")
    mask = torch.rand(n, generator=g) < 0.5
    out = engine._where_ray_fields(mask, bundle(2.0), bundle(1.0))
    want = torch.where(mask, 2.0, 1.0)
    for f in engine._RAY_FIELDS:
        t = getattr(out, f)
        assert torch.equal(t if t.ndim == 1 else t[:, 0], want), f
    old = bundle(1.0)
    assert torch.equal(out.alive, old.alive)
    assert torch.equal(out.parent, old.parent)
    assert engine._RAY_FIELDS == jax_engine._RAY_FIELDS


def test_streaming_refusals_left():
    """Mixed IAM exponents (K2 takes one) trace on the general path's
    unfused bounce from both sources, within 3 combined binomial sigma of
    tracer_tpu's trace_streaming per plate; a spec-less source over a
    scattering sheet traces there too; energy splitting traces on both
    sources. Every closure below 1e-5. A float64 table streams on the
    general path (the spec ignored, the source's rays cast to float64),
    within 3 combined sigma of tracer_tpu's float64 trace_streaming per
    row, closing to 1e-9."""
    _, _, source_fn = bench_scene(7, SLAB, "cpu")
    G, M = ptt.geometry, ptt.materials

    def build(pkg, *optics):
        # side by side under the beam (it crosses z = 0 about y = 0.4)
        return pkg.Assembly([pkg.AssembledObject([
            pkg.Surface(pkg.geometry.round_plate(0.3), o,
                        location=[0.6 * i - 0.3, 0.4, 0.5 * i])
            for i, o in enumerate(optics)])])

    def scene(*optics, dtype=torch.float32):
        return ptt.compile_scene(build(ptt, *optics), dtype=dtype,
                                 device="cpu")[0]

    def mixed_optics(pkg):
        M_ = pkg.materials
        return (M_.iam(M_.reflective(0.1), 1.0, c=1.0),
                M_.iam(M_.lambertian(0.3), 0.5, c=2.0))
    mixed = scene(*mixed_optics(ptt))
    assert "iam_nonmirror" in mixed.features
    split = scene(M.refractive_homogenous(1.0, 1.5, single_ray=False))
    for src in (source_fn, without_spec(source_fn)):
        acc, em, se = trace_streaming(mixed, src,
                                      torch.Generator().manual_seed(4),
                                      TOTAL, max_rounds=40, max_path=8)
        assert int(em) == TOTAL
        assert abs(energy_closure(acc, se)) < 1e-5
        acc, em, se = trace_streaming(split, src, torch.Generator(), SLAB,
                                      max_rounds=20, max_path=4)
        assert int(em) == SLAB
        assert abs(energy_closure(acc, se)) < 1e-5
    acc_mixed, em, se = trace_streaming(mixed, source_fn,
                                        torch.Generator().manual_seed(5),
                                        TOTAL, max_rounds=40, max_path=8)
    p = acc_mixed.absorbed.double().numpy() / float(se)
    jt, _ = tracer_tpu.compile_scene(
        build(tracer_tpu, *mixed_optics(tracer_tpu)), dtype=jnp.float32)
    c = BENCH[7]

    def jax_source(key):
        return _disk(tracer_tpu, SLAB, c["center"], c["direction"],
                     c["radius"], c["ang_range"], key)
    ja, jem, jse = jax_engine.trace_streaming(
        jt, jax_source, jax.random.PRNGKey(0), total_rays=TOTAL,
        max_rounds=40, max_path=8)
    q = np.asarray(ja.absorbed, np.float64) / float(jse)
    sig = np.sqrt(q * (1 - q) * (1 / int(em) + 1 / int(jem)))
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    assert p.min() > 0.005
    box = scene(M.scattering_interface(0.3), M.reflective(0.2))
    acc, em, se = trace_streaming(box, without_spec(source_fn),
                                  torch.Generator().manual_seed(6), TOTAL,
                                  max_rounds=60, max_path=16)
    assert int(em) == TOTAL
    assert abs(energy_closure(acc, se)) < 1e-5
    plates = (M.reflective(0.1), M.lambertian(0.3))
    acc, em, se = trace_streaming(scene(*plates, dtype=torch.float64),
                                  source_fn, torch.Generator().manual_seed(7),
                                  TOTAL, max_rounds=40, max_path=8)
    assert acc.absorbed.dtype == torch.float64 and int(em) == TOTAL
    assert abs(energy_closure(acc, se)) < 1e-9
    jt64, _ = tracer_tpu.compile_scene(
        build(tracer_tpu, tracer_tpu.materials.reflective(0.1),
              tracer_tpu.materials.lambertian(0.3)), dtype=jnp.float64)

    def jax_source64(key):
        return jax_sources.disk_bundle(key, SLAB, center=c["center"],
                                       direction=c["direction"],
                                       radius=c["radius"],
                                       ang_range=c["ang_range"],
                                       flux=1000.0)
    ja, jem, jse = jax_engine.trace_streaming(
        jt64, jax_source64, jax.random.PRNGKey(1), total_rays=TOTAL,
        max_rounds=40, max_path=8)
    p = acc.absorbed.numpy() / float(se)
    q = np.asarray(ja.absorbed, np.float64) / float(jse)
    sig = np.sqrt(q * (1 - q) * (1 / int(em) + 1 / int(jem)))
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    assert p.min() > 0.005
