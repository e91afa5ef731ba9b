"""The bundle traces on the unfused bounce against tracer_tpu on the CPU:

* TracerEngine.ray_tracer's splitter on tests/test_engine.py:372's glass
  slab (float64, 20,000 rays): per-surface fractions within 3 combined
  binomial sigma of tracer_tpu's ray_tracer, closure below 1e-9, every
  appended ray's ``parent`` its originating slot and its first segment
  the split's reflected branch; hits_of and ray_history index the grown
  bundle;
* trace_fused on scenes of every other kind (the stage (d)/(e) rows, IAM
  with mixed exponents, a dispersive interface, a scattering sheet):
  closure below 1e-5 and the per-surface fractions within 3 sigma of
  tracer_tpu's trace_fused (float64); F_SPLIT rows roulette there, in
  both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import engine as jax_engine
from tracer_tpu_torch.engine import TracerEngine, trace_fused
from test_torch_gpu import STAGE_DE, stage_de_assembly
from test_torch_refraction import _disk
from test_torch_split import SLAB_BEAM, glass_slab

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)


def _fractions(meta, absorbed, source):
    f = np.zeros(len(meta.names))
    np.add.at(f, np.asarray(meta.row_logical),
              np.asarray(absorbed, np.float64))
    return f / source


def test_ray_tracer_splitter_matches_jax():
    n, min_e = 20_000, 1e-7
    asm, _ = glass_slab(ptt)
    eng = TracerEngine(asm, dtype=torch.float64, device="cpu")
    beam = ptt.sources.disk_bundle(torch.Generator().manual_seed(7), n,
                                   SLAB_BEAM[0], SLAB_BEAM[1], 1.0, 1e-3,
                                   flux=1000.0, dtype=torch.float64,
                                   device="cpu")
    res = eng.ray_tracer(beam, reps=30, min_energy=min_e,
                         generator=torch.Generator().manual_seed(8))
    src = float(beam.total_energy())
    bal = res.energy_balance()
    assert abs(bal["closure"]) < 1e-9 * src
    assert bal["culled"] > 0.0
    f = res.absorbed_by_logical() / src
    jasm, _ = glass_slab(tracer_tpu)
    jt, jmeta = tracer_tpu.compile_scene(jasm, dtype=jnp.float64)
    jbeam = tracer_tpu.sources.disk_bundle(
        jax.random.PRNGKey(7), n, center=SLAB_BEAM[0],
        direction=SLAB_BEAM[1], radius=1.0, ang_range=1e-3, flux=1000.0)
    jres = jax_engine.TracerEngine(jt, jmeta).ray_tracer(
        jbeam, reps=30, key=jax.random.PRNGKey(8), min_energy=min_e)
    q = jres.absorbed_by_logical() / float(np.asarray(jbeam.energy).sum())
    sig = np.sqrt(np.maximum(q * (1 - q), 1e-12) * 2 / n)
    assert (np.abs(f - q) <= 3 * sig).all(), (f, q, sig)
    meta = res.meta
    assert f[meta.index_of("floor")] > 0.75
    assert f[meta.index_of("ceil")] > 0.02
    # the bundle grew by the kept branches, slot by slot
    sizes = [len(r.sid) for r in res.records]
    assert sizes[0] == n and res.final.num_rays > n
    for b, rec in enumerate(res.records[:-1]):
        mask, s_e, s_dir = rec.split
        kept = torch.nonzero(mask & (s_e > min_e)).flatten()
        lo = sizes[b]
        assert sizes[b + 1] == lo + kept.numel()
        new = slice(lo, lo + kept.numel())
        assert torch.equal(res.final.parent[new], kept.to(torch.int32))
        nxt = res.records[b + 1]
        assert torch.equal(nxt.dir_in[new], s_dir[kept])
        assert torch.equal(nxt.e_in[new] > 0, torch.ones_like(kept,
                                                             dtype=bool)
                           & (nxt.sid[new] >= 0))
    # the queries read the grown records
    hits = res.hits_of("ceil")
    assert len(hits["absorbed"]) and (hits["bounce"] > 0).all()
    np.testing.assert_allclose(hits["absorbed"].sum() / src,
                               f[meta.index_of("ceil")], rtol=1e-9)
    hist = res.ray_history(n + 3)
    assert hist and hist[0]["bounce"] >= 1


def _mixed_assembly(pkg):
    """IAM rows with two exponents under a dispersive energy-splitting
    interface and two scattering, absorbing sheets, in a dome."""
    M, G = pkg.materials, pkg.geometry
    surfs = [
        pkg.Surface(G.round_plate(0.4), M.iam(M.reflective(0.1), 1.0, c=1.0),
                    location=[-0.5, 0.0, 0.0], name="iam1"),
        pkg.Surface(G.round_plate(0.4), M.iam(M.lambertian(0.3), 0.5, c=2.0),
                    location=[0.5, 0.0, 0.0], name="iam2"),
        pkg.Surface(G.rect_plate(3.0, 3.0), M.refractive_material(
            1.0, ([4e-7, 7e-7], [1.6, 1.4]), single_ray=False),
            location=[0.0, 0.0, 1.0],
            name="glass"),
        pkg.Surface(G.rect_plate(3.0, 3.0), M.scattering_interface(
            0.4, g=0.5, att_inside=0.3), location=[0.0, 0.0, 1.5],
            name="sheet"),
        pkg.Surface(G.rect_plate(3.0, 3.0), M.scattering_interface(
            0.4, g=0.5, att_inside=0.3), location=[0.0, 0.0, 2.0],
            name="sheet2"),
        pkg.Surface(G.hemisphere(4.0), M.absorber(one_sided=False),
                    name="dome")]
    return pkg.Assembly([pkg.AssembledObject(surfs)])


# the mixed scene's beam: centre, direction, radius, pillbox half-angle,
# wavelength band
MIXED_BEAM = ([0.0, 0.0, 3.0], [0.0, 0.1, -1.0], 0.9, 1e-3, (4e-7, 7e-7))


@pytest.mark.parametrize("scene", ("scatterers", "conductor",
                                   "piecewise_2d", "periodic_hg", "mixed"))
def test_trace_fused_every_kind_matches_jax(scene):
    """trace_fused of 16,384 float32 rays on the unfused bounce against
    tracer_tpu's (float64, the same beam): closure below 1e-5, every
    surface's share and the medium's within 3 combined binomial sigma."""
    n = 16_384
    if scene == "mixed":
        build, beam = _mixed_assembly, MIXED_BEAM
    else:
        def build(pkg):
            return stage_de_assembly(pkg, scene)
        beam = STAGE_DE[scene]
    table, meta = ptt.compile_scene(build(ptt), device="cpu")
    jt, jmeta = tracer_tpu.compile_scene(build(tracer_tpu),
                                         dtype=jnp.float64)
    bundle = _disk(ptt, n, *beam[:4], torch.Generator().manual_seed(0))
    jbundle = tracer_tpu.sources.disk_bundle(
        jax.random.PRNGKey(0), n, center=beam[0], direction=beam[1],
        radius=beam[2], ang_range=beam[3], flux=1000.0)
    if beam[4] is not None:
        rng = np.random.default_rng(1)
        wl = rng.uniform(*beam[4], n)
        bundle = bundle.replace(wavelength=torch.tensor(wl,
                                                        dtype=torch.float32))
        jbundle = jbundle.replace(wavelength=jnp.asarray(wl))
    final, acc = trace_fused(table, bundle,
                             torch.Generator().manual_seed(1),
                             max_bounces=40)
    src = float(bundle.total_energy())
    tot = (float(acc.absorbed.double().sum()) + float(acc.escaped)
           + float(acc.culled) + float(acc.medium)
           + float(final.total_energy()))
    assert abs(tot - src) < 1e-5 * src
    _, ja = jax_engine.trace_fused(jt, jbundle, jax.random.PRNGKey(2),
                                   max_bounces=40)
    jsrc = float(np.asarray(jbundle.energy).sum())
    p = np.append(_fractions(meta, acc.absorbed.double().numpy(), src),
                  float(acc.medium) / src)
    q = np.append(_fractions(jmeta, ja.absorbed, jsrc),
                  float(ja.medium) / jsrc)
    sig = np.sqrt(np.maximum(q * (1 - q), 1e-12) * 2 / n)
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    assert p[:-1].max() > 0.05
    if scene == "mixed":
        assert p[-1] > 0.01
        assert p[meta.index_of("iam2")] > 0.005
