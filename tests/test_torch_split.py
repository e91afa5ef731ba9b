"""Energy-splitting refraction against tracer_tpu on the CPU: K2's
refr_split mode and the general streaming path's split stream.

* the split lens's packed rows equal tracer_tpu's, with the F_SPLIT bit
  in the flags word;
* K2's plain version with ``refr_split`` lane by lane against tracer_tpu's
  bounce_reflect_pallas in TPU interpret mode: on the split lens's rows
  and on a glass plate lit from inside past the critical angle (TIR
  lanes) in an absorbing ambient. An F_SPLIT interface draws no decision
  (the lane always crosses), so every lane is deterministic: sid, point,
  direction, energy, absorbed, index, and the reflected branch's energy
  and direction;
* the energy a split leaves: per lane the primary's and the branch's
  energies add up to the attenuated energy, and at normal incidence on
  n = 1.5 the branch takes R = 0.04;
* the overflow machinery on hand-made lanes: a branch takes its own free
  lane with its age + 1, a second split merges the two branches (summed
  energy, the new one kept with probability s_e / (e_ovf + s_e)), tiny
  branches and branches past the bounce budget are culled with their
  energy accounted;
* tests/test_engine.py:372's glass-slab scene on the port's split stream
  against tracer_tpu's host-stepped splitter (float64) and its split
  stream; the split lens against the roulette lens and tracer_tpu's
  split stream; at the bench's energy a ray, the second reflections
  that fall below min_energy and are culled;
* the dispatch: a split scene streams on the general path even with a
  spec, on K2's refr_split where it fuses; with volumetric media or
  dispersion on K3 and the shade's split mode (the splitting sheet
  within 3 sigma of tracer_tpu's trace_streaming), and the host-stepped
  ray_tracer splits the lens (tests/test_torch_unfused_traces.py holds
  its splitter against tracer_tpu's).

The CUDA kernel runs only on a GPU: tests/test_torch_gpu.py and
tests/test_torch_emulated.py hold it against the same plain version.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import engine as jax_engine
from tracer_tpu.kernels.pallas_intersect import pack_rows as jax_pack_rows
from tracer_tpu_torch import engine
from tracer_tpu_torch.engine import (TraceAccum, TracerEngine,
                                     energy_closure, trace_streaming)
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.models.bench_configs import (BENCH, bench_assembly,
                                                   bench_scene, max_rounds,
                                                   without_spec)
from test_torch_gpu import T_EPS, bench_lanes, bench_modes
from test_torch_refraction import (_disk, _frac, assert_lanes_equal,
                                   cone_dirs, k2_interpret, plates, twins)

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

SLAB = 2 * kb.TILE
TOTAL = 4 * SLAB


@pytest.fixture(autouse=True)
def _fresh_jit_caches():
    """The interpret-mode switches are read at trace time and are not part
    of the jit cache key: keep no trace made under them."""
    yield
    jax.clear_caches()


def split_lens(pkg):
    return bench_assembly(pkg, "6s")


def test_split_lens_rows_equal_jax():
    """The split lens (config 6's lens with single_ray=False) compiles to
    tracer_tpu's rows and packed table; its two faces carry F_SPLIT, which
    the packed kind word holds as bit 3 (kf mod 16 >= 8)."""
    table, _, jt, _ = twins(split_lens)
    assert "split" in table.features and table.features == jt.features
    for name in ("frame", "quadric", "ap_type", "ap_params", "opt_kind",
                 "opt_flags", "opt_params"):
        np.testing.assert_array_equal(getattr(table, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    rows = kb.pack_rows(table).numpy()
    # tracer_tpu packs (K, S) for its scalar memory
    np.testing.assert_array_equal(rows, np.asarray(jax_pack_rows(jt)).T)
    lens = table.opt_kind.numpy() == ptt.materials.K_REFRACTIVE
    assert lens.sum() == 2
    assert (table.opt_flags.numpy()[lens] & ptt.materials.F_SPLIT).all()
    kf = rows[:, kb.ROW_KIND]
    np.testing.assert_array_equal(np.mod(kf, 16.0) >= 8.0, lens)


def split_compare(got, want, pos, energy, split):
    """The primary's outputs and index through assert_lanes_equal, then
    the reflected branch: its energy within 1e-6 of the lane's, zero off
    the split lanes, and on the lanes that split (``split``) its direction
    within 1e-5 (tracer_tpu's kernel writes the reflection on every lane;
    the port zeroes it where no lane split)."""
    e_in = energy.numpy()
    g_se, g_sd = (a.numpy() for a in got[-2:])
    w_se, w_sd = want[-2:]
    assert_lanes_equal(got[:-2], want[:-2], pos, energy)
    assert (np.abs(g_se - w_se) <= 1e-6 * np.maximum(e_in, w_se)).all()
    assert (g_se[~split] == 0.0).all() and (g_sd[~split] == 0.0).all()
    assert np.abs(g_sd[split] - w_sd[split]).max() <= 1e-5
    return g_se, g_sd


@pytest.mark.parametrize("scene", ("lens", "tir"))
def test_k2_split_matches_tpu_kernel_interpret(monkeypatch, scene):
    """One tile through K2's refr_split mode against tracer_tpu's kernel.
    "lens": the split lens's rows, lanes drawn from config 6's source, a
    random half of them carried through one bounce (inside the glass or
    past it). "tir": a glass plate (n 1 | 1.5) in a 0.3/m absorbing
    ambient, lanes inside the glass at 50-80 degrees from either side
    (total internal reflection: the primary keeps nothing, the branch all
    of the attenuated energy) and lanes from the air at 0-60 degrees; 5%
    of the lanes dead."""
    kw = dict(bivar=False, one_sided=False, slope=False, refr_split=True)
    if scene == "lens":
        table, _, jt, _ = twins(split_lens)
        spec = bench_scene("6s", kb.TILE, "cpu")[2].pallas_spec
        pos, dirs, e, lanes = bench_lanes(table, spec, kb.TILE, 0.05, 5,
                                          "cpu")
        ri = lanes["ref_index"]
        modes = bench_modes(table, spec)
        kw.update(bivar=modes["bivar"], one_sided=modes["one_sided"],
                  slope=modes["slope"])
    else:
        table, _, jt, _ = twins(plates(
            (lambda G: G.rect_plate(4.0, 4.0),
             lambda M: M.refractive_homogenous(1.0, 1.5, single_ray=False),
             (0, 0, 0), "glass")))
        rng = np.random.default_rng(11)
        n = kb.TILE
        part = rng.integers(0, 3, n)
        xy = rng.uniform(-1.0, 1.0, (n, 2))
        pos = np.column_stack([xy, np.choose(part, [-0.5, 0.5, 0.5])])
        d = np.where((part == 0)[:, None],
                     cone_dirs(rng, n, 0.87, 1.4, True),
                     cone_dirs(rng, n, 0.87, 1.4, False))
        d = np.where((part == 2)[:, None], cone_dirs(rng, n, 0.0, 1.05,
                                                     False), d)
        ri = np.where(part == 2, 1.0, 1.5)
        e = np.where(rng.uniform(size=n) < 0.05, 0.0,
                     rng.uniform(0.5, 2.0, n))
        pos, dirs, e, ri = (torch.tensor(a, dtype=torch.float32)
                            for a in (pos, d, e, ri))
        kw["ambient_att"] = 0.3
    got = kb.bounce_reflect(kb.pack_rows(table), 7, pos, dirs, e,
                            table.groups, T_EPS, ref_index=ri, **kw)
    want = k2_interpret(monkeypatch, jt, 7, pos, dirs, e, ref_index=ri,
                        **kw)
    live = e.numpy() > 0
    kinds = table.opt_kind.numpy()[np.maximum(want[3], 0)]
    split = live & (want[3] >= 0) & (kinds == ptt.materials.K_REFRACTIVE)
    s_e, _ = split_compare(got, want, pos, e, split)
    assert split.sum() > 0.3 * kb.TILE
    assert (s_e[split] > 0.0).all()
    if scene == "tir":
        tir = split & (ri.numpy() == 1.5)
        assert tir.sum() > 1000
        # the primary keeps nothing, the branch the attenuated energy
        assert (got[2].numpy()[tir] == 0.0).all()
        dist = np.linalg.norm(got[0].numpy() - pos.numpy(), axis=1)
        np.testing.assert_allclose(
            s_e[tir], e.numpy()[tir] * np.exp(-0.3 * dist[tir]), rtol=1e-5)
        # every lane that split crossed the plate: its index changed
        assert (got[5].numpy()[split] != ri.numpy()[split]).all()


def test_split_energies_add_up():
    """A split at a glass plate (n 1 | 1.5) in a 0.2/m absorbing ambient:
    per lane the primary's and the branch's energies add up to the
    energy left after the medium, e exp(-0.2 t), to 1e-6; at normal
    incidence the branch takes R = 0.04 of it and leaves straight back;
    the surface absorbs nothing."""
    table, _, _, _ = twins(plates(
        (lambda G: G.rect_plate(4.0, 4.0),
         lambda M: M.refractive_homogenous(1.0, 1.5, single_ray=False),
         (0, 0, 0), "glass")))
    n = 512
    rng = np.random.default_rng(2)
    pos = np.column_stack([rng.uniform(-1.0, 1.0, (n, 2)),
                           rng.uniform(0.5, 2.0, n)])
    e = rng.uniform(0.5, 2.0, n)
    pos, e = (torch.tensor(a, dtype=torch.float32) for a in (pos, e))
    dirs = torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1)
    out = kb.bounce_reflect(kb.pack_rows(table), 3, pos, dirs, e,
                            table.groups, T_EPS, ref_index=torch.ones(n),
                            bivar=False, one_sided=False, slope=False,
                            ambient_att=0.2, refr_split=True)
    e_att = e.double() * torch.exp(-0.2 * pos[:, 2].double())
    total = out[2].double() + out[-2].double()
    assert ((total - e_att).abs() <= 1e-6 * e_att).all()
    np.testing.assert_allclose(out[-2] / total, 0.04, atol=1e-6)
    np.testing.assert_array_equal(out[-1].numpy(),
                                  np.tile([0.0, 0.0, 1.0], (n, 1)))
    assert (out[4] == 0.0).all() and (out[5] == 1.5).all()


# ---------------------------------------------------------------------------
# the overflow slots, on hand-made lanes
# ---------------------------------------------------------------------------

def lanes_bundle(n, **fields):
    """A float32 CPU bundle of ``n`` lanes with the given fields set."""
    b = ptt.RayBundle.create(torch.zeros((n, 3)), torch.tensor(
        [[0.0, 0.0, 1.0]]).repeat(n, 1), device="cpu")
    return b.replace(**{k: torch.as_tensor(v) for k, v in fields.items()})


def test_place_overflow_takes_the_free_lane():
    """Lane 1 is free and has a parked branch: the branch takes it (every
    ray field, alive, age = its age + 1) and leaves the slot empty. Lane 0
    is busy: its branch waits. Lanes 2 and 3 have none."""
    bundle = lanes_bundle(4, alive=[True, False, False, True],
                          energy=[1.0, 0.0, 0.0, 1.0])
    ovf = lanes_bundle(4, alive=[True, True, False, False],
                       energy=[0.3, 0.4, 0.0, 0.0],
                       pos=torch.arange(12.0).view(4, 3),
                       ref_index=[1.5, 1.5, 1.0, 1.0])
    age = torch.full((4,), 2, dtype=torch.int32)
    ovf_age = torch.tensor([3, 5, 0, 0], dtype=torch.int32)
    b, a, o = engine._place_overflow(bundle, age, ovf, ovf_age)
    assert b.alive.tolist() == [True, True, False, True]
    assert a.tolist() == [2, 6, 2, 2]
    assert b.energy.tolist() == pytest.approx([1.0, 0.4, 0.0, 1.0])
    assert b.pos[1].tolist() == [3.0, 4.0, 5.0]
    assert b.ref_index.tolist() == [1.0, 1.5, 1.0, 1.0]
    assert o.alive.tolist() == [True, False, False, False]
    assert o.energy.tolist() == pytest.approx([0.3, 0.0, 0.0, 0.0])


def test_merge_split_sums_and_culls():
    """This round's branches park: lane 1 (free slot) stores its branch at
    the hit point along s_dir with the incidence side's fields and its
    parent's age; lane 2's branch (1e-9 <= min_energy) is culled and
    accounted; on 20,000 lanes whose slot is occupied the two branches
    merge into their summed energy and the new one is kept on a share of
    them within 4 sigma of s_e / (e_ovf + s_e)."""
    n = 20_004
    ovf = lanes_bundle(n, alive=[True, False, False, False] + [True] * 20_000,
                       energy=[2.0, 0.0, 0.0, 0.0] + [0.3] * 20_000,
                       pos=torch.full((n, 3), -1.0))
    prev = lanes_bundle(n, ref_index=torch.full((n,), 1.5),
                        wavelength=torch.full((n,), 5e-7))
    s_mask = torch.ones(n, dtype=torch.bool)
    s_mask[3] = False
    s_e = torch.full((n,), 0.1)
    s_e[:4] = torch.tensor([1.0, 0.5, 1e-9, 0.0])
    s_dir = torch.tensor([[0.0, 1.0, 0.0]]).repeat(n, 1)
    rec = types.SimpleNamespace(split=(s_mask, torch.where(s_mask, s_e, 0.0),
                                       s_dir),
                                hit=torch.full((n, 3), 7.0))
    accum = TraceAccum.zeros(1, device="cpu")
    age_now = torch.full((n,), 4, dtype=torch.int32)
    ovf_age = torch.full((n,), 9, dtype=torch.int32)
    o, oa = engine._merge_split(ovf, ovf_age, prev, age_now, rec, accum,
                                1e-6, torch.Generator().manual_seed(0))
    assert float(accum.culled) == pytest.approx(1e-9)
    assert o.alive[:4].tolist() == [True, True, False, False]
    assert o.energy[:4].tolist() == pytest.approx([3.0, 0.5, 0.0, 0.0])
    assert o.pos[1].tolist() == [7.0, 7.0, 7.0]
    assert o.dir[1].tolist() == [0.0, 1.0, 0.0]
    assert (float(o.ref_index[1]), int(oa[1])) == (1.5, 4)
    assert o.wavelength[1].item() == pytest.approx(5e-7)
    # the merged lanes: summed energy, the new branch kept with
    # probability 0.1 / 0.4, with its age
    np.testing.assert_allclose(o.energy[4:].numpy(), 0.4, rtol=1e-6)
    took = (o.pos[4:, 0] == 7.0).numpy()
    assert (oa[4:].numpy()[took] == 4).all()
    assert (oa[4:].numpy()[~took] == 9).all()
    p = 0.25
    assert abs(took.mean() - p) <= 4 * np.sqrt(p * (1 - p) / len(took))


def test_overflow_age_cull():
    """A parked branch that would resume at the bounce budget
    (ovf_age + 1 >= max_path) is culled with its energy accounted; one
    bounce younger it stays."""
    ovf = lanes_bundle(3, alive=[True, True, False],
                       energy=[0.25, 0.5, 0.75])
    accum = TraceAccum.zeros(1, device="cpu")
    out = engine._cull_overflow(ovf, torch.tensor([18, 19, 19],
                                                  dtype=torch.int32),
                                20, accum)
    assert out.alive.tolist() == [True, False, False]
    assert float(accum.culled) == 0.5
    assert out.energy.tolist() == [0.25, 0.5, 0.75]


# ---------------------------------------------------------------------------
# the split stream against tracer_tpu
# ---------------------------------------------------------------------------

def glass_slab(pkg):
    """tests/test_engine.py:372's scene: a glass slab of two
    energy-splitting faces (z = 1 and 0.5) between an absorbing
    Lambertian floor and ceiling."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene

    def glass():
        return M.refractive_homogenous(1.0, 1.5, single_ray=False)
    return sc.Assembly([sc.AssembledObject([
        sc.Surface(G.rect_plate(8.0, 8.0), glass(), location=[0.0, 0.0, 1.0],
                   name="top"),
        sc.Surface(G.rect_plate(8.0, 8.0), glass(), location=[0.0, 0.0, 0.5],
                   name="bot"),
        sc.Surface(G.rect_plate(12.0, 12.0), M.lambertian(1.0),
                   name="floor"),
        sc.Surface(G.rect_plate(12.0, 12.0), M.lambertian(1.0),
                   location=[0.0, 0.0, 3.0],
                   rotation=sp.rotx(np.pi)[:3, :3], name="ceil")])]), ()


_ANG = 0.45
_D = [np.sin(_ANG), 0.0, -np.cos(_ANG)]
SLAB_BEAM = ([-2.0 * _D[0], 0.0, 2.0], _D, 1.0, 1e-3)


def port_source(n, beam):
    def source_fn(generator, device=None):
        return _disk(ptt, n, *beam, generator)
    source_fn.num_rays = n
    return source_fn


def jax_source(n, beam):
    def source_fn(key):
        return _disk(tracer_tpu, n, *beam, key)
    return source_fn


def jax_split_stream(build, beam, total, rounds, max_path, min_energy):
    """tracer_tpu's split stream (float32, its general path) of the scene
    ``build`` makes: (per-logical-surface fractions, rays emitted)."""
    asm, extra = build(tracer_tpu)
    jt, jmeta = tracer_tpu.compile_scene(asm, dtype=jnp.float32,
                                         extra_features=extra)
    acc, em, se = jax_engine.trace_streaming(
        jt, jax_source(SLAB, beam), jax.random.PRNGKey(3), total_rays=total,
        max_rounds=rounds, max_path=max_path, min_energy=min_energy)
    f = np.zeros(len(jmeta.names))
    np.add.at(f, np.asarray(jmeta.row_logical),
              np.asarray(acc.absorbed, np.float64))
    return f / float(se), int(em)


def port_split_stream(build, beam, total, rounds, max_path, min_energy):
    """The port's split stream (float32) of the same scene: (fractions,
    rays emitted, accum, source energy, meta)."""
    asm, extra = build(ptt)
    table, meta = ptt.compile_scene(asm, extra_features=extra, device="cpu")
    assert "split" in table.features
    acc, em, se = trace_streaming(
        table, port_source(SLAB, beam), torch.Generator().manual_seed(0),
        total, max_rounds=rounds, max_path=max_path, min_energy=min_energy)
    f = np.zeros(len(meta.names))
    np.add.at(f, meta.row_logical, acc.absorbed.double().numpy())
    return f / float(se), int(em), acc, se, meta


def test_glass_slab_split_stream_matches_jax():
    """The glass slab of tests/test_engine.py:372 on the port's split
    stream (float32, 8 slabs of 2 tiles): every surface within that
    test's atol 0.01 of tracer_tpu's host-stepped splitter
    (TracerEngine.ray_tracer, float64, 20,000 rays) and within 3 combined
    sigma of tracer_tpu's split stream; the floor takes the doubly
    transmitted beam, the ceiling the reflected branches; closure below
    1e-5, residual below 1e-6 of the source, the budget emitted."""
    total = 8 * SLAB
    f, em, acc, se, meta = port_split_stream(glass_slab, SLAB_BEAM, total,
                                             300, 30, 1e-7)
    assert em == total
    assert abs(energy_closure(acc, se)) < 1e-5
    assert float(acc.residual) < 1e-6 * float(se)
    asm, _ = glass_slab(tracer_tpu)
    jt, jmeta = tracer_tpu.compile_scene(asm, dtype=jnp.float64)
    beam = tracer_tpu.sources.disk_bundle(
        jax.random.PRNGKey(7), 20_000, center=SLAB_BEAM[0],
        direction=SLAB_BEAM[1], radius=1.0, ang_range=1e-3, flux=1000.0)
    res = jax_engine.TracerEngine(jt, jmeta).ray_tracer(
        beam, reps=30, key=jax.random.PRNGKey(8), min_energy=1e-7)
    f_host = res.absorbed_by_logical() / float(np.asarray(beam.energy).sum())
    assert f_host[meta.index_of("floor")] > 0.75
    assert f_host[meta.index_of("ceil")] > 0.02
    np.testing.assert_allclose(f, f_host, atol=0.01)
    q, jem = jax_split_stream(glass_slab, SLAB_BEAM, total, 300, 30, 1e-7)
    sig = np.sqrt(np.maximum(q * (1 - q), 1e-12) * (1 / em + 1 / jem))
    assert (np.abs(f - q) <= 3 * sig).all(), (f, q, sig)


LENS_BEAM = (BENCH[6]["center"], BENCH[6]["direction"], BENCH[6]["radius"],
             BENCH[6]["ang_range"])


def test_split_lens_matches_roulette_and_jax():
    """The split lens at 4 slabs of 2 tiles (max_path 20, the suite's
    round budget): the receiver's share within 2% of the roulette lens's
    on the port's megakernel (suite.py:351) and within 3 combined sigma of
    tracer_tpu's split stream; closure below 1e-5."""
    rounds = max_rounds("6s", 4)
    f, em, acc, se, meta = port_split_stream(split_lens, LENS_BEAM, TOTAL,
                                             rounds, 20, 1e-6)
    assert em == TOTAL
    assert abs(energy_closure(acc, se)) < 1e-5
    rec = meta.index_of("rec")
    table, rmeta, src = bench_scene(6, SLAB, "cpu")
    racc, rem, rse = trace_streaming(table, src,
                                     torch.Generator().manual_seed(1),
                                     TOTAL, max_rounds=max_rounds(6, 4),
                                     max_path=20)
    r = _frac(rmeta, racc.absorbed.double().numpy(), "rec") / float(rse)
    assert abs(f[rec] - r) < 0.02 * r, (f[rec], r)
    q, jem = jax_split_stream(split_lens, LENS_BEAM, TOTAL, rounds, 20, 1e-6)
    sig = np.sqrt(q[rec] * (1 - q[rec]) * (1 / em + 1 / jem))
    assert abs(f[rec] - q[rec]) <= 3 * sig, (f[rec], q[rec], sig)
    assert 0.75 < f[rec] < 0.98


def test_split_stream_culls_second_reflections():
    """At the energy a ray of the bench's 700,416-lane slab (4.5e-5 W),
    the split lens's second reflections carry R^2 ~ 0.0016 of a ray,
    below min_energy 1e-6: the merge culls them with their energy
    accounted (0.2-0.4% of the source), and the receiver reads lower than
    with min_energy 1e-12, which culls nothing, by less than the culled
    share (the allowance chip_smoke.py's split-stream guard makes against
    the roulette lens); both close to 1e-5."""
    table, meta, _ = bench_scene("6s", SLAB, "cpu")
    rec = meta.row_logical == meta.index_of("rec")
    flux = 1000.0 * SLAB / 700_416
    beam = LENS_BEAM
    out = {}
    for min_energy in (1e-6, 1e-12):
        def source_fn(generator, device=None):
            return ptt.sources.disk_bundle(generator, SLAB, *beam,
                                           flux=flux, device="cpu")
        source_fn.num_rays = SLAB
        acc, em, se = trace_streaming(
            table, source_fn, torch.Generator().manual_seed(0), 8 * SLAB,
            max_rounds=200, max_path=20, min_energy=min_energy)
        assert abs(energy_closure(acc, se)) < 1e-5
        out[min_energy] = (acc.absorbed.double().numpy()[rec].sum()
                           / float(se), float(acc.culled) / float(se))
    (r_cut, culled), (r_all, none) = out[1e-6], out[1e-12]
    assert 0.002 < culled < 0.004 and none < 1e-6
    assert 0.0 < r_all - r_cut < culled


# ---------------------------------------------------------------------------
# the dispatch
# ---------------------------------------------------------------------------

def test_split_scene_with_spec_takes_the_general_path(monkeypatch):
    """The split lens under config 6's source with its spec streams on the
    general path (the megakernel would roulette its faces), which runs
    K2's refr_split bounce every round."""
    table, meta, source_fn = bench_scene("6s", SLAB, "cpu")
    assert getattr(source_fn, "pallas_spec", None) is not None

    def refuse(*args, **kw):
        raise AssertionError("the megakernel took a split scene")
    calls = []
    general = engine._trace_streaming_general
    splits = []
    fused = engine._bounce_step_fused

    def count(*args, **kw):
        calls.append(1)
        return general(*args, **kw)

    def step(*args, **kw):
        out = fused(*args, **kw)
        splits.append(out[2].split is not None)
        return out
    monkeypatch.setattr(engine, "_trace_streaming_megakernel", refuse)
    monkeypatch.setattr(engine, "_trace_streaming_general", count)
    monkeypatch.setattr(engine, "_bounce_step_fused", step)
    acc, em, se = trace_streaming(table, source_fn,
                                  torch.Generator().manual_seed(2), SLAB,
                                  max_rounds=40, max_path=20)
    assert calls == [1] and splits and all(splits)
    assert int(em) == SLAB and abs(energy_closure(acc, se)) < 1e-5
    assert engine._media_for(table, source_fn.pallas_spec) is None


def test_split_refusals_name_a9():
    """Splitting scenes that K2 does not take, refused before the shade
    had its split mode, now trace: with volumetric media (a scattering
    sheet behind the splitting face) and with dispersive interfaces, on
    both sources, on the general path's unfused bounce (K3 and the shade,
    never K2's fused branch); every closure below 1e-5. The scattering
    sheet's fractions lie within 3 combined binomial sigma of tracer_tpu's
    trace_streaming. The host-stepped ray_tracer splits the lens."""
    _, _, source_fn = bench_scene(6, SLAB, "cpu")

    def build(pkg, *optics):
        return pkg.Assembly([pkg.AssembledObject([
            pkg.Surface(pkg.geometry.round_plate(0.5), o, location=[0, 0, -i])
            for i, o in enumerate(optics)])])

    def volumetric_optics(pkg):
        M_ = pkg.materials
        return (M_.refractive_homogenous(1.0, 1.5, single_ray=False),
                M_.scattering_interface(0.3, att_inside=0.2),
                M_.lambertian(0.6))
    M = ptt.materials
    volumetric = ptt.compile_scene(build(ptt, *volumetric_optics(ptt)),
                                   device="cpu")[0]
    dispersive = ptt.compile_scene(build(ptt, M.refractive_material(
        1.0, ([4e-7, 7e-7], [1.6, 1.4]), single_ray=False)),
        device="cpu")[0]
    assert {"split", "volumetric"} <= set(volumetric.features)
    assert {"split", "dispersive"} <= set(dispersive.features)
    assert not engine._fused_ok(volumetric, split_mode=True)
    assert not engine._fused_ok(dispersive, split_mode=True)
    for table in (volumetric, dispersive):
        for src in (source_fn, without_spec(source_fn)):
            acc, em, se = trace_streaming(table, src,
                                          torch.Generator().manual_seed(1),
                                          TOTAL, max_rounds=80, max_path=20)
            assert int(em) == TOTAL
            assert abs(energy_closure(acc, se)) < 1e-5
            if table is volumetric and src is source_fn:
                p = acc.absorbed.double().numpy() / float(se)
                p = np.append(p, float(acc.medium) / float(se))
    jt, _ = tracer_tpu.compile_scene(
        build(tracer_tpu, *volumetric_optics(tracer_tpu)),
        dtype=jnp.float32)
    ja, jem, jse = jax_engine.trace_streaming(
        jt, jax_source(SLAB, LENS_BEAM), jax.random.PRNGKey(2),
        total_rays=TOTAL, max_rounds=80, max_path=20)
    q = np.append(np.asarray(ja.absorbed, np.float64),
                  float(ja.medium)) / float(jse)
    sig = np.sqrt(np.maximum(q * (1 - q), 1e-12)
                  * (1 / TOTAL + 1 / int(jem)))
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    assert p[-1] > 0.005 and p[2] > 0.1
    eng = TracerEngine(split_lens(ptt)[0], device="cpu")
    assert "split" in eng.scene.features
    res = eng.ray_tracer(_disk(ptt, 64, *LENS_BEAM, torch.Generator()))
    assert res.final.num_rays > 64
    assert abs(res.energy_balance()["closure"]) < 1e-5 * float(
        res.source.total_energy())
