"""The plain streaming megakernel (bench configs 1-3) against tracer_tpu on
the CPU:

* K2's plain version lane by lane against tracer_tpu's
  bounce_reflect_pallas in TPU interpret mode, in the deterministic modes:
  the MiniDish's rows (paraboloid with a z-range, rects) without
  regeneration or slope error, and config 3's spectral mirror in an
  attenuating medium;
* the random modes statistically: regenerated rays (positions uniform in
  r^2, directions within the pillbox cone, wavelengths uniform in the
  band, drawn at the traced pose) and the Lambertian lobe (mean cos 2/3);
* trace_streaming(culling=None) against tracer_tpu's trace_streaming (its
  jnp path) for configs 1-3 at a 2-tile slab: per-surface absorbed and
  medium fractions within 3 combined binomial sigma, closure 1e-5;
* the source specs, _spec_frame_split, from_sopra("AG") and the copied
  silver table equal to tracer_tpu's.

The kernel itself runs only on a GPU: tests/test_torch_gpu.py compares it
with its plain version there.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import engine as jax_engine
from tracer_tpu import optical_constants as jax_oc
from tracer_tpu import sources as jax_sources
from tracer_tpu.kernels.pallas_intersect import (
    bounce_reflect_pallas, pack_rows as jax_pack_rows)
from tracer_tpu.culling import build_block_culling as jax_build
from tracer_tpu.scene import compile_scene as jax_compile_scene
from tracer_tpu_torch import engine, optical_constants, sources
from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.models.bench_configs import (
    BENCH, BENCH_FLUX, bench_assembly, bench_scene, bench_spec, silver_table)
from test_torch_gpu import T_EPS, bench_lanes, bench_modes

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


def _jax_scene(cfg):
    asm, extra = bench_assembly(tracer_tpu, cfg)
    return jax_compile_scene(asm, dtype=jnp.float32, extra_features=extra)


def _jax_table(cfg):
    return _jax_scene(cfg)[0]


# ---------------------------------------------------------------------------
# K2's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cfg", (1, 3), ids=("minidish", "spectral"))
def test_k2_plain_matches_tpu_kernel_interpret(monkeypatch, cfg):
    """One tile of rays in flight (after a regenerating round, 5% dead):
    sid equal apart from ties (best and second-best t within 1e-5 of the
    scale) and at most one edge flip; on the other lanes hit points within
    1e-4 of the scene scale, directions within 1e-5, energies and absorbed
    energies within 1e-6 of the lane's energy, wavelengths exact."""
    table, _, source_fn = bench_scene(cfg, kb.TILE, "cpu")
    spec = source_fn.pallas_spec
    pos, dirs, e, lanes = bench_lanes(table, spec, kb.TILE, 0.05, 5, "cpu")
    wl = lanes["wavelength"]
    modes = bench_modes(table, spec)
    kw = dict(bivar=modes["bivar"], one_sided=modes["one_sided"],
              slope=False, lambertian=modes["lambertian"],
              ambient_att=modes["ambient_att"])
    rows = kb.pack_rows(table)
    got = kb.bounce_reflect(rows, 7, pos, dirs, e, table.groups, T_EPS,
                            wavelength=wl, spectral_tab=modes["spectral_tab"],
                            **kw)
    jt = _jax_table(cfg)
    assert jt.groups == table.groups
    spectral = wl is not None
    monkeypatch.setenv("TRACER_FORCE_PALLAS", "1")
    monkeypatch.setenv("TRACER_INTERPRET_PRNG", "1")
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(bounce_reflect_pallas(
            jax_pack_rows(jt), jnp.array([7], jnp.int32),
            jnp.asarray(pos.numpy()), jnp.asarray(dirs.numpy()),
            jnp.asarray(e.numpy()), jt.groups, T_EPS,
            wavelength=jnp.asarray(wl.numpy()) if spectral else None,
            spectral_tab=(jnp.asarray(modes["spectral_tab"].numpy())
                          if spectral else None), **kw))
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    t1, t2 = (a.numpy() for a in kn.nearest_two_t(rows, pos, dirs,
                                                  table.groups, T_EPS))
    scale = 1.0 + float(np.abs(pos.numpy()).max())
    with np.errstate(invalid="ignore"):                    # inf - inf
        tie = np.isfinite(t2) & ((t2 - t1) <= 1e-5 * (scale + t1))
    live = e.numpy() > 0
    same = got[3] == want[3]
    assert (~same & ~tie).sum() <= 1
    ok = same & ~tie
    assert (got[3][ok & live] >= 0).mean() > 0.5
    assert (np.abs(got[0] - want[0])[ok] <= 1e-4 * scale).all()
    assert (np.abs(got[1] - want[1])[ok] <= 1e-5).all()
    # energies relative to the lane's own: the absorbed share is a
    # difference (e_att - e_out), and XLA's and PyTorch's float32 exp
    # differ in the last bit
    e_in = e.numpy()
    for k in (2, 4):
        assert (np.abs(got[k] - want[k])[ok]
                <= 1e-6 * np.maximum(e_in, np.abs(want[k]))[ok]).all(), k
    # every group takes hits
    for start, end, _, _ in table.groups:
        assert ((got[3] >= start) & (got[3] < end) & live).sum() > 100
    if spectral:
        np.testing.assert_array_equal(got[5], want[5])
        # the spectral rows absorb a wavelength-dependent share
        mirror = (table.opt_kind.numpy() == 5)[np.maximum(got[3], 0)] \
            & (got[3] >= 0) & live
        frac = got[4][mirror] / e.numpy()[mirror]
        assert frac.max() - frac.min() > 0.01


# ---------------------------------------------------------------------------
# the random modes, statistically
# ---------------------------------------------------------------------------

def _within(x, mean, n_sigma=4.0):
    """|mean(x) - mean| within n_sigma standard errors of x's mean."""
    x = np.asarray(x, np.float64)
    se = x.std() / np.sqrt(len(x))
    assert abs(x.mean() - mean) <= n_sigma * se, (x.mean(), mean, se)


@pytest.mark.parametrize("cfg", (1, 3), ids=("pillbox", "buie_band"))
def test_regeneration_statistics(cfg):
    """Dead lanes of three tiles regenerate at the traced pose: positions
    on the source disc uniform in r^2, energy e_ray, directions within the
    pillbox cone (sin^2 of the angle uniform up to sin^2 ang_range) or, for
    the Buie source, 98% within the solar disc; wavelengths uniform in the
    band. The scene's one plate lies off the beam, so every lane comes
    out as it regenerated."""
    n = 3 * kb.TILE
    G, M, sp = ptt.geometry, ptt.materials, ptt.spatial
    plate = ptt.Surface(G.rect_plate(0.1, 0.1), M.absorber(),
                        location=[100.0, 0.0, 0.0])
    table, _ = ptt.compile_scene(ptt.Assembly([ptt.AssembledObject([plate])]),
                                 device="cpu")
    spec = bench_spec(ptt, cfg, n)
    spec_c, frame = engine._spec_frame_split(spec)
    z = torch.zeros((n, 3))
    wl = torch.zeros(n) if cfg == 3 else None
    out = kb.bounce_reflect(kb.pack_rows(table), 3, z, z, torch.zeros(n),
                            table.groups, T_EPS, source_spec=spec_c,
                            regen=True, wavelength=wl,
                            spectral_tab=torch.zeros((2, 2)),
                            src_frame=torch.tensor(frame))
    assert (out[3] == -1).all()
    torch.testing.assert_close(out[2], torch.full((n,), spec[5]),
                               rtol=1e-6, atol=0)
    c = BENCH[cfg]
    rot = np.asarray(spec[3]).reshape(3, 3)
    local = (out[0].double().numpy() - c["center"]) @ rot   # source frame
    assert np.abs(local[:, 2]).max() < 1e-5 * c["radius"]
    r2 = (local[:, :2] ** 2).sum(1) / c["radius"] ** 2
    assert r2.max() <= 1.0 + 1e-5
    _within(r2, 0.5)
    _within(r2 < 0.25, 0.25)
    d = out[1].double().numpy()
    sin2 = ((np.cross(d, c["direction"]) ** 2).sum(1)
            / (d ** 2).sum(1))                  # of the angle to the axis
    if cfg == 1:
        s2 = np.sin(c["ang_range"]) ** 2
        assert sin2.max() <= s2 * (1.0 + 1e-3)
        _within(sin2 / s2, 0.5)
    else:
        assert (sin2 <= np.sin(4.65e-3) ** 2 * (1.0 + 1e-3)).mean() > 0.95
        lo, hi = spec[13]
        w = out[5].double().numpy()
        assert lo <= w.min() and w.max() <= hi
        _within((w - lo) / (hi - lo), 0.5)


def test_lambertian_lobe():
    """Rays shot straight up at config 2's Lambertian absorber (0.1 m,
    facing down, ang_range pi/2) leave cosine-weighted about its normal:
    mean cos = 2/3 within 4 sigma, every one into the lower hemisphere,
    with 0.1 of their energy; the dish's slope error does not touch them."""
    n = 3 * kb.TILE
    table, _, source_fn = bench_scene(2, n, "cpu")
    rng = np.random.default_rng(11)
    r = 0.09 * np.sqrt(rng.uniform(size=n))
    a = rng.uniform(0.0, 2.0 * np.pi, n)
    pos = torch.tensor(np.stack([r * np.cos(a), r * np.sin(a),
                                 np.full(n, 1.0)], 1), dtype=torch.float32)
    dirs = torch.zeros((n, 3))
    dirs[:, 2] = 1.0
    e = torch.ones(n)
    modes = bench_modes(table, source_fn.pallas_spec)
    out = kb.bounce_reflect(kb.pack_rows(table), 9, pos, dirs, e,
                            table.groups, T_EPS, **modes)
    lam_row = int(np.nonzero(table.opt_kind.numpy()
                             == ptt.materials.K_LAMBERTIAN)[0][0])
    assert (out[3] == lam_row).all()
    cos = -out[1][:, 2].double().numpy()
    assert cos.min() > 0.0
    _within(cos, 2.0 / 3.0)
    torch.testing.assert_close(out[2], torch.full((n,), 0.1), rtol=1e-6,
                               atol=0)


# ---------------------------------------------------------------------------
# the whole path: trace_streaming(culling=None) against tracer_tpu
# ---------------------------------------------------------------------------

def _jax_source(cfg):
    c = BENCH[cfg]

    def source_fn(key):
        if cfg != 3:
            b = jax_sources.disk_bundle(key, SLAB, center=c["center"],
                                        direction=c["direction"],
                                        radius=c["radius"],
                                        ang_range=c["ang_range"],
                                        flux=BENCH_FLUX)
        else:
            k1, k2 = jax.random.split(key)
            b = jax_sources.buie_sunshape(k1, SLAB, center=c["center"],
                                          direction=c["direction"],
                                          radius=c["radius"], CSR=c["csr"],
                                          flux=BENCH_FLUX)
            wls = silver_table(tracer_tpu)[0]
            wl = jax.random.uniform(k2, (SLAB,), minval=float(wls[0]),
                                    maxval=float(wls[-1]))
            b = b.replace(wavelength=wl, att_coeff=jnp.full((SLAB,), c["att"]))
        return jax.tree.map(lambda x: x.astype(jnp.float32)
                            if jnp.issubdtype(x.dtype, jnp.floating) else x, b)

    source_fn.pallas_spec = bench_spec(tracer_tpu, cfg, SLAB)
    return source_fn


@pytest.mark.parametrize("cfg", (1, 2, 3), ids=("minidish", "slope_dish",
                                                "spectral_buie"))
def test_trace_streaming_matches_jax(cfg):
    """Per-surface absorbed fractions and the medium's share within 3
    combined binomial sigma of tracer_tpu's, closure 1e-5, full emission;
    config 1 also fills the receiver's 50x50 flux map with the receiver's
    energy."""
    table, meta, source_fn = bench_scene(cfg, SLAB, "cpu")
    max_path = BENCH[cfg]["max_path"]
    fluxspecs = ((flux_plan(meta, "receiver", resolution=50),) if cfg == 1
                 else ())
    accum, emitted, source_e = trace_streaming(
        table, source_fn, torch.Generator().manual_seed(0), TOTAL,
        max_rounds=4 * 4 + 80, max_path=max_path, fluxspecs=fluxspecs)
    assert TOTAL <= int(emitted) <= TOTAL + SLAB
    assert abs(energy_closure(accum, source_e)) < 1e-5
    if fluxspecs:
        rec = float(accum.absorbed[fluxspecs[0].rows[0]])
        assert accum.flux[0].shape == (50, 50)
        assert abs(float(accum.flux[0].double().sum()) - rec) < 1e-5 * rec
    ja, jem, jse = jax_engine.trace_streaming(
        _jax_table(cfg), _jax_source(cfg), jax.random.PRNGKey(0),
        total_rays=TOTAL, max_rounds=4 * 4 + 80, max_path=max_path)
    p = np.append(accum.absorbed.double().numpy(), float(accum.medium)) \
        / float(source_e)
    q = np.append(np.asarray(ja.absorbed, np.float64), float(ja.medium)) \
        / float(jse)
    n_p, n_q = int(emitted), int(jem)
    sig = np.sqrt(np.maximum(q * (1 - q), 1e-12) * (1 / n_p + 1 / n_q))
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    assert p[:-1].max() > 0.05
    if cfg == 3:
        assert p[-1] > 0.05
    else:
        assert p[-1] == 0.0


def test_unported_streaming_modes_raise():
    """The culling layout of a two-rank mesh build equals tracer_tpu's;
    a float64 plate streams on the general path within 3 combined sigma
    of tracer_tpu's float64 trace_streaming, closing to 1e-9 (the
    modes once refused); K2's refr_split needs ref_index
    (ValueError, as tracer_tpu asserts); mixed IAM exponents trace on the
    general path's unfused bounce, closing to 1e-5; a cullable scene
    traces culled, with aureole parking too, an energy-splitting scene on
    the general path, single-ray refraction, the spec's HG medium and the
    stage (d) kinds on the plain megakernel."""
    table, meta, source_fn = bench_scene(2, SLAB, "cpu")
    G, M = ptt.geometry, ptt.materials

    def scene(optics, dtype=torch.float32):
        plate = ptt.Surface(G.round_plate(0.5), optics)
        return ptt.compile_scene(
            ptt.Assembly([ptt.AssembledObject([plate])]), dtype=dtype,
            device="cpu")[0]
    split = scene(M.refractive_homogenous(1.0, 1.5, single_ray=False))
    acc, emitted, se = trace_streaming(split, source_fn, torch.Generator(),
                                       SLAB, max_rounds=8, max_path=4)
    assert int(emitted) == SLAB
    assert abs(energy_closure(acc, se)) < 1e-5
    z = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="ref_index"):
        kb.bounce_reflect(kb.pack_rows(split), 1, z, z, torch.ones(4),
                          split.groups, T_EPS, refr_split=True)
    mixed = ptt.compile_scene(ptt.Assembly([ptt.AssembledObject([
        ptt.Surface(G.round_plate(0.5), M.iam(M.reflective(0.1), 1.0, c=c),
                    location=[0.0, 0.0, c]) for c in (1.0, 2.0)])]),
        device="cpu")[0]
    acc, emitted, se = trace_streaming(mixed, source_fn, torch.Generator(),
                                       SLAB, max_rounds=8, max_path=4)
    assert int(emitted) == SLAB
    assert abs(energy_closure(acc, se)) < 1e-5
    # config 2's dish and Lambertian absorber are cullable ...
    culling = build_block_culling(table, meta, source_fn.pallas_spec, SLAB)
    acc, emitted, _ = trace_streaming(table, source_fn, torch.Generator(),
                                      SLAB, max_rounds=8, max_path=4,
                                      culling=culling)
    assert int(emitted) == SLAB
    # ... with K1's aureole parking on too, and in tracer_tpu's mesh
    # layout
    parked = dataclasses.replace(culling)
    object.__setattr__(parked, "park_aureole", True)
    acc, emitted, se = trace_streaming(table, source_fn, torch.Generator(),
                                       SLAB, max_rounds=8, max_path=4,
                                       culling=parked)
    assert int(emitted) == SLAB
    assert abs(energy_closure(acc, se)) < 1e-5
    mesh = build_block_culling(table, meta, source_fn.pallas_spec, SLAB,
                               mesh_devices=2)
    jmesh = jax_build(*_jax_scene(2), bench_spec(tracer_tpu, 2, SLAB), SLAB,
                      mesh_devices=2)
    for name in ("lists", "counts", "cell_bounds", "cell_of_block",
                 "age_caps"):
        np.testing.assert_array_equal(getattr(mesh, name),
                                      getattr(jmesh, name), err_msg=name)
    assert mesh.mesh_devices == jmesh.mesh_devices == 2
    assert mesh.stats["mesh_n_seg"] == jmesh.stats["mesh_n_seg"]
    acc, emitted, se = trace_streaming(scene(M.reflective(0.1), torch.float64),
                                       source_fn,
                                       torch.Generator().manual_seed(3),
                                       SLAB, max_rounds=8, max_path=4)
    assert acc.absorbed.dtype == torch.float64 and int(emitted) == SLAB
    assert abs(energy_closure(acc, se)) < 1e-9
    jplate = jax_compile_scene(tracer_tpu.Assembly([tracer_tpu.AssembledObject(
        [tracer_tpu.Surface(tracer_tpu.geometry.round_plate(0.5),
                            tracer_tpu.materials.reflective(0.1))])]),
        dtype=jnp.float64)[0]
    c = BENCH[2]
    ja, jem, jse = jax_engine.trace_streaming(
        jplate, lambda key: jax_sources.disk_bundle(
            key, SLAB, center=c["center"], direction=c["direction"],
            radius=c["radius"], ang_range=c["ang_range"], flux=BENCH_FLUX),
        jax.random.PRNGKey(3), total_rays=SLAB, max_rounds=8, max_path=4)
    p = np.append(acc.absorbed.numpy(), float(acc.escaped)) / float(se)
    q = np.append(np.asarray(ja.absorbed), float(ja.escaped)) / float(jse)
    sig = np.sqrt(q * (1 - q) * (1 / int(emitted) + 1 / int(jem)))
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    assert p[0] > 0.005
    # a Cook-Torrance plate takes the plain megakernel (stage d)
    acc, emitted, _ = trace_streaming(
        scene(M.bdrf_cook_torrance(0.3, 1.2, 7.0, 0.9)), source_fn,
        torch.Generator(), SLAB, max_rounds=4, max_path=4)
    assert int(emitted) == SLAB
    # a refractive scene and config 8's HG spec take the plain megakernel
    lens = scene(M.refractive_homogenous(1.0, 1.5))
    acc, emitted, _ = trace_streaming(lens, source_fn, torch.Generator(),
                                      SLAB, max_rounds=4, max_path=4)
    assert int(emitted) == SLAB
    _, _, hg_source = bench_scene(8, SLAB, "cpu")
    kb.source_params(hg_source.pallas_spec)


# ---------------------------------------------------------------------------
# host pieces equal to tracer_tpu's
# ---------------------------------------------------------------------------

def test_source_specs_equal_jax():
    c = BENCH[1]
    args = (SLAB, c["center"], c["direction"], 3.0, 0.005, 1000.0)
    assert sources.disk_pillbox_pallas_spec(*args) \
        == jax_sources.disk_pillbox_pallas_spec(*args)
    kw = dict(wl_band=(4e-7, 2e-6), ambient_att=0.3)
    assert sources.disk_pillbox_pallas_spec(*args, **kw) \
        == jax_sources.disk_pillbox_pallas_spec(*args, **kw)
    assert bench_spec(ptt, 3, SLAB) == bench_spec(tracer_tpu, 3, SLAB)
    spec = bench_spec(ptt, 3, SLAB)
    assert spec[13] is not None and spec[14] == 0.3
    # the band rides the kernels' parameter block
    p = kb.source_params(engine._spec_frame_split(spec)[0])
    np.testing.assert_array_equal(p[30:33], np.float32([1.0, *spec[13]]))
    assert not p[kb.SP_RECT]


@pytest.mark.parametrize("cfg", (1, 3))
def test_spec_frame_split_equals_jax(cfg):
    spec = bench_spec(ptt, cfg, SLAB)
    spec_c, frame = engine._spec_frame_split(spec)
    jspec_c, jframe = jax_engine._spec_frame_split(
        bench_spec(tracer_tpu, cfg, SLAB))
    assert spec_c == jspec_c
    assert frame.dtype == np.float32
    np.testing.assert_array_equal(frame, np.asarray(jframe))


def test_silver_table_equals_jax():
    here = pathlib.Path(optical_constants.__file__).parent / "data" / "nk"
    there = pathlib.Path(jax_oc.__file__).parent / "data" / "nk"
    assert (here / "AG.txt").read_bytes() == (there / "AG.txt").read_bytes()
    mine, theirs = optical_constants.from_sopra("AG"), \
        jax_oc.from_sopra("AG")
    assert (mine.l_min, mine.l_max) == (theirs.l_min, theirs.l_max)
    wls = np.linspace(mine.l_min, mine.l_max, 200)
    np.testing.assert_array_equal(mine.m(wls), theirs.m(wls))
    for pkg in (ptt, tracer_tpu):
        wls, ab = silver_table(pkg)
        assert ((0.0 < ab) & (ab < 0.5)).all() and len(wls) == 32
