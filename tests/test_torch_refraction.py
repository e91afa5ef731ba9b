"""K2's refractive interfaces (stage c) against tracer_tpu on the CPU:

* the SphericalLens model's compiled rows equal tracer_tpu's (a constant
  index and an explicit (wavelength, n) table);
* K2's plain version lane by lane against tracer_tpu's
  bounce_reflect_pallas in TPU interpret mode on the lanes whose outcome
  does not depend on the roulette's draw: total internal reflection
  (R = 1) and index-matched interfaces (R = 0); the two PRNGs differ, so
  the random lanes are held statistically;
* statistics with 4-sigma bounds: the reflected share against the
  analytic Fresnel R at 0 and 60 degrees (and Snell on the crossing
  lanes), a frosted interface's spread against tracer_tpu's host-stepped
  oracle, a dispersive interface's 25/75 strip split;
* trace_streaming(culling=None) for bench config 6 (the spherical lens)
  against tracer_tpu's trace_streaming.

The CUDA kernel runs only on a GPU: tests/test_torch_gpu.py and
tests/test_torch_emulated.py hold it against the same plain version.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import engine as jax_engine
from tracer_tpu import sources as jax_sources
from tracer_tpu.kernels.pallas_intersect import (
    bounce_reflect_pallas, pack_rows as jax_pack_rows)
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.models.bench_configs import (
    BENCH, bench_assembly, bench_scene, bench_spec, max_rounds)
from test_torch_gpu import T_EPS

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


def twins(build):
    """(port table, port meta, tracer_tpu table, tracer_tpu meta) of the
    float32 scene ``build(pkg)`` returns as (assembly, extra features)."""
    asm, extra = build(ptt)
    table, meta = ptt.compile_scene(asm, extra_features=extra, device="cpu")
    jasm, jextra = build(tracer_tpu)
    jt, jmeta = tracer_tpu.compile_scene(jasm, dtype=jnp.float32,
                                         extra_features=jextra)
    return table, meta, jt, jmeta


def plates(*surfaces):
    """The ``build(pkg)`` of one assembled object of (geometry, optics,
    location, name) surfaces, for twins."""
    def build(pkg):
        G, M = pkg.geometry, pkg.materials
        return pkg.Assembly([pkg.AssembledObject([
            pkg.Surface(geom(G), optics(M), location=list(loc), name=name)
            for geom, optics, loc, name in surfaces])]), ()
    return build


def k2_interpret(monkeypatch, jt, seed, pos, dirs, energy, **kw):
    """tracer_tpu's bounce_reflect_pallas in TPU interpret mode on the same
    inputs (tensors go over as numpy); returns its outputs as numpy."""
    monkeypatch.setenv("TRACER_FORCE_PALLAS", "1")
    monkeypatch.setenv("TRACER_INTERPRET_PRNG", "1")
    conv = {k: jnp.asarray(v.numpy()) if torch.is_tensor(v) else v
            for k, v in kw.items()}
    with pltpu.force_tpu_interpret_mode():
        out = jax.block_until_ready(bounce_reflect_pallas(
            jax_pack_rows(jt), jnp.array([seed], jnp.int32),
            jnp.asarray(pos.numpy()), jnp.asarray(dirs.numpy()),
            jnp.asarray(energy.numpy()), jt.groups, T_EPS, **conv))
    return [np.asarray(a) for a in out]


def cone_dirs(rng, n, th_lo, th_hi, up: bool):
    """n unit directions at a polar angle uniform in [th_lo, th_hi] from
    +z (up) or -z, azimuth uniform."""
    th = rng.uniform(th_lo, th_hi, n)
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  np.cos(th)], axis=1)
    return d if up else d * [1.0, 1.0, -1.0]


def assert_lanes_equal(got, want, pos, energy):
    """Deterministic lanes of the two versions: sid and the lane outputs
    equal, points within 1e-4 of the scene scale, directions within 1e-5,
    energies within 1e-6 of the lane's (XLA's and PyTorch's float32 exp
    differ in the last bit)."""
    got = [a.numpy() for a in got]
    scale = 1.0 + float(np.abs(pos.numpy()).max())
    np.testing.assert_array_equal(got[3], want[3])
    assert np.abs(got[0] - want[0]).max() <= 1e-4 * scale
    assert np.abs(got[1] - want[1]).max() <= 1e-5
    e_in = energy.numpy()
    for k in (2, 4):
        assert (np.abs(got[k] - want[k])
                <= 1e-6 * np.maximum(e_in, np.abs(want[k]))).all(), k
    for k in range(5, len(got)):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=0)
    return got


# ---------------------------------------------------------------------------
# the lens model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", ("constant", "table"))
def test_spherical_lens_rows_equal_jax(index):
    """The port's SphericalLens compiles to tracer_tpu's rows: frames,
    quadrics, apertures, optics and the dispersive faces' n(wl) table;
    the focal lengths agree."""
    refr = (1.5 if index == "constant"
            else ([4e-7, 5.5e-7, 7e-7], [1.53, 1.51, 1.50]))
    lenses = {}

    def build(pkg):
        model = importlib.import_module(f"{pkg.__name__}.models."
                                        "spherical_lens")
        lens = model.SphericalLens(diameter=0.5, depth=0.02, R1=0.3,
                                   R2=-0.3, refr_idx=refr)
        lenses[pkg.__name__] = lens
        return pkg.Assembly([lens]), ()
    table, _, jt, _ = twins(build)
    for name in ("frame", "quadric", "ap_type", "ap_params", "opt_kind",
                 "opt_flags", "opt_params", "spectral_wl", "spectral_ab"):
        np.testing.assert_array_equal(getattr(table, name).numpy(),
                                      np.asarray(getattr(jt, name)), name)
    assert (table.groups, table.kinds_present, table.features) \
        == (jt.groups, jt.kinds_present, jt.features)
    mine, theirs = lenses["tracer_tpu_torch"], lenses["tracer_tpu"]
    assert mine.focal_length() == theirs.focal_length()
    if index == "table":
        assert "dispersive" in table.features
        assert mine.focal_length(5e-7) == theirs.focal_length(5e-7)


# ---------------------------------------------------------------------------
# K2's plain version against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------

def test_k2_refraction_matches_tpu_kernel_interpret(monkeypatch):
    """One tile against a glass plate (n 1 | 1.5) at z = 0 and an
    index-matched plate (1.3 | 1.3) at z = -1: lanes inside the glass at
    50-80 degrees from either side reflect totally (R = 1), lanes of index
    1.3 cross the matched plate undeflected (R = 0); 5% of lanes dead.
    Every lane agrees with tracer_tpu's kernel: sid, point, direction,
    energy, absorbed and index."""
    table, _, jt, _ = twins(plates(
        (lambda G: G.rect_plate(4.0, 4.0),
         lambda M: M.refractive_homogenous(1.0, 1.5), (0, 0, 0), "glass"),
        (lambda G: G.rect_plate(4.0, 4.0),
         lambda M: M.refractive_homogenous(1.3, 1.3), (0, 0, -1), "matched")))
    rng = np.random.default_rng(3)
    n = kb.TILE
    part = rng.integers(0, 4, n)
    xy = rng.uniform(-1.0, 1.0, (n, 2))
    z0 = np.choose(part, [-0.5, 0.5, -0.5, -1.5])
    pos = np.column_stack([xy, z0])
    d = np.where((part == 0)[:, None], cone_dirs(rng, n, 0.87, 1.4, True),
                 cone_dirs(rng, n, 0.87, 1.4, False))
    d = np.where((part == 2)[:, None], cone_dirs(rng, n, 0.0, 1.2, False), d)
    d = np.where((part == 3)[:, None], cone_dirs(rng, n, 0.0, 1.2, True), d)
    ri = np.where(part >= 2, 1.3, 1.5)
    e = np.where(rng.uniform(size=n) < 0.05, 0.0, rng.uniform(0.5, 2.0, n))
    pos, dirs, e, ri = (torch.tensor(a, dtype=torch.float32)
                        for a in (pos, d, e, ri))
    kw = dict(bivar=False, one_sided=False, slope=False)
    got = kb.bounce_reflect(kb.pack_rows(table), 7, pos, dirs, e,
                            table.groups, T_EPS, ref_index=ri, **kw)
    want = k2_interpret(monkeypatch, jt, 7, pos, dirs, e, ref_index=ri,
                        **kw)
    got = assert_lanes_equal(got, want, pos, e)
    sid, live = got[3], e.numpy() > 0
    glass = int(np.nonzero(table.opt_params[:, 1].numpy() == 1.5)[0][0])
    tir = live & (sid == glass)
    crossed = live & (sid >= 0) & (sid != glass)
    assert tir.sum() > 800 and crossed.sum() > 800
    # total internal reflection turns d_z over; the matched plate does not
    np.testing.assert_allclose(got[1][tir, 2], -dirs.numpy()[tir, 2],
                               atol=1e-6)
    np.testing.assert_allclose(got[1][crossed], dirs.numpy()[crossed],
                               atol=1e-6)
    np.testing.assert_array_equal(got[5][live & (sid >= 0)],
                                  ri.numpy()[live & (sid >= 0)])


# ---------------------------------------------------------------------------
# the random lanes, statistically
# ---------------------------------------------------------------------------

def _within(x, mean, n_sigma=4.0):
    """|mean(x) - mean| within n_sigma standard errors of x's mean."""
    x = np.asarray(x, np.float64)
    se = x.std() / np.sqrt(len(x))
    assert abs(x.mean() - mean) <= n_sigma * se, (x.mean(), mean, se)


def fresnel_r(theta, n):
    """Unpolarized Fresnel reflectance from air into index n at the
    incidence angle theta."""
    ci = np.cos(theta)
    ct = np.sqrt(1.0 - (np.sin(theta) / n) ** 2)
    rs = (ci - n * ct) / (ci + n * ct)
    rp = (ct - n * ci) / (ct + n * ci)
    return 0.5 * (rs * rs + rp * rp)


@pytest.mark.parametrize("deg", (0.0, 60.0))
def test_fresnel_share_and_snell(deg):
    """Three tiles of lanes from air onto glass (n 1.5) at one incidence
    angle: the reflected share within 4 sigma of the analytic Fresnel R;
    reflected lanes keep index 1 and mirror d_z, crossing lanes take index
    1.5 and leave at Snell's angle."""
    table, _, _, _ = twins(plates(
        (lambda G: G.rect_plate(4.0, 4.0),
         lambda M: M.refractive_homogenous(1.0, 1.5), (0, 0, 0), "glass")))
    n = 3 * kb.TILE
    th = np.radians(deg)
    rng = np.random.default_rng(int(deg))
    # aimed at the plate's centre region
    pos = np.column_stack([rng.uniform(-0.5, 0.5, (n, 2)), np.ones(n)])
    pos[:, 0] -= np.tan(th)
    d = np.tile([np.sin(th), 0.0, -np.cos(th)], (n, 1))
    pos, dirs = (torch.tensor(a, dtype=torch.float32) for a in (pos, d))
    out = kb.bounce_reflect(kb.pack_rows(table), 13, pos, dirs,
                            torch.ones(n), table.groups, T_EPS,
                            ref_index=torch.ones(n), bivar=False,
                            one_sided=False, slope=False)
    assert (out[3] == 0).all()
    nd, ri = out[1].double().numpy(), out[5].numpy()
    refl = nd[:, 2] > 0.0
    _within(refl, fresnel_r(th, 1.5))
    assert (ri[refl] == 1.0).all() and (ri[~refl] == 1.5).all()
    np.testing.assert_allclose(nd[refl, 2], np.cos(th), atol=1e-6)
    sin_t = np.hypot(nd[~refl, 0], nd[~refl, 1])
    np.testing.assert_allclose(1.5 * sin_t, np.sin(th), atol=1e-5)
    # no interface absorption: roulette keeps the full energy
    np.testing.assert_array_equal(out[2].numpy(), 1.0)


def _frac(meta, f, name):
    return f[np.nonzero(np.asarray(meta.row_logical)
                        == meta.index_of(name))[0]].sum()


def _disk(pkg, n, center, direction, radius, ang, key_or_gen, **kw):
    """A float32 pillbox disk bundle of either package."""
    if pkg is tracer_tpu:
        b = jax_sources.disk_bundle(key_or_gen, n, center=center,
                                    direction=direction, radius=radius,
                                    ang_range=ang, flux=1000.0)
        return jax.tree.map(lambda x: x.astype(jnp.float32)
                            if jnp.issubdtype(x.dtype, jnp.floating) else x,
                            b)
    return ptt.sources.disk_bundle(key_or_gen, n, center, direction, radius,
                                   ang, flux=1000.0, device="cpu")


def _port_source(n, center, direction, radius, ang, **spec_kw):
    def source_fn(generator, device=None):
        return _disk(ptt, n, center, direction, radius, ang, generator)
    source_fn.pallas_spec = ptt.sources.disk_pillbox_pallas_spec(
        n, center, direction, radius, ang, 1000.0, **spec_kw)
    source_fn.num_rays = n
    return source_fn


def test_frosted_spread_matches_jax_oracle():
    """A vertical beam through frosted glass (sigma 0.05) onto a small
    deep target (tests/test_interpret_megakernel.py:784): the port's
    plain megakernel puts the same share on the target as tracer_tpu's
    host-stepped oracle, within 4 combined binomial sigma, and far less
    than the specular ~96%."""
    table, meta, jt, jmeta = twins(plates(
        (lambda G: G.rect_plate(4.0, 4.0),
         lambda M: M.refractive_homogenous(1.0, 1.5, sigma=0.05), (0, 0, 0),
         "iface"),
        (lambda G: G.round_plate(0.1),
         lambda M: M.absorber(one_sided=False), (0, 0, -10.0), "target")))
    assert "refractive_slope" in table.features
    beam = ([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], 0.02, 1e-5)
    b = _disk(tracer_tpu, kb.TILE, *beam, jax.random.PRNGKey(1))
    res = jax_engine.TracerEngine(jt, jmeta).ray_tracer(
        b, reps=6, key=jax.random.PRNGKey(2),
        opts=jax_engine.TraceOptions(max_bounces=6, record=False))
    t0 = _frac(jmeta, np.asarray(res.accum.absorbed), "target") \
        / float(np.asarray(b.energy).sum())
    acc, em, se = trace_streaming(
        table, _port_source(SLAB, *beam), torch.Generator().manual_seed(0),
        TOTAL, max_rounds=40, max_path=6)
    assert abs(energy_closure(acc, se)) < 1e-5
    t1 = _frac(meta, acc.absorbed.double().numpy(), "target") / float(se)
    sig = np.sqrt(t0 * (1 - t0) * (1 / kb.TILE + 1 / int(em)))
    assert 0.02 < t0 < 0.6
    assert abs(t1 - t0) <= 4 * sig, (t1, t0, sig)


def test_dispersive_strip_split():
    """An oblique beam (30 degrees) with a 400-700 nm band through an
    interface whose index falls linearly from 1.6 to 1.4
    (tests/test_interpret_megakernel.py:652): two floor strips straddling
    the n = 1.55 landing point take 25% and 75% of the refracted power
    (the mean-index fallback would give 0/100), within 4 sigma."""
    band = (400e-9, 700e-9)

    def landing(nn):
        return -2.0 * np.tan(np.arcsin(0.5 / nn))
    x_split = landing(1.55)
    x_hi, x_lo = landing(1.6) + 0.06, landing(1.4) - 0.06
    table, meta, _, _ = twins(plates(
        (lambda G: G.rect_plate(4.0, 4.0),
         lambda M: M.refractive_material(1.0, ([band[0], band[1]],
                                               [1.6, 1.4])),
         (0, 0, 0), "iface"),
        (lambda G: G.rect_plate(x_hi - x_split, 1.0),
         lambda M: M.absorber(one_sided=False),
         ((x_split + x_hi) / 2.0, 0.0, -2.0), "plate_a"),
        (lambda G: G.rect_plate(x_split - x_lo, 1.0),
         lambda M: M.absorber(one_sided=False),
         ((x_lo + x_split) / 2.0, 0.0, -2.0), "plate_b")))
    assert "dispersive" in table.features
    d = [-0.5, 0.0, -np.sqrt(3.0) / 2.0]
    src = _port_source(SLAB, [2.0 / np.sqrt(3.0), 0.0, 2.0], d, 0.01, 1e-4,
                       wl_band=band)
    acc, em, se = trace_streaming(table, src,
                                  torch.Generator().manual_seed(0),
                                  4 * TOTAL, max_rounds=60, max_path=6)
    assert abs(energy_closure(acc, se)) < 1e-5
    f = acc.absorbed.double().numpy() / float(se)
    a, b = _frac(meta, f, "plate_a"), _frac(meta, f, "plate_b")
    assert a + b > 0.85                      # ~5% Fresnel reflection
    n_ref = (a + b) * int(em)
    sig = np.sqrt(0.25 * 0.75 / n_ref)
    assert abs(a / (a + b) - 0.25) <= 4 * sig, (a / (a + b), sig)


# ---------------------------------------------------------------------------
# the whole path against tracer_tpu
# ---------------------------------------------------------------------------

def jax_bench_source(cfg):
    """tracer_tpu's source of bench config ``cfg`` (6, 8 or "8b") at SLAB
    lanes, with its pallas spec."""
    c = BENCH[cfg]

    def source_fn(key):
        b = _disk(tracer_tpu, SLAB, c["center"], c["direction"],
                  c["radius"], c["ang_range"], key)
        if cfg == 8:
            b = b.replace(att_coeff=jnp.full((SLAB,), c["att"], jnp.float32),
                          scat_coeff=jnp.full((SLAB,), c["scat"],
                                              jnp.float32),
                          scat_g=jnp.full((SLAB,), c["g"], jnp.float32))
        return b
    source_fn.pallas_spec = bench_spec(tracer_tpu, cfg, SLAB)
    return source_fn


def trace_matches_jax(cfg):
    """trace_streaming(culling=None) of bench config ``cfg`` on the port
    against tracer_tpu's trace_streaming (its jnp general path on the CPU)
    at SLAB lanes and TOTAL rays: per-surface absorbed fractions and the
    medium's share within 3 combined binomial sigma, closure 1e-5, full
    emission. Returns the port's fractions (surfaces, then medium) and
    its meta."""
    table, meta, source_fn = bench_scene(cfg, SLAB, "cpu")
    rounds = max_rounds(cfg, 4)
    max_path = BENCH[cfg]["max_path"]
    accum, emitted, source_e = trace_streaming(
        table, source_fn, torch.Generator().manual_seed(0), TOTAL,
        max_rounds=rounds, max_path=max_path)
    assert TOTAL <= int(emitted) <= TOTAL + SLAB
    assert abs(energy_closure(accum, source_e)) < 1e-5
    asm, extra = bench_assembly(tracer_tpu, cfg)
    jt = tracer_tpu.compile_scene(asm, dtype=jnp.float32,
                                  extra_features=extra)[0]
    ja, jem, jse = jax_engine.trace_streaming(
        jt, jax_bench_source(cfg), jax.random.PRNGKey(0), total_rays=TOTAL,
        max_rounds=rounds, max_path=max_path)
    p = np.append(accum.absorbed.double().numpy(), float(accum.medium)) \
        / float(source_e)
    q = np.append(np.asarray(ja.absorbed, np.float64), float(ja.medium)) \
        / float(jse)
    sig = np.sqrt(np.maximum(q * (1 - q), 1e-12)
                  * (1 / int(emitted) + 1 / int(jem)))
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)
    return p, meta


def test_lens_trace_matches_jax():
    """Bench config 6: fractions within 3 sigma of tracer_tpu's, and the
    receiver takes 0.75-0.98 of the source (the suite's guard)."""
    p, meta = trace_matches_jax(6)
    assert 0.75 < _frac(meta, p[:-1], "rec") < 0.98
    assert p[-1] == 0.0
