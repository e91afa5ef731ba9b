"""K2's participating media (stage c) against tracer_tpu on the CPU:

* K2's plain version in media mode lane by lane against tracer_tpu's
  bounce_reflect_pallas in TPU interpret mode, on index-matched
  absorbant_interface crossings (R = 0: every lane crosses, its medium id
  toggles and the medium it leaves attenuates the segment);
* HG scattering statistics with 4-sigma bounds: mean cos = g for g = 0.6
  and 0, mean free path = 1 / sigma_s;
* trace_streaming(culling=None) for bench configs 8 (ambient HG medium)
  and 8b (media bounded by scattering_interface sheets) against
  tracer_tpu's trace_streaming, and the analytic absorbing slab of
  tests/test_interpret_megakernel.py:1185;
* _bake_media's tables equal to tracer_tpu's, and scattered lanes
  (sid -2) kept out of the per-row sums and flux maps.
"""
import jax
import numpy as np
import pytest
import torch

import tracer_tpu_torch as ptt
from tracer_tpu import engine as jax_engine
from tracer_tpu_torch import engine
from tracer_tpu_torch.analysis import device_fluxmap as dfm
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.models.bench_configs import bench_assembly
from test_torch_gpu import T_EPS
from test_torch_refraction import (_frac, _port_source, _within,
                                   assert_lanes_equal, cone_dirs,
                                   k2_interpret, plates, trace_matches_jax,
                                   twins)

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_jit_caches():
    """The interpret-mode switches are read at trace time and are not part
    of the jit cache key: keep no trace made under them."""
    yield
    jax.clear_caches()


def _absorbing_slab(att_in=1.5):
    """Two absorbant_interface discs at z = 0.6 and 0.2 bounding an
    absorbing slab over an absorber plate at z = 0."""
    return plates(
        (lambda G: G.round_plate(1.0),
         lambda M: M.absorbant_interface(att_in), (0, 0, 0.6), "b1"),
        (lambda G: G.round_plate(1.0),
         lambda M: M.absorbant_interface(att_in), (0, 0, 0.2), "b2"),
        (lambda G: G.round_plate(1.0),
         lambda M: M.absorber(one_sided=False), (0, 0, 0.0), "plate"))


def test_k2_media_matches_tpu_kernel_interpret(monkeypatch):
    """One tile of lanes in the absorbing slab's two media (ids 0 and 1),
    from above, between the discs and from below, at up to 40 degrees:
    every lane crosses its disc (index-matched, R = 0), takes the other
    side's id, and loses exp(-att d) over the segment in its medium; 5% of
    lanes dead. Every lane agrees with tracer_tpu's kernel: sid, point,
    direction, energy, absorbed, index and medium id."""
    table, _, jt, _ = twins(_absorbing_slab())
    media = engine._bake_media(table, 0.0, 0.0, 0.0)
    assert media == jax_engine._bake_media(jt, 0.0, 0.0, 0.0)
    rng = np.random.default_rng(5)
    n = kb.TILE
    part = rng.integers(0, 3, n)           # above, inside, below the slab
    pos = np.column_stack([rng.uniform(-0.3, 0.3, (n, 2)),
                           np.choose(part, [1.0, 0.4, 0.1])])
    up = (part == 2) | ((part == 1) & (rng.uniform(size=n) < 0.5))
    d = np.where(up[:, None], cone_dirs(rng, n, 0.0, 0.7, True),
                 cone_dirs(rng, n, 0.0, 0.7, False))
    mid = (part == 1).astype(np.float64)
    e = np.where(rng.uniform(size=n) < 0.05, 0.0, rng.uniform(0.5, 2.0, n))
    pos, dirs, e, mid = (torch.tensor(a, dtype=torch.float32)
                         for a in (pos, d, e, mid))
    ri = torch.ones(n)
    kw = dict(bivar=False, one_sided=False, slope=False, ref_index=ri,
              medium_id=mid, media=media)
    got = kb.bounce_reflect(kb.pack_rows(table), 9, pos, dirs, e,
                            table.groups, T_EPS, **kw)
    want = k2_interpret(monkeypatch, jt, 9, pos, dirs, e, **kw)
    got = assert_lanes_equal(got, want, pos, e)
    live = e.numpy() > 0
    crossed = live & (got[3] >= 0) & (table.opt_kind.numpy()[
        np.maximum(got[3], 0)] == ptt.materials.K_REFRACTIVE)
    assert crossed.sum() > 1500
    np.testing.assert_array_equal(got[6][crossed], 1.0 - mid.numpy()[crossed])
    np.testing.assert_allclose(got[1][crossed], dirs.numpy()[crossed],
                               atol=1e-6)
    inside = crossed & (mid.numpy() == 1.0)
    t = np.linalg.norm(got[0] - pos.numpy(), axis=1)
    np.testing.assert_allclose(got[2][inside],
                               (e.numpy() * np.exp(-1.5 * t))[inside],
                               rtol=1e-5)


@pytest.mark.parametrize("g", (0.6, 0.0))
def test_hg_scattering_statistics(g):
    """Three tiles of lanes in an ambient medium (sigma_s 2/m, attenuation
    0.3/m) with nothing in reach: every live lane scatters (sid -2) at an
    exponential free path of mean 1/sigma_s, leaves at an HG angle of mean
    cos g, keeps its index, and carries exp(-att free) of its energy;
    none is absorbed."""
    table, _, _, _ = twins(plates(
        (lambda G: G.rect_plate(0.1, 0.1), lambda M: M.absorber(),
         (100.0, 0.0, 0.0), "far")))
    n = 3 * kb.TILE
    rng = np.random.default_rng(17)
    d = cone_dirs(rng, n, 0.0, np.pi, True)
    dirs = torch.tensor(d, dtype=torch.float32)
    pos = torch.zeros((n, 3))
    out = kb.bounce_reflect(kb.pack_rows(table), 21, pos, dirs, torch.ones(n),
                            table.groups, T_EPS, ref_index=torch.ones(n),
                            ambient_att=0.3, ambient_scat=2.0, ambient_g=g,
                            bivar=False, one_sided=False, slope=False)
    assert (out[3] == -2).all() and (out[4] == 0.0).all()
    free = out[0].double().norm(dim=1).numpy()
    _within(free, 0.5)
    cos = (out[1].double() * dirs.double()).sum(1).numpy()
    _within(cos, g)
    np.testing.assert_allclose(out[2].numpy(), np.exp(-0.3 * free),
                               rtol=1e-5)
    np.testing.assert_array_equal(out[5].numpy(), 1.0)
    # the lanes moved along their own direction
    np.testing.assert_allclose(out[0].numpy(), d * free[:, None],
                               atol=1e-5 * (1 + free.max()))


@pytest.mark.parametrize("cfg", (8, "8b"), ids=("ambient", "media_bounded"))
def test_volumetric_trace_matches_jax(cfg):
    """Bench configs 8 and 8b: fractions within 3 sigma of tracer_tpu's;
    the medium takes more than the suite's guard (0.1 and 0.05)."""
    p, _ = trace_matches_jax(cfg)
    assert p[-1] > (0.1 if cfg == 8 else 0.05)


def test_absorbing_slab_analytic():
    """A collimated beam through the 0.4 m absorbing slab (attenuation
    1.5/m) bounded by two index-matched absorbant_interface discs onto an
    absorber: the plate takes exp(-0.6) of the source and the medium the
    rest, within 2e-3 (tests/test_interpret_megakernel.py:1185)."""
    table, meta, _, _ = twins(_absorbing_slab())
    assert "volumetric" in table.features
    src = _port_source(kb.TILE, [0.0, 0.0, 1.2], [0.0, 0.0, -1.0], 0.3, 1e-5)
    acc, _, se = trace_streaming(table, src, torch.Generator().manual_seed(0),
                                 2 * kb.TILE, max_rounds=20, max_path=8)
    assert abs(energy_closure(acc, se)) < 1e-5
    expect = np.exp(-1.5 * 0.4)
    f = acc.absorbed.double().numpy() / float(se)
    assert abs(_frac(meta, f, "plate") - expect) < 2e-3
    assert abs(float(acc.medium) / float(se) - (1.0 - expect)) < 2e-3


def test_bake_media_equals_jax():
    """_bake_media's (media_tab, media_rows) equal tracer_tpu's for config
    8b's sheets under a spec ambient, including the dedup of a float64
    spec value against the scene's float32 rows."""
    table, _, jt, _ = twins(lambda pkg: bench_assembly(pkg, "8b"))
    for spec_medium in ((0.0, 0.0, 0.0), (0.15, 0.4, 0.6), (0.1, 0.0, 0.0)):
        mine = engine._bake_media(table, *spec_medium)
        assert mine == jax_engine._bake_media(jt, *spec_medium)
    # the sheets' inside medium is the float32 twin of (0.15, 0.4, 0.6):
    # a float64 ambient of the same values folds into it (id 0), and
    # their outside (clear) side becomes id 1
    tab, rows = engine._bake_media(table, 0.15, 0.4, 0.6)
    assert len(tab) == 2 and all(r[1:] == (1, 0) for r in rows)


def test_scattered_lanes_not_on_surfaces():
    """sid -2 (scattered, alive) adds nothing to the per-row sums (both
    the masked reduction of small scenes and the index_add_ of large
    ones) or to a flux map."""
    sid = torch.tensor([0, -2, 1, -1, -2, 0], dtype=torch.int32)
    vals = torch.tensor([1.0, 10.0, 2.0, 20.0, 30.0, 3.0])
    for n_rows in (2, 100):
        sums = engine._row_sums(sid, vals, n_rows)
        assert sums[:2].tolist() == [4.0, 2.0] and float(sums.sum()) == 6.0
    table, meta, _, _ = twins(plates(
        (lambda G: G.rect_plate(1.0, 1.0), lambda M: M.absorber(),
         (0, 0, 0), "rec")))
    spec = dfm.flux_plan(meta, "rec", resolution=4)
    flux = dfm.zeros_for((spec,), device="cpu")
    pts = torch.zeros((6, 3))
    dfm.accumulate(flux, (spec,), table, sid, pts, vals)
    assert float(flux[0].sum()) == 4.0
