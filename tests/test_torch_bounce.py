"""The port's bounce kernels' plain versions against tracer_tpu, on NSTTF
rows and rays aimed at heliostats (with misses, back-face hits and dead
lanes):

* K1's plain version lane by lane against tracer_tpu's culled Pallas
  kernel run in TPU interpret mode, deterministically (no slope error, no
  regeneration);
* K2's plain version lane by lane against tracer_tpu's jnp reference
  (intersect.nearest_hit + shade.shade) over all 219 rows;
* the slope-error spread of both plain versions against 2 sigma.

The kernels themselves run only on a GPU: tests/test_torch_gpu.py
compares them with their plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks import nsttf as jax_nsttf
from tracer_tpu.kernels.intersect import nearest_hit
from tracer_tpu.kernels.pallas_intersect import (
    bounce_reflect_culled_pallas, pack_rows as jax_pack_rows)
from tracer_tpu.kernels.shade import shade
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.models import nsttf
from test_torch_gpu import ACTIVE, T_EPS, TILES, tile_args
from test_torch_gpu import aimed_rays as _aimed_rays

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_jit_caches():
    """The interpret-mode switches are read at trace time and are not part
    of the jit cache key: keep no trace made under them."""
    yield
    jax.clear_caches()


_CACHE = {}


def _setup(sigma):
    """(jax table, port table, port meta, culling, spec) of the NSTTF
    scene with slope error ``sigma``, at bench.py's slab."""
    if sigma not in _CACHE:
        slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)
        jt, _, _ = jax_nsttf.build_scene(sigma=sigma, dtype=jnp.float32)
        pt, pm, pinfo = nsttf.build_scene(sigma=sigma, device="cpu")
        spec = nsttf.make_source_fn(pinfo, slab).pallas_spec
        _CACHE[sigma] = (jt, pt, pm, build_block_culling(pt, pm, spec, slab),
                         spec, pinfo)
    return _CACHE[sigma]


def _incidence_cos(rows, sid, dirs):
    """|cos| of each lane's incidence angle on its hit row (1 on misses)."""
    r = rows.numpy()[np.maximum(sid, 0)]
    c = np.abs((r[:, 6:9] * dirs).sum(1))
    return np.where(sid >= 0, c, 1.0)


def _assert_close(name, got, want, lanes=None):
    """rtol 1e-5 and atol 1e-5 (1 + |x|), |x| the largest component of the
    lane's vector: float32 rounding at meter scale. Hit points are
    compared on ``lanes`` only: at grazing incidence (|cos| < 0.01) the
    hit point's float32 rounding grows as 1 / |cos|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if lanes is not None:
        got, want = got[lanes], want[lanes]
    x = np.abs(want)
    if x.ndim == 2:
        x = x.max(axis=1, keepdims=True)
    bad = np.abs(got - want) > 1e-5 * np.abs(want) + 1e-5 * (1 + x)
    assert not bad.any(), (name, np.argwhere(bad)[:5], got[bad][:5],
                           want[bad][:5])


def test_culled_plain_matches_tpu_kernel_interpret(monkeypatch):
    jt, pt, pm, culling, spec, info = _setup(0.0)
    assert "slope_error" not in pt.features
    pos, dirs, e = _aimed_rays(pm, culling, info["sun"])
    lists, counts, cells, cb = tile_args(culling)
    nb = len(TILES)
    monkeypatch.setenv("TRACER_FORCE_PALLAS", "1")
    monkeypatch.setenv("TRACER_INTERPRET_PRNG", "1")
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(bounce_reflect_culled_pallas(
            jax_pack_rows(jt), jnp.asarray(lists), jnp.asarray(counts),
            jnp.asarray(cells), jnp.asarray(cb),
            jnp.array([7], jnp.int32), jnp.zeros((nb,), jnp.int32),
            jnp.asarray(ACTIVE, jnp.int32), jnp.asarray(pos),
            jnp.asarray(dirs), jnp.asarray(e), jt.groups,
            culling.group_offsets, T_EPS, bivar=False, one_sided=True,
            slope=False, source_spec=spec))
    got = kb.bounce_reflect_culled(
        kb.pack_rows(pt), torch.tensor(lists), torch.tensor(counts),
        torch.tensor(cells), torch.tensor(cb), 7,
        torch.zeros(nb, dtype=torch.int32),
        torch.tensor(ACTIVE, dtype=torch.int32), torch.tensor(pos),
        torch.tensor(dirs), torch.tensor(e), pt.groups,
        culling.group_offsets, T_EPS, bivar=False, one_sided=True,
        slope=False, source_spec=spec)
    sid_w, sid_g = np.asarray(want[3]), got[3].numpy()
    np.testing.assert_array_equal(sid_g, sid_w)
    traced = np.repeat(np.asarray(ACTIVE) != 0, kb.TILE)
    live = traced & (e > 0)
    # the rays hit front faces, back faces (killed) and nothing
    assert (sid_g[live] >= 0).mean() > 0.5 and (sid_g[live] < 0).any()
    assert ((np.asarray(want[2]) == 0) & (sid_w >= 0)).any()
    assert (sid_g[~traced] == -1).all()
    steep = _incidence_cos(kb.pack_rows(pt), sid_g, dirs) >= 0.01
    assert steep.mean() > 0.99
    _assert_close("pos", got[0].numpy(), np.asarray(want[0]), steep)
    for k, name in ((1, "dir"), (2, "energy"), (4, "absorbed")):
        _assert_close(name, got[k].numpy(), np.asarray(want[k]))


def test_plain_bounce_matches_jnp_reference():
    jt, pt, pm, culling, spec, info = _setup(0.0)
    pos, dirs, e = _aimed_rays(pm, culling, info["sun"], seed=1)
    got = kb.bounce_reflect(kb.pack_rows(pt), 3, torch.tensor(pos),
                            torch.tensor(dirs), torch.tensor(e), pt.groups,
                            T_EPS, bivar=False, one_sided=True, slope=False)
    jp, jd, je = jnp.asarray(pos), jnp.asarray(dirs), jnp.asarray(e)
    t, sid = nearest_hit(jt, jp, jd, t_eps=T_EPS, use_pallas=False)
    n = len(e)
    res = shade(jt, sid, t, jp, jd, je, jnp.zeros((n,), jnp.float32),
                jnp.ones((n,), jnp.float32), jax.random.PRNGKey(0))
    sid = np.asarray(sid)
    hit = sid >= 0
    live = e > 0
    np.testing.assert_array_equal(got[3].numpy(),
                                  np.where(hit & live, sid, -1))
    assert (hit & live).mean() > 0.5
    want = (np.where(hit[:, None], np.asarray(res.out_pos), pos),
            np.where(hit[:, None], np.asarray(res.out_dir), dirs),
            np.where(hit, np.asarray(res.out_energy), e),
            np.where(hit & live, np.asarray(res.absorbed), 0.0))
    steep = _incidence_cos(kb.pack_rows(pt), got[3].numpy(), dirs) >= 0.01
    assert steep.mean() > 0.99
    _assert_close("pos", got[0].numpy(), want[0], steep)
    for k, name in ((1, "dir"), (2, "energy"), (4, "absorbed")):
        _assert_close(name, got[k].numpy(), want[k if k < 4 else 3])


@pytest.mark.parametrize("which", ("culled", "plain"))
def test_slope_error_spread(which):
    """With bivariate slope error sigma, the reflected direction moves by
    dr with E|dr|^2 = 4 sigma^2 (1 + cos^2 theta_i): the plain versions'
    mean of |dr|^2 / (1 + cos^2) equals (2 sigma)^2 within 3 standard
    errors of its own estimate."""
    jt, pt, pm, culling, spec, info = _setup(1.5e-3)
    sigma = 1.5e-3
    pos, dirs, e = (torch.tensor(a) for a in
                    _aimed_rays(pm, culling, info["sun"], seed=2))
    rows = kb.pack_rows(pt)

    def run(slope):
        if which == "plain":
            return kb.bounce_reflect_ref(rows, 11, pos, dirs, e, pt.groups,
                                         T_EPS, bivar=True, slope=slope)
        lists, counts, cells, cb = (torch.tensor(a)
                                    for a in tile_args(culling))
        nb = len(TILES)
        return kb.bounce_reflect_culled_ref(
            rows, lists, counts, cells, cb, 11,
            torch.zeros(nb, dtype=torch.int32),
            torch.ones(nb, dtype=torch.int32), pos, dirs, e, pt.groups,
            culling.group_offsets, T_EPS, bivar=True, slope=slope,
            source_spec=spec)

    on, off = run(True), run(False)
    m = ((on[3] >= 0) & (on[3] == off[3])).numpy()
    r1, r0 = on[1].double().numpy()[m], off[1].double().numpy()[m]
    d = dirs.double().numpy()[m]
    cos2 = (1.0 - (d * r0).sum(1)) / 2.0        # d.r = 1 - 2 cos^2
    x = ((r1 - r0) ** 2).sum(1) / (1.0 + cos2)
    assert m.sum() > 4000
    se = x.std() / np.sqrt(len(x))
    assert abs(x.mean() - 4 * sigma ** 2) < 3 * se, (x.mean(), se)
