"""The host sources that feed the record path (pillbox and edge-ray
directions, edge-ray disks, tabulated sunshapes, single rays, square
grids, triangles and trapezoids, concatenated bundles) against
tracer_tpu's on the CPU: the deterministic ones exactly (positions,
directions, energies, the tabulated spec), the random ones by their
moments within 3 standard errors. The tabulated spec rides the disk
branch's polynomial slot: one plain-megakernel trace with it puts the
pillbox spec's share on config 1's receiver within 3 sigma."""
import math

import jax
import numpy as np
import pytest
import torch

from tracer_tpu import bundle as jbundle
from tracer_tpu import sources as jsrc
from tracer_tpu_torch import sources as psrc
from tracer_tpu_torch.bundle import FIELDS, concatenate_rays
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.models.bench_configs import BENCH, bench_scene

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

F64 = torch.float64
N = 40_000
# a profile near a Buie disk: flat to the solar disc's edge, a falling
# aureole
ANGLES = np.array([0.0, 2e-3, 4e-3, 4.65e-3, 6e-3, 1e-2])
INTEN = np.array([1.0, 0.98, 0.9, 0.8, 0.05, 0.01])
# a smooth limb-darkened disc the baked sampler fits
SMOOTH_TH = np.linspace(0.0, 4.65e-3, 12)
SMOOTH = 1.0 - 0.6 * (SMOOTH_TH / 4.65e-3) ** 2


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _close_means(a, b):
    """Column means of two samples within 3 combined standard errors."""
    a, b = np.atleast_2d(a.T).T, np.atleast_2d(b.T).T
    se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b)) + 1e-15
    assert (np.abs(a.mean(0) - b.mean(0)) <= 3 * se).all(), (
        a.mean(0), b.mean(0), se)


def test_deterministic_sources_equal_jax():
    got = psrc.single_ray_source([0.1, 0.2, 3.0], [0.0, 1.0, -1.0], 2.5,
                                 dtype=F64, device="cpu")
    want = jsrc.single_ray_source([0.1, 0.2, 3.0], [0.0, 1.0, -1.0], 2.5)
    got2 = psrc.regular_square_bundle(1000, [0.0, 1.0, 2.0],
                                      [0.0, 0.6, -0.8], 3.0, dtype=F64,
                                      device="cpu")
    want2 = jsrc.regular_square_bundle(1000, [0.0, 1.0, 2.0],
                                       [0.0, 0.6, -0.8], 3.0)
    for g, w in ((got, want), (got2, want2)):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(g, f).numpy(),
                                       np.asarray(getattr(w, f)),
                                       rtol=1e-12, atol=1e-15, err_msg=f)
    assert got2.num_rays == 31 ** 2


def test_tabulated_spec_equals_jax():
    kw = dict(wl_band=(4e-7, 8e-7), ambient_att=0.1)
    a = psrc.tabulated_sunshape_pallas_spec(4096, [0.0, 0.0, 3.0],
                                            [0.0, 0.0, -1.0], 1.0, SMOOTH_TH,
                                            SMOOTH, 1000.0, **kw)
    b = jsrc.tabulated_sunshape_pallas_spec(4096, [0.0, 0.0, 3.0],
                                            [0.0, 0.0, -1.0], 1.0, SMOOTH_TH,
                                            SMOOTH, 1000.0, **kw)
    assert len(a) == len(b) == 17
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            np.testing.assert_allclose(x, y, rtol=1e-9, atol=1e-15)
        else:
            assert x == y
    with pytest.raises(ValueError, match="fit_tol"):
        psrc.tabulated_sunshape_pallas_spec(
            4096, [0, 0, 3], [0, 0, -1], 1.0, [0.0, 1e-3, 1.001e-3, 0.5],
            [1.0, 1.0, 1e-6, 1e-6], 1000.0)
    with pytest.raises(ValueError, match="start at 0"):
        psrc.tabulated_sunshape_pallas_spec(4096, [0, 0, 3], [0, 0, -1],
                                            1.0, ANGLES + 1e-3, INTEN, 1.0)


def _polar(d):
    return np.arctan2(np.hypot(d[:, 0], d[:, 1]), d[:, 2])


@pytest.mark.parametrize("name", ("pillbox", "edge", "tabulated"))
def test_direction_samplers_match_jax(name):
    """The polar angle's first two moments and the azimuth's cosine and
    sine within 3 standard errors of tracer_tpu's; edge rays all at the
    exact angle."""
    if name == "pillbox":
        got = psrc.pillbox_sunshape_directions(_gen(), N, 0.05, F64, "cpu")
        want = jsrc.pillbox_sunshape_directions(jax.random.PRNGKey(0), N,
                                                0.05)
    elif name == "edge":
        got = psrc.edge_rays_directions(_gen(), N, 0.05, F64, "cpu")
        want = jsrc.edge_rays_directions(jax.random.PRNGKey(0), N, 0.05)
        np.testing.assert_allclose(_polar(got.numpy()), 0.05, rtol=1e-12)
    else:
        got = psrc.sunshape_to_ray_directions(_gen(), ANGLES, INTEN, N, F64,
                                              "cpu")
        want = jsrc.sunshape_to_ray_directions(jax.random.PRNGKey(0),
                                               ANGLES, INTEN, N)
    g, w = got.numpy(), np.asarray(want)
    np.testing.assert_allclose(np.linalg.norm(g, axis=1), 1.0, rtol=1e-12)
    th_g, th_w = _polar(g), _polar(w)
    assert th_g.max() <= (0.05 if name != "tabulated" else ANGLES[-1]) \
        * (1 + 1e-9)
    _close_means(np.stack([th_g, th_g ** 2, g[:, 0] / np.hypot(g[:, 0],
                                                                g[:, 1]),
                           g[:, 1] / np.hypot(g[:, 0], g[:, 1])], 1),
                 np.stack([th_w, th_w ** 2, w[:, 0] / np.hypot(w[:, 0],
                                                                w[:, 1]),
                           w[:, 1] / np.hypot(w[:, 0], w[:, 1])], 1))


@pytest.mark.parametrize("name", ("edge_bundle", "triangle", "trapezoid"))
def test_bundles_match_jax(name):
    """Energies exactly, positions and directions by their means and
    second moments; triangle points inside the triangle."""
    A, B, C = [0.0, 0.0, 1.0], [2.0, 0.0, 1.0], [1.5, 1.0, 1.2]
    if name == "edge_bundle":
        args = (N, [0.0, 1.0, 3.0], [0.0, 0.0, -1.0], 1.5, 0.02)
        got = psrc.edge_rays_bundle(_gen(), *args, flux=900.0,
                                    radius_in=0.3, dtype=F64, device="cpu")
        want = jsrc.edge_rays_bundle(jax.random.PRNGKey(0), *args,
                                     flux=900.0, radius_in=0.3)
    elif name == "triangle":
        got = psrc.triangular_bundle(_gen(), N, A, B, C, ang_range=0.1,
                                     flux=500.0, dtype=F64, device="cpu")
        want = jsrc.triangular_bundle(jax.random.PRNGKey(0), N, A, B, C,
                                      ang_range=0.1, flux=500.0)
    else:
        got = psrc.trapezoid_bundle(_gen(), N, A, B, C,
                                    direction=[0.0, 0.0, -1.0],
                                    ang_range=0.1, dtype=F64, device="cpu")
        want = jsrc.trapezoid_bundle(jax.random.PRNGKey(0), N, A, B, C,
                                     direction=[0.0, 0.0, -1.0],
                                     ang_range=0.1)
    assert got.num_rays == want.num_rays == N
    np.testing.assert_allclose(got.energy.numpy(), np.asarray(want.energy),
                               rtol=1e-12)
    gp, wp = got.pos.numpy(), np.asarray(want.pos)
    gd, wd = got.dir.numpy(), np.asarray(want.dir)
    _close_means(np.concatenate([gp, gp ** 2, gd], 1),
                 np.concatenate([wp, wp ** 2, wd], 1))
    if name == "triangle":
        # barycentric coordinates of every point in [0, 1]
        M = np.array([np.subtract(B, A), np.subtract(C, A)]).T
        lam = np.linalg.lstsq(M, (gp - A).T, rcond=None)[0]
        assert (lam > -1e-9).all() and (lam.sum(0) < 1 + 1e-9).all()


def test_concatenate_rays_equals_jax():
    parts = [psrc.single_ray_source([0, 0, i], [0, 0, -1], flux=i + 1.0,
                                    dtype=F64, device="cpu")
             for i in range(3)]
    jparts = [jsrc.single_ray_source([0, 0, i], [0, 0, -1], flux=i + 1.0)
              for i in range(3)]
    got = concatenate_rays(parts)
    want = jbundle.concatenate_rays(jparts)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), err_msg=f)
    assert torch.equal(parts[0].concat(parts[1]).energy,
                       torch.tensor([1.0, 2.0], dtype=F64))
    with pytest.raises(ValueError):
        concatenate_rays([])


def test_tabulated_spec_on_the_megakernel():
    """Config 1 (the MiniDish) with a tabulated pillbox profile of the
    same half-angle baked into the disk spec: K2's plain version draws it
    through the polynomial slot, and the receiver takes the pillbox
    spec's share within 3 combined binomial sigma."""
    slab = 2 * kb.TILE
    total = 4 * slab
    c = BENCH[1]
    table, meta, src = bench_scene(1, slab, "cpu")
    th = np.linspace(0.0, c["ang_range"], 9)
    tab = psrc.tabulated_sunshape_pallas_spec(
        slab, c["center"], c["direction"], c["radius"], th,
        np.ones_like(th), 1000.0)

    def tabulated(generator, device=None):
        return src(generator, device)
    tabulated.num_rays = slab
    tabulated.pallas_spec = tab
    rec = np.nonzero(meta.row_logical == meta.index_of("receiver"))[0]
    out = []
    for s in (src, tabulated):
        acc, em, se = trace_streaming(table, s, _gen(1), total,
                                      max_rounds=4 * 4 + 80, max_path=20)
        assert abs(energy_closure(acc, se)) < 1e-5
        out.append((float(acc.absorbed[rec].double().sum()) / float(se),
                    int(em)))
    (p, n_p), (q, n_q) = out
    assert abs(p - q) <= 3 * math.sqrt(q * (1 - q) * (1 / n_p + 1 / n_q))
    assert q > 0.5
