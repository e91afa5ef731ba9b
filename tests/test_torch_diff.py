"""Differentiable tracing on the port (tracer_tpu_torch.diff) against
tracer_tpu.diff and against central finite differences.

* parity: the same scene and beam, carried across with scene_from_jax and
  bundle_from_jax, through tracer_tpu's trace_diff + jax.grad and the
  port's trace_diff + torch.autograd.grad: config 9's dish (2 rows, the
  oracle's brute force) and a 51-row field (past the fast-winner gate: the
  winner from the nearest hit under no_grad, its distance recomputed), 2
  bounces, where no random draw reaches the loss, float64 on the CPU;
  the 51-row case again in float32 through K3's plain version;
* the finite-difference checks of tests/test_diff.py within the port, at
  that file's tolerances (the port's random streams are not jax.random's);
* checkpoint=True against checkpoint=False on a scene that draws random
  numbers every bounce;
* the double-where helpers' gradients and the functional scene edits.

tests/test_diff.py's vmap sweep has no counterpart (the port has no vmap);
its sharded gradient is tests/test_torch_parallel.py's, over
torch.distributed.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import diff as jdiff
from tracer_tpu.sources import disk_bundle as jax_disk_bundle
from tracer_tpu_torch import bundle_from_jax, diff, scene_from_jax
from tracer_tpu_torch.bundle import FIELDS
from tracer_tpu_torch.engine import FAST_WINNER_ROWS
from tracer_tpu_torch.kernels.intersect import _oracle_nearest, nearest_hit_aux
from tracer_tpu_torch.sources import disk_bundle

torch.set_num_threads(1)

F64 = torch.float64
TABLE = ("frame", "inv_frame", "quadric", "ap_type", "ap_params",
         "opt_kind", "opt_flags", "opt_params", "spectral_wl",
         "spectral_ab", "logical")
STATIC = ("groups", "kinds_present", "flags_present", "slope_flags_present",
          "features", "ambient_medium", "iam_c")


def _mods(pkg):
    return [importlib.import_module(f"{pkg.__name__}.{m}")
            for m in ("geometry", "materials", "spatial", "scene")]


def _compile(pkg, surfs, dtype, **kw):
    sc = _mods(pkg)[3]
    asm = sc.Assembly([sc.AssembledObject(surfs)])
    if pkg is ptt:
        return sc.compile_scene(asm, dtype=dtype, device="cpu", **kw)
    return sc.compile_scene(asm, dtype=dtype, **kw)


def _rows_of(meta, name):
    return np.nonzero(meta.row_logical == meta.index_of(name))[0]


def dish_surfaces(pkg, f0=2.0):
    """Config 9 (benchmarks/suite.py:569): a 2 m dish of focal length 2 m
    and a 0.5 m Lambertian receiver at its focus, facing it."""
    G, M, sp, sc = _mods(pkg)
    return [sc.Surface(G.parabolic_dish(2.0, f0), M.reflective(0.05),
                       name="dish"),
            sc.Surface(G.rect_plate(0.5, 0.5), M.lambertian(0.95),
                       location=[0.0, 0.0, f0],
                       rotation=sp.rotx(np.pi)[:3, :3], name="receiver")]


def field_surfaces(pkg):
    """tests/test_diff.py:545's field: 50 flat mirrors and a 30 m
    receiver 20 m above them, 51 rows."""
    G, M, sp, sc = _mods(pkg)
    rng = np.random.default_rng(11)
    surfs = []
    for i in range(50):
        x, y = rng.uniform(-6, 6, 2)
        surfs.append(sc.Surface(G.rect_plate(1.2, 1.2), M.reflective(0.1),
                                location=[x, y, 0.0], name=f"m{i}"))
    surfs.append(sc.Surface(G.rect_plate(30.0, 30.0), M.lambertian(0.9),
                            location=[0.0, 0.0, 20.0],
                            rotation=sp.rotx(np.pi)[:3, :3],
                            name="receiver"))
    return surfs


def mirror_receiver(pkg=ptt, sigma=0.0, dtype=F64):
    """tests/test_diff.py:21: a 45-degree flat mirror deflecting a
    downward beam onto a receiver plate at x = 6 facing it."""
    G, M, sp, sc = _mods(pkg)
    mirror = sc.Surface(G.rect_plate(3.0, 3.0),
                        M.reflective(absorptivity=0.1, sigma=sigma),
                        rotation=sp.roty(np.pi / 4)[:3, :3], name="mirror")
    recv = sc.Surface(G.rect_plate(8.0, 8.0), M.lambertian(absorptivity=0.9),
                      location=[6.0, 0.0, 0.0],
                      rotation=sp.roty(np.pi / 2)[:3, :3], name="receiver")
    return _compile(pkg, [mirror, recv], dtype)


def beam(n, seed=7, **kw):
    args = dict(center=[0.0, 0.0, 4.0], direction=[0.0, 0.0, -1.0],
                radius=0.8, ang_range=1e-4, flux=1000.0)
    args.update(kw)
    return disk_bundle(torch.Generator().manual_seed(seed), n, dtype=F64,
                       device="cpu", **args)


def value_and_grad(loss, x0):
    x = torch.tensor(x0, dtype=F64, requires_grad=True)
    v = loss(x)
    (g,) = torch.autograd.grad(v, x)
    assert torch.isfinite(g), g
    return float(v.detach()), float(g)


def central_fd(loss, x0, h):
    with torch.no_grad():
        return float((loss(torch.tensor(x0 + h, dtype=F64))
                      - loss(torch.tensor(x0 - h, dtype=F64))) / (2 * h))


def quadric(f):
    """The paraboloid z = r^2 / (4 f) as a differentiable 10-vector."""
    q = 1.0 / (4.0 * f)
    z = torch.zeros((), dtype=q.dtype)
    return torch.stack([q, q, z, z, z, z, z, z, z - 0.5, z])


def tilt(b, a):
    """The beam tilted by ``a`` about x (benchmarks/suite.py:658)."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=b.dir.dtype).expand_as(b.dir)
    d = b.dir + a * torch.linalg.cross(ex, b.dir, dim=1)
    return b.replace(dir=d / torch.linalg.norm(d, dim=1, keepdim=True))


# ---- parity with tracer_tpu ---------------------------------------------

def _jax_case(case):
    """(jax table, meta, jax beam, parameter, jax loss(x, table, beam)
    -> (loss, moments))."""
    if case == "dish":
        table, meta = _compile(tracer_tpu, dish_surfaces(tracer_tpu),
                               jnp.float64)
        d_rows = _rows_of(meta, "dish")
        b = jax_disk_bundle(jax.random.PRNGKey(5), 4096,
                            center=[0.0, 0.0, 5.0],
                            direction=[0.0, 0.0, -1.0], radius=0.95,
                            radius_in=0.45, ang_range=1e-4, flux=1000.0)

        def jloss(f, t, bb):
            q = 1.0 / (4.0 * f)
            quad = jnp.zeros((10,), jnp.float64).at[0].set(q).at[1].set(q) \
                .at[8].set(-0.5)
            t = jdiff.with_rows(t, d_rows, quadric=quad[None])
            _, mom = jdiff.trace_diff(t, bb, jax.random.PRNGKey(4),
                                      bounces=2)
            return jdiff.spot_rms(mom, _rows_of(meta, "receiver")), mom
        return table, meta, b, 1.7, jloss
    table, meta = _compile(tracer_tpu, field_surfaces(tracer_tpu),
                           jnp.float64)
    b = jax_disk_bundle(jax.random.PRNGKey(5), 4096, center=[0.0, 0.0, 8.0],
                        direction=[0.0, 0.0, -1.0], radius=7.0,
                        ang_range=1e-4, flux=1000.0)

    def jloss(a, t, bb):
        d = bb.dir + a * jnp.cross(jnp.array([1.0, 0.0, 0.0], jnp.float64),
                                   bb.dir)
        d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
        _, mom = jdiff.trace_diff(t, bb.replace(dir=d),
                                  jax.random.PRNGKey(9), bounces=2)
        return jdiff.spot_rms(mom, _rows_of(meta, "receiver")), mom
    return table, meta, b, 0.01, jloss


def _port_loss(case, meta, table, b, seed=4):
    if case == "dish":
        d_rows = _rows_of(meta, "dish")

        def loss(f):
            t = diff.with_rows(table, d_rows, quadric=quadric(f)[None])
            _, mom = diff.trace_diff(t, b, seed, bounces=2)
            return diff.spot_rms(mom, _rows_of(meta, "receiver")), mom
        return loss

    def loss(a):
        _, mom = diff.trace_diff(table, tilt(b, a.to(b.dir.dtype)), seed,
                                 bounces=2)
        return diff.spot_rms(mom, _rows_of(meta, "receiver")), mom
    return loss


def _carry(table, b, dtype):
    tn = {f: np.asarray(getattr(table, f)) for f in TABLE}
    tn.update({f: getattr(table, f) for f in STATIC})
    return (scene_from_jax(tn, device="cpu", dtype=dtype),
            bundle_from_jax({f: np.asarray(getattr(b, f)) for f in FIELDS},
                            device="cpu", dtype=dtype))


def _count_fast_winner(monkeypatch):
    from tracer_tpu_torch import engine
    calls = []
    real = engine._fast_winner

    def spy(*args, **kw):
        calls.append(args[1].pos.dtype)
        return real(*args, **kw)
    monkeypatch.setattr(engine, "_fast_winner", spy)
    return calls


@pytest.mark.parametrize("case", ("dish", "field51"))
def test_trace_diff_matches_tracer_tpu(case, monkeypatch):
    """Loss, gradient and every moment equal tracer_tpu's to rtol 1e-9;
    the dish takes the brute force, the 51-row field the fast winner."""
    table, meta, b, x0, jloss = _jax_case(case)
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(x0), table, b)
    pt, pb = _carry(table, b, F64)
    assert (pt.num_rows >= FAST_WINNER_ROWS) == (case == "field51")
    calls = _count_fast_winner(monkeypatch)
    x = torch.tensor(x0, dtype=F64, requires_grad=True)
    pl, pm = _port_loss(case, meta, pt, pb)(x)
    (pg,) = torch.autograd.grad(pl, x)
    assert len(calls) == (2 if case == "field51" else 0)
    np.testing.assert_allclose(float(pl.detach()), float(jl), rtol=1e-9)
    np.testing.assert_allclose(float(pg), float(jg), rtol=1e-9)
    assert abs(float(pg)) > 0.0
    for k in ("e_in", "absorbed", "m1", "m2"):
        a = np.asarray(getattr(jm, k))
        np.testing.assert_allclose(getattr(pm, k).detach().numpy(), a,
                                   rtol=1e-9, atol=1e-12 * np.abs(a).max(),
                                   err_msg=k)
    assert float(pm.absorbed.detach()[_rows_of(meta, "receiver")].sum()) > 0.0


def test_fast_winner_float32_matches_float64(monkeypatch):
    """The 51-row case in float32, its winners from K3's plain version
    under no_grad, against the float64 port. Tolerance: a float32 hit
    point carries ~2^-24 x 20 m ~ 1.2e-6 m of rounding against spot radii
    of metres (a relative error ~1e-6 a lane in r^2), and each float32
    sum of 4,096 lanes adds up to ~4,096 x 6e-8 = 2.4e-4 relative at
    worst, ~1e-5 typically; so rtol 1e-4 on the loss and 1e-3 on the
    gradient, and every lane's winner the same."""
    table, meta, b, x0, _ = _jax_case("field51")
    losses = {}
    for dt in (torch.float32, F64):
        pt, pb = _carry(table, b, dt)
        calls = _count_fast_winner(monkeypatch)
        x = torch.tensor(x0, dtype=F64, requires_grad=True)
        pl, pm = _port_loss("field51", meta, pt, pb)(x)
        (pg,) = torch.autograd.grad(pl, x)
        assert calls == [dt, dt]
        losses[dt] = (float(pl.detach()), float(pg),
                      pm.absorbed.detach().double().numpy())
    (l32, g32, a32), (l64, g64, a64) = losses[torch.float32], losses[F64]
    np.testing.assert_allclose(l32, l64, rtol=1e-4)
    np.testing.assert_allclose(g32, g64, rtol=1e-3)
    np.testing.assert_allclose(a32, a64, rtol=1e-4, atol=1e-4 * a64.max())


def test_nearest_hit_aux_force_jnp_is_the_oracle():
    """force_jnp no longer raises: it returns the oracle's hits and no
    aux, in float32 too (where K3 would serve the fast path)."""
    table, meta = mirror_receiver(dtype=torch.float32)
    b = beam(256).to("cpu")
    pos, d = b.pos.float(), b.dir.float()
    t, sid, aux = nearest_hit_aux(table, pos, d, force_jnp=True)
    t0, sid0 = _oracle_nearest(table, pos, d, 3e-4, 1e-6, 16)
    assert aux is None
    assert torch.equal(sid, sid0) and torch.equal(t, t0)
    assert int((sid >= 0).sum()) > 200


# ---- finite differences within the port (tests/test_diff.py) ------------

def _tilted(table, rows, a):
    n = torch.stack([torch.sin(a), torch.zeros_like(a), torch.cos(a)])
    return diff.with_rows(table, rows,
                          frame=diff.frame_to(n, torch.zeros(3, dtype=F64))
                          [None])


def test_tilt_gradient_matches_finite_difference():
    table, meta = mirror_receiver()
    m_rows, r_rows = _rows_of(meta, "mirror"), _rows_of(meta, "receiver")
    b = beam(2048)

    def loss(a):
        _, mom = diff.trace_diff(_tilted(table, m_rows, a), b, 3, bounces=3)
        return diff.spot_rms(mom, r_rows, center=(0.4, -0.3))

    a0 = np.pi / 4 + 0.02
    _, g = value_and_grad(loss, a0)
    np.testing.assert_allclose(g, central_fd(loss, a0, 1e-6), rtol=1e-5)


def test_focal_length_gradient_matches_finite_difference():
    table, meta = _compile(ptt, dish_surfaces(ptt), F64)
    d_rows, r_rows = _rows_of(meta, "dish"), _rows_of(meta, "receiver")
    b = disk_bundle(torch.Generator().manual_seed(5), 2048,
                    center=[0.0, 0.0, 5.0], direction=[0.0, 0.0, -1.0],
                    radius=0.95, radius_in=0.45, ang_range=1e-4, flux=1000.0,
                    dtype=F64, device="cpu")

    def loss(f):
        t = diff.with_rows(table, d_rows, quadric=quadric(f)[None])
        _, mom = diff.trace_diff(t, b, 4, bounces=3)
        return diff.spot_rms(mom, r_rows)

    v, g = value_and_grad(loss, 1.7)
    np.testing.assert_allclose(g, central_fd(loss, 1.7, 1e-6), rtol=1e-5)
    with torch.no_grad():
        assert v > float(loss(torch.tensor(2.0, dtype=F64)))


def test_absorptivity_gradient_is_incident_power():
    table, meta = mirror_receiver()
    r_rows = _rows_of(meta, "receiver")
    b = beam(2048)

    def absorbed(alpha):
        prm = table.opt_params[r_rows[0]]
        prm = torch.cat([alpha[None], prm[1:]])
        t = diff.with_rows(table, r_rows, opt_params=prm[None])
        _, mom = diff.trace_diff(t, b, 9, bounces=2)
        return mom.absorbed[r_rows].sum(), mom.e_in[r_rows].sum()

    a = torch.tensor(0.9, dtype=F64, requires_grad=True)
    p, e_in = absorbed(a)
    (g,) = torch.autograd.grad(p, a)
    np.testing.assert_allclose(float(g), float(e_in.detach()), rtol=1e-12)


def test_refractive_index_gradient_matches_finite_difference():
    G, M, sp, sc = _mods(ptt)
    iface = sc.Surface(G.rect_plate(10.0, 10.0),
                       M.refractive_homogenous(1.0, 1.5),
                       location=[0.0, 0.0, 1.0], name="iface")
    recv = sc.Surface(G.rect_plate(20.0, 20.0), M.lambertian(1.0),
                      name="receiver")
    table, meta = _compile(ptt, [iface, recv], F64)
    i_rows, r_rows = _rows_of(meta, "iface"), _rows_of(meta, "receiver")
    d = np.array([np.sin(0.5), 0.0, -np.cos(0.5)])
    b = beam(512, seed=21, center=[-2.0 * d[0], 0.0, 3.0], direction=d,
             radius=0.5)

    def centroid_x(n2):
        prm = table.opt_params[i_rows[0]]
        prm = torch.cat([prm[:1], n2[None], prm[2:]])
        t = diff.with_rows(table, i_rows, opt_params=prm[None])
        _, mom = diff.trace_diff(t, b, 22, bounces=3)
        return diff.spot_centroid(mom, r_rows)[0]

    _, g = value_and_grad(centroid_x, 1.5)
    fd = central_fd(centroid_x, 1.5, 1e-6)
    assert abs(fd) > 1e-4
    np.testing.assert_allclose(g, fd, rtol=1e-5)


def test_slope_error_sigma_gradient_matches_finite_difference():
    table, meta = mirror_receiver(sigma=2e-3)
    m_rows, r_rows = _rows_of(meta, "mirror"), _rows_of(meta, "receiver")
    b = beam(2048)

    def loss(sigma):
        prm = table.opt_params[m_rows[0]]
        prm = torch.cat([prm[:1], sigma[None], prm[2:]])
        t = diff.with_rows(table, m_rows, opt_params=prm[None])
        _, mom = diff.trace_diff(t, b, 31, bounces=3)
        return diff.spot_rms(mom, r_rows)

    _, g = value_and_grad(loss, 2e-3)
    assert g > 0.0
    np.testing.assert_allclose(g, central_fd(loss, 2e-3, 1e-7), rtol=1e-4)


def test_fluxmap_fit_recovers_aim():
    """The splat conserves energy, its gradient matches finite
    differences, and Adam on the map misfit against a map of another
    seed recovers the aim (tests/test_diff.py:245, torch.optim.Adam in
    place of optax.adam: the same update)."""
    table, meta = mirror_receiver()
    m_rows, r_rows = _rows_of(meta, "mirror"), _rows_of(meta, "receiver")
    spec = diff.DiffFluxSpec(rows=tuple(int(r) for r in r_rows),
                             xlim=(-4.0, 4.0), ylim=(-4.0, 4.0),
                             shape=(24, 24))
    b = beam(4096)

    def fluxmap(a, seed):
        _, mom, (grid,) = diff.trace_diff(_tilted(table, m_rows, a), b,
                                          seed, bounces=3, fluxspecs=(spec,))
        return grid, mom

    a_true = np.pi / 4 + 0.05
    with torch.no_grad():
        measured, mom_t = fluxmap(torch.tensor(a_true, dtype=F64), 40)
    np.testing.assert_allclose(float(measured.sum()),
                               float(mom_t.absorbed[r_rows].sum()),
                               rtol=1e-12)

    def loss(a):
        return ((fluxmap(a, 41)[0] - measured) ** 2).mean()

    a0 = np.pi / 4
    _, g = value_and_grad(loss, a0)
    np.testing.assert_allclose(g, central_fd(loss, a0, 1e-6), rtol=1e-3)
    a = torch.tensor(a0, dtype=F64, requires_grad=True)
    opt = torch.optim.Adam([a], lr=2e-3)
    for _ in range(120):
        opt.zero_grad()
        loss(a).backward()
        opt.step()
    assert abs(float(a) - a_true) < 2e-3


def test_checkpoint_matches_plain_gradient():
    """checkpoint=True equals checkpoint=False (tests/test_diff.py:327's
    tolerances) on a scene that draws random numbers every bounce: slope
    error on the mirror, Lambertian directions off the receiver; the
    recompute draws the same uniforms from its per-bounce generator. A
    torch.Generator as the seed gives the same trace as the int it
    yields."""
    table, meta = mirror_receiver(sigma=2e-3)
    m_rows, r_rows = _rows_of(meta, "mirror"), _rows_of(meta, "receiver")
    b = beam(256)

    def loss(a, ckpt, seed=51):
        _, mom = diff.trace_diff(_tilted(table, m_rows, a), b, seed,
                                 bounces=4, checkpoint=ckpt)
        return diff.spot_rms(mom, r_rows)

    a0 = np.pi / 4 + 0.01
    v0, g0 = value_and_grad(lambda a: loss(a, False), a0)
    v1, g1 = value_and_grad(lambda a: loss(a, True), a0)
    np.testing.assert_allclose(v0, v1, rtol=1e-14)
    np.testing.assert_allclose(g0, g1, rtol=1e-12)
    # the random draws do reach the loss: another seed moves it
    v2, _ = value_and_grad(lambda a: loss(a, True, seed=52), a0)
    assert abs(v2 - v0) > 1e-6 * abs(v0)
    seed = diff._base_seed(torch.Generator().manual_seed(3))
    v3, _ = value_and_grad(
        lambda a: loss(a, True, seed=torch.Generator().manual_seed(3)), a0)
    v4, _ = value_and_grad(lambda a: loss(a, False, seed=seed), a0)
    assert v3 == v4


def test_volumetric_medium_gradients_match_finite_difference():
    G, M, sp, sc = _mods(ptt)
    floor = sc.Surface(G.rect_plate(20.0, 20.0),
                       M.lambertian(absorptivity=1.0), name="floor")
    table, meta = _compile(ptt, [floor], F64,
                           extra_features=("volumetric",))
    r_rows = _rows_of(meta, "floor")
    b0 = beam(2048, seed=70, center=[0.0, 0.0, 3.0],
              direction=[0.2, 0.0, -1.0], radius=0.5, ang_range=1e-3)

    def medium_beam(att, scat, g):
        one = torch.ones_like(b0.energy)
        return b0.replace(att_coeff=att * one, scat_coeff=scat * one,
                          scat_g=g * one)

    def medium_loss(att):
        acc, _ = diff.trace_diff(table, medium_beam(att, 0.4, 0.5), 71,
                                 bounces=6)
        return acc.medium

    _, g = value_and_grad(medium_loss, 0.2)
    assert g > 0.0
    np.testing.assert_allclose(g, central_fd(medium_loss, 0.2, 1e-6),
                               rtol=1e-6)

    def spot(gg):
        _, mom = diff.trace_diff(table, medium_beam(0.1, 0.4, gg), 71,
                                 bounces=6)
        return diff.spot_rms(mom, r_rows)

    _, g = value_and_grad(spot, 0.5)
    np.testing.assert_allclose(g, central_fd(spot, 0.5, 1e-6), rtol=1e-5)


def test_source_direction_gradient():
    table, meta = mirror_receiver()
    r_rows = _rows_of(meta, "receiver")
    b = beam(1024)

    def centroid_x(t):
        d = torch.stack([torch.sin(t), torch.zeros_like(t), -torch.cos(t)])
        _, mom = diff.trace_diff(table, b.replace(dir=d.expand_as(b.dir)),
                                 13, bounces=3)
        return diff.spot_centroid(mom, r_rows)[0]

    _, g = value_and_grad(centroid_x, 0.03)
    np.testing.assert_allclose(g, central_fd(centroid_x, 0.03, 1e-6),
                               rtol=1e-6)


def test_multirow_fast_winner_gradient_matches_finite_difference(
        monkeypatch):
    table, meta = _compile(ptt, field_surfaces(ptt), F64)
    assert table.num_rows >= FAST_WINNER_ROWS
    r_rows = _rows_of(meta, "receiver")
    b = disk_bundle(torch.Generator().manual_seed(5), 4096,
                    center=[0.0, 0.0, 8.0], direction=[0.0, 0.0, -1.0],
                    radius=7.0, ang_range=1e-4, flux=1000.0, dtype=F64,
                    device="cpu")
    calls = _count_fast_winner(monkeypatch)

    def loss(a):
        _, mom = diff.trace_diff(table, tilt(b, a), 9, bounces=2)
        return diff.spot_rms(mom, r_rows)

    _, g = value_and_grad(loss, 0.01)
    assert len(calls) == 2
    np.testing.assert_allclose(g, central_fd(loss, 0.01, 1e-6), rtol=2e-4)


@pytest.mark.parametrize("nz", (1.0, -1.0))
def test_frame_to_z_axis_fallback(nz):
    fr = diff.frame_to(torch.tensor([0.0, 0.0, nz], dtype=F64),
                       torch.zeros(3, dtype=F64)).numpy()
    assert np.isfinite(fr).all()
    R = fr[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-14)
    np.testing.assert_allclose(R[:, 2], [0.0, 0.0, nz], atol=1e-14)


# ---- the helpers ------------------------------------------------------

def test_safe_sqrt_and_arccos_gradients_match_tracer_tpu():
    """Zero on the clamped lanes (no inf, no NaN downstream of a where),
    tracer_tpu's gradient everywhere else, the same forward values as
    the clamped forms."""
    from tracer_tpu import mathutils as jm
    from tracer_tpu_torch.mathutils import safe_arccos, safe_sqrt
    cases = ((safe_sqrt, jm.safe_sqrt,
              [-2.0, -1e-300, 0.0, 1e-12, 0.25, 4.0], (0, 1, 2)),
             (safe_arccos, jm.safe_arccos,
              [-1.5, -1.0, -0.999, 0.0, 0.5, 0.999999, 1.0, 3.0],
              (0, 1, 6, 7)))
    for fn, jfn, xs, clamped in cases:
        x = torch.tensor(xs, dtype=F64, requires_grad=True)
        y = fn(x)
        (g,) = torch.autograd.grad(y.sum(), x)
        jg = np.asarray(jax.vmap(jax.grad(jfn))(jnp.asarray(xs)))
        np.testing.assert_allclose(y.detach().numpy(),
                                   np.asarray(jfn(jnp.asarray(xs))),
                                   rtol=1e-15)
        # arccos' derivative near |c| = 1 cancels in 1 - c^2: the two
        # libraries' formulas agree there to ~1e-11
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-10)
        assert torch.isfinite(g).all()
        assert (g[list(clamped)] == 0.0).all()
    x = torch.tensor([-1.0, 0.0, 2.0], dtype=F64)
    assert torch.equal(safe_sqrt(x), torch.sqrt(x.clamp(min=0.0)))
    assert torch.equal(safe_arccos(x), torch.arccos(x.clamp(-1.0, 1.0)))


def test_with_rows_and_trace_diff_leave_the_callers_tensors_unchanged():
    table, meta = mirror_receiver(sigma=2e-3)
    m_rows = _rows_of(meta, "mirror")
    b = beam(256)
    keep_t = {f: getattr(table, f).clone() for f in TABLE}
    keep_b = {f: getattr(b, f).clone() for f in FIELDS}
    a = torch.tensor(0.8, dtype=F64, requires_grad=True)
    prm = table.opt_params[m_rows[0]] * 2.0
    quad = table.quadric[m_rows[0]] + 1e-3
    t = diff.with_rows(_tilted(table, m_rows, a), m_rows,
                       quadric=quad[None], opt_params=prm[None])
    acc, mom = diff.trace_diff(t, b, 1, bounces=3, checkpoint=True)
    (g,) = torch.autograd.grad(acc.absorbed.sum() + mom.m2.sum(), a)
    assert torch.isfinite(g)
    for f in TABLE:
        assert torch.equal(getattr(table, f), keep_t[f]), f
    for f in FIELDS:
        assert torch.equal(getattr(b, f), keep_b[f]), f
    r = int(m_rows[0])
    assert torch.equal(t.opt_params[r], prm.detach())
    assert torch.equal(t.quadric[r], quad)
    inv = t.frame[r].detach() @ t.inv_frame[r].detach()
    np.testing.assert_allclose(inv.numpy(), np.eye(4), atol=1e-14)
    others = [i for i in range(table.num_rows) if i != r]
    assert torch.equal(t.frame[others].detach(), table.frame[others])


def test_config9_and_9b_twins_run_small(monkeypatch):
    """The suite's configs 9 and 9b (models/bench_configs) at 4,096
    rays on the CPU: the warm-up's loss and gradient are the step's, 9b
    takes the fast winner twice a step (forward and the checkpoint's
    recompute) and config 9 never."""
    from tracer_tpu_torch.models.bench_configs import (
        config9_diff_gradient, config9b_diff_gradient_field,
        diff_gradient_step)
    calls = _count_fast_winner(monkeypatch)
    r9 = config9_diff_gradient(4096, device="cpu")
    assert calls == []
    loss, g = diff_gradient_step(4096, 3, device="cpu")[0](1.7)
    assert (r9["loss"], r9["grad"]) == (float(loss), float(g))
    assert r9["grad"] < 0.0 < r9["loss"] and len(r9["walls"]) == 3
    r9b = config9b_diff_gradient_field(4096, device="cpu")
    assert len(calls) == 2 * 2 * 4 and r9b["n_rows"] == 219
    assert np.isfinite(r9b["grad"]) and r9b["grad"] != 0.0
