"""The device flux map (analysis/device_fluxmap) of every kind and of
multi-row surfaces against the host histogram and tracer_tpu, on the CPU
(tests/test_device_fluxmap.py:83-188 are the counterparts):

* ``_uv`` equal to the host ``uv_project`` and to tracer_tpu's ``_uv``
  for every kind to 1e-12, and ``flux_plan`` equal to tracer_tpu's;
* trace_fused's map of a disc, a dish, a cylinder, a frustum and a
  sphere equal to the host histogram of the same rays' records
  (``ray_tracer``) to 1e-9 in float64, and to tracer_tpu's trace_fused on
  the same rays within its bfloat16 deposit rounding (each hit's energy
  rounded stochastically to 8 bits before binning: 2^-7 of a bin);
* the general streaming path's map summing to the absorbed energy, and
  equal to tracer_tpu's on the same slab within that rounding;
* the bifacial two-row plate summing into one map to 1e-6, and a surface
  of 24 tilted panels, each binned in its own row's frame, equal to the
  host histogram of its records and to tracer_tpu's map.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu.analysis import device_fluxmap as jax_dfm
from tracer_tpu.bundle import RayBundle as JaxBundle
from tracer_tpu.engine import trace_fused as jax_trace_fused
from tracer_tpu.engine import trace_streaming as jax_trace_streaming
from tracer_tpu_torch.analysis import device_fluxmap as dfm
from tracer_tpu_torch.analysis.fluxmap import edges_of, uv_project
from tracer_tpu_torch.bundle import RayBundle
from tracer_tpu_torch.engine import (TracerEngine, trace_fused,
                                     trace_streaming)

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = "cpu"
BF16 = 2.0 ** -7       # tracer_tpu's stochastic bf16 deposit, per bin


UV_CASES = [
    ("rect", dict(w=4.0, h=3.0), 0.0),
    ("round", dict(re=2.0, ri=0.5), 0.0),
    ("parabolic_dish", dict(R=2.0, qa=0.1), 0.0),
    ("finite_cylinder", dict(R=1.0, h=2.0), 0.0),
    ("conical_frustum", dict(z1=0.0, z2=1.0, c=0.5, a=-1.0), 0.0),
    ("sphere", dict(R=3.0), 3.0),
    ("hemisphere", dict(R=3.0), 3.0),
]


@pytest.mark.parametrize("kind,extent,p0", UV_CASES,
                         ids=[c[0] for c in UV_CASES])
def test_uv_matches_host_and_jax(kind, extent, p0):
    local = np.random.default_rng(0).normal(size=(256, 3)) * 2.0
    spec = dfm.FluxSpec(rows=(0,), kind=kind, nu=4, nv=4, u0=0.0, u1=1.0,
                        v0=0.0, v1=1.0, p0=p0, resolution=4)
    jspec = jax_dfm.FluxSpec(*spec)
    got = dfm._uv(spec, torch.tensor(local))
    for g, h, j in zip(got, uv_project(kind, extent, local),
                       jax_dfm._uv(jspec, jnp.asarray(local))):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), h, rtol=0, atol=1e-12)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-12)


# one receiver of each binned family, built with either package
RECEIVERS = {
    "round": lambda G: G.round_plate(1.5),
    "parabolic_dish": lambda G: G.parabolic_dish(3.0, 1.2),
    "finite_cylinder": lambda G: G.finite_cylinder(2.0, 1.5),
    "conical_frustum": lambda G: G.conical_frustum(-0.6, 1.2, 0.8, 0.7),
    "sphere": lambda G: G.sphere(1.1),
    "hemisphere": lambda G: G.hemisphere(1.1),
}


def _scene(pkg, geom_fn, optics=None, dtype=None, frames=None):
    """(table, meta) of one receiver surface named "rec" (several rows
    when ``frames`` gives each geometry its own frame)."""
    G, M, sc = pkg.geometry, pkg.materials, pkg.scene
    optics = optics or M.receiver(M.absorber())
    if frames is None:
        geoms = geom_fn(G)
    else:
        geoms = []
        for f in frames:
            g = geom_fn(G)
            g.frame = f
            geoms.append(g)
    asm = sc.Assembly([sc.AssembledObject([sc.Surface(geoms, optics,
                                                      name="rec")])])
    if pkg is ptt:
        return ptt.compile_scene(asm, dtype=dtype or torch.float64,
                                 device=CPU)
    return tracer_tpu.scene.compile_scene(asm, dtype=dtype or jnp.float64)


def _rays(kind, n, seed):
    """Rays that reach the receiver's front: down onto discs and dishes,
    out from inside cylinders, frusta and spheres."""
    rng = np.random.default_rng(seed)
    if kind in ("round", "parabolic_dish"):
        r = 1.45 * np.sqrt(rng.uniform(size=n))
        a = rng.uniform(0, 2 * np.pi, n)
        pos = np.stack([r * np.cos(a) + 0.05, r * np.sin(a) - 0.03,
                        np.full(n, 3.0)], 1)
        d = np.tile([0.0, 0.0, -1.0], (n, 1)) + rng.normal(size=(n, 3)) * 1e-3
    else:
        pos = rng.normal(size=(n, 3)) * 0.05
        d = rng.normal(size=(n, 3))
        if kind in ("finite_cylinder", "conical_frustum"):
            d[:, 2] *= 0.3
        if kind == "hemisphere":
            d[:, 2] = -np.abs(d[:, 2])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos, d, rng.uniform(0.5, 1.5, n)


def _bundles(pos, d, e, dtype=torch.float64):
    pb = RayBundle.create(pos=pos, dir=d, energy=e, dtype=dtype, device=CPU)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jb = JaxBundle.create(pos=jnp.asarray(pos, jdt), dir=jnp.asarray(d, jdt),
                          energy=jnp.asarray(e, jdt))
    return pb, jb


def _assert_bf16_close(hist, jhist):
    """The port's f32/f64 map against tracer_tpu's bf16-deposited one."""
    assert (np.abs(hist - jhist) <= BF16 * np.maximum(hist, jhist)
            + 1e-12).all(), np.abs(hist - jhist).max()


@pytest.mark.parametrize("kind", sorted(RECEIVERS))
def test_flux_plan_matches_jax(kind):
    _, meta = _scene(ptt, RECEIVERS[kind])
    _, jmeta = _scene(tracer_tpu, RECEIVERS[kind])
    spec = dfm.flux_plan(meta, "rec", resolution=9)
    assert tuple(spec) == tuple(jax_dfm.flux_plan(jmeta, "rec",
                                                  resolution=9))
    assert spec.kind == kind
    assert (spec.p0 > 0) == (kind in ("sphere", "hemisphere"))


@pytest.mark.parametrize("kind", sorted(RECEIVERS))
def test_curved_device_flux_matches_host_and_jax(kind):
    """trace_fused's map of each kind against the host histogram of the
    same rays' ray_tracer records (float64: the same hits, bins summed in
    another order) and against tracer_tpu's trace_fused."""
    table, meta = _scene(ptt, RECEIVERS[kind])
    spec = dfm.flux_plan(meta, "rec", resolution=8)
    pb, jb = _bundles(*_rays(kind, 4000, len(kind)))
    _, acc = trace_fused(table, pb, max_bounces=4, fluxspecs=(spec,))
    dev = acc.flux[0].double().numpy()
    res = TracerEngine(table, meta).ray_tracer(pb, reps=4)
    hits = res.hits_of("rec")
    geom = meta.surfaces[meta.index_of("rec")].geometries[0]
    u, v = uv_project(kind, geom.extent, hits["local"])
    ue, ve = edges_of(kind, geom.extent, 8)
    host = np.histogram2d(u, v, bins=[ue, ve], weights=hits["absorbed"])[0]
    absorbed = float(acc.absorbed[list(spec.rows)].sum())
    assert absorbed > 0.5 * float(pb.energy.sum())
    np.testing.assert_allclose(dev, host, rtol=1e-9, atol=1e-12)
    assert abs(dev.sum() - absorbed) <= 1e-9 * absorbed
    jtable, jmeta = _scene(tracer_tpu, RECEIVERS[kind])
    _, jacc = jax_trace_fused(
        jtable, jb, jax.random.PRNGKey(0), max_bounces=4,
        fluxspecs=(jax_dfm.flux_plan(jmeta, "rec", resolution=8),))
    _assert_bf16_close(dev, np.asarray(jacc.flux[0], dtype=float))
    flux, (u_d, _) = dfm.finalize(spec, acc.flux[0], meta)
    jflux, (u_j, _) = jax_dfm.finalize(
        jax_dfm.flux_plan(jmeta, "rec", resolution=8), jacc.flux[0], jmeta)
    np.testing.assert_array_equal(u_d, u_j)
    assert (np.abs(flux - jflux) <= BF16 * np.maximum(flux, jflux)
            + 1e-12).all()


def test_polar_device_flux_float32_matches_host():
    """tests/test_device_fluxmap.py:136 in float32 (K3's plain version):
    the round plate's map against the host histogram of the same trace's
    records, within float32 rounding of the bins."""
    table, meta = _scene(ptt, RECEIVERS["round"], dtype=torch.float32)
    spec = dfm.flux_plan(meta, "rec", resolution=8)
    pb, _ = _bundles(*_rays("round", 20_000, 1), dtype=torch.float32)
    _, acc = trace_fused(table, pb, max_bounces=4, fluxspecs=(spec,))
    dev = acc.flux[0].double().numpy()
    hits = TracerEngine(table, meta).ray_tracer(pb, reps=4).hits_of("rec")
    u, v = uv_project("round", dict(re=1.5, ri=0.0), hits["local"])
    ue, ve = edges_of("round", dict(re=1.5, ri=0.0), 8)
    host = np.histogram2d(u, v, bins=[ue, ve], weights=hits["absorbed"])[0]
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-6 * host.max())


def test_streaming_general_flux():
    """tests/test_device_fluxmap.py:168: the general streaming path (a
    source without a spec) accumulates the plate's map, summing to the
    absorbed energy, corners dark; tracer_tpu's general path on the same
    slab, three rounds of it, gives the same map within its bf16
    rounding."""
    slab = 4096
    rng = np.random.default_rng(2)
    r = np.sqrt(rng.uniform(size=slab))
    a = rng.uniform(0, 2 * np.pi, slab)
    pos = np.stack([r * np.cos(a), r * np.sin(a), np.full(slab, 3.0)], 1)
    d = rng.normal(size=(slab, 3)) * 0.15
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = np.full(slab, 0.25)
    pb, _ = _bundles(pos, d, e, dtype=torch.float32)

    def source_fn(generator, device=None):
        return pb
    source_fn.num_rays = slab

    def plate(G):
        return G.rect_plate(4.0, 4.0)
    table, meta = _scene(ptt, plate, dtype=torch.float32)
    spec = dfm.flux_plan(meta, "rec", resolution=10)
    acc, emitted, src_e = trace_streaming(
        table, source_fn, torch.Generator().manual_seed(2), 3 * slab,
        max_rounds=50, max_path=10, fluxspecs=(spec,))
    hist = acc.flux[0].double().numpy()
    absorbed = float(acc.absorbed[list(spec.rows)].double().sum())
    assert int(emitted) == 3 * slab and absorbed > 0
    np.testing.assert_allclose(hist.sum(), absorbed, rtol=1e-5)
    assert hist[0, 0] == 0.0 and hist[-1, -1] == 0.0 and hist[5, 5] > 0.0
    with jax.enable_x64(False):
        jtable, jmeta = _scene(tracer_tpu, plate, dtype=jnp.float32)
        jb = JaxBundle.create(pos=jnp.asarray(pos, jnp.float32),
                              dir=jnp.asarray(d, jnp.float32),
                              energy=jnp.asarray(e, jnp.float32))
        jacc, _, _ = jax_trace_streaming(
            jtable, lambda key: jb, jax.random.PRNGKey(2),
            total_rays=3 * slab, max_rounds=50, max_path=10,
            fluxspecs=(jax_dfm.flux_plan(jmeta, "rec", resolution=10),))
        jhist = np.asarray(jacc.flux[0], dtype=float)
    _assert_bf16_close(hist, jhist)


def test_multi_row_surface_flux():
    """tests/test_device_fluxmap.py:188: the bifacial plate's two
    coincident rows on flipped frames sum into one map to 1e-6, half the
    rays from each side; tracer_tpu's map on the same rays within its
    bf16 rounding."""
    def plate(G):
        return G.rect_plate(2.0, 2.0)

    def bifacial(M):
        return M.bifacial(M.absorber(one_sided=True),
                          M.absorber(one_sided=True))
    table, meta = _scene(ptt, plate, bifacial(ptt.materials))
    spec = dfm.flux_plan(meta, "rec", resolution=6)
    assert len(spec.rows) == 2
    n = 1024
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.9, 0.9, (n, 2))
    zs = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
    pos = np.concatenate([xy, zs[:, None]], axis=1)
    d = np.stack([np.zeros(n), np.zeros(n), -zs], axis=1)
    pb, jb = _bundles(pos, d, np.ones(n))
    _, acc = trace_fused(table, pb, max_bounces=3, fluxspecs=(spec,))
    hist = acc.flux[0].double().numpy()
    absorbed = float(acc.absorbed[list(spec.rows)].sum())
    np.testing.assert_allclose(hist.sum(), absorbed, rtol=1e-6)
    np.testing.assert_allclose(hist.sum(), n * 1.0, rtol=1e-6)
    jtable, jmeta = _scene(tracer_tpu, plate, bifacial(tracer_tpu.materials))
    _, jacc = jax_trace_fused(
        jtable, jb, jax.random.PRNGKey(0), max_bounces=3,
        fluxspecs=(jax_dfm.flux_plan(jmeta, "rec", resolution=6),))
    _assert_bf16_close(hist, np.asarray(jacc.flux[0], dtype=float))


def _panel_frames(k=24):
    """k panels on a ring of radius 2, each tilted to face the axis."""
    frames = []
    for i in range(k):
        a = 2 * np.pi * i / k
        f = ptt.spatial.generate_transform([0, 0, 1.0], a, [0, 0, 0]) \
            @ ptt.spatial.translate(2.0, 0.0, 0.3 * math.sin(3 * a)) \
            @ ptt.spatial.roty(-np.pi / 2)
        frames.append(f)
    return frames


def test_many_row_surface_flux_matches_host_and_jax():
    """A surface of 24 tilted rect panels (24 rows, each with its own
    frame): each hit bins in its own row's local frame through the sid ->
    slot gather, equal to the host histogram of the records' local points
    to 1e-9, and to tracer_tpu's (n, rows) comparison within its bf16
    rounding."""
    def panel(G):
        return G.rect_plate(0.5, 0.6)
    frames = _panel_frames()
    table, meta = _scene(ptt, panel, frames=frames)
    spec = dfm.flux_plan(meta, "rec", resolution=5)
    assert len(spec.rows) == 24
    rng = np.random.default_rng(4)
    n = 6000
    d = rng.normal(size=(n, 3))
    d[:, 2] *= 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = rng.normal(size=(n, 3)) * 0.02
    pb, jb = _bundles(pos, d, rng.uniform(0.5, 1.5, n))
    _, acc = trace_fused(table, pb, max_bounces=2, fluxspecs=(spec,))
    hist = acc.flux[0].double().numpy()
    hits = TracerEngine(table, meta).ray_tracer(pb, reps=2).hits_of("rec")
    ue, ve = edges_of("rect", dict(w=0.5, h=0.6), 5)
    host = np.histogram2d(hits["local"][:, 0], hits["local"][:, 1],
                          bins=[ue, ve], weights=hits["absorbed"])[0]
    assert host.sum() > 0.3 * float(pb.energy.sum())
    np.testing.assert_allclose(hist, host, rtol=1e-9, atol=1e-12)
    jframes = [np.asarray(f) for f in frames]
    jtable, jmeta = _scene(tracer_tpu, panel, frames=jframes)
    _, jacc = jax_trace_fused(
        jtable, jb, jax.random.PRNGKey(0), max_bounces=2,
        fluxspecs=(jax_dfm.flux_plan(jmeta, "rec", resolution=5),))
    _assert_bf16_close(hist, np.asarray(jacc.flux[0], dtype=float))


def test_row_frames_gather_one_row_and_misses():
    """_row_frames: a one-row spec keeps its one frame; for several rows,
    lanes on no row of the spec (sid -1 or another surface's) are off the
    spec and lanes on its rows take their own row's frame."""
    def panel(G):
        return G.rect_plate(0.5, 0.6)
    table, meta = _scene(ptt, panel, frames=_panel_frames(5))
    spec = dfm.flux_plan(meta, "rec", resolution=3)
    rows = list(spec.rows)
    sid = torch.tensor([-1, rows[3], rows[0], rows[4], rows[3]],
                       dtype=torch.int32)
    on, inv = dfm._row_frames(spec, table, sid)
    assert on.tolist() == [False, True, True, True, True]
    assert inv.shape == (5, 3, 4)
    for lane in (1, 2, 3, 4):
        assert torch.equal(inv[lane], table.inv_frame[int(sid[lane])][:3])
    one = spec._replace(rows=(rows[2],))
    on, inv = dfm._row_frames(one, table, sid)
    assert not bool(on.any()) and inv.shape == (4, 4)
