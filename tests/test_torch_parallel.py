"""Multi-device tracing on the port (tracer_tpu_torch.parallel) on the CPU,
against tracer_tpu.parallel on the conftest's virtual CPU devices.

The ranks are threads of this process, each with its own
``torch.distributed.ProcessGroupGloo`` over one in-process HashStore (the
port's collectives take an explicit group), so a two-rank world costs
milliseconds and no port:

* the counterparts of tests/test_parallel.py: deterministic float64
  optics to 1e-12, closure to 1e-12, Monte-Carlo shares and flux maps
  within 3 combined sigma of tracer_tpu's sharded traces, the split
  stream, and the culled path's two refusals with tracer_tpu's messages;
* the mesh layouts of tests/test_mesh_scale.py (lists, segments, row maps
  and demote masks) equal to tracer_tpu's for 2 and 8 ranks, and the
  20,001-row field's per-rank budgets;
* a culled sharded trace in row shards (two forced segments a rank, or
  the row-shard path at one; K1's plain version on rows[row_map]) within
  0.02 per row of the unculled trace_streaming of the port and of
  tracer_tpu, and equal bit for bit to the sum of its ranks' traces run
  one at a time, which shows that no per-round collective is needed;
* the counterpart of tests/test_diff.py's sharded gradient: trace_diff
  per rank, moments summed by torch.distributed.nn.functional.all_reduce,
  the gradient equal to the per-shard sum's to round-off;
* the culled drain through the oracle (what a table past K2's stage
  takes, tracer_tpu's drain_jnp), forced, against the K2 drain.
"""
import datetime
import math
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import culling as jax_culling
from tracer_tpu import parallel as jax_parallel
from tracer_tpu.analysis.device_fluxmap import flux_plan as jax_flux_plan
from tracer_tpu.sources import disk_bundle as jax_disk_bundle
from tracer_tpu_torch import culling, diff, parallel
from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
from tracer_tpu_torch.engine import energy_closure, trace_fused, \
    trace_streaming
from tracer_tpu_torch.kernels.bounce import TILE
from tracer_tpu_torch.sources import disk_bundle, disk_pillbox_pallas_spec

torch.set_num_threads(1)

F64 = torch.float64


def run_world(fn, n=2):
    """``fn(group, rank)`` on ``n`` ranks, each a thread with its own gloo
    group; returns the ranks' results in rank order. A rank that raises
    fails the call (the others time out of their collectives)."""
    store = dist.HashStore()
    out, errors = [None] * n, []

    def target(r):
        try:
            pg = dist.ProcessGroupGloo(store, r, n,
                                       datetime.timedelta(seconds=60))
            out[r] = fn(pg, r)
        except BaseException as e:      # noqa: BLE001 - re-raised below
            errors.append(e)
    threads = [threading.Thread(target=target, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a rank did not finish"
    if errors:
        raise errors[0]
    return out


def _mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("rays",))


def _both(build):
    """``build(pkg)`` -> Assembly, compiled in float64 by both packages."""
    jt, jm = tracer_tpu.compile_scene(build(tracer_tpu), dtype=jnp.float64)
    pt, pm = ptt.compile_scene(build(ptt), dtype=F64, device="cpu")
    return (jt, jm), (pt, pm)


def _plate(pkg):
    return pkg.Assembly([pkg.AssembledObject([pkg.Surface(
        pkg.geometry.rect_plate(4, 4), pkg.materials.reflective(1.0))])])


def _plate_bundle(n, seed=0):
    xy = np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 2))
    pos = np.concatenate([xy, np.ones((n, 1))], axis=1)
    dirs = np.tile([0.0, 0.0, -1.0], (n, 1))
    return pos, dirs


def _mirror_rec(pkg, optics=None):
    sp = pkg.spatial
    mirror = pkg.Surface(pkg.geometry.rect_plate(3.0, 3.0),
                         optics or pkg.materials.reflective(0.2,
                                                            sigma=2e-3))
    rec = pkg.Surface(pkg.geometry.rect_plate(3.0, 3.0),
                      pkg.materials.absorber(), location=[0.0, 0.0, 2.0],
                      rotation=sp.rotx(np.pi)[:3, :3], name="rec")
    return pkg.Assembly([pkg.AssembledObject([mirror, rec])])


def _glass(pkg):
    G, M, sp = pkg.geometry, pkg.materials, pkg.spatial
    top = pkg.Surface(G.rect_plate(8.0, 8.0),
                      M.refractive_homogenous(1.0, 1.5, single_ray=False),
                      location=[0.0, 0.0, 1.0], name="top")
    floor = pkg.Surface(G.rect_plate(12.0, 12.0), M.lambertian(1.0),
                        name="floor")
    ceil = pkg.Surface(G.rect_plate(12.0, 12.0), M.lambertian(1.0),
                       location=[0.0, 0.0, 3.0],
                       rotation=sp.rotx(np.pi)[:3, :3], name="ceil")
    return pkg.Assembly([pkg.AssembledObject([top, floor, ceil])])


SLAB = 512                       # per rank, as tests/test_parallel.py's
DISK = dict(center=[0.0, 0.0, 1.0], direction=[0.0, 0.0, -1.0],
            radius=1.2, ang_range=2e-3, flux=1000.0)
ANG = 0.45
GLASS_DIR = [math.sin(ANG), 0.0, -math.cos(ANG)]
GLASS = dict(center=[-2.0 * GLASS_DIR[0], 0.0, 2.0], direction=GLASS_DIR,
             radius=1.0, ang_range=1e-3, flux=1000.0)


def _port_source(args, slab=SLAB):
    def source_fn(generator, device=None):
        return disk_bundle(generator, slab, dtype=F64, device=device,
                           **args)
    source_fn.num_rays = slab
    return source_fn


def _jax_source(args, slab=SLAB):
    return lambda key: jax_disk_bundle(key, slab, **args)


def _closure(accum, source_e):
    tot = (float(accum.absorbed.sum()) + float(accum.escaped)
           + float(accum.culled) + float(accum.medium)
           + float(accum.residual))
    return (float(source_e) - tot) / float(source_e)


def _within_3_sigma(p, n_p, q, n_q):
    """Shares p and q of two independent traces of n_p and n_q rays agree
    within 3 combined binomial sigma of their pooled share."""
    p, q = np.asarray(p, np.float64), np.asarray(q, np.float64)
    m = (p * n_p + q * n_q) / (n_p + n_q)
    sig = np.sqrt(np.maximum(m * (1 - m), 1e-12) * (1 / n_p + 1 / n_q))
    assert (np.abs(p - q) <= 3 * sig).all(), (p, q, sig)


# ---------------------------------------------------------------------------
# tests/test_parallel.py's seven tests
# ---------------------------------------------------------------------------

def test_sharded_accumulators_match_single_device():
    """Full absorption on the first hit: two ranks' summed accumulators
    equal tracer_tpu's trace_sharded over 8 virtual devices, its
    trace_fused and the port's one-rank trace to 1e-12; a world of one
    (no group) is trace_fused with the rank-0 generator, bit for bit."""
    (jt, _), (pt, _) = _both(_plate)
    pos, dirs = _plate_bundle(64)
    jb = tracer_tpu.RayBundle.create(pos=jnp.asarray(pos),
                                     dir=jnp.asarray(dirs))
    pb = ptt.RayBundle.create(pos, dirs, dtype=F64, device="cpu")
    key = jax.random.PRNGKey(5)
    _, ja_s = jax_parallel.trace_sharded(jt, jb, key, _mesh(8),
                                         max_bounces=3)
    _, ja_1 = tracer_tpu.engine.trace_fused(jt, jb, key, max_bounces=3)
    res = run_world(lambda g, r: parallel.trace_sharded(
        pt, pb, 5, g, max_bounces=3))
    for final, acc in res:
        assert final.pos.shape == (32, 3)
        for ja in (ja_s, ja_1):
            np.testing.assert_allclose(acc.absorbed.numpy(),
                                       np.asarray(ja.absorbed), rtol=1e-12)
            np.testing.assert_allclose(float(acc.escaped),
                                       float(ja.escaped), rtol=1e-12)
    final_1, acc_1 = parallel.trace_sharded(pt, pb, 5, max_bounces=3)
    final_f, acc_f = trace_fused(pt, pb, parallel.rank_generator(5, 0),
                                 max_bounces=3)
    assert torch.equal(acc_1.absorbed, acc_f.absorbed)
    assert torch.equal(final_1.pos, final_f.pos)
    np.testing.assert_allclose(res[0][1].absorbed.numpy(),
                               acc_1.absorbed.numpy(), rtol=1e-12)


def test_sharded_energy_conservation():
    """trace_sharded, multi_ray_sim and TracerEngineMP over two ranks:
    absorbed + escaped + culled + the ranks' final energies equal the
    source to 1e-12 (two bundles of 60 and 68 rays pad to 128)."""
    (_, _), (pt, _) = _both(_plate)
    pos, dirs = _plate_bundle(128, seed=1)
    pb = ptt.RayBundle.create(pos, dirs, dtype=F64, device="cpu")
    src = float(pb.energy.sum())

    def work(g, r):
        out = [parallel.trace_sharded(pt, pb, 1, g, max_bounces=5)]
        out.append(parallel.multi_ray_sim(
            pt, [ptt.RayBundle.create(pos[:60], dirs[:60], dtype=F64,
                                      device="cpu"),
                 ptt.RayBundle.create(pos[60:], dirs[60:], dtype=F64,
                                      device="cpu")], 1, g, max_bounces=5))
        mp = parallel.TracerEngineMP(_plate(ptt), group=g, dtype=F64,
                                     device="cpu")
        out.append(mp.multi_ray_sim([pb], procs=2, seed=1))
        assert mp.accum is out[-1][1]
        return out
    res = run_world(work)
    for k in range(3):
        acc = res[0][k][1]
        left = sum(float(res[r][k][0].energy.sum()) for r in range(2))
        total = (float(acc.absorbed.sum()) + float(acc.escaped)
                 + float(acc.culled) + left)
        np.testing.assert_allclose(total, src, rtol=1e-12)


@pytest.fixture(scope="module")
def jax_mirror_run():
    """tracer_tpu's sharded streaming trace of the mirror scene on 2
    virtual devices, with the receiver's flux map."""
    jt, jm = tracer_tpu.compile_scene(_mirror_rec(tracer_tpu),
                                      dtype=jnp.float64)
    return jax_parallel.trace_streaming_sharded(
        jt, _jax_source(DISK), jax.random.PRNGKey(3), 2 * SLAB * 4,
        _mesh(2), max_rounds=100, max_path=10,
        fluxspecs=(jax_flux_plan(jm, "rec", resolution=8),))


def test_streaming_sharded_closure_and_agreement(jax_mirror_run):
    """Each rank streams its own slab: two ranks emit exactly the total,
    close to 1e-12, and their absorbed shares agree with tracer_tpu's
    sharded trace within 3 combined sigma."""
    pt, _ = ptt.compile_scene(_mirror_rec(ptt), dtype=F64, device="cpu")
    total = 2 * SLAB * 4
    res = run_world(lambda g, r: parallel.trace_streaming_sharded(
        pt, _port_source(DISK), 3, total, g, max_rounds=100, max_path=10))
    acc, em, se = res[0]
    assert int(em) == total and acc.absorbed.dtype == F64
    assert abs(_closure(acc, se)) < 1e-12
    ja, jem, jse = jax_mirror_run
    _within_3_sigma(acc.absorbed.numpy() / float(se), int(em),
                    np.asarray(ja.absorbed) / float(jse), int(jem))


def _culled_refusal_scene(optics):
    pt, pm = ptt.compile_scene(_mirror_rec(ptt, optics), device="cpu")
    slab = 8 * TILE
    return pt, pm, slab


def test_streaming_sharded_culled_rejects_uncullable_kinds():
    """A Cook-Torrance mirror is refused with tracer_tpu's message: the
    sharded culled path has no fallback."""
    M = ptt.materials
    pt, pm, slab = _culled_refusal_scene(
        M.bdrf_cook_torrance(0.3, 2.0, 4.0, 0.9))
    spec = disk_pillbox_pallas_spec(slab, DISK["center"], DISK["direction"],
                                    1.2, 2e-3, 1000.0)
    src = _port_source(DISK, slab)
    src.pallas_spec = spec
    cul = culling.build_block_culling(pt, pm, spec, slab)
    with pytest.raises(ValueError, match="not culled-megakernel eligible"):
        parallel.trace_streaming_sharded(pt, src, 0, 8 * slab, culling=cul)
    with pytest.raises(ValueError, match="not culled-megakernel eligible"):
        run_world(lambda g, r: parallel.trace_streaming_sharded(
            pt, src, 0, 8 * slab, g, culling=cul))


def test_streaming_sharded_fluxmap_matches_single_device(jax_mirror_run):
    """Flux maps sum over the ranks like every other accumulator: each
    map integrates to its receiver's absorbed share, and the two-rank map
    agrees bin by bin with the one-rank trace and with tracer_tpu's
    sharded map within 3 combined sigma."""
    pt, pm = ptt.compile_scene(_mirror_rec(ptt), dtype=F64, device="cpu")
    spec = flux_plan(pm, "rec", resolution=8)
    total = 2 * SLAB * 4
    a_s, em_s, se_s = run_world(lambda g, r: parallel.trace_streaming_sharded(
        pt, _port_source(DISK), 3, total, g, max_rounds=100, max_path=10,
        fluxspecs=(spec,)))[0]
    a_1, em_1, se_1 = trace_streaming(
        pt, _port_source(DISK), torch.Generator().manual_seed(4), total,
        max_rounds=400, max_path=10, fluxspecs=(spec,))
    ja, jem, jse = jax_mirror_run
    rows = np.nonzero(pm.row_logical == pm.index_of("rec"))[0]
    maps = []
    for a, em, se in ((a_s, em_s, se_s), (a_1, em_1, se_1)):
        H = a.flux[0].numpy() / float(se)
        rec = float(a.absorbed[rows].sum()) / float(se)
        np.testing.assert_allclose(H.sum(), rec, rtol=2e-3)
        maps.append((H, int(em)))
    maps.append((np.asarray(ja.flux[0]) / float(jse), int(jem)))
    (H_s, n_s), *others = maps
    assert (H_s > 0.01).sum() >= 4
    for H, n in others:
        _within_3_sigma(H_s.sum(), n_s, H.sum(), n)
        _within_3_sigma(H_s, n_s, H, n)


def test_streaming_sharded_culled_rejects_ambient_scattering():
    """A spec with ambient HG scattering is refused with tracer_tpu's
    message."""
    pt, pm, slab = _culled_refusal_scene(ptt.materials.reflective(0.1))
    spec = disk_pillbox_pallas_spec(slab, DISK["center"], DISK["direction"],
                                    1.2, 2e-3, 1000.0, ambient_scat=0.4,
                                    ambient_g=0.6)
    src = _port_source(DISK, slab)
    src.pallas_spec = spec
    cul = culling.build_block_culling(pt, pm, spec, slab)
    with pytest.raises(ValueError, match="ambient HG scattering"):
        parallel.trace_streaming_sharded(pt, src, 0, 8 * slab, culling=cul)


def test_streaming_sharded_split_closure():
    """The split stream (true energy splitting on the general path) on two
    ranks closes to 1e-12, emits exactly its total, and agrees with
    tracer_tpu's sharded split stream per row within 0.02."""
    (jt, _), (pt, _) = _both(_glass)
    assert "split" in pt.features
    total = 4 * SLAB
    acc, em, se = run_world(lambda g, r: parallel.trace_streaming_sharded(
        pt, _port_source(GLASS), 3, total, g, max_rounds=200,
        max_path=20))[0]
    assert abs(_closure(acc, se)) < 1e-12
    assert int(em) == total
    ja, _, jse = jax_parallel.trace_streaming_sharded(
        jt, _jax_source(GLASS), jax.random.PRNGKey(3), total, _mesh(2),
        max_rounds=200, max_path=20)
    np.testing.assert_allclose(acc.absorbed.numpy() / float(se),
                               np.asarray(ja.absorbed) / float(jse),
                               atol=0.02)


# ---------------------------------------------------------------------------
# the mesh layouts (tests/test_mesh_scale.py)
# ---------------------------------------------------------------------------

def _grid_field(pkg, n_mirrors, pitch=1.0, size=0.45, **kw):
    """tests/test_mesh_scale.py's field: n small upward mirrors on a square
    grid and one large one-sided receiver above."""
    G, M, sp = pkg.geometry, pkg.materials, pkg.spatial
    cols = int(math.ceil(math.sqrt(n_mirrors)))
    half = (cols - 1) / 2.0
    surfs = []
    for k in range(n_mirrors):
        i, j = divmod(k, cols)
        surfs.append(pkg.Surface(
            G.rect_plate(size, size), M.reflective(0.1),
            location=[(i - half) * pitch, (j - half) * pitch, 0.0],
            name=f"m{k}"))
    rec = pkg.Surface(G.rect_plate(3.0 * half * pitch, 3.0 * half * pitch),
                      M.absorber(one_sided=True), name="rec",
                      location=[0.0, 0.0, 50.0],
                      rotation=sp.rotx(np.pi)[:3, :3])
    table, meta = pkg.compile_scene(
        pkg.Assembly([pkg.AssembledObject(surfs + [rec])]), **kw)
    return table, meta, half * pitch * np.sqrt(2.0) + 2.0


def _assert_same(p, j, what):
    assert p.dtype == j.dtype, what
    np.testing.assert_array_equal(p, j, err_msg=what)


@pytest.mark.parametrize("smem", [1 << 20, 235_000])
def test_mesh_layouts_equal_tracer_tpu(smem):
    """build_block_culling(mesh_devices=D) for D = 2 and 8 (a Buie sun, so
    the mesh build parks the aureole), mesh_segment_shards (the build's
    segment count and a forced 2) and device_row_shards equal tracer_tpu's
    array for array, at the default budget and at one that splits each
    rank's range into 8 and 2 segments."""
    jt, jm, radius = _grid_field(tracer_tpu, 400, dtype=jnp.float32)
    pt, pm, _ = _grid_field(ptt, 400, dtype=torch.float32, device="cpu")
    slab = 16 * TILE
    args = (slab, [0.0, 0.0, 60.0], [0.0, 0.0, -1.0], radius, 0.02, 1000.0)
    jspec = tracer_tpu.sources.buie_sunshape_pallas_spec(*args)
    pspec = ptt.sources.buie_sunshape_pallas_spec(*args)
    n_seg = []
    for D in (2, 8):
        j = jax_culling.build_block_culling(jt, jm, jspec, slab,
                                            mesh_devices=D,
                                            max_smem_bytes=smem)
        p = culling.build_block_culling(pt, pm, pspec, slab,
                                        mesh_devices=D, max_smem_bytes=smem)
        assert p.park_aureole and j.park_aureole and p.mesh_devices == D
        assert p.stats["mesh_n_seg"] == j.stats["mesh_n_seg"]
        n_seg.append(p.stats["mesh_n_seg"])
        for name in ("lists", "counts", "cell_bounds", "cell_of_block",
                     "age_caps"):
            _assert_same(getattr(p, name), getattr(j, name), name)
        assert p.group_offsets == j.group_offsets
        assert p.demote_rows == j.demote_rows
        if smem != 1 << 20:
            # one segment a rank overflows the budget on both sides
            for pkg_cul, c, t in ((culling, p, pt), (jax_culling, j, jt)):
                with pytest.raises(ValueError, match="forced n_seg=1"):
                    pkg_cul.mesh_segment_shards(c, t, D, max_smem_bytes=smem,
                                                force_n_seg=1)
        for force in ((0, 2) if smem == 1 << 20 else (0,)):
            ps = culling.mesh_segment_shards(p, pt, D, max_smem_bytes=smem,
                                             force_n_seg=force)
            js = jax_culling.mesh_segment_shards(j, jt, D,
                                                 max_smem_bytes=smem,
                                                 force_n_seg=force)
            assert len(ps) == len(js) == (force or n_seg[-1])
            for a, b in zip(ps, js):
                assert a.keys() == b.keys()
                assert a["group_offsets"] == b["group_offsets"]
                for k in ("blocks", "lists", "counts", "row_maps",
                          "demote_masks"):
                    _assert_same(a[k], b[k], k)
        n_rows = int(jt.ap_params.shape[0])
        for a, b in zip(culling.device_row_shards(p, n_rows, D),
                        jax_culling.device_row_shards(j, n_rows, D)):
            _assert_same(a, b, "device_row_shards")
    assert n_seg == ([1, 1] if smem == 1 << 20 else [8, 2])


def test_20k_rows_fit_8way_budgets():
    """The 20,001-row field (its table past tracer_tpu's one-chip budget)
    builds an 8-rank layout at full corridor depth whose every (rank,
    segment) chunk fits the budget, with real row shards."""
    table, meta, radius = _grid_field(ptt, 20000, dtype=torch.float32,
                                      device="cpu")
    assert table.num_rows == 20001
    assert culling.smem_need_bytes(table, 1, 1) > (1 << 20)
    slab = 128 * TILE
    spec = disk_pillbox_pallas_spec(slab, [0.0, 0.0, 60.0],
                                    [0.0, 0.0, -1.0], radius, 4.65e-3,
                                    1000.0)
    cul = culling.build_block_culling(table, meta, spec, slab,
                                      mesh_devices=8)
    assert (cul.age_caps == cul.age_cap).all()
    for sg in culling.mesh_segment_shards(cul, table, 8):
        chunk = sg["lists"].shape[0] // 8
        need = culling.smem_need_bytes(table, chunk, sg["lists"].shape[1],
                                       n_rows=sg["row_maps"].shape[1])
        assert need <= (1 << 20)
        assert sg["row_maps"].shape[1] < 8000


# ---------------------------------------------------------------------------
# the culled sharded trace on K1's plain version
# ---------------------------------------------------------------------------

def _mirror_field(pkg):
    """tests/test_mesh_scale.py's four-mirror field under a receiver."""
    G, M, sp = pkg.geometry, pkg.materials, pkg.spatial
    mirrors = [pkg.Surface(G.rect_plate(1.2, 1.2), M.reflective(0.08),
                           location=[x, y, 0.0], name=f"m{i}")
               for i, (x, y) in enumerate([(-1.5, -1.5), (1.5, -1.5),
                                           (-1.5, 1.5), (1.5, 1.5)])]
    rec = pkg.Surface(G.rect_plate(5.0, 5.0), M.absorber(one_sided=True),
                      name="rec", location=[0.0, 0.0, 6.0],
                      rotation=sp.rotx(np.pi)[:3, :3])
    return pkg.Assembly([pkg.AssembledObject(mirrors + [rec])])


@pytest.mark.parametrize("force", [dict(_force_mesh_segments=2),
                                   dict(_force_row_shards=True)],
                         ids=["two_segments", "row_shards"])
def test_mesh_segments_trace_parity(monkeypatch, force):
    """A culled trace over two ranks in row shards (forced 2 segments a
    rank, or the row-shard path at the budget's one segment: per segment
    group offsets, local row ids, rows[row_map] for K1's plain version,
    demote masks, quota slices) agrees per row within 0.02 with two
    traces that share none of that code: the port's unculled
    trace_streaming (K2's plain version over the whole table) and
    tracer_tpu's, as tests/test_mesh_scale.py holds tracer_tpu's
    segmented trace; within 3 combined sigma of the port's unculled trace
    on every row too, so that no row's energy lands on another row. It
    closes; and the reduced result equals the sum of the two ranks'
    traces run one after the other with no collective at all, bit for
    bit: a rank's rounds need nothing of the other's."""
    table, meta = ptt.compile_scene(_mirror_field(ptt), device="cpu")
    slab = 16 * TILE
    total = 2 * slab
    spec = disk_pillbox_pallas_spec(slab, [0, 0, 3.0], [0, 0, -1.0], 2.8,
                                    4.65e-3, 1000.0)
    disk = dict(center=[0, 0, 3.0], direction=[0, 0, -1.0], radius=2.8,
                ang_range=4.65e-3, flux=1000.0)

    def source_fn(generator, device=None):
        return disk_bundle(generator, slab, device=device, **disk)
    source_fn.num_rays = slab
    source_fn.pallas_spec = spec
    a0, em0, se0 = trace_streaming(table, source_fn,
                                   torch.Generator().manual_seed(0), total,
                                   max_rounds=40, max_path=6)
    f0 = a0.absorbed.double().numpy() / float(se0)
    jt, _ = tracer_tpu.compile_scene(_mirror_field(tracer_tpu),
                                     dtype=jnp.float32)
    aj, _, sej = tracer_tpu.engine.trace_streaming(
        jt, lambda key: jax.tree.map(
            lambda a: a.astype(jnp.float32)
            if jnp.issubdtype(a.dtype, jnp.floating) else a,
            jax_disk_bundle(key, slab, **disk)),
        jax.random.PRNGKey(0), total_rays=total, max_rounds=40, max_path=6)
    fj = np.asarray(aj.absorbed, np.float64) / float(sej)
    np.testing.assert_allclose(f0, fj, atol=0.02)

    cul = culling.build_block_culling(table, meta, spec, slab)
    kw = dict(max_rounds=16, max_path=6, culling=cul, **force)
    a1, em1, se1 = run_world(lambda g, r: parallel.trace_streaming_sharded(
        table, source_fn, 0, total, g, **kw))[0]
    f1 = a1.absorbed.double().numpy() / float(se1)
    assert f0[-1] > 0.1                  # the receiver takes its share
    np.testing.assert_allclose(f1, f0, atol=0.02)
    np.testing.assert_allclose(f1, fj, atol=0.02)
    _within_3_sigma(f1, int(em1), f0, int(em0))
    assert abs(energy_closure(a1, se1)) < 1e-5
    assert total <= int(em1) < total + cul.n_cells

    class Rank:
        def __init__(self, r):
            self.r = r

        def rank(self):
            return self.r

        def size(self):
            return 2
    monkeypatch.setattr(parallel, "_all_reduce", lambda t, g: list(t))
    alone = [parallel.trace_streaming_sharded(table, source_fn, 0, total,
                                              Rank(r), **kw)
             for r in range(2)]
    for name in ("absorbed", "escaped", "culled", "residual"):
        want = (getattr(alone[0][0], name).double()
                + getattr(alone[1][0], name).double()).float()
        assert torch.equal(getattr(a1, name), want), name
    assert int(em1) == int(alone[0][1]) + int(alone[1][1])


# ---------------------------------------------------------------------------
# tests/test_diff.py's sharded gradient
# ---------------------------------------------------------------------------

def test_sharded_gradient_matches_per_shard_sum():
    """trace_diff on each rank's half of the beam, the moments summed by
    torch.distributed.nn.functional.all_reduce (autograd-aware: its
    backward sums the ranks' output gradients, so each rank's gradient is
    D times its own shard's share), and the ranks' gradients averaged as
    a data-parallel step averages them: loss and gradient equal the
    sequential per-shard sum's to round-off, on every rank."""
    from torch.distributed.nn.functional import all_reduce

    sp, M, G = ptt.spatial, ptt.materials, ptt.geometry
    mirror = ptt.Surface(G.rect_plate(3.0, 3.0),
                         M.reflective(absorptivity=0.1),
                         rotation=sp.roty(np.pi / 4)[:3, :3], name="mirror")
    recv = ptt.Surface(G.rect_plate(8.0, 8.0),
                       M.lambertian(absorptivity=0.9),
                       location=[6.0, 0.0, 0.0],
                       rotation=sp.roty(np.pi / 2)[:3, :3], name="receiver")
    table, meta = ptt.compile_scene(
        ptt.Assembly([ptt.AssembledObject([mirror, recv])]), dtype=F64,
        device="cpu")
    m_rows = np.nonzero(meta.row_logical == meta.index_of("mirror"))[0]
    r_rows = np.nonzero(meta.row_logical == meta.index_of("receiver"))[0]
    beam = disk_bundle(torch.Generator().manual_seed(7), 512,
                       [0.0, 0.0, 4.0], [0.0, 0.0, -1.0], 0.8, 1e-4,
                       flux=1000.0, dtype=F64, device="cpu")
    halves = [parallel._shard(beam, 0, 256), parallel._shard(beam, 256, 512)]
    a0 = np.pi / 4 + 0.02

    def tilted(a):
        n = torch.stack([torch.sin(a), torch.zeros_like(a), torch.cos(a)])
        return diff.with_rows(table, m_rows, frame=diff.frame_to(
            n, torch.zeros(3, dtype=F64))[None])

    def moments(a, r):
        return diff.trace_diff(tilted(a), halves[r], 61 + r, bounces=3)[1]

    def sharded(g, r):
        a = torch.tensor(a0, dtype=F64, requires_grad=True)
        mom = moments(a, r)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            mom = diff.MomentAccum(*(all_reduce(x, group=g) for x in (
                mom.e_in, mom.absorbed, mom.m1, mom.m2)))
        v = diff.spot_rms(mom, r_rows, center=(0.4, -0.3))
        (grad,) = torch.autograd.grad(v, a)
        dist.all_reduce(grad, group=g)
        return float(v.detach()), float(grad) / 2

    a = torch.tensor(a0, dtype=F64, requires_grad=True)
    m = [moments(a, r) for r in range(2)]
    mom = diff.MomentAccum(*(getattr(m[0], f) + getattr(m[1], f)
                             for f in ("e_in", "absorbed", "m1", "m2")))
    v_q = diff.spot_rms(mom, r_rows, center=(0.4, -0.3))
    (g_q,) = torch.autograd.grad(v_q, a)
    for v_s, g_s in run_world(sharded):
        np.testing.assert_allclose(v_s, float(v_q.detach()), rtol=1e-13)
        np.testing.assert_allclose(g_s, float(g_q), rtol=1e-11)
        assert g_s != 0.0


def test_oracle_drain_matches_k2_drain(monkeypatch, caplog):
    """The culled drain of a table past K2's stage runs the oracle and
    the unfused shade (tracer_tpu's drain_jnp), with a warning and its
    bounces counted: forced here on the four-mirror field with depth-1
    corridors (every mirror survivor parks and drains), its shares agree
    with the K2 drain's within 3 combined sigma and it closes to 1e-5."""
    from tracer_tpu_torch import engine
    table, meta = ptt.compile_scene(_mirror_field(ptt), device="cpu")
    slab = 4 * TILE
    spec = disk_pillbox_pallas_spec(slab, [0, 0, 3.0], [0, 0, -1.0], 2.8,
                                    4.65e-3, 1000.0)

    def source_fn(generator, device=None):
        return disk_bundle(generator, slab, [0, 0, 3.0], [0, 0, -1.0], 2.8,
                           4.65e-3, flux=1000.0, device=device)
    source_fn.num_rays = slab
    source_fn.pallas_spec = spec
    cul = culling.build_block_culling(table, meta, spec, slab, age_cap=1)
    runs = []
    for fits in (True, False):
        monkeypatch.setattr(engine, "_k2_fits", lambda scene, media=None,
                            fits=fits: fits)
        monkeypatch.setattr(engine._oracle_bounce, "launches", 0)
        caplog.clear()
        with caplog.at_level("WARNING", logger="tracer_tpu_torch"):
            acc, em, se = trace_streaming(table, source_fn,
                                          torch.Generator().manual_seed(1),
                                          2 * slab, max_rounds=200,
                                          max_path=6, culling=cul)
        assert abs(energy_closure(acc, se)) < 1e-5
        runs.append((acc.absorbed.double().numpy() / float(se), int(em)))
        assert (engine._oracle_bounce.launches > 0) == (not fits)
        assert ("past K2's stage" in caplog.text) == (not fits)
    (p, n_p), (q, n_q) = runs
    assert p[-1] > 0.1
    _within_3_sigma(p, n_p, q, n_q)
