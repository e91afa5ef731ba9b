"""The Kd accelerator on the port (tracer_tpu_torch) against tracer_tpu on
the CPU: the NumPy copy of the tree, the torch candidate intersection and
ray_tracer(accel=...).

* row_aabbs, the node list, traversal and surfaces_for_rays equal to
  tracer_tpu's on the same scenes and rays;
* the engine's per-ray candidate lists equal to tracer_tpu's;
* nearest_hit_candidates against tracer_tpu's on the same candidates, t
  to 1e-12 and sid equal, in float64; with every row a candidate, equal
  to the brute-force oracle;
* ray_tracer with accel on and off on tests/test_accel.py's mixed scene
  (the MiniDish, rows reordered by the compiler): per-surface absorbed
  energy to 1e-9 in float64, the pruning and the per-bounce log line;
* float32 on the CPU (K3's plain version against the candidates' general
  quadric): sids equal but for at most 1e-3 of the lanes;
* the unbounded-kinds case and the slab-plane-parallel ray.
"""
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu.accel import KdTree as JaxKdTree
from tracer_tpu.accel import row_aabbs as jax_row_aabbs
from tracer_tpu.engine import TracerEngine as JaxEngine
from tracer_tpu.kernels.intersect import (
    nearest_hit_candidates as jax_candidates)
from tracer_tpu.scene import compile_scene as jax_compile
from tracer_tpu_torch.accel import KdTree, row_aabbs
from tracer_tpu_torch.bundle import RayBundle
from tracer_tpu_torch.engine import TracerEngine
from tracer_tpu_torch.kernels.intersect import (nearest_hit,
                                                nearest_hit_candidates)
from tracer_tpu_torch.scene import compile_scene

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def _plate_field(pkg, n_side=5, spacing=3.0):
    """tests/test_accel.py:19: a grid of mirror plates."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene
    objs = []
    for i in range(n_side):
        for j in range(n_side):
            o = sc.AssembledObject(surfs=[sc.Surface(G.rect_plate(2.0, 2.0),
                                                     M.reflective(1.0))])
            o.set_transform(sp.translate(x=(i - n_side // 2) * spacing,
                                         y=(j - n_side // 2) * spacing))
            objs.append(o)
    return sc.Assembly(objects=objs)


def _mixed_scene(pkg):
    """tests/test_accel.py:66: the MiniDish rotated by -pi/4, several
    aperture-signature groups, so the compiler reorders rows."""
    if pkg is ptt:
        from tracer_tpu_torch.models.tau_minidish import MiniDish
    else:
        from tracer_tpu.models.tau_minidish import MiniDish
    asm = MiniDish(diameter=5.0, focal_length=6.25, dish_opt_eff=0.9,
                   receiver_pos=6.95, receiver_side=0.4,
                   homogenizer_depth=0.7, homog_opt_eff=0.9)
    asm.set_transform(pkg.spatial.rotx(-np.pi / 4))
    return asm


def _scene_meta(build, pkg):
    if pkg is ptt:
        return compile_scene(build(ptt), **F64)
    return jax_compile(build(tracer_tpu), dtype=jnp.float64)


def _rays(n, seed=0, z=5.0, spread=8.0, tilt=(0.05, -0.03)):
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.uniform(-spread, spread, (n, 2)),
                          np.full((n, 1), z)], axis=1)
    dirs = np.tile([tilt[0], tilt[1], -1.0], (n, 1))
    dirs[:, :2] += rng.normal(0.0, 0.02, (n, 2))
    return pos, dirs / np.linalg.norm(dirs, axis=1, keepdims=True)


SCENES = {"plates": _plate_field, "mixed": _mixed_scene}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tree_equals_tracer_tpu(name):
    """row_aabbs, every node (bounds, axis, split, children, rows, leaf),
    the always-relevant rows, traversal and surfaces_for_rays."""
    _, pm = _scene_meta(SCENES[name], ptt)
    _, jm = _scene_meta(SCENES[name], tracer_tpu)
    np.testing.assert_array_equal(row_aabbs(pm), jax_row_aabbs(jm))
    pt, jt = KdTree(pm), JaxKdTree(jm)
    assert len(pt.nodes) == len(jt.nodes) > 1
    assert pt.always_relevant == jt.always_relevant
    assert pt.max_depth == jt.max_depth
    for a, b in zip(pt.nodes, jt.nodes):
        np.testing.assert_array_equal(a.bounds, b.bounds)
        assert (a.leaf, a.axis, a.split, a.left, a.right, list(a.rows)) == \
            (b.leaf, b.axis, b.split, b.left, b.right, list(b.rows))
    pos, dirs = _rays(3000, seed=1)
    if name == "mixed":
        pos, dirs = pos * [0.4, 0.4, 1.6], -dirs
        pos[:, 2] = -2.0
    mask = pt.traversal(pos, dirs)
    np.testing.assert_array_equal(mask, jt.traversal(pos, dirs))
    assert mask.any(axis=0).mean() > 0.1
    for a, b in zip(pt.surfaces_for_rays(pos[:50], dirs[:50]),
                    jt.surfaces_for_rays(pos[:50], dirs[:50])):
        np.testing.assert_array_equal(a, b)


def test_engine_candidates_equal_tracer_tpu():
    """The per-ray candidate rows of one traversal, dead lanes given
    none, bucketed to a power of two: equal to tracer_tpu's."""
    _, pm = _scene_meta(_plate_field, ptt)
    _, jm = _scene_meta(_plate_field, tracer_tpu)
    pos, dirs = _rays(2000, seed=2)
    alive = np.random.default_rng(3).uniform(size=2000) > 0.2
    pb = RayBundle.create(pos, dirs, alive=alive, **F64)
    jb = tracer_tpu.RayBundle.create(pos, dirs, alive=alive)
    got = TracerEngine._candidates(KdTree(pm), pb)
    want = np.asarray(JaxEngine._candidates(JaxKdTree(jm), jb))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[~torch.as_tensor(alive)] == -1).all()


@pytest.mark.parametrize("name", sorted(SCENES))
def test_nearest_hit_candidates_equal_tracer_tpu(name):
    """Both packages' candidate intersection on the same candidate lists
    (the tree's, shuffled, some lanes' last column a repeat or a pad):
    t to 1e-12 and sid equal in float64; every row a candidate gives the
    brute-force oracle's hits."""
    ps, pm = _scene_meta(SCENES[name], ptt)
    js, _ = _scene_meta(SCENES[name], tracer_tpu)
    n = 3000
    pos, dirs = _rays(n, seed=4)
    if name == "mixed":
        pos, dirs = pos * [0.4, 0.4, 1.6], -dirs
        pos[:, 2] = -2.0
    rng = np.random.default_rng(5)
    S = ps.num_rows
    mask = KdTree(pm).traversal(pos, dirs)
    cand = np.full((n, mask.sum(0).max() + 1), -1, dtype=np.int32)
    for i in range(n):
        rows = rng.permutation(np.nonzero(mask[:, i])[0])
        cand[i, :len(rows)] = rows
        if len(rows) and i % 3 == 0:
            cand[i, len(rows)] = rows[0]
    tp, sp = nearest_hit_candidates(ps, torch.as_tensor(cand),
                                    torch.as_tensor(pos),
                                    torch.as_tensor(dirs))
    tj, sj = jax_candidates(js, jnp.asarray(cand), jnp.asarray(pos),
                            jnp.asarray(dirs))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj))
    np.testing.assert_allclose(tp.numpy(), np.asarray(tj), rtol=1e-12)
    assert (sp.numpy() >= 0).mean() > 0.1
    every = torch.arange(S, dtype=torch.int32).expand(n, S)
    ta, sa = nearest_hit_candidates(ps, every, torch.as_tensor(pos),
                                    torch.as_tensor(dirs))
    to, so = nearest_hit(ps, torch.as_tensor(pos), torch.as_tensor(dirs))
    np.testing.assert_array_equal(sa.numpy(), so.numpy())
    np.testing.assert_array_equal(sa.numpy(), sp.numpy())
    np.testing.assert_allclose(ta.numpy(), to.numpy(), rtol=1e-12)


def _sun(pkg, n, seed):
    x = -1.0 / np.sqrt(2.0)
    kw = dict(center=[0.0, 7.0, 7.0], direction=[0.0, x, x], radius=3.0,
              ang_range=0.005, flux=1000.0)
    if pkg is ptt:
        return ptt.sources.disk_bundle(torch.Generator().manual_seed(seed),
                                       n, **kw, **F64)
    return tracer_tpu.sources.disk_bundle(jax.random.PRNGKey(seed), n, **kw)


def test_accel_on_off_identical_trace(caplog):
    """tests/test_accel.py:85-107 on the port: ray_tracer with
    accel="lightweight" gives brute force's per-surface absorbed energy
    to 1e-9 (and its sids bounce by bounce), closes to 1e-6, builds the
    tree once with tracer_tpu's log line and logs each bounce's
    candidates a ray; tracer_tpu's accel trace of the same rays agrees
    to 1e-9."""
    eng = TracerEngine(_mixed_scene(ptt), **F64)
    bundle = _sun(ptt, 4096, 5)
    off = eng.ray_tracer(bundle, reps=20)
    with caplog.at_level(logging.INFO, logger="tracer_tpu_torch"):
        on = eng.ray_tracer(bundle, reps=20, accel="lightweight")
    np.testing.assert_allclose(on.absorbed_by_logical(),
                               off.absorbed_by_logical(), rtol=1e-9)
    assert len(on.records) == len(off.records)
    for a, b in zip(on.records, off.records):
        np.testing.assert_array_equal(a.sid.numpy(), b.sid.numpy())
    bal = on.energy_balance()
    assert abs(bal["closure"]) < 1e-6 * bal["source"]
    msgs = [r.message for r in caplog.records]
    assert sum("kdtree build" in m for m in msgs) == 1
    widths = [int(m.group(1)) for m in
              (re.search(r"(\d+) candidates/ray", s) for s in msgs) if m]
    assert len(widths) == len(on.records)
    assert max(widths) <= 1 << (eng.scene.num_rows - 1).bit_length()
    jeng = JaxEngine(_mixed_scene(tracer_tpu))
    fields = {f: np.asarray(getattr(bundle, f))
              for f in ("pos", "dir", "energy")}
    jres = jeng.ray_tracer(tracer_tpu.RayBundle.create(**fields), reps=20,
                           accel="lightweight")
    np.testing.assert_allclose(on.absorbed_by_logical(),
                               jres.absorbed_by_logical(), rtol=1e-9)


def test_accel_prunes_on_a_plate_field(caplog):
    """tests/test_accel.py:110-128: 49 plates, at most 16 candidates a
    ray, the per-bounce line logged."""
    eng = TracerEngine(_plate_field(ptt, n_side=7), **F64)
    sun = ptt.sources.disk_bundle(torch.Generator().manual_seed(1), 512,
                                  center=[0.0, 0.0, 6.0],
                                  direction=[0.0, 0.0, -1.0], radius=8.0,
                                  ang_range=0.01, flux=1000.0, **F64)
    with caplog.at_level(logging.INFO, logger="tracer_tpu_torch"):
        res = eng.ray_tracer(sun, reps=4, accel="lightweight")
    msgs = [r.message for r in caplog.records]
    assert any("trace time" in m and "alive" in m for m in msgs)
    widths = [int(m.group(1)) for m in
              (re.search(r"(\d+) candidates/ray", s) for s in msgs) if m]
    assert widths and max(widths) <= 16
    np.testing.assert_allclose(res.absorbed_by_logical(),
                               eng.ray_tracer(sun, reps=4)
                               .absorbed_by_logical(), rtol=1e-9)
    with pytest.raises(ValueError, match="SceneMeta"):
        TracerEngine(eng.scene).ray_tracer(sun, accel=True)


def test_accel_float32_flips_bounded():
    """float32 on the CPU: brute force is K3's plain version (class
    solves, the flat rows' L1 guard), the candidates the general quadric;
    near ties and guard edges may flip a sid, at most 1e-3 of the lanes
    of each bounce."""
    eng = TracerEngine(_mixed_scene(ptt), device="cpu")
    bundle = ptt.sources.disk_bundle(
        torch.Generator().manual_seed(6), 8192, center=[0.0, 7.0, 7.0],
        direction=[0.0, -0.5 ** 0.5, -0.5 ** 0.5], radius=3.0,
        ang_range=0.005, flux=1000.0, device="cpu")
    off = eng.ray_tracer(bundle, reps=20)
    on = eng.ray_tracer(bundle, reps=20, accel=True)
    for a, b in zip(on.records, off.records):
        live = b.alive_in.numpy()
        assert (a.sid.numpy() != b.sid.numpy())[live].sum() \
            <= 1e-3 * live.size + 1
    src = off.energy_balance()["source"]
    assert np.abs(on.absorbed_by_logical()
                  - off.absorbed_by_logical()).max() < 1e-3 * src


def test_unbounded_kinds_always_relevant():
    """tests/test_accel.py:139-160: an infinite plane is always relevant,
    its token box in no node."""
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    plane = sc.Surface(G.flat(), M.absorber(), location=[50.0, 0.0, 0.0])
    plate = sc.Surface(G.rect_plate(1.0, 1.0), M.absorber(),
                       location=[0.0, 0.0, 2.0])
    eng = TracerEngine(sc.Assembly(objects=[sc.AssembledObject(
        surfs=[plane, plate])]), **F64)
    tree = KdTree(eng.meta)
    assert len(tree.always_relevant) == 1
    mask = tree.traversal(np.array([[200.0, 0.0, 1.0]]),
                          np.array([[0.0, 0.0, -1.0]]))
    assert mask[tree.always_relevant[0], 0]
    assert not mask[1 - tree.always_relevant[0], 0]


def test_intersect_bounds_on_slab_plane_parallel_ray():
    """tests/test_accel.py:163-172: an origin exactly on an AABB face
    with the matching direction component 0 is inside that slab."""
    bounds = np.array([[0.0, -1.0, -1.0], [2.0, 1.0, 1.0]])
    pos = np.array([[0.0, 0.0, 5.0], [3.0, 0.0, 5.0]])
    dirs = np.array([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    np.testing.assert_array_equal(KdTree.intersect_bounds(bounds, pos, dirs),
                                  [True, False])


def test_ray_tree_equals_tracer_tpu():
    """RayTree over both packages' float64 MiniDish traces of the same
    rays: levels, parents, each level's record and the histories of a
    few slots (sids, hit points to 1e-9, energies to 1e-9)."""
    from tracer_tpu.trace_tree import RayTree as JaxRayTree
    from tracer_tpu_torch.trace_tree import RayTree
    bundle = _sun(ptt, 2048, 8)
    res = TracerEngine(_mixed_scene(ptt), **F64).ray_tracer(bundle, reps=20)
    fields = {f: np.asarray(getattr(bundle, f))
              for f in ("pos", "dir", "energy")}
    jres = JaxEngine(_mixed_scene(tracer_tpu)).ray_tracer(
        tracer_tpu.RayBundle.create(**fields), reps=20)
    tree, jtree = RayTree(res), JaxRayTree(jres)
    assert tree.num_bunds == jtree.num_bunds == len(res.records) + 1 >= 4
    np.testing.assert_array_equal(tree.ordered_parents(2),
                                  jtree.ordered_parents(2))
    for level in range(tree.num_bunds - 1):
        np.testing.assert_array_equal(tree.bounce(level).sid.numpy(),
                                      np.asarray(jtree.bounce(level).sid))
    for slot in (0, 7, 513, 2047):
        for lv in (None, 1):
            got, want = tree.ray_history(slot, lv), jtree.ray_history(slot,
                                                                      lv)
            assert [h["sid"] for h in got] == [h["sid"] for h in want]
            for g, w in zip(got, want):
                np.testing.assert_allclose(g["hit"], w["hit"], rtol=1e-9,
                                           atol=1e-9)
                for k in ("e_in", "e_out"):
                    np.testing.assert_allclose(g[k], w[k], rtol=1e-9)
