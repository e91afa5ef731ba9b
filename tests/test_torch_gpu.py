"""The CUDA kernels against their plain PyTorch versions on the card.

Runs only where torch sees an NVIDIA GPU (elsewhere it skips). The GPU
machine has no jax, so run it without the suite's jax-based conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py

The ray helpers and the fuzzed scene here also feed the CPU parity tests
of tests/test_torch_bounce.py and tests/test_torch_intersect.py.
"""
import numpy as np
import pytest
import torch

import tracer_tpu_torch as ptt
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.models import nsttf

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

TILES = (300, 301, 302)     # two traced tiles and an idle one
ACTIVE = (1, 1, 0)
T_EPS = 3e-4


def aimed_rays(meta, culling, sun, seed=0):
    """Rays of the TILES' lanes, each aimed at a random point near one of
    its tile's candidate heliostats: 80% from the sun side, 10% at random
    downward angles, 10% from below (back-face hits); 5% of lanes dead."""
    rng = np.random.default_rng(seed)
    n = kb.TILE * len(TILES)
    tile = np.repeat(np.arange(len(TILES)), kb.TILE)
    rows = np.empty(n, dtype=np.int64)
    for k, b in enumerate(TILES):
        cand = culling.lists[b][culling.lists[b] >= 0]
        cand = cand[cand != meta.index_of("receiver")] if len(cand) > 1 \
            else cand
        rows[tile == k] = rng.choice(cand, kb.TILE)
    fr = meta.frames[rows]
    local = np.stack([rng.uniform(-3.6, 3.6, n), rng.uniform(-3.6, 3.6, n),
                      np.zeros(n)], axis=1)
    pts = np.einsum("nij,nj->ni", fr[:, :3, :3], local) + fr[:, :3, 3]
    d = -sun + rng.normal(0.0, 0.01, (n, 3))
    kind = rng.uniform(size=n)
    rnd = rng.normal(size=(n, 3))
    rnd[:, 2] = -np.abs(rnd[:, 2]) - 0.3
    d = np.where((kind > 0.8)[:, None], rnd, d)
    d = np.where((kind > 0.9)[:, None], -d, d)          # from below
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = pts - d * rng.uniform(20.0, 200.0, (n, 1))
    e = np.where(rng.uniform(size=n) < 0.05, 0.0, rng.uniform(0.5, 2.0, n))
    return (pos.astype(np.float32), d.astype(np.float32),
            e.astype(np.float32))


# aperture kind -> its parameters in a surface's local frame (kinds that
# leave the surface unbounded get a RECT bound beside them). No boundary
# may run along a surface: a radial bound of 0.8 on the 0.8 m sphere
# would hold with equality along its whole equator.
AP_PARAMS = {1: (0.6, 0.4), 2: (0.2, 0.7), 3: (-0.5, 0.5), 4: (0.3, 4.0),
             5: (0.3,), 6: (0.8,), 7: (-0.7, -0.5, 0.8, -0.4, 0.0, 0.9),
             8: (0.1, 0.0, 0.3, 0.2), 9: (0.0, 0.1, 0.3),
             10: (0.1, -0.1, 0.7), 11: (0.0, 0.0, 0.0, 0.9),
             12: (0.6, 0.8, 0.4), 13: (-0.3, -0.2, 0.3, -0.2, 0.0, 0.3)}
UNBOUNDED = (3, 4, 5, 8, 9, 12, 13)
CLASSES = ("flat", "parab", "sphere", "quadric")


def fuzz_assembly(pkg, seed: int, extra: int = 0):
    """A scene with every quadric class and every aperture kind, built
    with the package ``pkg`` (tracer_tpu or tracer_tpu_torch, which share
    the host API): one K_REFLECT row per aperture kind on a rotating
    class, plus one more row of each class, plus ``extra`` rect rows of
    random classes (groups of hundreds of rows), each at a random pose."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene
    rng = np.random.default_rng(seed)
    base = {"flat": G.flat, "parab": lambda: G.paraboloid(1.2, 0.9),
            "sphere": lambda: G.sphere(0.8),
            "quadric": lambda: G.ellipsoid(0.9, 0.6, 0.7)}
    cases = [(k, CLASSES[(k + seed) % 4]) for k in AP_PARAMS]
    cases += [(int(rng.integers(1, 14)), c) for c in CLASSES]
    cases += [(G.AP_RECT, CLASSES[int(c)])
              for c in rng.integers(0, 4, extra)]
    surfs = []
    for i, (k, cls) in enumerate(cases):
        aps = [G._c(k, *AP_PARAMS[k])]
        if k in UNBOUNDED and cls in ("flat", "parab"):
            aps.append(G._c(G.AP_RECT, 1.0, 1.0))
        geom = base[cls]().with_aperture(*aps)
        rot = (sp.rotx(rng.uniform(0, 2 * np.pi))[:3, :3]
               @ sp.roty(rng.uniform(0, np.pi))[:3, :3])
        spread = 2.0 + 0.04 * extra ** 0.5          # a few rows per m^3
        surfs.append(sc.Surface(geom, M.reflective(rng.uniform(0.0, 0.3)),
                                location=rng.uniform(-spread, spread,
                                                     3).tolist(),
                                rotation=rot, name=f"s{i}"))
    return sc.Assembly([sc.AssembledObject(surfs)])


def fuzz_rays(meta, n: int, seed: int):
    """n float32 rays, each aimed from 1-5 m away, from a random direction,
    at a random point within 1 m of a random row's origin."""
    rng = np.random.default_rng(seed)
    fr = meta.frames[rng.integers(0, len(meta.frames), n)]
    local = rng.uniform(-1.0, 1.0, (n, 3)) * [1.0, 1.0, 0.3]
    pts = np.einsum("nij,nj->ni", fr[:, :3, :3], local) + fr[:, :3, 3]
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = pts - d * rng.uniform(1.0, 5.0, (n, 1))
    return pos.astype(np.float32), d.astype(np.float32)


def k3_compare(got, want, t12, pos, dirs, rtol=1e-5, max_flips=0):
    """K3 results (t, sid, aux) against another version's (``want``).

    Two float32 versions of the same arithmetic round differently: by a
    few ulps of the ray's scale L = 1 + max|pos| and of t, amplified near
    tangency by the discriminant's conditioning, 1 / cos^2 of the angle of
    incidence (cos^2 floored at 1e-4). So on lanes that hit, t and each
    aux vector component must agree within rtol * (L + t) / cos^2, the
    aux relative to 1 + the lane's largest component; kind and flags
    exactly. Ties are lanes whose best and second-best t lie within 1e-5
    (L + t) of each other: either row may win there. Flips are the other
    lanes where the versions disagree on sid or on t: a hit point within
    rounding of an aperture edge or of the self-hit guard, which FMA
    contraction may decide (the other root of the same row, or another
    row). At most ``max_flips`` are allowed. Returns (ties, flips)."""
    t1, t2 = t12
    scale = 1.0 + pos.abs().amax(dim=1)
    tie = (t2 - t1) <= 1e-5 * (scale + t1)
    n = want[2]["normal"]
    cos2 = ((dirs * n).sum(1) ** 2
            / (n * n).sum(1).clamp(min=1e-30)).clamp(min=1e-4)
    base = (scale + torch.where(want[1] >= 0, want[0], 0.0)) / cos2
    t_ok = ((got[0] - want[0]).abs() <= rtol * base) | (
        torch.isinf(got[0]) & torch.isinf(want[0]))
    agree = (got[1] == want[1]) & t_ok
    flips = int((~agree & ~tie).sum())
    assert flips <= max_flips, (flips, torch.nonzero(~agree & ~tie)[:5])
    hit = (want[1] >= 0) & agree & ~tie
    base = base[hit]
    for k in ("normal", "local", "up_dot", "p0", "p1"):
        g, w = got[2][k][hit], want[2][k][hit]
        if w.ndim == 2:
            err = (g - w).abs().amax(dim=1)
            w = w.abs().amax(dim=1)
        else:
            err = (g - w).abs()
        assert (err <= rtol * (1.0 + w.abs()) * base).all(), k
    for k in ("kind", "flags"):
        assert torch.equal(got[2][k][hit], want[2][k][hit]), k
    return int(tie.sum()), flips


def tile_args(culling):
    """(lists, counts, cells, cell_bounds) of the TILES, as numpy."""
    idx = np.asarray(TILES)
    return (culling.lists[idx], culling.counts[idx], idx.astype(np.int32),
            culling.cell_bounds[idx])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                    "mode (python3 chip_smoke.py runs them on the card)")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_match_plain_on_gpu(cuda_device):
    """Both CUDA kernels against their plain versions, same inputs and
    random streams, slope error and regeneration on: sid equal on >=
    99.99% of lanes; on those, pos within 1e-5 relative + 1e-2 m, dir
    within 1e-5, energy within 1e-5 relative."""
    dev = cuda_device
    slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)
    table, meta, info = nsttf.build_scene(device="cpu")
    spec = nsttf.make_source_fn(info, slab).pallas_spec
    culling = build_block_culling(table, meta, spec, slab)
    pos, dirs, e = (torch.tensor(a, device=dev) for a in
                    aimed_rays(meta, culling, info["sun"], seed=3))
    e[: kb.TILE // 2] = 0.0
    rows = kb.pack_rows(table).to(dev)
    lists, counts, cells, cb = (torch.tensor(a, device=dev)
                                for a in tile_args(culling))
    rem = torch.full((len(TILES),), 500, dtype=torch.int32, device=dev)
    act = torch.tensor(ACTIVE, dtype=torch.int32, device=dev)
    args = (rows, lists, counts, cells, cb, 5, rem, act, pos, dirs, e,
            table.groups, culling.group_offsets, T_EPS)
    n0 = kb.bounce_reflect_culled.launches
    got = kb.bounce_reflect_culled(*args, source_spec=spec)
    want = kb.bounce_reflect_culled_ref(*args, source_spec=spec)
    assert kb.bounce_reflect_culled.launches == n0 + 1
    n0 = kb.bounce_reflect.launches
    got2 = kb.bounce_reflect(rows, 9, pos, dirs, e, table.groups, T_EPS)
    want2 = kb.bounce_reflect_ref(rows, 9, pos, dirs, e, table.groups,
                                  T_EPS)
    assert kb.bounce_reflect.launches == n0 + 1
    torch.cuda.synchronize()
    for g, w in ((got, want), (got2, want2)):
        same = g[3] == w[3]
        assert same.float().mean() > 0.9999
        torch.testing.assert_close(g[0][same], w[0][same], rtol=1e-5,
                                   atol=1e-2)
        torch.testing.assert_close(g[1][same], w[1][same], rtol=0,
                                   atol=1e-5)
        torch.testing.assert_close(g[2][same], w[2][same], rtol=1e-5,
                                   atol=0)
        torch.testing.assert_close(g[4][same], w[4][same], rtol=1e-5,
                                   atol=0)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrappers run the plain versions (no launch)."""
    slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)
    table, meta, info = nsttf.build_scene(device="cpu")
    spec = nsttf.make_source_fn(info, slab).pallas_spec
    culling = build_block_culling(table, meta, spec, slab)
    pos, dirs, e = (torch.tensor(a) for a in
                    aimed_rays(meta, culling, info["sun"], seed=4))
    rows = kb.pack_rows(table)
    lists, counts, cells, cb = (torch.tensor(a) for a in tile_args(culling))
    rem = torch.full((len(TILES),), 500, dtype=torch.int32)
    act = torch.tensor(ACTIVE, dtype=torch.int32)
    args = (rows, lists, counts, cells, cb, 5, rem, act, pos, dirs, e,
            table.groups, culling.group_offsets, T_EPS)
    n1, n2 = kb.bounce_reflect_culled.launches, kb.bounce_reflect.launches
    for g, w in zip(kb.bounce_reflect_culled(*args, source_spec=spec),
                    kb.bounce_reflect_culled_ref(*args, source_spec=spec)):
        assert torch.equal(g, w)
    for g, w in zip(kb.bounce_reflect(rows, 9, pos, dirs, e, table.groups,
                                      T_EPS),
                    kb.bounce_reflect_ref(rows, 9, pos, dirs, e,
                                          table.groups, T_EPS)):
        assert torch.equal(g, w)
    assert (kb.bounce_reflect_culled.launches, kb.bounce_reflect.launches) \
        == (n1, n2)


@pytest.mark.cuda
@pytest.mark.parametrize("need_local", (True, False))
def test_nearest_hit_matches_plain_on_gpu(cuda_device, need_local):
    """K3 against its plain version on the card, on a table with every
    quadric class and aperture kind, on the same with 2,000 more rows
    (groups that span several of the kernel's staged chunks) and on the
    NSTTF table: sid equal off ties, t and aux within 1e-5 of their scale
    (k3_compare); one launch per call."""
    dev = cuda_device
    table, meta = ptt.compile_scene(fuzz_assembly(ptt, 0), device=dev)
    big, big_meta = ptt.compile_scene(fuzz_assembly(ptt, 1, extra=2000),
                                      device=dev)
    chunk = kn.STAGE_FLOATS // kb.row_width(big)
    assert max(g[1] - g[0] for g in big.groups) > chunk
    nsttf_table, nsttf_meta, _ = nsttf.build_scene(device=dev)
    for tab, met, n in ((table, meta, 1 << 18), (big, big_meta, 1 << 16),
                        (nsttf_table, nsttf_meta, 1 << 16)):
        rows = kb.pack_rows(tab)
        pos, dirs = (torch.tensor(a, device=dev)
                     for a in fuzz_rays(met, n, seed=5))
        args = (rows, pos, dirs, tab.groups, T_EPS)
        n0 = kn.nearest_hit.launches
        got = kn.nearest_hit(*args, need_local=need_local)
        assert kn.nearest_hit.launches == n0 + 1
        want = kn.nearest_hit_ref(*args, need_local=need_local)
        torch.cuda.synchronize()
        assert (want[1] >= 0).float().mean() > 0.3
        ties, flips = k3_compare(got, want, kn.nearest_two_t(*args), pos,
                                 dirs, max_flips=int(1e-5 * n) + 1)
        assert ties <= 1e-4 * n
