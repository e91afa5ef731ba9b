"""The CUDA kernels against their plain PyTorch versions on the card.

Runs only where torch sees an NVIDIA GPU (elsewhere it skips). The GPU
machine has no jax, so run it without the suite's jax-based conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_gpu.py

The ray helpers, the fuzzed scene and the comparisons here also feed the
CPU parity tests (tests/test_torch_bounce.py, tests/test_torch_intersect.py,
tests/test_torch_megakernel.py, tests/test_torch_emulated.py) and
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import tracer_tpu_torch as ptt
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.models import nsttf
from tracer_tpu_torch.models.bench_configs import (BENCH, BENCH_FLUX,
                                                   bench_assembly,
                                                   bench_scene)

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


def bench_modes(table, spec):
    """K2's keyword arguments for a bench scene's trace (its static modes,
    the spectral table, the source's ambient medium and the media pair; no
    pose: the wrappers take the spec's own)."""
    feats = set(table.features)
    refr = ptt.materials.K_REFRACTIVE in table.kinds_present
    tab = (torch.stack([table.spectral_wl, table.spectral_ab], dim=1)
           .contiguous() if feats & {"spectral", "dispersive"} else None)
    att, scat, g = ptt.engine._spec_medium(spec)
    return dict(bivar=ptt.engine._bivar_mode(table),
                one_sided="one_sided" in feats,
                slope="slope_error" in feats,
                lambertian=ptt.materials.K_LAMBERTIAN in table.kinds_present,
                source_spec=spec, spectral_tab=tab, ambient_att=att,
                ambient_scat=scat, ambient_g=g,
                refr_frost=refr and "refractive_slope" in feats,
                refr_disp=refr and "dispersive" in feats,
                media=ptt.engine._media_for(table, spec))


def bench_lanes(table, spec, n: int, dead: float, seed: int, device):
    """n lanes of K2 input: rays drawn from the source, a random half of
    them carried through one bounce of the plain version (so the lanes
    hit the scene's rows from the source and from its first bounce; rays
    that missed there keep their state), then a ``dead`` share of all
    lanes without energy. Wavelengths come with the source's band, indices
    with refractive rows and medium ids with the media mode. Returns (pos,
    dirs, energy, lanes): ``lanes`` the wavelength, ref_index and
    medium_id keywords (None where the mode is off)."""
    modes = bench_modes(table, spec)
    idx = torch.arange(n, device=device)
    f = kb._sample_disk(spec, kb.source_pose(spec), seed, idx // kb.TILE,
                        idx % kb.TILE)
    pos, dirs = torch.stack(f[0:3], dim=1), torch.stack(f[3:6], dim=1)
    e = torch.full((n,), float(kb.source_params(spec)[kb.SP_ERAY]),
                   device=device)
    refr = ptt.materials.K_REFRACTIVE in table.kinds_present
    lanes = dict(
        wavelength=f[6] if modes["spectral_tab"] is not None else None,
        ref_index=torch.ones(n, device=device) if refr else None,
        medium_id=(torch.zeros(n, device=device)
                   if modes["media"] is not None else None))
    out = kb.bounce_reflect_ref(kb.pack_rows(table), seed + 1, pos, dirs, e,
                                table.groups, T_EPS, **lanes, **modes)
    g = torch.Generator().manual_seed(seed)
    moved = (torch.rand(n, generator=g) < 0.5).to(device)
    pos = torch.where(moved[:, None], out[0], pos)
    dirs = torch.where(moved[:, None], out[1], dirs)
    e = torch.where(moved & (out[3] != -1), out[2], e)
    rest = iter(out[5:])
    for k, v in lanes.items():
        if v is not None:
            lanes[k] = torch.where(moved, next(rest), v)
    e = torch.where((torch.rand(n, generator=g) < dead).to(device), 0.0, e)
    return pos, dirs, e, lanes


def traced_rays(spec, seed: int, pos, dirs, energy, regen: bool):
    """The rays K2 traces: with regen, the dead lanes' fresh ones."""
    if not regen:
        return pos, dirs
    idx = torch.arange(pos.shape[0], device=pos.device)
    f = kb._sample_disk(spec, kb.source_pose(spec), seed, idx // kb.TILE,
                        idx % kb.TILE)
    reborn = (energy <= 0.0)[:, None]
    return (torch.where(reborn, torch.stack(f[0:3], 1), pos),
            torch.where(reborn, torch.stack(f[3:6], 1), dirs))


def medium_att(kw) -> float:
    """The largest attenuation coefficient a lane of K2's call ``kw`` can
    travel in."""
    if kw.get("media") is not None:
        return max(a for a, _, _ in kw["media"][0])
    return kw["ambient_att"]


def k2_near(rows, pos, dirs, groups, t_eps: float = T_EPS):
    """What k2_compare needs of the rays K2 traced: their two nearest hit
    distances (kn.nearest_two_t), and their winner row's unnormalised
    normal and optical kind (the plain version's, kn.nearest_hit_ref)."""
    t1, t2 = kn.nearest_two_t(rows, pos, dirs, groups, t_eps)
    aux = kn.nearest_hit_ref(rows, pos, dirs, groups, t_eps,
                             need_local=False)[2]
    return t1, t2, aux["normal"], aux["kind"]


def k2_compare(got, want, near, pos, dirs, live, att=0.0, rtol=1e-5,
               max_flips=0, decisions=False):
    """K2 results (pos, dir, energy, sid, absorbed[, wavelength][, index]
    [, medium id]) against another version's on the ``live`` lanes
    (``pos``/``dirs`` the rays each traced after regeneration,
    traced_rays; ``near`` their k2_near). Ties (best and second-best t
    within 1e-5 of the scale) may pick either row; at most ``max_flips``
    of them, but where the winner is refractive: a lens's two caps meet
    along a seam, where lanes hit both at one point (at most 1% of the
    lanes). Flips are other lanes whose sid differs (a hit within rounding
    of an aperture edge or the self-hit guard, or a free path within
    rounding of the hit distance), at most ``max_flips``. With
    ``decisions`` (the Fresnel roulette's u <= R) lanes whose sid agrees
    but whose index or medium id does not count as flips too: a uniform
    within rounding of R went the other way. On the other lanes,
    moved points agree within rtol * (L + d) / cos^2 (k3_compare's scale,
    L = 1 + max|pos|, d the distance moved; cos^2 is 1 on scattered
    lanes), directions within 10 rtol / cos^2 (slope error and Lambertian
    lobes turn about that normal) or, on a scattered lane, 10 rtol / sin
    of its scattering angle, energies and absorbed energies within 10 rtol
    relative plus what the moved point's rounding moves through an
    attenuation ``att``, the other lanes within 1e-6 relative (FMA
    contraction). On a refractive winner cos is the smaller of the
    incident and the outgoing direction's against its normal (Snell's
    conditioning); elsewhere it comes from the turned direction. Returns
    (ties, flips, max abs error)."""
    t1, t2, normal, kind = near
    scale = 1.0 + pos.abs().amax(dim=1)
    tie = live & ((t2 - t1) <= 1e-5 * (scale + t1))
    refr = kind == ptt.materials.K_REFRACTIVE
    n_tie = int((tie & ~refr).sum())
    assert n_tie <= max_flips, ("ties", n_tie)
    assert int((tie & refr).sum()) <= 0.01 * int(live.sum()), "seam ties"
    same = got[3] == want[3]
    flips = int((live & ~same & ~tie).sum())
    ok = live & same & ~tie
    moved = ok & (want[3] != -1)
    # cos^2 of the incidence angle from the turned direction (1 on misses
    # and scattered lanes); the Lambertian rows' lobes only get a looser
    # scale. A refraction turns the direction by far less than a
    # reflection: there both the incident and the outgoing direction are
    # held against the winner's normal
    turn = want[1] - dirs
    cos2 = (dirs * turn).sum(1) ** 2 / (turn * turn).sum(1).clamp(min=1e-30)
    n_hat = normal / normal.norm(dim=1, keepdim=True).clamp(min=1e-30)
    cos_io = torch.minimum((dirs * n_hat).sum(1).abs(),
                           (want[1] * n_hat).sum(1).abs())
    cos2 = torch.where(refr, cos_io ** 2, cos2)
    cos2 = torch.where(want[3] >= 0, cos2, 1.0).clamp(min=1e-4)
    dist = (want[0] - pos).norm(dim=1)
    base = (scale + torch.where(want[3] >= 0, t1, dist)) / cos2
    d_pos = (got[0] - want[0]).abs().amax(dim=1)
    d_dir = (got[1] - want[1]).abs().amax(dim=1)
    # an HG direction leaves at sin = sqrt(1 - cos^2) of the scattering
    # angle, whose rounding grows as 1 / sin near the travel direction
    sin_sc = torch.sqrt((1.0 - (dirs * want[1]).sum(1) ** 2).clamp(min=0.0))
    c_dir = torch.where(want[3] == -2, sin_sc.clamp(min=1e-4), cos2)
    lane_bad = torch.zeros_like(ok)
    for k in range(5, len(got)):
        lane_bad |= (got[k] - want[k]).abs() > 1e-6 * want[k].abs()
    if decisions:
        # one version reflected, the other crossed: the index (or, at an
        # index-matched interface, the medium id) tells them apart
        bad = ok & lane_bad
        flips += int(bad.sum())
        ok, moved = ok & ~bad, moved & ~bad
    assert flips <= max_flips, (flips, torch.nonzero(live & ~same & ~tie)[:5])
    assert (d_pos[moved] <= rtol * base[moved]).all(), "pos"
    assert (d_dir[ok] <= 10 * rtol / c_dir[ok]).all(), "dir"
    for k, name in ((2, "energy"), (4, "absorbed")):
        g, w = got[k][ok], want[k][ok]
        tol = (10 * rtol + att * rtol * base[ok]) * w.abs()
        assert ((g - w).abs() <= tol).all(), name
    assert not lane_bad[ok if decisions else live].any(), "wl, ri or mid"
    big = [float((got[k][ok] - want[k][ok]).abs().max()) if ok.any() else 0.0
           for k in (0, 1, 2, 4)]
    return int(tie.sum()), flips, max(big)


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


def k2_scene(scene, n: int, device):
    """(table, spec) of a K2 mode's scene: a bench configuration, or one of
    the two that reach K2's other instances through trace_streaming:
    "lens_hg", config 6's lens in config 8's ambient HG medium
    (refraction and scattering), and "slab_media", an absorbing slab
    between two index-matched absorbant_interface discs over an absorber
    (media ids without scattering)."""
    if scene in BENCH:
        table, _, source_fn = bench_scene(scene, n, device)
        return table, source_fn.pallas_spec
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    if scene == "lens_hg":
        asm, _ = bench_assembly(ptt, 6)
        c, m = BENCH[6], BENCH[8]
        spec = ptt.sources.disk_pillbox_pallas_spec(
            n, c["center"], c["direction"], c["radius"], c["ang_range"],
            BENCH_FLUX, ambient_att=m["att"], ambient_scat=m["scat"],
            ambient_g=m["g"])
    else:
        surfs = [sc.Surface(G.round_plate(1.0), M.absorbant_interface(1.5),
                            location=[0.0, 0.0, z], name=name)
                 for z, name in ((0.6, "b1"), (0.2, "b2"))]
        surfs.append(sc.Surface(G.round_plate(1.0),
                                M.absorber(one_sided=False), name="plate"))
        asm = sc.Assembly([sc.AssembledObject(surfs)])
        spec = ptt.sources.disk_pillbox_pallas_spec(
            n, [0.0, 0.0, 1.2], [0.0, 0.0, -1.0], 0.3, 0.3, BENCH_FLUX)
    table, _ = ptt.compile_scene(asm, device=device)
    return table, spec


# K2's modes, one or more for each of its six instances <kRefr, kScat,
# kMedia>: (scene of k2_scene, dead share, regen)
K2_MODES = {"regen": (1, 0.5, True), "minidish": (1, 0.0, False),
            "lambertian": (2, 0.5, True), "spectral": (3, 0.5, True),
            "lens": (6, 0.5, True), "ambient_hg": (8, 0.5, True),
            "media": ("8b", 0.5, True), "lens_hg": ("lens_hg", 0.5, True),
            "slab_media": ("slab_media", 0.5, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_modes_match_plain_on_gpu(cuda_device, mode):
    """K2 in each of its instances against its plain version on the card,
    same inputs and random streams: regeneration over a half-dead slab,
    the MiniDish's paraboloid and rect rows, config 2's Lambertian
    absorber and bivariate slope error, config 3's spectral mirror in an
    attenuating medium, config 6's lens (Fresnel roulette), config 8's
    ambient HG medium, 8b's media ids, the lens in that HG medium and
    absorbing media without scattering (k2_compare: edge flips and
    roulette flips at most 1e-5 of the lanes, ties too but on the lens's
    seam); one launch per call."""
    dev = cuda_device
    cfg, dead, regen = K2_MODES[mode]
    n = 64 * kb.TILE
    table, spec = k2_scene(cfg, n, dev)
    pos, dirs, e, lanes = bench_lanes(table, spec, n, dead, 3, dev)
    rows = kb.pack_rows(table)
    kw = dict(regen=regen, **lanes, **bench_modes(table, spec))
    n0 = kb.bounce_reflect.launches
    got = kb.bounce_reflect(rows, 17, pos, dirs, e, table.groups, T_EPS,
                            **kw)
    assert kb.bounce_reflect.launches == n0 + 1
    want = kb.bounce_reflect_ref(rows, 17, pos, dirs, e, table.groups,
                                 T_EPS, **kw)
    torch.cuda.synchronize()
    tp, td = traced_rays(spec, 17, pos, dirs, e, regen)
    live = (e > 0.0) | (e <= 0.0) & regen
    k2_compare(got, want, k2_near(rows, tp, td, table.groups), tp, td, live,
               att=medium_att(kw), max_flips=int(1e-5 * n) + 1,
               decisions=lanes["ref_index"] is not None)
    assert (want[3][live] != -1).float().mean() > 0.2


def k2_instance(kw):
    """The template instance <kRefr, kScat, kMedia> K2's call ``kw`` runs
    (tt_bounce's dispatch in csrc/bounce.cu)."""
    scat = (kb.media_flags(kw["media"])[1] if kw["media"] is not None
            else kw["ambient_scat"] > 0.0)
    return (kw["ref_index"] is not None, scat, kw["media"] is not None)


def test_k2_modes_cover_every_instance():
    """K2_MODES runs each of K2's six template instances, so the emulated
    and on-card comparisons hold every one against the plain version."""
    seen = set()
    for scene, _, _ in K2_MODES.values():
        table, spec = k2_scene(scene, kb.TILE, "cpu")
        refr = ptt.materials.K_REFRACTIVE in table.kinds_present
        kw = dict(bench_modes(table, spec),
                  ref_index=torch.ones(1) if refr else None)
        seen.add(k2_instance(kw))
    assert seen == {(False, False, False), (False, True, False),
                    (True, False, False), (True, True, False),
                    (True, False, True), (True, True, True)}


@pytest.mark.cuda
def test_plain_megakernel_trace_closes_on_gpu(cuda_device):
    """A small plain-megakernel trace of config 3 (every K2 mode but the
    Lambertian) on the card emits its rays, closes its energy balance to
    1e-5 and puts energy into the medium; one K2 launch per round."""
    slab = 8 * kb.TILE
    table, _, source_fn = bench_scene(3, slab, cuda_device)
    n0 = kb.bounce_reflect.launches
    accum, emitted, source_e = trace_streaming(
        table, source_fn, torch.Generator().manual_seed(0), 4 * slab,
        max_rounds=96, max_path=8)
    assert 4 * slab <= int(emitted) <= 5 * slab
    assert abs(energy_closure(accum, source_e)) < 1e-5
    assert float(accum.medium) > 0.0
    assert kb.bounce_reflect.launches > n0 + 4
