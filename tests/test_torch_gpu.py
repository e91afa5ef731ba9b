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
                                                   bench_scene, without_spec)

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


def fuzz_assembly(pkg, seed: int, extra: int = 0, every_kind=True):
    """A scene with every quadric class and every aperture kind, built
    with the package ``pkg`` (tracer_tpu or tracer_tpu_torch, which share
    the host API): one K_REFLECT row per aperture kind on a rotating
    class, plus one more row of each class, plus ``extra`` rect rows of
    random classes (groups of hundreds of rows), each at a random pose.
    Without ``every_kind``, the rect rows alone (one aperture slot)."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene
    rng = np.random.default_rng(seed)
    base = {"flat": G.flat, "parab": lambda: G.paraboloid(1.2, 0.9),
            "sphere": lambda: G.sphere(0.8),
            "quadric": lambda: G.ellipsoid(0.9, 0.6, 0.7)}
    cases = [(k, CLASSES[(k + seed) % 4]) for k in AP_PARAMS]
    cases += [(int(rng.integers(1, 14)), c) for c in CLASSES]
    if not every_kind:
        cases = []
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


def k3_compare(got, want, t12, pos, dirs, rtol=1e-5, max_flips=0,
               aux=True, tie=1e-5):
    """K3 results (t, sid, aux) against another version's (``want``).

    Two float32 versions of the same arithmetic round differently: by a
    few ulps of the ray's scale L = 1 + max|pos| and of t, amplified near
    tangency by the discriminant's conditioning, 1 / cos^2 of the angle of
    incidence (cos^2 floored at 1e-4). So on lanes that hit, t and each
    aux vector component must agree within rtol * (L + t) / cos^2, the
    aux relative to 1 + the lane's largest component; kind and flags
    exactly. Ties are lanes whose best and second-best t lie within
    ``tie`` (L + t) of each other: either row may win there (a caller
    whose rows lie closer than that, such as two dish layers 1e-4 apart,
    narrows the band so that those lanes count as flips). Flips are the other
    lanes where the versions disagree on sid or on t: a hit point within
    rounding of an aperture edge or of the self-hit guard, which FMA
    contraction may decide (the other root of the same row, or another
    row). At most ``max_flips`` are allowed. ``aux`` False compares t and
    sid alone, for a caller that reads nothing else. Returns (ties,
    flips)."""
    t1, t2 = t12
    scale = 1.0 + pos.abs().amax(dim=1)
    tie = (t2 - t1) <= tie * (scale + t1)
    n = want[2]["normal"]
    cos2 = ((dirs * n).sum(1) ** 2
            / (n * n).sum(1).clamp(min=1e-30)).clamp(min=1e-4)
    base = (scale + torch.where(want[1] >= 0, want[0], 0.0)) / cos2
    t_ok = ((got[0] - want[0]).abs() <= rtol * base) | (
        torch.isinf(got[0]) & torch.isinf(want[0]))
    agree = (got[1] == want[1]) & t_ok
    flips = int((~agree & ~tie).sum())
    assert flips <= max_flips, (flips, torch.nonzero(~agree & ~tie)[:5])
    if not aux:
        return int(tie.sum()), flips
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


def wavelength_lane(table) -> bool:
    """Whether K2 threads a wavelength lane for ``table``: spectral or
    dispersive rows, dispersive conductors, bilinear piecewise grids."""
    return bool(set(table.features) & {"spectral", "dispersive"}
                or ptt.engine._k2_needs_wl(table))


def bench_modes(table, spec):
    """K2's keyword arguments for a bench scene's trace (its static modes,
    the spectral table, the source's ambient medium, the media pair, the
    bifacial rows' test, energy splitting where the scene has F_SPLIT
    interfaces and the stage (d)/(e) switches; no pose: the wrappers take
    the spec's own)."""
    feats = set(table.features)
    refr = ptt.materials.K_REFRACTIVE in table.kinds_present
    extra = ptt.engine._k2_extra(table)
    tab = (ptt.engine._k2_table(table) if wavelength_lane(table)
           or extra["conductor"] or extra["piecewise"] else None)
    att, scat, g = ptt.engine._spec_medium(spec)
    return dict(bivar=ptt.engine._bivar_mode(table),
                one_sided="one_sided" in feats,
                slope="slope_error" in feats,
                lambertian=ptt.materials.K_LAMBERTIAN in table.kinds_present,
                source_spec=spec, spectral_tab=tab, ambient_att=att,
                ambient_scat=scat, ambient_g=g,
                refr_frost=refr and "refractive_slope" in feats,
                refr_disp=refr and "dispersive" in feats,
                refr_split=refr and "split" in feats,
                media=ptt.engine._media_for(table, spec),
                backside_miss="bifacial" in feats, **extra)


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
        wavelength=f[6] if wavelength_lane(table) else None,
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


def k2_near(rows, pos, dirs, groups, t_eps: float = T_EPS,
            backside_miss: bool = False):
    """What k2_compare needs of the rays K2 traced: their two nearest hit
    distances (kn.nearest_two_t), and their winner row's unnormalised
    normal and optical kind (the plain version's, kn.nearest_hit_ref),
    under K2's ``backside_miss``."""
    t1, t2 = kn.nearest_two_t(rows, pos, dirs, groups, t_eps,
                              backside_miss=backside_miss)
    aux = kn.nearest_hit_ref(rows, pos, dirs, groups, t_eps,
                             need_local=False,
                             backside_miss=backside_miss)[2]
    return t1, t2, aux["normal"], aux["kind"]


def k2_dead(rows, seed: int, pos, dirs, energy, groups, kw,
            t_eps: float = T_EPS):
    """k2_compare's ``dead`` for a K2 call (``kw`` its keywords): the lanes
    that enter without energy and are not regenerated, which K2 traces and
    shades all the same, and the sid the plain version reports for each
    when it carries energy (no decision of K2 depends on a lane's energy);
    None when there are none."""
    dead = (energy <= 0.0) & (not kw.get("regen"))
    if not bool(dead.any()):
        return None
    lit = kb.bounce_reflect_ref(rows, seed, pos, dirs,
                                torch.where(dead, 1.0, energy), groups,
                                t_eps, **kw)
    return dead, lit[3]


def k2_compare(got, want, near, pos, dirs, live, att=0.0, rtol=1e-5,
               max_flips=0, decisions=False, split=False, dead=None):
    """K2 results (pos, dir, energy, sid, absorbed[, wavelength][, index]
    [, medium id][, s_e, s_dir]) against another version's on the ``live``
    lanes and, with ``dead`` (k2_dead: the lanes that enter dead and are
    not regenerated, and the sid each would report with energy), on those
    lanes too
    (``pos``/``dirs`` the rays each traced after regeneration,
    traced_rays; ``near`` their k2_near). A dead lane's sid is -1 in both,
    so it cannot show which row won: there the lit sid stands in for it,
    and a dead lane whose point, direction, index or medium id lies
    outside the tolerances below counts as a flip, within the same
    ``max_flips``; its energy and absorbed energy (0) must match. Ties (best and second-best t
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
    conditioning); elsewhere it comes from the turned direction. With
    ``split`` (refr_split's outputs last) the reflected branch's energy
    is held like the energies, the lanes that split must be the same, and
    on them its direction within 10 rtol / cos^2 of the reflection (cos
    from the reflected turn). Returns (ties, flips, max abs error)."""
    t1, t2, normal, kind = near
    sid_w = want[3]
    if dead is not None:
        dead, lit = dead
        assert (got[3][dead] == -1).all() and (want[3][dead] == -1).all()
        sid_w = torch.where(dead, lit, want[3])
        traced = live | dead
    else:
        dead = torch.zeros_like(live)
        traced = live
    scale = 1.0 + pos.abs().amax(dim=1)
    tie = traced & ((t2 - t1) <= 1e-5 * (scale + t1))
    refr = kind == ptt.materials.K_REFRACTIVE
    n_tie = int((tie & ~refr).sum())
    assert n_tie <= max_flips, ("ties", n_tie)
    assert int((tie & refr).sum()) <= 0.01 * int(traced.sum()), "seam ties"
    same = got[3] == want[3]
    flips = int((live & ~same & ~tie).sum())
    ok = traced & same & ~tie
    moved = ok & (sid_w != -1)
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
    cos2 = torch.where(sid_w >= 0, cos2, 1.0).clamp(min=1e-4)
    dist = (want[0] - pos).norm(dim=1)
    base = (scale + torch.where(sid_w >= 0, t1, dist)) / cos2
    d_pos = (got[0] - want[0]).abs().amax(dim=1)
    d_dir = (got[1] - want[1]).abs().amax(dim=1)
    # an HG direction leaves at sin = sqrt(1 - cos^2) of the scattering
    # angle, whose rounding grows as 1 / sin near the travel direction
    sin_sc = torch.sqrt((1.0 - (dirs * want[1]).sum(1) ** 2).clamp(min=0.0))
    c_dir = torch.where(sid_w == -2, sin_sc.clamp(min=1e-4), cos2)
    n_out = len(got) - (2 if split else 0)
    lane_bad = torch.zeros_like(ok)
    for k in range(5, n_out):
        lane_bad |= (got[k] - want[k]).abs() > 1e-6 * want[k].abs()
    if decisions:
        # one version reflected, the other crossed: the index (or, at an
        # index-matched interface, the medium id) tells them apart
        bad = ok & lane_bad
        flips += int(bad.sum())
        ok, moved = ok & ~bad, moved & ~bad
    # a dead lane that met another row than the plain version's, or went
    # the other way at a refractive row, shows it in its point, its
    # direction or its lane fields
    d_bad = ok & dead & ((d_pos > rtol * base) & (sid_w != -1)
                         | (d_dir > 10 * rtol / c_dir) | lane_bad)
    flips += int(d_bad.sum())
    ok, moved = ok & ~d_bad, moved & ~d_bad
    assert flips <= max_flips, (flips, torch.nonzero(live & ~same & ~tie)[:5],
                                torch.nonzero(d_bad)[:5])
    assert (d_pos[moved] <= rtol * base[moved]).all(), "pos"
    assert (d_dir[ok] <= 10 * rtol / c_dir[ok]).all(), "dir"
    energies = ((2, "energy"), (4, "absorbed"))
    if split:
        energies += ((n_out, "s_e"),)
        sp = ok & (want[n_out] > 0.0)
        assert torch.equal(sp, ok & (got[n_out] > 0.0)), "split lanes"
        r_turn = want[n_out + 1] - dirs
        cos2_r = ((dirs * r_turn).sum(1) ** 2
                  / (r_turn * r_turn).sum(1).clamp(min=1e-30)).clamp(
                      min=1e-4)
        d_sdir = (got[n_out + 1] - want[n_out + 1]).abs().amax(dim=1)
        assert (d_sdir[sp] <= 10 * rtol / cos2_r[sp]).all(), "s_dir"
        assert (got[n_out + 1][ok & ~sp] == 0.0).all(), "s_dir off splits"
    for k, name in energies:
        g, w = got[k][ok], want[k][ok]
        tol = (10 * rtol + att * rtol * base[ok]) * w.abs()
        assert ((g - w).abs() <= tol).all(), name
    assert not lane_bad[ok if decisions else live | (ok & dead)].any(), \
        "wl, ri or mid"
    big = [float((got[k][ok] - want[k][ok]).abs().max()) if ok.any() else 0.0
           for k, _ in ((0, ""), (1, "")) + energies]
    return int(tie.sum()), flips, max(big)


def tile_args(culling, tiles=TILES):
    """(lists, counts, cells, cell_bounds) of the ``tiles``, as numpy."""
    idx = np.asarray(tiles)
    return (culling.lists[idx], culling.counts[idx], idx.astype(np.int32),
            culling.cell_bounds[idx])


# K1's modes beyond the NSTTF's (chip_smoke.py phase 10, the emulated and
# the on-card comparisons): each a field of NSTTF heliostats
# (field_assembly) under its source (field_spec); the "aureole" modes park
# aureole-born lanes (culling park_aureole) under a Buie disk or the rect
# source with CSR 0.2
K1_MODES = ("curved", "rect", "lambertian", "spectral", "conductor_iam",
            "bifacial", "aureole", "aureole_rect")
AUREOLE_CSR = 0.2               # the aureole modes' circumsolar ratio
FIELD_BAND = (350e-9, 2.4e-6)   # the spectral field's wavelength band [m]
FIELD_ATT = 2e-4                # and its ambient attenuation [1/m]


def field_assembly(pkg, mode: str, n: int):
    """(assembly, extra features) of K1 mode ``mode``'s field of the first
    n NSTTF pads, built with the package ``pkg`` (tracer_tpu or
    tracer_tpu_torch): the fields of tracer_tpu's culled-versus-unculled
    tests (tests/test_culling.py:303, tests/test_pallas_tpu.py:185, :258,
    :1023) and two more. "curved": slant-focused paraboloids; "rect": the
    flat field (lit by the rect source); "lambertian": the flat field over
    a Lambertian receiver (0.9); "spectral": mirrors whose absorptance
    rises from 0.05 to 0.15 over 300-2500 nm, in an attenuating ambient;
    "conductor_iam": Fresnel-conductor mirrors (n 1.2 + 6i) and an IAM
    receiver (a_r 0.3, c 2); "bifacial": mirrors whose back absorbs 0.6;
    "aureole" and "aureole_rect": the flat field. Every receiver is 11 x
    11 m, 60 m up, tilted toward (cx, cy, -45)."""
    import importlib
    M, sp, sc, G = pkg.materials, pkg.spatial, pkg.scene, pkg.geometry
    hf = importlib.import_module(pkg.__name__ + ".models.heliostat_field")
    osm = importlib.import_module(pkg.__name__ + ".models.one_sided_mirror")
    pos = hf.load_heliostat_positions()[:n]
    mirror = dict(absorptivity=0.1, sigma=1.5e-3, bi_var=True)
    if mode == "curved":
        mirror["focal_lengths"] = np.hypot(np.hypot(pos[:, 0], pos[:, 1]),
                                           60.0)
    elif mode == "spectral":
        wls = np.linspace(300e-9, 2500e-9, 16)
        abss = 0.05 + 0.10 * (wls - wls[0]) / (wls[-1] - wls[0])
        mirror = dict(optics=M.reflective_spectral(abss, wls, sigma=1.5e-3,
                                                   one_sided=True))
    elif mode == "conductor_iam":
        mirror = dict(optics=M.fresnel_conductor_homogenous(
            1.0, complex(1.2, 6.0)))
    elif mode == "bifacial":
        mirror = dict(optics=M.bifacial(
            M.reflective(0.1, sigma=1.5e-3, bi_var=True), M.reflective(0.6)))
    field = hf.HeliostatField(pos, width=6.1, height=6.1, **mirror)
    field.set_aim_height(60.0)
    field.track_sun(azimuth=0.0, zenith=np.pi / 6)
    if mode == "lambertian":
        rec = sc.AssembledObject(surfs=[sc.Surface(
            G.rect_plate(11.0, 11.0), M.lambertian(0.9), name="receiver")])
    elif mode == "conductor_iam":
        rec = sc.AssembledObject(surfs=[sc.Surface(
            G.rect_plate(11.0, 11.0),
            M.iam(M.reflective(0.95, one_sided=True), a_r=0.3, c=2.0),
            name="receiver")])
    else:
        rec = osm.one_sided_receiver(11.0, 11.0)[1]
    center = pos.mean(axis=0)
    aim = np.array([center[0], center[1], -45.0])
    aim /= np.linalg.norm(aim)
    rec.set_transform(sp.translate(0, 0, 60.0)
                      @ sp._homog(sp.rotation_to_z(aim)))
    extra = ("volumetric",) if mode == "spectral" else ()
    return sc.Assembly(objects=[rec], subassemblies=[field]), extra


def field_spec(pkg, mode: str, n: int, slab: int) -> tuple:
    """The pallas spec of K1 mode ``mode``'s source over the first n
    pads, at ``slab`` lanes: the NSTTF's rect source for "rect", else its
    Buie disk (with the band and the attenuation for "spectral"); CSR 0.02,
    AUREOLE_CSR for the "aureole" modes (a rect source for
    "aureole_rect")."""
    import importlib
    hf = importlib.import_module(pkg.__name__ + ".models.heliostat_field")
    pos = hf.load_heliostat_positions()[:n]
    sun = hf.solar_vector(0.0, np.pi / 6)
    csr = AUREOLE_CSR if mode.startswith("aureole") else 0.02
    if mode in ("rect", "aureole_rect"):
        center_xy = pos[:, :2].mean(axis=0)
        half = (pos[:, :2].max(axis=0) - pos[:, :2].min(axis=0)) / 2 + 12.0
        src_c = (np.array([center_xy[0], center_xy[1], 0.0])
                 + sun * (300.0 / sun[2]))
        return pkg.sources.rect_buie_sunshape_pallas_spec(
            slab, src_c, [0.0, 0.0, -1.0], 2.0 * float(half[0]),
            2.0 * float(half[1]), csr, 1000.0, rays_direction=-sun)
    center = pos.mean(axis=0)
    extent = float(np.max(np.hypot(*(pos[:, :2] - center[:2]).T))) + 10.0
    kw = (dict(wl_band=FIELD_BAND, ambient_att=FIELD_ATT)
          if mode == "spectral" else {})
    return pkg.sources.buie_sunshape_pallas_spec(
        slab, center + sun * 300.0, -sun, extent, csr, 1000.0, **kw)


def k1_modes(table, spec, culling=None) -> dict:
    """bounce_reflect_culled's keyword arguments for a cullable scene's
    trace under ``spec`` (engine._trace_culled's) with ``culling``'s
    parking, and the spectral table where its rows read it."""
    kinds, feats = set(table.kinds_present), set(table.features)
    spectral = ptt.materials.K_REFLECT_SPECTRAL in kinds
    conductor = ptt.materials.K_FRESNEL_CONDUCTOR in kinds
    return dict(bivar=ptt.engine._bivar_mode(table),
                one_sided="one_sided" in feats, slope="slope_error" in feats,
                source_spec=spec,
                spectral_tab=(ptt.engine._k2_table(table)
                              if spectral or conductor else None),
                lambertian=ptt.materials.K_LAMBERTIAN in kinds,
                ambient_att=ptt.engine._spec_medium(spec)[0],
                conductor=conductor, iam=ptt.engine._iam_mode(table),
                backside_miss="bifacial" in feats,
                park_aureole=bool(getattr(culling, "park_aureole", False)))


def k1_scene(mode: str, n: int, slab: int, device, park_aureole=None):
    """(table, meta, culling, spec) of K1 mode ``mode`` over the first n
    pads, the culling built for ``slab`` lanes, parking aureole-born lanes
    with ``park_aureole`` (None: in the "aureole" modes)."""
    asm, extra = field_assembly(ptt, mode, n)
    table, meta = ptt.compile_scene(asm, extra_features=extra,
                                    device=device)
    spec = field_spec(ptt, mode, n, slab)
    if park_aureole is None:
        park_aureole = mode.startswith("aureole")
    culling = build_block_culling(table, meta, spec, slab,
                                  park_aureole=park_aureole)
    return table, meta, culling, spec


def k1_lanes(meta, culling, tiles, seed: int, dead: float, device,
             band=None):
    """Lanes of the ``tiles`` for K1: rays aimed at random points near
    their tile's candidate rows (the receiver, where listed, three times
    in ten; any row for a tile without candidates) from the sun side, from random downward directions and from
    below (aimed_rays' mix), then a ``dead`` share of lanes without
    energy, and with ``band`` wavelengths uniform in it. Returns (pos,
    dirs, energy, wavelength or None) on ``device``."""
    rng = np.random.default_rng(seed)
    n = kb.TILE * len(tiles)
    tile = np.repeat(np.arange(len(tiles)), kb.TILE)
    rec = int(np.nonzero(meta.row_logical == meta.index_of("receiver"))[0]
              [0])
    rows = np.empty(n, dtype=np.int64)
    for k, b in enumerate(tiles):
        cand = culling.lists[b][culling.lists[b] >= 0]
        if not len(cand):
            cand = np.arange(len(meta.frames))
        pick = rng.choice(cand, kb.TILE)
        if rec in cand:
            pick = np.where(rng.uniform(size=kb.TILE) < 0.3, rec, pick)
        rows[tile == k] = pick
    fr = meta.frames[rows]
    local = np.stack([rng.uniform(-3.6, 3.6, n), rng.uniform(-3.6, 3.6, n),
                      np.zeros(n)], axis=1)
    pts = np.einsum("nij,nj->ni", fr[:, :3, :3], local) + fr[:, :3, 3]
    sun = nsttf.solar_vector(0.0, np.pi / 6)
    d = -sun + rng.normal(0.0, 0.01, (n, 3))
    kind = rng.uniform(size=n)
    rnd = rng.normal(size=(n, 3))
    rnd[:, 2] = -np.abs(rnd[:, 2]) - 0.3
    d = np.where((kind > 0.8)[:, None], rnd, d)
    d = np.where((kind > 0.9)[:, None], -d, d)          # from below
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = pts - d * rng.uniform(20.0, 200.0, (n, 1))
    e = np.where(rng.uniform(size=n) < dead, 0.0, rng.uniform(0.5, 2.0, n))
    wl = None if band is None else torch.tensor(
        rng.uniform(*band, n), dtype=torch.float32, device=device)
    return (torch.tensor(pos, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device),
            torch.tensor(e, dtype=torch.float32, device=device), wl)


def k1_straddling(meta, culling, tiles, seed: int, device, band=None):
    """Lanes of four ``tiles`` (k1_lanes' rays, a tenth of them dead)
    whose other dead lanes cluster in windows across each boundary
    between K1's sub-tiles (kb.K1_SPLIT a tile), with quotas of 0, one
    that ends 25 lanes into the third sub-tile, TILE - 1 (past the tile's
    dead count, yet ranked) and TILE. Returns (lanes, remaining)."""
    assert len(tiles) == 4
    pos, dirs, e, wl = k1_lanes(meta, culling, tiles, seed, 0.1, "cpu",
                                band)
    sub = kb.TILE // kb.K1_SPLIT
    lane = torch.arange(kb.TILE)
    near = torch.zeros(kb.TILE, dtype=torch.bool)
    for k in range(1, kb.K1_SPLIT):
        near |= (lane >= k * sub - 90 + 20 * k) & (lane < k * sub + 30 * k)
    e = torch.where(near, 0.0, e.view(4, kb.TILE))
    dead = (e <= 0.0).to(torch.int32)
    inside = int(dead[1, :2 * sub + 25].sum())
    assert int(dead[2].sum()) < kb.TILE - 1
    rem = torch.tensor([0, inside, kb.TILE - 1, kb.TILE],
                       dtype=torch.int32, device=device)
    lanes = tuple(None if t is None else t.to(device)
                  for t in (pos, dirs, e.reshape(-1), wl))
    return lanes, rem


def k1_live(energy, remaining, active):
    """The lanes K1 traces: in active tiles, those with energy and the
    dead ones its quota regenerates (the first ``remaining[b]`` of tile b
    in flat lane order)."""
    nb = remaining.shape[0]
    dead = (energy <= 0.0).view(nb, kb.TILE)
    rank = torch.cumsum(dead.to(torch.int32), 1) - 1
    live = (~dead | (dead & (rank < remaining[:, None]))).view(-1)
    return live & (active != 0).repeat_interleave(kb.TILE)


def k1_traced(table, culling, spec, tiles, seed: int, lanes, remaining,
              active):
    """What k1_compare needs of the rays K1 traces on the ``tiles``'
    lanes (the dead lanes within quota regenerate from their cells, the
    others carry theirs): their positions and directions and their
    winner's unnormalised normal (the plain version's, zero on misses)."""
    pos, dirs, e, _ = lanes
    dev = pos.device
    idx = torch.arange(pos.shape[0], device=dev)
    blk, lane = idx // kb.TILE, idx % kb.TILE
    lists, counts, cells, cb = (torch.as_tensor(a, device=dev)
                                for a in tile_args(culling, tiles))
    f = kb._sample_cell(spec, seed, cells[blk], lane, cb[blk])
    reborn = ((e <= 0.0) & k1_live(e, remaining, active))[:, None]
    pos = torch.where(reborn, torch.stack(f[0:3], 1), pos)
    dirs = torch.where(reborn, torch.stack(f[3:6], 1), dirs)
    normal = kb._nearest_listed(
        kb.pack_rows(table).to(dev), lists, counts, table.groups,
        culling.group_offsets, blk, list(pos.unbind(1)) + list(dirs.unbind(1)),
        T_EPS, 1e-6, k1_modes(table, spec)["backside_miss"])[2]
    return pos, dirs, torch.stack(normal, 1)


def k1_compare(got, want, live, max_flips: int, traced=None, rtol=1e-5,
               pos_tol=1e-4, dir_tol=1e-5, e_rtol=1e-5):
    """K1 results (pos, dir, energy, sid, absorbed[, wavelength]) against
    another version's on the ``live`` lanes: sid equal on all but
    ``max_flips`` of them (a hit within rounding of an aperture edge or
    of the self-hit guard, a tie between coincident rows); on the lanes
    whose sid agrees pos within pos_tol (1 + |x|), dir within dir_tol,
    energy and absorbed within e_rtol relative, wavelength within 1e-6
    relative. With the ``traced`` rays (k1_traced) the tolerances widen
    where two float32 versions' rounding does (k2_compare's scales, cos
    the incidence on the winner's normal, cos^2 floored at 1e-4): pos to
    rtol (L + d) / cos^2 (L = 1 + max|pos|, d the distance moved), dir to
    10 rtol / cos^2, energy and absorbed to e_rtol / cos (an IAM's cos^c
    and a conductor's Fresnel factor grow the cosine's rounding so).
    Returns (max abs error, flips, the largest error of each output in
    its tolerance's unit)."""
    gp, gd, ge, gs, ga = got[:5]
    wp, wd, we, ws, wa = want[:5]
    n_live = int(live.sum())
    m = live & (gs == ws)
    flips = n_live - int(m.sum())
    assert n_live > 0 and flips <= max_flips, (flips, n_live)

    def mx(t):
        return float(t.max()) if t.numel() else 0.0

    def rel(a, b):
        nz = b[m] != 0
        return mx(((a - b).abs()[m] / b.abs()[m].clamp(min=1e-30))[nz])

    unit = 1.0 + wp.abs().amax(dim=1)
    pos_lim = pos_tol * unit
    dir_lim = torch.full_like(unit, dir_tol)
    e_lim = torch.full_like(unit, e_rtol)
    if traced is not None:
        tpos, tdir, normal = traced
        cos2 = ((tdir * normal).sum(1) ** 2
                / (normal * normal).sum(1).clamp(min=1e-30))
        hit = (ws >= 0) | (ws <= -16)           # encoded sids hit too
        cos2 = torch.where(hit, cos2, 1.0).clamp(min=1e-4)
        moved = (wp - tpos).norm(dim=1)
        scale = 1.0 + tpos.abs().amax(dim=1)
        pos_lim = torch.maximum(pos_lim, rtol * (scale + moved) / cos2)
        dir_lim = torch.maximum(dir_lim, 10 * rtol / cos2)
        e_lim = e_rtol / cos2.sqrt()
    d_pos = (gp - wp).abs().amax(dim=1)
    d_dir = (gd - wd).abs().amax(dim=1)
    errs = {"pos": mx((d_pos / unit)[m]), "dir": mx(d_dir[m]),
            "energy": rel(ge, we), "absorbed": rel(ga, wa)}
    for name, d, lim in (("pos", d_pos, pos_lim), ("dir", d_dir, dir_lim),
                         ("energy", (ge - we).abs(), e_lim * we.abs()),
                         ("absorbed", (ga - wa).abs(), e_lim * wa.abs())):
        bad = m & (d > lim)
        assert not bad.any(), (name, int(bad.sum()),
                               mx((d / lim.clamp(min=1e-30))[bad]))
    if len(want) > 5:
        errs["wavelength"] = rel(got[5], want[5])
        assert errs["wavelength"] <= 1e-6, errs["wavelength"]
    max_abs = max(mx((g - w).abs()[m]) for g, w in zip(got[:5], want[:5])
                  if g.is_floating_point())
    return max_abs, flips, errs


def k1_args(table, culling, spec, tiles, seed: int, lanes, remaining,
            active, **kw):
    """bounce_reflect_culled's (positional, keyword) arguments on the
    ``tiles``' lanes with their quotas ``remaining`` and ``active``
    flags, in the modes of ``table``, ``spec`` and ``culling`` (k1_modes;
    ``kw`` overrides them), every tensor on the lanes' device."""
    dev = lanes[0].device
    lists, counts, cells, cb = (torch.as_tensor(a, device=dev)
                                for a in tile_args(culling, tiles))
    modes = dict(k1_modes(table, spec, culling), **kw)
    if modes["spectral_tab"] is not None:
        modes["spectral_tab"] = modes["spectral_tab"].to(dev)
    pos, dirs, e, wl = lanes
    return ((kb.pack_rows(table).to(dev), lists, counts, cells, cb, seed,
             remaining, active, pos, dirs, e, table.groups,
             culling.group_offsets, T_EPS), dict(wavelength=wl, **modes))


def k1_call(fn, *args, **kw):
    """One call of K1 (``fn``: the wrapper, its plain version or an
    emulated launch) on k1_args' arguments."""
    pos, kwargs = k1_args(*args, **kw)
    return fn(*pos, **kwargs)


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


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K1_MODES)
def test_k1_modes_match_plain_on_gpu(cuda_device, mode):
    """K1 against its plain version on the card in each mode of phase 10
    (chip_smoke.py): the full fields, 64 tiles of the benchmark slab's
    culling (the last idle), regeneration over a 40%-dead slab with
    random quotas, slope error: sid equal on all but 1e-5 of the live
    lanes, the rest within k1_compare's tolerance; one launch a call."""
    dev = cuda_device
    slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)
    table, meta, culling, spec = k1_scene(mode, 218, slab, dev)
    tiles = tuple(range(300, 364))
    lanes = k1_lanes(meta, culling, tiles, 7, 0.4, dev, spec[13])
    g = torch.Generator().manual_seed(7)
    rem = torch.randint(0, kb.TILE + 1, (len(tiles),), generator=g,
                        dtype=torch.int32).to(dev)
    act = torch.ones(len(tiles), dtype=torch.int32, device=dev)
    act[-1] = 0
    args = (table, culling, spec, tiles, 19, lanes, rem, act)
    n0 = kb.bounce_reflect_culled.launches
    got = k1_call(kb.bounce_reflect_culled, *args)
    assert kb.bounce_reflect_culled.launches == n0 + 1
    want = k1_call(kb.bounce_reflect_culled_ref, *args)
    torch.cuda.synchronize()
    live = k1_live(lanes[2], rem, act)
    n = int(live.sum())
    k1_compare(got, want, live, max_flips=int(1e-5 * n) + 1,
               traced=k1_traced(*args))
    assert (want[3][live] >= 0).float().mean() > 0.25


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ("rect", "curved"))
def test_k1_sub_tile_ranks_and_order_on_gpu(cuda_device, mode):
    """K1 on the card (the NSTTF instance on rect cells, the general one
    on the curved field) over four tiles whose dead lanes straddle its
    sub-tile boundaries, with quotas of 0, one ending inside a sub-tile,
    one past the dead count and TILE (k1_straddling): within k1_compare's
    tolerance of the plain version, lanes leaving with energy exactly
    where the plain version's do, and every output the same bit for bit
    in another dispatch order of the tiles."""
    dev = cuda_device
    table, meta, culling, spec = k1_scene(mode, 218, 64 * kb.TILE, dev)
    tiles = (20, 21, 22, 23)
    lanes, rem = k1_straddling(meta, culling, tiles, 5, dev, spec[13])
    act = torch.ones(4, dtype=torch.int32, device=dev)
    args = (table, culling, spec, tiles, 29, lanes, rem, act)
    got = k1_call(kb.bounce_reflect_culled, *args)
    want = k1_call(kb.bounce_reflect_culled_ref, *args)
    turned = k1_call(kb.bounce_reflect_culled, *args,
                     order=torch.tensor((3, 1, 0, 2), dtype=torch.int32,
                                        device=dev))
    torch.cuda.synchronize()
    live = k1_live(lanes[2], rem, act)
    k1_compare(got, want, live, max_flips=int(1e-5 * int(live.sum())) + 1,
               traced=k1_traced(*args))
    assert torch.equal(got[2] > 0.0, want[2] > 0.0)
    for g, t in zip(got, turned):
        assert torch.equal(g, t)


def _offset_view(t):
    """A contiguous view of a copy of ``t`` whose data starts 4 bytes past
    a 16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ("k1", "k2"))
def test_unaligned_rays_match_aligned_on_gpu(cuda_device, kernel):
    """Given pos, dirs and energy as contiguous views 4 bytes past a
    16-byte boundary, K1 (which moves the rays 16 bytes at a time: its
    wrapper copies them first) and K2 give every output bit for bit the
    aligned tensors' results."""
    dev = cuda_device
    if kernel == "k1":
        table, meta, culling, spec = k1_scene("rect", 40, 16 * kb.TILE, dev)
        lanes = k1_lanes(meta, culling, K1_TILES_GPU, 3, 0.4, dev, spec[13])
        rem = torch.tensor([kb.TILE, 400, kb.TILE], dtype=torch.int32,
                           device=dev)
        act = torch.tensor([1, 1, 0], dtype=torch.int32, device=dev)
        args = (table, culling, spec, K1_TILES_GPU, 13)
        want = k1_call(kb.bounce_reflect_culled, *args, lanes, rem, act)
        got = k1_call(kb.bounce_reflect_culled, *args,
                      tuple(_offset_view(t) for t in lanes[:3]) + lanes[3:],
                      rem, act)
    else:
        table, _, rows, pos, dirs, e, kw, _ = k2_mode("drain_lens",
                                                      4 * kb.TILE, 3, dev)
        want = kb.bounce_reflect(rows, 17, pos, dirs, e, table.groups, T_EPS,
                                 **kw)
        got = kb.bounce_reflect(rows, 17, _offset_view(pos),
                                _offset_view(dirs), _offset_view(e),
                                table.groups, T_EPS, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


K1_TILES_GPU = (3, 4, 5)


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
    (groups that span several of the kernel's streamed parts) and on the
    NSTTF table: sid equal off ties, t and aux within 1e-5 of their scale
    (k3_compare); one launch per call."""
    dev = cuda_device
    table, meta = ptt.compile_scene(fuzz_assembly(ptt, 0), device=dev)
    big, big_meta = ptt.compile_scene(fuzz_assembly(ptt, 1, extra=2000),
                                      device=dev)
    part = kn.k3_geometry(kb.pack_rows(big), 1 << 16)["part"]
    assert part < big.num_rows
    assert max(g[1] - g[0] for g in big.groups) > part
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


@pytest.mark.cuda
@pytest.mark.parametrize("extra", (0, 2000))
def test_nearest_hit_ragged_and_local_off_on_gpu(cuda_device, extra):
    """K3 on lane counts that end inside a chunk and a 16-byte word, on
    the table with every class and aperture kind and its 2,017-row
    version (streamed): within
    k3_compare of the plain version; without need_local the local points
    are zeros and every other output equals the call with it, bit for
    bit."""
    dev = cuda_device
    table, meta = ptt.compile_scene(fuzz_assembly(ptt, 1, extra=extra),
                                    device=dev)
    rows = kb.pack_rows(table)
    for n in ((1 << 16) - 3, 1_000_003):
        pos, dirs = (torch.tensor(a, device=dev)
                     for a in fuzz_rays(meta, n, seed=11))
        args = (rows, pos, dirs, table.groups, T_EPS)
        got = kn.nearest_hit(*args)
        off = kn.nearest_hit(*args, need_local=False)
        want = kn.nearest_hit_ref(*args)
        torch.cuda.synchronize()
        assert got[0].shape == (n,) and (want[1] >= 0).float().mean() > 0.3
        k3_compare(got, want, kn.nearest_two_t(*args), pos, dirs,
                   max_flips=int(1e-5 * n) + 1)
        assert not bool(off[2]["local"].any())
        assert torch.equal(off[0], got[0]) and torch.equal(off[1], got[1])
        for k in ("normal", "up_dot", "kind", "flags", "p0", "p1"):
            assert torch.equal(off[2][k], got[2][k]), k


@pytest.mark.cuda
def test_k3_geometry_on_gpu(cuda_device):
    """K3's grid on a table staged whole is the card's resident blocks: as
    many blocks as the occupancy calculator keeps resident a SM times the
    SMs (never more than there are chunks); on a streamed table a block a
    chunk. Every block's stage fits the SM's shared memory."""
    dev = cuda_device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for extra in (0, 2000):
        table, _ = ptt.compile_scene(fuzz_assembly(ptt, 1, extra=extra),
                                     device=dev)
        rows = kb.pack_rows(table)
        for n in (1 << 22, 1000):
            geo = kn.k3_geometry(rows, n)
            chunks = -(-n // geo["threads"])
            assert geo["sms"] == sms and geo["resident"] >= 1
            assert geo["blocks"] == (
                min(chunks, sms * geo["resident"])
                if geo["part"] == table.num_rows else chunks)
            assert (geo["part"] == table.num_rows) == (extra == 0)
            assert geo["smem"] <= 232448


# the stage (d)/(e) scenes (stage_de_assembly) and their sources: centre,
# direction, radius, pillbox half-angle, wavelength band or None
_BAND = (400e-9, 1200e-9)
STAGE_DE = {
    "scatterers": ([0.0, 0.0, -2.0], [0.0, 0.2, 0.98], 0.4, 1e-3, None),
    "conductor": ([0.0, 0.0, 2.0], [0.0, 0.0, -1.0], 0.9, 2e-3, _BAND),
    "iam": ([0.0, 0.0, 2.0], [0.0, 0.0, -1.0], 0.3, 2e-3, None),
    "iam_c2": ([0.0, 0.0, 2.0], [0.0, 0.0, -1.0], 0.3, 2e-3, None),
    "piecewise": ([0.0, 0.0, 2.0], [0.0, 0.0, -1.0], 0.7, 2e-3, None),
    "piecewise_2d": ([0.0, 0.0, 2.0], [0.0, 0.0, -1.0], 0.7, 2e-3, _BAND),
    "periodic": ([0.0, 0.0, 2.0], [0.0, 0.1, -0.995], 0.8, 0.2, None),
    "periodic_hg": ([0.0, 0.0, 2.0], [0.0, 0.1, -0.995], 0.8, 0.2, None)}
# the medium periodic_hg's boundary declares: attenuation, HG scattering
# [1/m], HG asymmetry
PERIODIC_MEDIUM = (0.1, 0.3, 0.5)


def stage_de_assembly(pkg, name):
    """The assembly of stage (d)/(e) scene ``name``, built with the package
    ``pkg`` (tracer_tpu or tracer_tpu_torch): the scenes of tracer_tpu's
    interpret-mode tests (tests/test_interpret_megakernel.py) —
    "scatterers" a transparent cover, a Lambertian-specular target and a
    semi-Lambertian dome (:549), "conductor" a dispersive conductor mirror
    over an absorber (:597), "iam" and "iam_c2" an IAM mirror at 60 deg
    with c = 1 and 2 (:346, :383), "piecewise" a piecewise Lambertian
    plate at 45 deg (:470), "periodic" a periodic boundary over a sink
    (:897) — and two more: "piecewise_2d", the plate with a bilinear
    (theta, wl) grid, and "periodic_hg", the boundary of a cell filled
    with PERIODIC_MEDIUM (a scene-declared ambient HG medium)."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene
    if name == "scatterers":
        surfs = [sc.Surface(G.rect_plate(3.0, 3.0), M.transparent(),
                            location=[0.0, 0.0, -1.0], name="cover"),
                 sc.Surface(G.rect_plate(1.0, 1.0),
                            M.lambertian_specular(0.1, 0.6, 2e-3),
                            name="target"),
                 sc.Surface(G.hemisphere(3.0),
                            M.semi_lambertian(0.8, np.pi / 3), name="dome")]
    elif name == "conductor":
        wls = np.linspace(_BAND[0], _BAND[1], 12)
        x = (wls - wls[0]) / (wls[-1] - wls[0])
        refl = np.array([0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)])
        surfs = [sc.Surface(G.round_plate(1.2),
                            M.fresnel_conductor_homogenous(
                                1.0, (wls, 0.8 + 2.0 * x, 4.0 + 3.5 * x)),
                            rotation=sp.rotx(-np.pi / 8)[:3, :3],
                            name="mirror"),
                 sc.Surface(G.round_plate(1.0), M.absorber(), name="rec",
                            location=(1.6 * refl).tolist(),
                            rotation=sp.rotation_to_z(-refl))]
    elif name in ("iam", "iam_c2"):
        refl = np.array([0.0, np.sin(2 * np.pi / 3), np.cos(2 * np.pi / 3)])
        surfs = [sc.Surface(G.rect_plate(1.6, 1.6),
                            M.iam(M.reflective(0.4, sigma=1e-3), a_r=1.0,
                                  c=2.0 if name == "iam_c2" else 1.0),
                            rotation=sp.rotx(-np.pi / 3)[:3, :3],
                            name="mirror"),
                 sc.Surface(G.rect_plate(3.0, 3.0),
                            M.absorber(one_sided=False), name="rec",
                            location=(1.6 * refl).tolist(),
                            rotation=sp.rotation_to_z(-refl))]
    elif name in ("piecewise", "piecewise_2d"):
        opt = (M.lambertian_directional_piecewise(
            [0.0, np.pi / 3, np.pi / 2], [0.2, 0.6, 0.8], specularity=0.9)
            if name == "piecewise" else
            M.lambertian_directional_spectral_piecewise(
                [0.0, np.pi / 4, np.pi / 2], [_BAND[0], 8e-7, _BAND[1]],
                [[0.1, 0.2, 0.3], [0.3, 0.5, 0.6], [0.6, 0.8, 0.9]]))
        surfs = [sc.Surface(G.rect_plate(2.0, 2.0), opt,
                            rotation=sp.rotx(-np.pi / 4)[:3, :3],
                            name="mirror")]
    else:
        att, scat, g = PERIODIC_MEDIUM
        opt = (M.periodic_boundary(-2.0) if name == "periodic" else
               M.scattering_periodic_boundary(-2.0, scat, g_hg=g, att=att))
        surfs = [sc.Surface(G.rect_plate(4.0, 4.0), opt, name="bound"),
                 sc.Surface(G.rect_plate(6.0, 6.0),
                            M.absorber(one_sided=False),
                            location=[0.0, 0.0, -3.0], name="sink")]
    return sc.Assembly([sc.AssembledObject(surfs)])


def stage_de_spec(name, n: int):
    """The port's pallas spec of stage (d)/(e) scene ``name``'s source at
    ``n`` lanes (with the medium its scene declares folded in)."""
    c, d, r, ang, band = STAGE_DE[name]
    att, scat, g = PERIODIC_MEDIUM if name == "periodic_hg" else (0, 0, 0)
    return ptt.sources.disk_pillbox_pallas_spec(
        n, c, d, r, ang, BENCH_FLUX, wl_band=band, ambient_att=att,
        ambient_scat=scat, ambient_g=g)


# scenes with refraction or media ids beside the stage (d)/(e) kinds, and
# TIR lanes on energy-splitting interfaces (mixed_assembly), with their
# sources: centre, direction, radius, pillbox half-angle, ambient
# attenuation [1/m], HG scattering [1/m] and asymmetry
MIXED = {
    "split_tir": ([0.0, 0.0, 1.0], [0.0, 0.0, -1.0], 0.3, 0.05,
                  (0.5, 0.0, 0.0)),
    "lens_hg_ct": (BENCH[6]["center"], BENCH[6]["direction"],
                   BENCH[6]["radius"], BENCH[6]["ang_range"],
                   (BENCH[8]["att"], BENCH[8]["scat"], BENCH[8]["g"])),
    "slab_transparent": ([0.0, 0.0, 1.2], [0.0, 0.0, -1.0], 0.3, 0.3,
                         (0.0, 0.0, 0.0)),
    "box_ls": (BENCH["8b"]["center"], BENCH["8b"]["direction"],
               BENCH["8b"]["radius"], BENCH["8b"]["ang_range"],
               (0.0, 0.0, 0.0)),
    "split_glazed_ct": (BENCH[7]["center"], BENCH[7]["direction"],
                        BENCH[7]["radius"], BENCH[7]["ang_range"],
                        (0.0, 0.0, 0.0))}


def mixed_assembly(pkg, name):
    """The assembly of MIXED scene ``name``, built with ``pkg``:
    "split_tir" a glass block of energy-splitting faces, a horizontal top
    (n 1 | 1.5) over a face tilted 50 degrees (beyond the critical angle
    for the beam inside, which reflects totally there); "lens_hg_ct"
    config 6's lens and receiver over a 2 x 2 m Cook-Torrance floor (lit
    by the rays config 8's HG medium scatters past the receiver);
    "slab_transparent" an absorbing slab between two index-matched
    absorbant_interface discs over an absorber, beside a transparent
    sheet over half of it; "box_ls" config 8b's box with a
    Lambertian-specular floor (absorptivity 0.3, specularity 0.5, slope
    error 2 mrad); "split_glazed_ct" the glazed config 7 ("7g") with an
    energy-splitting cover."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene
    if name == "split_tir":
        return sc.Assembly([sc.AssembledObject([
            sc.Surface(G.rect_plate(1.2, 1.2),
                       M.refractive_homogenous(1.0, 1.5, single_ray=False),
                       name="top"),
            sc.Surface(G.rect_plate(1.2, 1.2),
                       M.refractive_homogenous(1.5, 1.0, single_ray=False),
                       location=[0.0, 0.0, -0.6],
                       rotation=sp.rotx(np.radians(50.0))[:3, :3],
                       name="tilted")])])
    if name == "lens_hg_ct":
        asm, _ = bench_assembly(pkg, 6)
        asm.objects[-1].add_surface(sc.Surface(
            G.rect_plate(2.0, 2.0), M.bdrf_cook_torrance(0.3, 1.2, 7.0, 0.9),
            location=[0.0, 0.0, -1.0], name="floor"))
        return asm
    if name == "split_glazed_ct":
        asm, _ = bench_assembly(pkg, "7g")
        asm.objects[0].surfaces[-1].optics = M.refractive_homogenous(
            1.0, 1.5, single_ray=False)
        return asm
    if name == "box_ls":
        asm, _ = bench_assembly(pkg, "8b")
        asm.objects[0].surfaces[0].optics = M.lambertian_specular(0.3, 0.5,
                                                                  2e-3)
        return asm
    surfs = [sc.Surface(G.round_plate(1.0), M.absorbant_interface(1.5),
                        location=[0.0, 0.0, z], name=name)
             for z, name in ((0.6, "b1"), (0.2, "b2"))]
    surfs += [sc.Surface(G.round_plate(1.0), M.absorber(one_sided=False),
                         name="plate"),
              sc.Surface(G.rect_plate(1.0, 2.0), M.transparent(),
                         location=[0.5, 0.0, 0.9], name="sheet")]
    return sc.Assembly([sc.AssembledObject(surfs)])


def mixed_spec(pkg, name, n: int):
    """The pallas spec of MIXED scene ``name``'s source at ``n`` lanes,
    built with ``pkg``."""
    c, d, r, ang, (att, scat, g) = MIXED[name]
    return pkg.sources.disk_pillbox_pallas_spec(
        n, c, d, r, ang, BENCH_FLUX, ambient_att=att, ambient_scat=scat,
        ambient_g=g)


def k2_scene(scene, n: int, device):
    """(table, spec) of a K2 mode's scene: a bench configuration, a stage
    (d)/(e) scene (STAGE_DE), a MIXED scene, or one of those that reach
    K2's other instances and modes through trace_streaming: "lens_hg",
    config 6's
    lens in config 8's ambient HG medium (refraction and scattering),
    "slab_media", an absorbing slab between two index-matched
    absorbant_interface discs over an absorber (media ids without
    scattering), "rect_nsttf", the NSTTF field under its oblique rect
    source (rect regeneration), and "bifacial", two bifacial plates
    (bifacial_assembly: both faces of each are hit)."""
    if scene in BENCH:
        table, _, source_fn = bench_scene(scene, n, device)
        return table, source_fn.pallas_spec
    if scene in STAGE_DE:
        table, _ = ptt.compile_scene(stage_de_assembly(ptt, scene),
                                     device=device)
        return table, stage_de_spec(scene, n)
    if scene == "rect_nsttf":
        table, _, info = nsttf.build_scene(device=device)
        return table, nsttf.make_rect_source_fn(info, n).pallas_spec
    if scene in MIXED:
        table, _ = ptt.compile_scene(mixed_assembly(ptt, scene),
                                     device=device)
        return table, mixed_spec(ptt, scene, n)
    if scene == "bifacial":
        table, _ = ptt.compile_scene(bifacial_assembly(ptt), device=device)
        return table, ptt.sources.disk_pillbox_pallas_spec(
            n, [0.0, 0.0, 2.0], [0.0, 0.0, -1.0], 0.6, 0.2, BENCH_FLUX)
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


def bifacial_assembly(pkg):
    """Two bifacial 1.6 x 1.6 m plates (front mirror absorbing 0.1, back
    mirror absorbing 0.5), built with ``pkg``: one tilted at z = 0 facing
    up, one at z = 1 facing down. A beam from z = 2 hits the upper plate's
    back and, past it, the lower plate's front, whose reflections reach
    the upper plate's front."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene
    optics = M.bifacial(M.reflective(0.1), M.reflective(0.5))
    return sc.Assembly([sc.AssembledObject([
        sc.Surface(G.rect_plate(1.6, 1.6), optics,
                   rotation=sp.rotx(0.3)[:3, :3], name="lower"),
        sc.Surface(G.rect_plate(1.6, 1.6), optics, location=[0.3, 0.0, 1.0],
                   rotation=sp.rotx(np.pi - 0.2)[:3, :3], name="upper")])])


# K2's modes, one or more for each of its twelve instances <kRefr, kScat,
# kMedia, kExtra>, with backside_miss off and on: (scene of k2_scene,
# dead share, regen, backside_miss forced on). Forcing the switch on a
# scene without bifacial rows runs the instance whose row loop tests it
# (no row rejects a ray there; the bifacial mode shows the rejection)
K2_MODES = {"regen": (1, 0.5, True, False), "minidish": (1, 0.0, False, False),
            "lambertian": (2, 0.5, True, False),
            "spectral": (3, 0.5, True, False),
            "lens": (6, 0.5, True, False), "ambient_hg": (8, 0.5, True, False),
            "media": ("8b", 0.5, True, False),
            "lens_hg": ("lens_hg", 0.5, True, False),
            "slab_media": ("slab_media", 0.5, True, False),
            "cook_torrance": (7, 0.5, True, False),
            "scatterers": ("scatterers", 0.5, True, False),
            "conductor": ("conductor", 0.5, True, False),
            "iam_c2": ("iam_c2", 0.5, True, False),
            "piecewise_2d": ("piecewise_2d", 0.5, True, False),
            "periodic_hg": ("periodic_hg", 0.5, True, False),
            "rect_regen": ("rect_nsttf", 0.5, True, False),
            "bifacial": ("bifacial", 0.5, True, False),
            "split_lens": ("6s", 0.0, False, False),
            "split_tir": ("split_tir", 0.0, False, False),
            "split_glazed_ct": ("split_glazed_ct", 0.0, False, False),
            "glazed_ct": ("7g", 0.5, True, False),
            "lens_hg_ct": ("lens_hg_ct", 0.5, True, False),
            "slab_transparent": ("slab_transparent", 0.5, True, False),
            "box_ls": ("box_ls", 0.5, True, False),
            # the drain's shape: half the lanes dead, none regenerated
            # (the megakernel's compacted tail, the culled trace's drain)
            "drain": (1, 0.5, False, False),
            "drain_lens": (6, 0.5, False, False)}
K2_MODES.update({f"{m}_bmiss": K2_MODES[m][:3] + (True,) for m in (
    "ambient_hg", "lens", "lens_hg", "slab_media", "media", "cook_torrance",
    "periodic_hg", "glazed_ct", "lens_hg_ct", "slab_transparent",
    "box_ls", "split_lens", "split_glazed_ct", "drain", "drain_lens")})


def k2_mode(mode, n: int, seed: int, device):
    """The inputs of K2 mode ``mode`` at ``n`` lanes (bench_lanes with
    ``seed``): (table, spec, rows, pos, dirs, energy, kw, regen), ``kw``
    the call's keywords."""
    scene, dead, regen, bmiss = K2_MODES[mode]
    table, spec = k2_scene(scene, n, device)
    pos, dirs, e, lanes = bench_lanes(table, spec, n, dead, seed, device)
    kw = dict(regen=regen, **lanes, **bench_modes(table, spec))
    kw["backside_miss"] |= bmiss
    return table, spec, kb.pack_rows(table), pos, dirs, e, kw, regen


@pytest.mark.cuda
@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_modes_match_plain_on_gpu(cuda_device, mode):
    """K2 in each of its instances against its plain version on the card,
    same inputs and random streams: regeneration over a half-dead slab,
    the MiniDish's paraboloid and rect rows, config 2's Lambertian
    absorber and bivariate slope error, config 3's spectral mirror in an
    attenuating medium, config 6's lens (Fresnel roulette), config 8's
    ambient HG medium, 8b's media ids, the lens in that HG medium and
    absorbing media without scattering, the stage (d)/(e) kinds, rect
    regeneration, bifacial rows, energy splitting (the split lens, TIR
    lanes, a splitting cover), the stage (d)/(e) kinds beside refraction
    and media ids (MIXED), the drain's half-dead lanes without
    regeneration on config 1's rows and the lens, and every instance's
    backside_miss twin (k2_compare: edge flips and roulette flips at most
    1e-5 of the lanes, dead lanes included, ties too but on the lens's
    seam; the split branch's energy and direction); one launch per
    call."""
    dev = cuda_device
    n = 64 * kb.TILE
    table, spec, rows, pos, dirs, e, kw, regen = k2_mode(mode, n, 3, dev)
    n0 = kb.bounce_reflect.launches
    got = kb.bounce_reflect(rows, 17, pos, dirs, e, table.groups, T_EPS,
                            **kw)
    assert kb.bounce_reflect.launches == n0 + 1
    want = kb.bounce_reflect_ref(rows, 17, pos, dirs, e, table.groups,
                                 T_EPS, **kw)
    torch.cuda.synchronize()
    tp, td = traced_rays(spec, 17, pos, dirs, e, regen)
    live = (e > 0.0) | (e <= 0.0) & regen
    k2_compare(got, want, k2_near(rows, tp, td, table.groups,
                                  backside_miss=kw["backside_miss"]),
               tp, td, live, att=medium_att(kw), max_flips=int(1e-5 * n) + 1,
               decisions=kw["ref_index"] is not None,
               split=kw["refr_split"],
               dead=k2_dead(rows, 17, pos, dirs, e, table.groups, kw))
    assert (want[3][live] != -1).float().mean() > 0.1


def k2_instance(kw):
    """The template instance <kRefr, kScat, kMedia, kExtra, kBmiss,
    kSplit> K2's call ``kw`` runs (tt_bounce's dispatch in
    csrc/bounce.cu)."""
    scat = (kb.media_flags(kw["media"])[1] if kw["media"] is not None
            else kw["ambient_scat"] > 0.0)
    return (kw["ref_index"] is not None, scat, kw["media"] is not None,
            any(kw.get(k) for k in kb.EXTRA_MODES), kw["backside_miss"],
            bool(kw.get("refr_split")))


def test_k2_modes_cover_every_instance():
    """K2_MODES runs each of K2's 28 template instances (twelve
    <kRefr, kScat, kMedia, kExtra> and the two splitting ones, kSplit
    beside refraction without scattering or media ids, each without and
    with backside_miss), so the emulated and on-card comparisons hold
    every one against the plain version: splitting on the split lens, on
    TIR lanes and on the glazed config 7's splitting cover; and the rect
    regeneration, a runtime switch of the base instance."""
    seen, split = set(), set()
    for scene, _, _, bmiss in K2_MODES.values():
        table, spec = k2_scene(scene, kb.TILE, "cpu")
        refr = ptt.materials.K_REFRACTIVE in table.kinds_present
        kw = dict(bench_modes(table, spec),
                  ref_index=torch.ones(1) if refr else None)
        kw["backside_miss"] |= bmiss
        seen.add(k2_instance(kw))
        if kw["refr_split"]:
            split.add(scene)
    base = {(False, False, False, False), (False, True, False, False),
            (True, False, False, False), (True, True, False, False),
            (True, False, True, False), (True, True, True, False),
            (False, False, False, True), (False, True, False, True),
            (True, False, False, True), (True, True, False, True),
            (True, False, True, True), (True, True, True, True)}
    splitting = {(True, False, False, False), (True, False, False, True)}
    assert seen == {k + (b, s) for b in (False, True)
                    for k, s in [(k, False) for k in base]
                    + [(k, True) for k in splitting]}
    assert split == {"6s", "split_tir", "split_glazed_ct"}
    table, spec = k2_scene(K2_MODES["rect_regen"][0], kb.TILE, "cpu")
    assert kb.source_params(spec)[kb.SP_RECT] == 1.0
    assert k2_instance(dict(bench_modes(table, spec), ref_index=None)) == (
        False, False, False, False, False, False)


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


@pytest.mark.cuda
def test_general_path_trace_closes_on_gpu(cuda_device):
    """Config 7's source without its spec takes the general streaming path
    on the card: it emits exactly its budget, closes its energy balance to
    1e-5, puts more than 0.4 of the source on the dome and runs K2 (no K3)
    once per round."""
    slab = 8 * kb.TILE
    table, meta, source_fn = bench_scene(7, slab, cuda_device)
    n2, n3 = kb.bounce_reflect.launches, kn.nearest_hit.launches
    accum, emitted, source_e = trace_streaming(
        table, without_spec(source_fn), torch.Generator().manual_seed(0),
        4 * slab, max_rounds=96, max_path=20)
    assert int(emitted) == 4 * slab
    assert abs(energy_closure(accum, source_e)) < 1e-5
    dome = torch.as_tensor(meta.row_logical == meta.index_of("dome"))
    assert float(accum.absorbed.cpu()[dome].sum()) / float(source_e) > 0.4
    assert kb.bounce_reflect.launches > n2 + 4
    assert kn.nearest_hit.launches == n3


@pytest.mark.cuda
def test_split_stream_closes_on_gpu(cuda_device):
    """Config 6's lens with energy-splitting interfaces streams on the
    general path on the card: it emits exactly its budget, closes its
    energy balance to 1e-5 with a residual below 1e-6 of the source, puts
    0.75-0.98 of the source on the receiver and runs K2 (refr_split; no
    K1 or K3) once per round."""
    slab = 8 * kb.TILE
    table, meta, source_fn = bench_scene("6s", slab, cuda_device)
    n1, n2, n3 = (kb.bounce_reflect_culled.launches,
                  kb.bounce_reflect.launches, kn.nearest_hit.launches)
    accum, emitted, source_e = trace_streaming(
        table, without_spec(source_fn), torch.Generator().manual_seed(0),
        4 * slab, max_rounds=8 * 4 + 80, max_path=20)
    assert int(emitted) == 4 * slab
    assert abs(energy_closure(accum, source_e)) < 1e-5
    assert float(accum.residual) < 1e-6 * float(source_e)
    rec = torch.as_tensor(meta.row_logical == meta.index_of("rec"))
    frac = float(accum.absorbed.cpu()[rec].sum()) / float(source_e)
    assert 0.75 < frac < 0.98
    assert kb.bounce_reflect.launches > n2 + 4
    assert (kb.bounce_reflect_culled.launches, kn.nearest_hit.launches) \
        == (n1, n3)


# ---- the differentiable bounce's fast winner (diff.trace_diff) ------------

# config 9b's receiver: the largest local |r| on the 11 x 11 m plate, and a
# bound on how far a receiver hit moves per radian of beam tilt: the tilt
# moves the ray's mirror hit by up to the 300 m source standoff and turns
# the reflected ray by twice the tilt over up to 150 m to the tower
RECEIVER_R = 5.5 * 2 ** 0.5
TILT_ARM = 300.0 + 2.0 * 150.0
# float32 sums of a bin's lanes in another order (index_add's atomics): up
# to 2,048 lanes a bin copy at 6e-8 each, ~1.2e-4 of the sum at worst
SUM_RTOL = 2e-4


def fast_winner_compare(step, table, beam) -> dict:
    """Config 9b's gradient step (bench_configs.field_gradient_step) with
    K3 choosing every bounce's winners and again with K3's plain version
    in its place, the same seeds. The recompute of the winner's distance
    is the same code both times, so the two differ by the lanes whose
    winner flipped (ties at aperture edges) and by the order of float32
    atomic sums. The tolerance: SUM_RTOL of the value, plus for each
    flipped lane at most its energy w times (RECEIVER_R^2 + loss) over the
    receiver's power p on the loss (it can move between the receiver and
    elsewhere with its moment), and w 2 RECEIVER_R TILT_ARM / p on the
    gradient (its term of d(loss)/da; the pathwise absorbed power does
    not move with the tilt). Returns dict(loss=(K3's, plain), grad=(K3's,
    plain), flipped lanes, tol_loss, tol_grad)."""
    from tracer_tpu_torch import diff
    real = kn.nearest_hit
    runs = {}
    for name, fn in (("K3", real), ("plain", kn.nearest_hit_ref)):
        sids = []

        def spy(*args, **kw):
            out = fn(*args, **kw)
            sids.append(out[1].clone())
            return out
        spy.launches = 0           # comparison launches count nowhere
        kn.nearest_hit = spy
        try:
            loss, g = step(0.0)
        finally:
            kn.nearest_hit = real
        # two bounces, each in the forward and in the checkpoint's
        # recompute
        assert len(sids) == 4, len(sids)
        runs[name] = (float(loss), float(g), sids[:2])
    (lk, gk, sk), (lp, gp, sp_) = runs["K3"], runs["plain"]
    flipped = (sk[0] != sp_[0]) | (sk[1] != sp_[1])
    with torch.no_grad():
        _, mom = diff.trace_diff(table, beam, 1, bounces=2)
    p = float(mom.absorbed[torch.as_tensor(
        step.receiver_rows, device=table.device)].double().sum())
    w = float(beam.energy[flipped].double().sum())
    return dict(loss=(lk, lp), grad=(gk, gp), flipped=int(flipped.sum()),
                tol_loss=SUM_RTOL * abs(lp) + w * (RECEIVER_R ** 2
                                                   + abs(lp)) / p,
                tol_grad=SUM_RTOL * abs(gp)
                + w * 2.0 * RECEIVER_R * TILT_ARM / p)


@pytest.mark.cuda
def test_fast_winner_gradient_k3_matches_plain_on_gpu(cuda_device):
    """Config 9b's step at 65,536 rays, 2 bounces: K3 launched in every
    bounce's forward and recompute, and the loss and gradient within
    fast_winner_compare's tolerance of the step with K3's plain version."""
    from tracer_tpu_torch.models.bench_configs import field_gradient_step
    step, table, beam = field_gradient_step(65_536, 2, device=cuda_device)
    kn.nearest_hit.launches = 0
    loss, g = step(0.0)
    assert kn.nearest_hit.launches == 4
    assert torch.isfinite(loss) and torch.isfinite(g) and float(g) != 0.0
    c = fast_winner_compare(step, table, beam)
    assert abs(c["loss"][0] - c["loss"][1]) <= c["tol_loss"], c
    assert abs(c["grad"][0] - c["grad"][1]) <= c["tol_grad"], c


@pytest.mark.cuda
def test_diff_dish_float32_on_gpu_matches_float64_on_cpu(cuda_device):
    """Config 9's step in float32 on the card (the oracle's brute force
    on CUDA tensors, no kernel) against float64 on the CPU, one beam cast
    to each, 65,536 rays, 2 bounces: rtol 1e-4 on the loss, 1e-3 on the
    gradient (chip_smoke.py phase 15 (d) derives them)."""
    from tracer_tpu_torch.models.bench_configs import (diff_gradient_step,
                                                       dish_beam)
    beam = dish_beam(65_536, torch.float64, "cpu")
    kn.nearest_hit.launches = 0
    got = diff_gradient_step(65_536, 2, device=cuda_device, beam=beam)[0](1.7)
    assert kn.nearest_hit.launches == 0
    want = diff_gradient_step(65_536, 2, dtype=torch.float64, device="cpu",
                              beam=beam)[0](1.7)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=1e-4)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-3)


# ---- the model library on K3: the STL receiver, the simulator's
# ellipsoids, a curved device flux map

STL_WINDOW = (1.2, 0.9)     # across the axis, along it (m)


def stl_receiver(directory, device):
    """(table, meta, verts) of a CAD receiver: the 48-gon cylinder wall
    of stl_utils.cylinder_verts_faces(0.5, 1.0, angbins=48, lbins=20)
    (1,008 vertices, 1,920 faces) written by make_stl into ``directory``
    and loaded back by load_stl_into_tracer as a receiving absorber: one
    logical surface of 1,920 triangle rows, float32 on ``device``."""
    import os
    from tracer_tpu_torch import stl_utils
    verts, faces = stl_utils.cylinder_verts_faces(0.5, 1.0, angbins=48,
                                                  lbins=20)
    path = os.path.join(directory, "receiver.stl")
    stl_utils.make_stl(path, verts, faces)
    obj = stl_utils.load_stl_into_tracer(
        path, ptt.materials.receiver(ptt.materials.absorber()))
    table, meta = ptt.compile_scene(ptt.scene.Assembly(objects=[obj]),
                                    device=device)
    return table, meta, stl_utils.load_stl(path)[0]


def stl_rays(n, seed, device):
    """n parallel float32 rays along +x from x = -2 m, uniform over the
    STL_WINDOW (y across the cylinder's axis, z along it): every ray that
    meets the mesh meets its wall."""
    g = torch.Generator(device=device).manual_seed(seed)
    w, h = STL_WINDOW
    u = torch.rand((n, 2), generator=g, device=device)
    pos = torch.stack([torch.full((n,), -2.0, device=device),
                       (u[:, 0] - 0.5) * w, (u[:, 1] - 0.5) * h], 1)
    dirs = torch.zeros((n, 3), device=device)
    dirs[:, 0] = 1.0
    return pos, dirs


@pytest.mark.cuda
def test_nearest_hit_on_stl_mesh_on_gpu(cuda_device, tmp_path):
    """K3 against its plain version on the 1,920-row triangle table of an
    STL receiver (one group, streamed through shared memory in parts):
    sid equal off ties (rays on an edge two faces share), t and aux
    within k3_compare's tolerance, at most 1e-5 of the lanes (plus one)
    flipped; the hit share is the 48-gon's width over the window's."""
    table, _, verts = stl_receiver(str(tmp_path), cuda_device)
    assert table.num_rows == 1920 and len(table.groups) == 1
    rows = kb.pack_rows(table)
    n = 1 << 20
    assert kn.k3_geometry(rows, n)["part"] < table.num_rows
    pos, dirs = stl_rays(n, 3, cuda_device)
    args = (rows, pos, dirs, table.groups, T_EPS)
    got = kn.nearest_hit(*args)
    want = kn.nearest_hit_ref(*args)
    torch.cuda.synchronize()
    ties, flips = k3_compare(got, want, kn.nearest_two_t(*args), pos, dirs,
                             max_flips=int(1e-5 * n) + 1)
    p = (verts[:, 1].max() - verts[:, 1].min()) / STL_WINDOW[0]
    share = float((got[1] >= 0).float().mean())
    assert abs(share - p) < 3 * (p * (1 - p) / n) ** 0.5, (share, p)


@pytest.mark.cuda
def test_nearest_hit_on_simulator_ellipsoids_on_gpu(cuda_device):
    """K3 against its plain version on the seven-module simulator's table
    (seven z-range-trimmed ellipsoids in the general-quadric class and the
    target plate) under its lamps' rays drawn on the card."""
    from tracer_tpu_torch.models.solar_simulator import high_flux_simulator
    sim = high_flux_simulator()
    table, _ = ptt.compile_scene(sim, device=cuda_device)
    assert {g[3] for g in table.groups} == {"flat", "quadric"}
    rays = sim.fire(torch.Generator(device=cuda_device).manual_seed(2),
                    1 << 17, device=cuda_device)
    n = rays.num_rays
    args = (kb.pack_rows(table), rays.pos, rays.dir, table.groups, T_EPS)
    got = kn.nearest_hit(*args)
    want = kn.nearest_hit_ref(*args)
    torch.cuda.synchronize()
    assert (want[1] >= 0).float().mean() > 0.3
    k3_compare(got, want, kn.nearest_two_t(*args), rays.pos, rays.dir,
               max_flips=int(1e-5 * n) + 1)


SG4_TIE = 1e-6    # k3_compare's tie band on SG4: below its 1e-4 m layer gap


def sg4_k3_compare(asm, table, sun, n64, max_rate=1e-5):
    """K3 on SG4's table (two dish layers 1e-4 m apart, 13-30 m from the
    source) on the sun rays of the first bounce and on the rays that
    leave the dish after it (trace_fused to one bounce), against its
    plain version and, on the first ``n64`` lanes of each, against the
    plain version in float64 on the CPU (the scene compiled in float64,
    the same float32 rays cast, the same t_eps). The tie band is SG4_TIE
    (L + t), below the gap, so a lane that takes the wrong layer is a
    flip; at most ``max_rate`` of the lanes plus one flip in each
    comparison. Returns one dict a bounce: lanes, lanes whose ray crosses
    two rows (``two``), sid mismatches against the plain version
    (``diff``), ties and flips, and the same against float64 (``diff64``,
    ``ties64``, ``flips64``) on ``m`` lanes."""
    from tracer_tpu_torch.engine import trace_fused
    table64, _ = ptt.compile_scene(asm, dtype=torch.float64, device="cpu")
    rows, rows64 = kb.pack_rows(table), kb.pack_rows(table64, torch.float64)
    after, _ = trace_fused(table, sun, torch.Generator(
        device=table.device).manual_seed(5), max_bounces=1)
    out = []
    for pos, dirs in ((sun.pos, sun.dir),
                      (after.pos[after.alive], after.dir[after.alive])):
        n, m = pos.shape[0], min(n64, pos.shape[0])
        args = (rows, pos, dirs, table.groups, T_EPS)
        got = kn.nearest_hit(*args)
        want = kn.nearest_hit_ref(*args)
        t12 = kn.nearest_two_t(*args)
        ties, flips = k3_compare(got, want, t12, pos, dirs, tie=SG4_TIE,
                                 max_flips=int(max_rate * n) + 1)
        p64, d64 = pos[:m].cpu().double(), dirs[:m].cpu().double()
        args64 = (rows64, p64, d64, table64.groups, T_EPS)
        want64 = kn.nearest_hit_ref(*args64)
        sub = (got[0][:m].cpu().double(), got[1][:m].cpu(),
               {k: v[:m].cpu().double() if v.is_floating_point()
                else v[:m].cpu() for k, v in got[2].items()})
        ties64, flips64 = k3_compare(sub, want64, kn.nearest_two_t(*args64),
                                     p64, d64, tie=SG4_TIE,
                                     max_flips=int(max_rate * m) + 1)
        out.append(dict(
            n=n, two=int(torch.isfinite(t12[1]).sum()),
            diff=int((got[1] != want[1]).sum()), ties=ties, flips=flips,
            m=m, diff64=int((sub[1] != want64[1]).sum()), ties64=ties64,
            flips64=flips64))
    return out


@pytest.mark.cuda
def test_nearest_hit_on_sg4_layers_on_gpu(cuda_device):
    """K3 on SG4's two dish layers 1e-4 m apart at full size, first and
    second bounce, against its plain version and against float64 on the
    CPU, with a tie band narrower than the gap (sg4_k3_compare): most
    first-bounce lanes cross both layers, and at most 1e-5 of the lanes
    (plus one) pick another row."""
    from tracer_tpu_torch.models.sg4 import SG4
    from tracer_tpu_torch.sources import solar_disk_bundle
    asm = SG4(dishDiameter=25.0, dishFocus=13.4, absMirrors=0.1,
              sigma=2e-3)
    table, _ = ptt.compile_scene(asm, device=cuda_device)
    sun = solar_disk_bundle(
        torch.Generator(device=cuda_device).manual_seed(4), 1 << 18,
        center=[0, 0, 30.0], direction=[0, 0, -1.0], radius=13.0,
        ang_range=0.005, flux=1000.0, device=cuda_device)
    first, second = sg4_k3_compare(asm, table, sun, 1 << 16)
    assert first["two"] > 0.5 * first["n"] and second["n"] > 0


def curved_map_compare(table, meta, names, bundle, seed, max_bounces,
                       resolution=50):
    """The device flux maps of the surfaces ``names`` from one trace_fused
    against analysis/fluxmap's host histograms (surface_fluxmap) of a
    ray_tracer run of the same rays with the same generator seed: the two
    draw the same numbers bounce for bounce, so they trace the same paths
    and differ only where the device's local point (the hit through the
    row's inverse frame) and K3's fall on two sides of a bin edge.
    trace_fused runs with the K3 epilogue's gate shut: the epilogue draws
    from its own Philox stream, not from the generator ray_tracer shares,
    and its bins are held against device_fluxmap's lane by lane in
    tests/test_torch_epilogue.py.
    Returns ({name: dict(device map, host map, hist (energy), absorbed on
    the surface's rows, l1: the maps' L1 distance over the host map's
    total, sq: the sum of the records' squared absorbed energies in each
    bin)}, trace_fused's accumulators, its final bundle, its wall in
    s)."""
    import time
    import unittest.mock
    from tracer_tpu_torch import engine
    from tracer_tpu_torch.analysis import device_fluxmap as dfm
    from tracer_tpu_torch.analysis.fluxmap import (areas_of, fluxmap,
                                                   surface_fluxmap)
    from tracer_tpu_torch.engine import (TraceOptions, TracerEngine,
                                         trace_fused)
    specs = tuple(dfm.flux_plan(meta, nm, resolution=resolution)
                  for nm in names)
    dev = table.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with unittest.mock.patch.object(engine, "_epilogue_ok",
                                    lambda *a, **k: False):
        final, acc = trace_fused(
            table, bundle, torch.Generator(device=dev).manual_seed(seed),
            max_bounces=max_bounces, fluxspecs=specs)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res = TracerEngine(table, meta).ray_tracer(
        bundle, generator=torch.Generator(device=dev).manual_seed(seed),
        opts=TraceOptions(max_bounces=max_bounces, record="tags"))
    out = {}
    for nm, spec, hist in zip(names, specs, acc.flux):
        flux, _ = dfm.finalize(spec, hist, meta)
        host, _ = surface_fluxmap(res, nm, resolution=resolution)
        hits = res.hits_of(meta.index_of(nm), keys=("absorbed", "local"))
        geom = meta.surfaces[meta.index_of(nm)].geometries[0]
        sq, _ = fluxmap(geom, np.asarray(hits["absorbed"], float) ** 2,
                        hits["local"], resolution)
        out[nm] = dict(
            device=flux, host=host, hist=hist.double().cpu().numpy(),
            absorbed=float(acc.absorbed[list(spec.rows)].double().sum()),
            l1=float(np.abs(flux - host).sum())
            / max(float(np.abs(host).sum()), 1e-300),
            sq=sq * areas_of(geom.kind, geom.extent, resolution))
    return out, acc, final, wall


def share_z(a: float, b: float, src: float, n: int) -> float:
    """|z| of two traces' energies ``a`` and ``b`` on one part of a scene
    (independent traces of n rays that carry src / n each). A ray puts at
    most its own energy there, so the share p of the source varies by at
    most p (1 - p) / n a trace (a Bernoulli trial of the ray's whole
    energy bounds it), and two traces' shares differ by at most twice
    that, at the pooled p."""
    pa, pb = a / src, b / src
    p = 0.5 * (pa + pb)
    if p <= 0.0:
        return 0.0
    return abs(pa - pb) / float(np.sqrt(2.0 * p * (1.0 - p) / n))


def map_distance(a, b, sq):
    """Two energy maps ``a`` and ``b`` of the same bins from independent
    traces, and ``sq``, a third trace's sum of its squared deposits in
    each bin (the variance V of a bin's energy, a trace). Their squared
    distance T = sum (a - b)^2 has mean 2 sum V and variance 8 sum V^2
    where the bins' differences are normal, as c chi^2_nu with nu =
    (sum V)^2 / sum V^2 (Welch-Satterthwaite). Returns (T / 2 sum V, the
    3-sigma quantile of chi^2_nu / nu by Wilson and Hilferty's cube)."""
    a, b, sq = (np.asarray(x, dtype=np.float64) for x in (a, b, sq))
    v, v2 = float(sq.sum()), float((sq * sq).sum())
    nu = v * v / v2
    w = 2.0 / (9.0 * nu)
    return (float(((a - b) ** 2).sum()) / (2.0 * v),
            (1.0 - w + 3.0 * float(np.sqrt(w))) ** 3)


def maps_agree(a, b, sq, src, n) -> bool:
    """The totals of ``a`` and ``b`` within 3 sigma (share_z) and their
    squared distance within its 3-sigma quantile (map_distance)."""
    r, limit = map_distance(a, b, sq)
    return share_z(float(np.sum(a)), float(np.sum(b)), src, n) <= 3.0 and \
        r <= limit


@pytest.mark.cuda
def test_curved_device_flux_matches_host_on_gpu(cuda_device):
    """The config 5 cavity (benchmarks/suite.py:695) lit through its
    aperture (tests/models/test_model_zoo.py:77): the device maps of its
    conical frustum and its cylinder (axial binning) sum to the energy
    absorbed on their rows to 1e-5, and lie within 1e-4 (L1, of the
    total) of the host histograms of ray_tracer's records."""
    from tracer_tpu_torch.models.two_n_cavity import TwoNParamCav
    from tracer_tpu_torch.sources import solar_disk_bundle
    cav = TwoNParamCav(apertureRadius=0.3, frustaRadii=[0.5, 0.5],
                       frustaDepths=[0.4, 0.4], coneDepth=0.3,
                       el_FRUs=[2, 2], el_CON=2)
    table, meta = ptt.compile_scene(cav, device=cuda_device)
    sun = solar_disk_bundle(
        torch.Generator(device=cuda_device).manual_seed(6), 1 << 18,
        center=[0, 0, 0.01], direction=[0, 0, 1.0], radius=0.29,
        ang_range=0.05, flux=5e5, device=cuda_device)
    names = ("frustum_0", "frustum_1")
    maps = curved_map_compare(table, meta, names, sun, 7, 30)[0]
    for name, kind in zip(names, ("conical_frustum", "finite_cylinder")):
        assert meta.surfaces[meta.index_of(name)].geometries[0].kind == kind
        c = maps[name]
        assert c["absorbed"] > 0
        assert abs(c["hist"].sum() - c["absorbed"]) <= 1e-5 * c["absorbed"]
        assert c["l1"] < 1e-4, (name, c["l1"])


# ---- float64 traces and the sharded entry points on the card


def _minidish(device, dtype):
    from tracer_tpu_torch.models.tau_minidish import MiniDish
    asm = MiniDish(5.0, 6.25, 0.9, 6.95, 0.4, 0.7, 0.9)
    asm.set_transform(ptt.spatial.rotx(-np.pi / 4))
    return ptt.compile_scene(asm, dtype=dtype, device=device)


def _minidish_sun(n, device, dtype):
    x = -1.0 / np.sqrt(2.0)
    return ptt.sources.solar_disk_bundle(
        torch.Generator(device=device).manual_seed(42), n, [0.0, 7.0, 7.0],
        [0.0, x, x], 3.0, 0.005, flux=1000.0, dtype=dtype, device=device)


@pytest.mark.cuda
def test_float64_traces_on_gpu(cuda_device):
    """float64 on CUDA tensors: the MiniDish through trace_fused at 65,536
    rays equals the same float64 trace on the CPU per row to 1e-9
    relative (its optics draw nothing), and ray_tracer's on the card to
    1e-12; config 1 streams on the general path closing to 1e-9; no
    kernel launches."""
    from tracer_tpu_torch.engine import trace_fused
    f64 = torch.float64
    table, meta = _minidish(cuda_device, f64)
    t_cpu, _ = _minidish("cpu", f64)
    sun = _minidish_sun(65_536, cuda_device, f64)
    for w in (kb.bounce_reflect_culled, kb.bounce_reflect, kn.nearest_hit):
        w.launches = 0
    _, got = trace_fused(table, sun, max_bounces=20)
    _, want = trace_fused(t_cpu, sun.to("cpu"), max_bounces=20)
    g, w_ = got.absorbed.cpu(), want.absorbed
    assert got.absorbed.dtype == f64
    np.testing.assert_allclose(g.numpy(), w_.numpy(), rtol=1e-9, atol=0)
    res = ptt.TracerEngine(table, meta).ray_tracer(sun, reps=20)
    assert res.accum.absorbed.dtype == f64
    np.testing.assert_allclose(res.accum.absorbed.numpy(), g.numpy(),
                               rtol=1e-12, atol=0)
    slab = 4 * kb.TILE
    table, meta, source_fn = bench_scene(1, slab, cuda_device, dtype=f64)
    acc, em, se = trace_streaming(table, source_fn,
                                  torch.Generator().manual_seed(1),
                                  4 * slab, max_rounds=60, max_path=20)
    assert int(em) == 4 * slab and abs(energy_closure(acc, se)) < 1e-9
    assert (kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
            == kn.nearest_hit.launches == 0)


@pytest.mark.cuda
def test_trace_sharded_one_rank_nccl_on_gpu(cuda_device):
    """One rank over NCCL: trace_sharded of the MiniDish equals trace_fused
    with the rank's generator bit for bit, on K3."""
    import socket
    import torch.distributed as dist
    from tracer_tpu_torch import parallel
    from tracer_tpu_torch.engine import trace_fused
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        table, _ = _minidish(cuda_device, torch.float32)
        sun = _minidish_sun(1 << 20, cuda_device, torch.float32)
        kn.nearest_hit.launches = 0
        final, acc = parallel.trace_sharded(table, sun, 5, max_bounces=20)
        assert kn.nearest_hit.launches > 0
        final_f, acc_f = trace_fused(
            table, sun, parallel.rank_generator(5, 0, cuda_device),
            max_bounces=20)
        for name in ("absorbed", "escaped", "culled"):
            assert torch.equal(getattr(acc, name), getattr(acc_f, name))
        assert torch.equal(final.energy, final_f.energy)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_spans_share_the_profilers_clock_on_gpu(cuda_device):
    """A span around one torch.cuda._sleep launch holds the launch's host
    event (cudaLaunchKernel) of the profiler's trace, and the kernel's
    device event starts after the span does: spans, host and device
    events read one clock."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from tracer_tpu_torch import telemetry
    torch.cuda.synchronize()
    telemetry.collect()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        telemetry.enable()
        try:
            with telemetry.span("launch"):
                torch.cuda._sleep(10_000_000)
        finally:
            telemetry.enable(False)
        torch.cuda.synchronize()
    (sp,) = telemetry.collect()
    events = list(prof.profiler.kineto_results.events())
    host = {e.correlation_id(): e for e in events
            if e.device_type() != DeviceType.CUDA
            and e.name().startswith("cu")}
    kernels = [e for e in events if e.device_type() == DeviceType.CUDA
               and e.correlation_id() in host]
    assert len(kernels) == 1, [e.name() for e in kernels]
    h = host[kernels[0].correlation_id()]
    assert sp.start <= h.start_ns()
    assert h.start_ns() + h.duration_ns() <= sp.end
    assert kernels[0].start_ns() >= sp.start


def _cell_paths(path: str, device):
    """A small call of a benchmark cell's path: the culled field with its
    receiver's flux map (K1, the drain on K2), the plain megakernel on the
    MiniDish (K2), trace_fused with the flux map on a bundle drawn on the
    card (K3)."""
    from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
    from tracer_tpu_torch.engine import trace_fused
    if path == "culled":
        slab = 4 * kb.TILE
        table, meta, culling, spec = k1_scene("flat", 40, slab, device)
        fspecs = (flux_plan(meta, "receiver", resolution=50),)

        def source_fn(generator, device=None):
            raise AssertionError("the culled trace draws in K1")
        source_fn.pallas_spec, source_fn.num_rays = spec, slab
        return lambda: trace_streaming(
            table, source_fn, torch.Generator().manual_seed(1), 2 * slab,
            culling=culling, max_rounds=300, max_path=8, fluxspecs=fspecs)
    if path == "megakernel":
        slab = 8 * kb.TILE
        table, _, source_fn = bench_scene(1, slab, device)
        return lambda: trace_streaming(
            table, source_fn, torch.Generator().manual_seed(1), 4 * slab,
            max_rounds=200, max_path=20)
    table, meta, source_fn = bench_scene(1, 1 << 16, device)
    fspecs = (flux_plan(meta, "receiver", resolution=50),)

    def fused():
        gen = torch.Generator(device=device).manual_seed(4)
        return trace_fused(table, source_fn(gen, device=device),
                           generator=gen, max_bounces=20, fluxspecs=fspecs)
    return fused


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["culled", "megakernel", "fused"])
def test_round_loops_wait_only_in_telemetry_read_on_gpu(cuda_device, path,
                                                        monkeypatch):
    """With torch.cuda.set_sync_debug_mode("error") from a call's first
    round to its end, everywhere but inside telemetry.read and
    telemetry.count, a small call of each benchmark cell's path runs:
    every wait of the round loops is a counted ``sync`` span. Its round
    spans equal each kernel's launch counter's delta."""
    from tracer_tpu_torch import engine, telemetry
    run = _cell_paths(path, cuda_device)
    run()
    real_span = telemetry.span

    def allowed(fn):
        def wait(x):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(x)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return wait

    def span(name, **attrs):
        if name == "round":
            torch.cuda.set_sync_debug_mode("error")
        return real_span(name, **attrs)
    monkeypatch.setattr(telemetry, "read", allowed(telemetry.read))
    monkeypatch.setattr(telemetry, "count", allowed(telemetry.count))
    monkeypatch.setattr(telemetry, "span", span)
    counters = (("k1", kb.bounce_reflect_culled), ("k2", kb.bounce_reflect),
                ("k3", kn.nearest_hit), ("oracle", engine._oracle_bounce))
    torch.cuda.synchronize()
    telemetry.collect()
    n0 = {k: f.launches for k, f in counters}
    telemetry.enable()
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        telemetry.enable(False)
    torch.cuda.synchronize()
    spans = telemetry.collect()
    rounds = {k: sum(1 for s in spans if s.name == "round"
                     and s.attrs["kernel"] == k) for k, _ in counters}
    assert rounds == {k: f.launches - n0[k] for k, f in counters}
    assert sum(rounds.values()) > 2
    assert sum(1 for s in spans if s.name == "sync") > 2
