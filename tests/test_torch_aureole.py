"""Aureole parking (culling park_aureole) against tracer_tpu on the CPU.

A Buie sunshape carries a circumsolar aureole about ten times wider than
the solar disc. With ``park_aureole`` the culling keeps the first-segment
sweep at the full sunshape cone but sizes the specular closure to the
disc cone; K1 marks the hits of lanes born into the aureole by an encoded
sid, -(sid + 16), and the engine parks their survivors for the exact
drain. Here:

* (a) the parked culling equals tracer_tpu's, array for array, on the
  NSTTF at 16 tiles under the Buie disk and the oblique rect source; the
  default build parks nothing and equals tracer_tpu's default;
* (b) the closure property with the port's float64 oracle on 40 pads
  (tracer_tpu's tests/test_culling.py:150-170, :249-280 with
  ``disc_only=park_aureole``): first hits of full-cone rays are listed,
  and after a worst-case slope-error bounce off a non-demoted row the
  next hits of disc-cone rays are too;
* (c) K1's plain version with parking against tracer_tpu's interpret-mode
  culled kernel with parking, lane by lane, on disk and rect cells: the
  plain version draws its regeneration uniforms from tracer_tpu's
  interpret-mode hash (pallas_intersect._interp_uniform) instead of
  Philox, so both versions regenerate the same rays;
* (d) the parked culled trace on tracer_tpu's mirror field
  (tests/test_interpret_megakernel.py:167) against tracer_tpu's unculled
  trace.

The kernel itself runs against the plain version in
tests/test_torch_emulated.py (g++) and tests/test_torch_gpu.py (the card),
in test_torch_gpu.K1_MODES' "aureole" modes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tracer_tpu
import tracer_tpu_torch as ptt
from benchmarks import nsttf as jax_nsttf
from tracer_tpu import engine as jax_engine
from tracer_tpu import sources as jax_sources
from tracer_tpu.culling import build_block_culling as jax_build
from tracer_tpu.kernels.pallas_intersect import (
    bounce_reflect_culled_pallas, pack_rows as jax_pack_rows)
from tracer_tpu.scene import compile_scene as jax_compile_scene
from tracer_tpu_torch import engine
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.kernels.intersect import nearest_hit
from tracer_tpu_torch.kernels.philox import CALL_REGEN
from tracer_tpu_torch.models import nsttf
from test_culling import _cell_rays, _cell_rays_rect
from test_torch_bounce import _assert_close
from test_torch_gpu import (AUREOLE_CSR, T_EPS, field_assembly, field_spec,
                            k1_call, k1_lanes, k1_modes, k1_scene,
                            k1_traced, tile_args)

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

ARRAYS = ("lists", "counts", "cell_bounds", "age_caps", "cell_of_block")
SLAB = 16 * kb.TILE


@pytest.fixture(autouse=True)
def _fresh_jit_caches():
    """The interpret-mode switches are read at trace time and are not part
    of the jit cache key: keep no trace made under them."""
    yield
    jax.clear_caches()


# ---------------------------------------------------------------------------
# (a) the parked culling equals tracer_tpu's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("source", ("disk", "rect"))
def test_parked_culling_equals_jax(source):
    """The NSTTF at 16 tiles under its Buie disk or its oblique rect
    source: with park_aureole=True every array, the group layout, the
    demoted rows and the flag equal tracer_tpu's, and the parked lists are
    no longer than the default ones; the default build parks nothing and
    equals tracer_tpu's default."""
    jt, jm, jinfo = jax_nsttf.build_scene(dtype=jnp.float32)
    pt, pm, pinfo = nsttf.build_scene(dtype=torch.float32, device="cpu")
    make_j, make_p = ((jax_nsttf.make_source_fn, nsttf.make_source_fn)
                      if source == "disk" else
                      (jax_nsttf.make_rect_source_fn,
                       nsttf.make_rect_source_fn))
    jspec = make_j(jinfo, SLAB).pallas_spec
    pspec = make_p(pinfo, SLAB).pallas_spec
    assert pspec == jspec
    built = {}
    for park in (None, True):
        j = jax_build(jt, jm, jspec, SLAB, park_aureole=park)
        p = build_block_culling(pt, pm, pspec, SLAB, park_aureole=park)
        assert p.park_aureole == j.park_aureole == bool(park)
        for name in ARRAYS:
            a, b = getattr(p, name), getattr(j, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        assert p.group_offsets == j.group_offsets
        assert p.demote_rows == j.demote_rows
        assert p.n_cells == j.n_cells
        built[park] = p
    assert (built[True].counts <= built[None].counts).all()


def test_park_aureole_needs_an_aureole_and_one_device():
    """A pillbox sun has no aureole: park_aureole=True is dropped, as in
    tracer_tpu, and a mesh build (mesh_devices=2) parks nothing either;
    its layout equals tracer_tpu's mesh build array for array.
    mesh_devices=1 is the default build."""
    table, meta, _ = nsttf.build_scene(40, device="cpu")
    args = (4 * kb.TILE, [0.0, 0.0, 300.0], [0.0, 0.0, -1.0], 150.0,
            4.65e-3, 1000.0)
    spec = ptt.sources.disk_pillbox_pallas_spec(*args)
    cul = build_block_culling(table, meta, spec, 4 * kb.TILE,
                              park_aureole=True)
    assert not cul.park_aureole
    one = build_block_culling(table, meta, spec, 4 * kb.TILE,
                              mesh_devices=1)
    np.testing.assert_array_equal(one.lists, cul.lists)
    mesh = build_block_culling(table, meta, spec, 4 * kb.TILE,
                               mesh_devices=2)
    jt, jm, _ = jax_nsttf.build_scene(40, dtype=jnp.float32)
    jmesh = jax_build(jt, jm, jax_sources.disk_pillbox_pallas_spec(*args),
                      4 * kb.TILE, mesh_devices=2)
    assert not mesh.park_aureole and not jmesh.park_aureole
    for name in ARRAYS:
        a, b = getattr(mesh, name), getattr(jmesh, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert mesh.group_offsets == jmesh.group_offsets
    assert mesh.demote_rows == jmesh.demote_rows
    assert mesh.stats["mesh_n_seg"] == jmesh.stats["mesh_n_seg"]


# ---------------------------------------------------------------------------
# (b) the closure property, with the float64 oracle
# ---------------------------------------------------------------------------

def _first_and_next_hits(table, meta, bc, spec, rect, disc_only, rng, n,
                         sigma):
    """For each cell: the rows hit first by n rays from the cell (full
    sunshape cone, or the disc cone with ``disc_only``), and the rows
    their reflections off non-demoted rows hit next after a worst-case
    k_sigma = 5 slope-error tilt (tracer_tpu's tests/test_culling.py)."""
    sample = _cell_rays_rect if rect else _cell_rays
    f64 = dict(dtype=torch.float64)
    for b in range(bc.nb):
        pos, dirs = sample(rng, spec, bc.cell_bounds[b], n,
                           disc_only=disc_only)
        t, sid = nearest_hit(table, torch.tensor(pos, **f64),
                             torch.tensor(dirs, **f64))
        t, sid = t.numpy(), sid.numpy()
        listed = set(r for r in bc.lists[b].tolist() if r >= 0)
        hit = (sid >= 0) & ~np.isin(sid, bc.demote_rows)
        nxt = np.zeros(0, dtype=np.int64)
        if hit.any():
            hp = pos[hit] + t[hit, None] * dirs[hit]
            d = dirs[hit]
            nrm = meta.frames[sid[hit]][:, :3, 2]
            tilt = 5.0 * np.sqrt(2.0) * sigma
            ax = np.cross(nrm, rng.standard_normal(nrm.shape))
            ax /= np.linalg.norm(ax, axis=1, keepdims=True)
            nrm = nrm * np.cos(tilt) + ax * np.sin(tilt)
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            refl = d - 2.0 * np.sum(d * nrm, axis=1, keepdims=True) * nrm
            sid2 = nearest_hit(table, torch.tensor(hp + 1e-6 * refl, **f64),
                               torch.tensor(refl, **f64))[1].numpy()
            nxt = np.unique(sid2[sid2 >= 0])
        yield b, np.unique(sid[sid >= 0]), nxt, listed


@pytest.mark.parametrize("source", ("disk", "rect"))
def test_parked_lists_cover_first_hits_and_disc_closure(source):
    """40 pads, 12 tiles, park_aureole=True: every first hit of full-cone
    rays from cell b lies in lists[b] (the aureole's first segments are
    covered), and so does every next hit of disc-cone rays after a
    worst-case slope-error bounce (the disc-sized closure)."""
    table, meta, info = nsttf.build_scene(40, dtype=torch.float64,
                                          device="cpu")
    slab = 12 * kb.TILE
    make = nsttf.make_source_fn if source == "disk" \
        else nsttf.make_rect_source_fn
    spec = make(info, slab).pallas_spec
    bc = build_block_culling(table, meta, spec, slab, park_aureole=True)
    assert bc.park_aureole
    sigma = float(table.opt_params[:, 1].max())
    rng = np.random.default_rng(5)
    checked = 0
    for b, first, _, listed in _first_and_next_hits(
            table, meta, bc, spec, source == "rect", False, rng, 4000,
            sigma):
        assert not set(first.tolist()) - listed, (b, first, listed)
    for b, _, nxt, listed in _first_and_next_hits(
            table, meta, bc, spec, source == "rect", True, rng, 4000,
            sigma):
        assert not set(nxt.tolist()) - listed, (b, nxt, listed)
        checked += len(nxt) > 0
    assert checked > 3


# ---------------------------------------------------------------------------
# (c) K1's plain version with parking against the interpret-mode kernel
# ---------------------------------------------------------------------------

N_PADS = 40
TILES = (3, 4)
REMAINING = (kb.TILE, 700)


def _interp_uniforms(seed: int, stream, lane):
    """tracer_tpu's interpret-mode draws of the regeneration's four
    uniforms (pallas_intersect._interp_uniform): a murmur3 finaliser of
    (lane index in the (SUB, LANE) tile, seed + cell, draw counter 1-4
    after _prng_seed), 24 bits to (0, 1]."""
    idx = lane.numpy().astype(np.uint32)
    key = (seed + stream.numpy().astype(np.int64)).astype(np.uint32)
    out = []
    with np.errstate(over="ignore"):
        for salt in range(1, 5):
            x = (idx * np.uint32(0x9E3779B9) + key * np.uint32(0x85EBCA6B)
                 + np.uint32(salt * 0x27D4EB2F & 0xFFFFFFFF))
            x = x ^ (x >> np.uint32(16))
            x = x * np.uint32(0x85EBCA6B)
            x = x ^ (x >> np.uint32(13))
            x = x * np.uint32(0xC2B2AE35)
            x = x ^ (x >> np.uint32(16))
            u = ((x >> np.uint32(8)).astype(np.float32)
                 * np.float32(1.0 / (1 << 24)) + np.float32(1e-12))
            out.append(torch.from_numpy(u))
    return out


@pytest.mark.parametrize("mode", ("aureole", "aureole_rect"))
def test_k1_parking_matches_tpu_kernel_interpret(monkeypatch, mode):
    """Two tiles of 40 pads under a CSR 0.2 Buie disk (the NSTTF
    instance's field) or rect source, about half their lanes dead, quotas
    of a whole tile and of 700 lanes, no slope error: sid equal on every
    lane, encoded sids included (at least 10 of them); positions on lanes
    whose incidence |cos| is at least 0.01, directions, energies and
    absorbed energies within rtol 1e-5 and atol 1e-5 (1 + |x|). The same
    plain call without parking differs only in the encoded sids."""
    table, meta, culling, spec = k1_scene(mode, N_PADS, SLAB, "cpu")
    assert culling.park_aureole
    asm, extra = field_assembly(tracer_tpu, mode, N_PADS)
    jt = jax_compile_scene(asm, dtype=jnp.float32, extra_features=extra)[0]
    assert jt.groups == table.groups
    assert field_spec(tracer_tpu, mode, N_PADS, SLAB) == spec
    lanes = k1_lanes(meta, culling, TILES, 4, 0.5, "cpu")
    rem = torch.tensor(REMAINING, dtype=torch.int32)
    act = torch.ones(len(TILES), dtype=torch.int32)
    philox = kb.uniforms

    def draws(seed, stream, lane, call):
        if call == CALL_REGEN:
            return _interp_uniforms(seed, stream, lane)
        return philox(seed, stream, lane, call)
    monkeypatch.setattr(kb, "uniforms", draws)
    args = (table, culling, spec, TILES, 7, lanes, rem, act)
    got = k1_call(kb.bounce_reflect_culled, *args, slope=False)
    off = k1_call(kb.bounce_reflect_culled, *args, slope=False,
                  park_aureole=False)
    modes = k1_modes(table, spec, culling)
    assert modes["park_aureole"] and not modes["lambertian"]
    lists, counts, cells, cb = tile_args(culling, TILES)
    pos, dirs, e = (jnp.asarray(a.numpy()) for a in lanes[:3])
    monkeypatch.setenv("TRACER_FORCE_PALLAS", "1")
    monkeypatch.setenv("TRACER_INTERPRET_PRNG", "1")
    with pltpu.force_tpu_interpret_mode():
        want = jax.block_until_ready(bounce_reflect_culled_pallas(
            jax_pack_rows(jt), jnp.asarray(lists), jnp.asarray(counts),
            jnp.asarray(cells), jnp.asarray(cb), jnp.array([7], jnp.int32),
            jnp.asarray(REMAINING, jnp.int32),
            jnp.ones(len(TILES), jnp.int32), pos, dirs, e, jt.groups,
            culling.group_offsets, T_EPS, bivar=modes["bivar"],
            one_sided=modes["one_sided"], slope=False, source_spec=spec,
            park_aureole=True))
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    sid = got[3]
    np.testing.assert_array_equal(sid, want[3])
    encoded = sid <= -16
    assert encoded.sum() >= 10
    dead = lanes[2].numpy() <= 0.0
    assert (sid >= 0).mean() > 0.3
    # only regenerated lanes park: dead lanes within their tile's quota
    d2 = dead.reshape(len(TILES), kb.TILE)
    rank = np.cumsum(d2, axis=1) - 1
    reborn = (d2 & (rank < np.asarray(REMAINING)[:, None])).reshape(-1)
    assert not (encoded & ~reborn).any()
    winner = np.where(encoded, -sid - 16, sid)
    _, tdir, normal = k1_traced(*args)
    cos = ((tdir * normal).sum(1).abs()
           / normal.norm(dim=1).clamp(min=1e-30)).numpy()
    steep = np.where(winner >= 0, cos, 1.0) >= 0.01
    assert steep.mean() > 0.99
    _assert_close("pos", got[0], want[0], steep)
    for k, name in ((1, "dir"), (2, "energy"), (4, "absorbed")):
        _assert_close(name, got[k], want[k])
    # without parking: the same results, the sids decoded
    off = [a.numpy() for a in off]
    np.testing.assert_array_equal(off[3], winner)
    for k in (0, 1, 2, 4):
        np.testing.assert_array_equal(off[k], got[k])


# ---------------------------------------------------------------------------
# (d) the parked culled trace against tracer_tpu's unculled one
# ---------------------------------------------------------------------------

def _mirror_field(pkg, dtype):
    """tracer_tpu's tests/test_interpret_megakernel.py:106 in package
    ``pkg``: four 1.2 m mirrors (absorptivity 0.08) under a one-sided 5 m
    receiver 6 m up."""
    G, M, sc, sp = pkg.geometry, pkg.materials, pkg.scene, pkg.spatial
    mirrors = [sc.Surface(G.rect_plate(1.2, 1.2), M.reflective(0.08),
                          location=[x, y, 0.0], name=f"m{i}")
               for i, (x, y) in enumerate([(-1.5, -1.5), (1.5, -1.5),
                                           (-1.5, 1.5), (1.5, 1.5)])]
    rec = sc.Surface(G.rect_plate(5.0, 5.0), M.absorber(one_sided=True),
                     name="rec", location=[0.0, 0.0, 6.0],
                     rotation=sp.rotx(np.pi)[:3, :3])
    asm = sc.Assembly([sc.AssembledObject(mirrors + [rec])])
    if pkg is tracer_tpu:
        return sc.compile_scene(asm, dtype=dtype)[0]
    return sc.compile_scene(asm, dtype=dtype, device="cpu")


def test_parked_trace_matches_jax_unculled(monkeypatch):
    """tracer_tpu's test_park_aureole_culled_interpret_matches_general on
    the port: the mirror field under a CSR 0.2 Buie disk between mirrors
    and receiver, slab 2 TILE, 2 slabs of rays, max_path 6. The port's
    culled trace with park_aureole=True (K1's plain version, K2's on the
    drain) puts the same fraction of the source on every row as
    tracer_tpu's unculled trace within 0.02, closes energy within 1e-5,
    emits exactly each cell's quota (2 slab <= emitted < 2 slab +
    n_cells) and parks aureole-born lanes on the way."""
    slab = 2 * kb.TILE
    center, radius = [0.0, 0.0, 3.0], 2.8
    jt = _mirror_field(tracer_tpu, jnp.float32)

    def jax_source(key):
        b = jax_sources.buie_sunshape(key, slab, center=center,
                                      direction=[0, 0, -1.0], radius=radius,
                                      CSR=AUREOLE_CSR, flux=1000.0)
        return jax.tree.map(lambda a: a.astype(jnp.float32)
                            if jnp.issubdtype(a.dtype, jnp.floating) else a,
                            b)
    a0, _, se0 = jax_engine.trace_streaming(
        jt, jax_source, jax.random.PRNGKey(0), total_rays=2 * slab,
        max_rounds=40, max_path=6)
    f0 = np.asarray(a0.absorbed, np.float64) / float(se0)

    table, meta = _mirror_field(ptt, torch.float32)
    spec = ptt.sources.buie_sunshape_pallas_spec(
        slab, center, [0, 0, -1.0], radius, AUREOLE_CSR, 1000.0)
    culling = build_block_culling(table, meta, spec, slab,
                                  park_aureole=True)
    assert culling.park_aureole

    def source_fn(generator, device=None):
        raise AssertionError("the culled path draws no slab")
    source_fn.pallas_spec = spec
    source_fn.num_rays = slab
    parked = []
    k1 = engine.bounce_reflect_culled

    def counted(*args, **kw):
        out = k1(*args, **kw)
        assert kw["park_aureole"]
        parked.append(int((out[3] <= -16).sum()))
        return out
    monkeypatch.setattr(engine, "bounce_reflect_culled", counted)
    acc, em, se = trace_streaming(table, source_fn,
                                  torch.Generator().manual_seed(0),
                                  2 * slab, max_rounds=40, max_path=6,
                                  culling=culling)
    f1 = acc.absorbed.double().numpy() / float(se)
    np.testing.assert_allclose(f1, f0, atol=0.02)
    assert abs(energy_closure(acc, se)) < 1e-5
    assert 2 * slab <= int(em) < 2 * slab + culling.n_cells
    assert sum(parked) > 0
