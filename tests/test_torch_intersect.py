"""The port's nearest hit against tracer_tpu's, on fuzzed tables with every
quadric class and every aperture kind:

* the float64 oracle (kernels/intersect.py) against tracer_tpu's jnp
  nearest_hit, to 1e-12;
* K3's plain version (kernels/nearest.py) against tracer_tpu's Pallas
  kernel nearest_hit_pallas run in TPU interpret mode, both ways of
  need_local;
* the bifacial flat plate, where the two tracer_tpu paths disagree.

The CUDA kernel itself runs only on a GPU (tests/test_torch_gpu.py).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu.kernels.intersect import nearest_hit as jax_nearest_hit
from tracer_tpu.kernels.pallas_intersect import (
    nearest_hit_pallas, pack_rows as jax_pack_rows)
from tracer_tpu.scene import compile_scene as jax_compile
from tracer_tpu_torch.kernels import intersect as ki
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.kernels.bounce import pack_rows
from test_torch_gpu import AP_PARAMS, fuzz_assembly, fuzz_rays, k3_compare

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

T_EPS = 3e-4
N_LANES = 2 * 3072          # two of the Pallas kernel's ray tiles


@pytest.fixture(autouse=True)
def _fresh_jit_caches():
    """The interpret-mode switches are read at trace time and are not part
    of the jit cache key: keep no trace made under them."""
    yield
    jax.clear_caches()


def _tables(seed, jdtype, tdtype):
    jt, _ = jax_compile(fuzz_assembly(tracer_tpu, seed), dtype=jdtype)
    pt, pm = ptt.compile_scene(fuzz_assembly(ptt, seed), dtype=tdtype,
                               device="cpu")
    return jt, pt, pm


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_fuzz_table_covers_every_class_and_aperture(seed):
    _, pt, _ = _tables(seed, jnp.float32, torch.float32)
    assert {g[3] for g in pt.groups} == {"flat", "parab", "sphere",
                                          "quadric"}
    assert {k for g in pt.groups for k in g[2]} >= set(AP_PARAMS)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_oracle_matches_jnp_float64(seed):
    """float64: sid equal on every lane, t to 1e-12 relative."""
    jt, pt, pm = _tables(seed, jnp.float64, torch.float64)
    pos, dirs = (a.astype(np.float64) for a in fuzz_rays(pm, 4096, seed))
    t, sid = ki.nearest_hit(pt, torch.tensor(pos), torch.tensor(dirs))
    jtv, jsid = jax_nearest_hit(jt, jnp.asarray(pos), jnp.asarray(dirs))
    jtv, jsid = np.asarray(jtv), np.asarray(jsid)
    np.testing.assert_array_equal(sid.numpy(), jsid)
    assert (jsid >= 0).mean() > 0.5
    hit = jsid >= 0
    np.testing.assert_allclose(t.numpy()[hit], jtv[hit], rtol=1e-12)
    assert np.isinf(t.numpy()[~hit]).all() and np.isinf(jtv[~hit]).all()


@pytest.mark.parametrize("need_local", (True, False))
def test_plain_k3_matches_pallas_interpret(monkeypatch, need_local):
    """K3's plain version against nearest_hit_pallas in TPU interpret mode
    (both float32, on the CPU): sid equal on every lane off ties; t and
    aux within 2e-6 of their scale (test_torch_gpu.k3_compare: float32
    rounding at the ray's scale, amplified by 1/cos^2 near tangency)."""
    seed = 0
    jt, pt, pm = _tables(seed, jnp.float32, torch.float32)
    pos, dirs = fuzz_rays(pm, N_LANES, seed)
    monkeypatch.setenv("TRACER_FORCE_PALLAS", "1")
    with pltpu.force_tpu_interpret_mode():
        jt_, js, ja = jax.block_until_ready(nearest_hit_pallas(
            jax_pack_rows(jt), jnp.asarray(pos), jnp.asarray(dirs),
            jt.groups, T_EPS, 1e-6, need_local=need_local))
    want = (torch.tensor(np.asarray(jt_)), torch.tensor(np.asarray(js)),
            {k: torch.tensor(np.asarray(v)) for k, v in ja.items()})
    rows, tp, tdir = pack_rows(pt), torch.tensor(pos), torch.tensor(dirs)
    got = kn.nearest_hit(rows, tp, tdir, pt.groups, T_EPS,
                         need_local=need_local)
    assert (want[1] >= 0).float().mean() > 0.5
    ties, flips = k3_compare(got, want,
                             kn.nearest_two_t(rows, tp, tdir, pt.groups,
                                              T_EPS), tp, tdir, rtol=2e-6)
    assert flips == 0 and ties < 10
    if not need_local:
        assert not got[2]["local"].any()


def test_plain_k3_agrees_with_float64_oracle():
    """K3's plain version in float32 against the port's float64 oracle on
    the same table: sid equal except on lanes whose t lies between the
    flat class's L1 self-hit guard and the oracle's L2 guard, and ties."""
    seed = 1
    _, p32, pm = _tables(seed, jnp.float32, torch.float32)
    _, p64, _ = _tables(seed, jnp.float64, torch.float64)
    pos, dirs = fuzz_rays(pm, 4096, seed)
    tp, tdir = torch.tensor(pos), torch.tensor(dirs)
    t, sid, _ = kn.nearest_hit_ref(pack_rows(p32), tp, tdir, p32.groups,
                                   T_EPS)
    t64, sid64 = ki.nearest_hit(p64, tp.double(), tdir.double(),
                                t_eps=T_EPS)
    t1, t2 = kn.nearest_two_t(pack_rows(p32), tp, tdir, p32.groups, T_EPS)
    scale = 1.0 + tp.abs().amax(1)
    tie = (t2 - t1) <= 1e-5 * (scale + t1)
    # the guards are T_EPS (1 + |v|_1) and T_EPS (1 + |v|_2) <= T_EPS * 4 L
    band = t1 <= 4 * T_EPS * scale
    differ = (sid != sid64) & ~tie & ~band
    assert int(differ.sum()) == 0
    assert int((tie | band).sum()) < 20


def _bifacial_plate(pkg):
    G, M, sc = pkg.geometry, pkg.materials, pkg.scene
    plate = sc.Surface(G.rect_plate(2.0, 2.0),
                       M.bifacial(M.reflective(0.0), M.reflective(1.0)),
                       name="plate")
    return sc.Assembly([sc.AssembledObject([plate])])


@pytest.mark.parametrize("from_below", (True, False))
def test_bifacial_flat_plate(monkeypatch, from_below):
    """A 2 x 2 m bifacial plate (front mirror row 0, back absorber row 1,
    one flat group, F_BACKSIDE_MISS on both) lit along -z from above and
    along +z from below. The port (oracle and K3's plain version) and
    tracer_tpu's jnp path give the back row to rays from below. tracer_tpu's
    Pallas kernel does not apply backside_miss to flat rows and gives them
    the front row: a reference defect (ROADMAP C) that this pins."""
    jt, _ = jax_compile(_bifacial_plate(tracer_tpu), dtype=jnp.float32)
    pt, _ = ptt.compile_scene(_bifacial_plate(ptt), device="cpu")
    assert pt.groups == ((0, 2, (1,), "flat"),)
    assert "bifacial" in pt.features
    rng = np.random.default_rng(7)
    n = 1536
    z = -3.0 if from_below else 3.0
    pos = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.9, 0.9, n),
                    np.full(n, z)], axis=1).astype(np.float32)
    dirs = np.tile([0.0, 0.0, -math.copysign(1.0, z)],
                   (n, 1)).astype(np.float32)
    expect = 1 if from_below else 0
    p64, _ = ptt.compile_scene(_bifacial_plate(ptt), dtype=torch.float64,
                               device="cpu")
    _, sid_o = ki.nearest_hit(p64, torch.tensor(pos).double(),
                              torch.tensor(dirs).double())
    _, sid_k, aux = ki.nearest_hit_aux(pt, torch.tensor(pos),
                                       torch.tensor(dirs))
    _, sid_j = jax_nearest_hit(jt, jnp.asarray(pos), jnp.asarray(dirs),
                               use_pallas=False)
    assert (sid_o.numpy() == expect).all()
    assert (sid_k.numpy() == expect).all()
    assert (np.asarray(sid_j) == expect).all()
    monkeypatch.setenv("TRACER_FORCE_PALLAS", "1")
    with pltpu.force_tpu_interpret_mode():
        _, sid_p, _ = nearest_hit_pallas(
            jax_pack_rows(jt), jnp.asarray(pos), jnp.asarray(dirs),
            jt.groups, T_EPS, backside_miss=True)
    assert (np.asarray(sid_p) == 0).all()


def test_float64_off_the_cpu_raises():
    """The oracle takes float64 rays on any device: on meta tensors (which
    stand in for CUDA ones here) it runs through, its outputs of the rays'
    shape on their device, in their dtype."""
    pt, _ = ptt.compile_scene(_bifacial_plate(ptt), dtype=torch.float64,
                              device="cpu")
    pt_meta = ptt.SceneTable(**{
        f: (v.to("meta") if isinstance(v, torch.Tensor) else v)
        for f, v in pt.__dict__.items()})
    pos = torch.zeros((4, 3), dtype=torch.float64, device="meta")
    t, sid, aux = ki.nearest_hit_aux(pt_meta, pos, pos)
    assert aux is None
    assert t.device.type == sid.device.type == "meta"
    assert t.shape == sid.shape == (4,) and t.dtype == torch.float64