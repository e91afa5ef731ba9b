"""Repairs of four faults of the port's signatures, on the CPU:

* a culling built from tracer_tpu's BlockCulling fields (no ``order``,
  which the port's K1 dispatch adds) derives its tile order from its
  counts, and the culled trace takes it;
* ``disk_bundle`` (and ``solar_disk_bundle``) take ``x_cut`` in
  tracer_tpu's parameter position: the chord-cut disc, drawn by the same
  inverse CDF, refused beside an annulus or a partial span as
  tracer_tpu refuses it;
* ``trace_streaming`` takes tracer_tpu's ``block`` and ignores it;
* ``build_block_culling`` takes tracer_tpu's ``max_smem_bytes``,
  ``max_segments`` and ``min_segments`` (its scalar-memory segmentation)
  and ignores them: the port's build is always one segment.
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest
import torch

import tracer_tpu_torch as ptt
from tracer_tpu import culling as jax_culling
from tracer_tpu import engine as jax_engine
from tracer_tpu import sources as jax_sources
from tracer_tpu_torch.culling import BlockCulling, build_block_culling
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.models import nsttf
from tracer_tpu_torch.models.bench_configs import BENCH, bench_scene

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

# tracer_tpu's BlockCulling fields without defaults (tests/test_utils.py
# builds one from these alone)
JAX_FIELDS = ("lists", "counts", "cell_bounds", "cell_of_block", "n_cells",
              "age_caps", "group_offsets", "demote_rows", "stats")


def test_block_culling_takes_tracer_tpu_fields():
    """tracer_tpu's required fields build the port's BlockCulling (the
    three-block culling of tests/test_utils.py among them); its order is
    the stable argsort of -counts.sum(1)."""
    required = tuple(
        f.name for f in dataclasses.fields(jax_culling.BlockCulling)
        if f.default is dataclasses.MISSING
        and f.default_factory is dataclasses.MISSING)
    assert required == JAX_FIELDS
    bc = BlockCulling(
        lists=np.array([[0, 1, -1], [1, 2, -1], [2, -1, -1]], np.int32),
        counts=np.array([[1], [2], [2]], np.int32),
        cell_bounds=np.zeros((3, 4), np.float32),
        cell_of_block=np.arange(3, dtype=np.int32), n_cells=3,
        age_caps=np.full(3, 3, np.int32), group_offsets=(0,),
        demote_rows=(1,), stats={})
    assert bc.order.dtype == np.int32 and bc.order.tolist() == [1, 2, 0]
    assert not bc.park_aureole


def test_culled_trace_takes_the_derived_order():
    """A culling rebuilt from tracer_tpu's fields of the port's own build
    (the 40-pad NSTTF field, four tiles) carries the build's order and
    traces exactly as the build does: equal accumulators."""
    slab = 4 * kb.TILE
    table, meta, info = nsttf.build_scene(40, device="cpu")
    src = nsttf.make_source_fn(info, slab)
    built = build_block_culling(table, meta, src.pallas_spec, slab)
    bare = BlockCulling(**{k: getattr(built, k) for k in JAX_FIELDS})
    np.testing.assert_array_equal(bare.order, built.order)
    runs = [trace_streaming(table, src, torch.Generator().manual_seed(0),
                            2 * slab, max_rounds=200, max_path=8,
                            culling=c) for c in (built, bare)]
    (a, em_a, se_a), (b, em_b, se_b) = runs
    assert int(em_a) == int(em_b) >= 2 * slab
    for name in ("absorbed", "escaped", "culled", "medium", "residual"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert abs(energy_closure(a, se_a)) < 1e-4


def test_block_culling_takes_segment_keywords():
    """build_block_culling takes tracer_tpu's three segmentation keywords
    with tracer_tpu's defaults, and a call that passes them (the values
    tracer_tpu's own tests pass: a budget one byte short, two segments at
    least) gives the same lists, counts, order and cells as one without
    them."""
    ref = inspect.signature(jax_culling.build_block_culling).parameters
    port = inspect.signature(build_block_culling).parameters
    for name in ("max_smem_bytes", "max_segments", "min_segments"):
        assert port[name].default == ref[name].default, name
        assert port[name].kind == inspect.Parameter.KEYWORD_ONLY, name
    slab = 4 * kb.TILE
    table, meta, info = nsttf.build_scene(40, device="cpu")
    spec = nsttf.make_source_fn(info, slab).pallas_spec
    plain = build_block_culling(table, meta, spec, slab)
    for kw in (dict(max_smem_bytes=1024, max_segments=4, min_segments=2),
               dict(max_smem_bytes=(1 << 20) - 1), dict(min_segments=2)):
        got = build_block_culling(table, meta, spec, slab, **kw)
        for name in ("lists", "counts", "order", "cell_bounds",
                     "cell_of_block", "age_caps"):
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(plain, name), err_msg=name)
        assert got.n_cells == plain.n_cells
        assert got.group_offsets == plain.group_offsets


def test_x_cut_in_tracer_tpu_position():
    """x_cut follows angular_span as in tracer_tpu's signature, and
    solar_disk_bundle is disk_bundle."""
    def names(fn):
        return list(inspect.signature(fn).parameters)
    ref = names(jax_sources.disk_bundle)
    port = names(ptt.sources.disk_bundle)
    # after the key (tracer_tpu) or generator (here), the same names in
    # the same order up to rays_direction
    assert port[1:port.index("rays_direction") + 1] == ref[1:ref.index(
        "rays_direction") + 1]
    assert ptt.sources.solar_disk_bundle is ptt.sources.disk_bundle


@pytest.mark.parametrize("x_cut", (0.3, -0.4))
def test_x_cut_matches_tracer_tpu_moments(x_cut):
    """The chord-cut disc (R = 1.5 m, facing +z) against tracer_tpu's, 2e5
    rays each: every point at x <= x_cut, z = 0; the means of x, y, x^2,
    y^2 and xy within 3 combined sigma; the same energy per ray."""
    n, r = 200_000, 1.5
    kw = dict(center=[0.0, 0.0, 0.0], direction=[0.0, 0.0, 1.0], radius=r,
              ang_range=0.01, flux=1000.0)
    jb = jax_sources.disk_bundle(jax.random.PRNGKey(3), n, x_cut=x_cut, **kw)
    pb = ptt.sources.disk_bundle(torch.Generator().manual_seed(3), n,
                                 kw["center"], kw["direction"], r, 0.01,
                                 1000.0, 0.0, (0.0, 2.0 * np.pi), x_cut,
                                 device="cpu")
    pj = np.asarray(jb.pos, dtype=np.float64)
    pp = pb.pos.double().numpy()
    assert (pp[:, 0] <= x_cut + 1e-6).all() and np.abs(pp[:, 2]).max() < 1e-6
    for f in (lambda p: p[:, 0], lambda p: p[:, 1], lambda p: p[:, 0] ** 2,
              lambda p: p[:, 1] ** 2, lambda p: p[:, 0] * p[:, 1]):
        a, b = f(pj), f(pp)
        sig = np.sqrt(a.var() / n + b.var() / n)
        assert abs(a.mean() - b.mean()) < 3 * sig, (a.mean(), b.mean(), sig)
    np.testing.assert_allclose(pb.energy.numpy(), np.asarray(jb.energy),
                               rtol=1e-6)


@pytest.mark.parametrize("bad", (dict(radius_in=0.2),
                                 dict(angular_span=(0.0, np.pi))))
def test_x_cut_refused_beside_annulus_or_span(bad):
    """x_cut beside an annulus or a partial span raises in both
    packages."""
    kw = dict(center=[0.0, 0.0, 0.0], direction=[0.0, 0.0, 1.0], radius=1.0,
              ang_range=0.0, x_cut=0.2, **bad)
    with pytest.raises(NotImplementedError):
        jax_sources.disk_bundle(jax.random.PRNGKey(0), 8, **kw)
    with pytest.raises(NotImplementedError):
        ptt.sources.disk_bundle(torch.Generator(), 8, device="cpu", **kw)


def test_trace_streaming_takes_block():
    """trace_streaming takes tracer_tpu's ``block`` in its position and
    ignores it: bench config 1 on two tiles gives the same accumulators
    with and without it."""
    ref = list(inspect.signature(jax_engine.trace_streaming).parameters)
    port = list(inspect.signature(trace_streaming).parameters)
    assert port.index("block") == ref.index("block")
    slab = 2 * kb.TILE
    table, _, src = bench_scene(1, slab, "cpu")
    runs = [trace_streaming(table, src, torch.Generator().manual_seed(2),
                            2 * slab, max_rounds=12,
                            max_path=BENCH[1]["max_path"], **kw)
            for kw in ({}, dict(block=16))]
    for name in ("absorbed", "escaped", "culled", "residual"):
        assert torch.equal(getattr(runs[0][0], name),
                           getattr(runs[1][0], name)), name
