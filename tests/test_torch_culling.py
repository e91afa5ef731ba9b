"""The port's per-tile culling equals tracer_tpu's build on the NSTTF scene,
at a 16-tile slab and at bench.py's 684-tile slab."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import nsttf as jax_nsttf
from tracer_tpu.culling import build_block_culling as jax_build
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.kernels.bounce import TILE
from tracer_tpu_torch.models import nsttf

BENCH_SLAB = 2 * ((1 << 20) // TILE * TILE + TILE)
SLABS = {"16tiles": 16 * TILE, "bench": BENCH_SLAB}
ARRAYS = ("lists", "counts", "cell_bounds", "age_caps", "cell_of_block")


@pytest.fixture(scope="module")
def scenes():
    jt, jm, jinfo = jax_nsttf.build_scene(dtype=jnp.float32)
    pt, pm, pinfo = nsttf.build_scene(dtype=torch.float32, device="cpu")
    return jt, jm, jinfo, pt, pm, pinfo


_CACHE = {}


def _cullings(scenes, name):
    """(tracer_tpu culling, port culling, slab) for one slab, built once."""
    jt, jm, jinfo, pt, pm, pinfo = scenes
    if name not in _CACHE:
        slab = SLABS[name]
        jspec = jax_nsttf.make_source_fn(jinfo, slab).pallas_spec
        pspec = nsttf.make_source_fn(pinfo, slab).pallas_spec
        assert pspec == jspec
        _CACHE[name] = (jax_build(jt, jm, jspec, slab),
                        build_block_culling(pt, pm, pspec, slab), slab)
    return _CACHE[name]


@pytest.fixture(params=sorted(SLABS))
def cullings(request, scenes):
    return _cullings(scenes, request.param)


@pytest.mark.parametrize("name", ARRAYS)
def test_culling_arrays_equal(cullings, name):
    j, p, _ = cullings
    a, b = getattr(p, name), getattr(j, name)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_culling_static_fields_equal(cullings):
    j, p, _ = cullings
    assert p.group_offsets == j.group_offsets
    assert p.demote_rows == j.demote_rows
    assert p.n_cells == j.n_cells and p.nb == j.nb
    assert not j.segment_bounds and not j.park_aureole


@pytest.mark.parametrize("slabs", (1, 4, 256))
def test_block_quota_equal(cullings, slabs):
    j, p, slab = cullings
    np.testing.assert_array_equal(p.block_quota(slabs * slab),
                                  j.block_quota(slabs * slab))


def test_bench_slab_layout(scenes):
    """bench.py's slab: 684 tiles, candidate lists 31 wide, age caps 3."""
    _, p, _ = _cullings(scenes, "bench")
    assert p.lists.shape == (684, 31)
    assert (p.age_caps == 3).all()
    assert abs(p.stats["L_mean"] - 12.1) < 0.05
