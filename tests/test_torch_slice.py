"""The whole slice on the CPU: the port's NSTTF scene -> per-tile culling
-> culled trace_streaming with the 50x50 receiver flux map, against
tracer_tpu's trace_streaming (its jnp path, no culling) on the same scene,
at a 16-tile slab and 4 slabs (196,608 rays)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import nsttf as jax_nsttf
from tracer_tpu.engine import trace_streaming as jax_trace_streaming
from tracer_tpu_torch.analysis.device_fluxmap import finalize, flux_plan
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels.bounce import TILE
from tracer_tpu_torch.models import nsttf

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

SLAB = 16 * TILE
TOTAL = 4 * SLAB
TRACE = dict(total_rays=TOTAL, max_path=8, min_energy=1e-6)


def _f32(bundle):
    return jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, bundle)


@pytest.fixture(scope="module")
def jax_run():
    table, meta, info = jax_nsttf.build_scene(dtype=jnp.float32)
    src = jax_nsttf.make_source_fn(info, SLAB)

    def source_fn(key):
        return _f32(src(key))
    source_fn.pallas_spec = src.pallas_spec
    accum, emitted, source_e = jax_trace_streaming(
        table, source_fn, jax.random.PRNGKey(0), **TRACE)
    rec = meta.index_of("receiver")
    absorbed = np.asarray(accum.absorbed, np.float64)
    lost = sum(float(getattr(accum, f))
               for f in ("escaped", "culled", "medium", "residual"))
    se = float(source_e)
    return dict(absorbed=absorbed, source_e=se, emitted=int(emitted),
                closure=(se - absorbed.sum() - lost) / se,
                rec_row=int(np.nonzero(meta.row_logical == rec)[0][0]))


_PORT = {}


def _port_run(age_cap: int):
    if age_cap not in _PORT:
        table, meta, info = nsttf.build_scene(device="cpu")
        source_fn = nsttf.make_source_fn(info, SLAB)
        culling = build_block_culling(table, meta, source_fn.pallas_spec,
                                      SLAB, age_cap=age_cap)
        fspec = flux_plan(meta, "receiver", resolution=50)
        accum, emitted, source_e = trace_streaming(
            table, source_fn, torch.Generator().manual_seed(0),
            max_rounds=600, culling=culling, fluxspecs=(fspec,), **TRACE)
        _PORT[age_cap] = dict(accum=accum, emitted=int(emitted),
                              source_e=float(source_e), meta=meta,
                              fspec=fspec)
    return _PORT[age_cap]


@pytest.fixture(params=[3, 1], ids=["corridors3", "corridors1"])
def port_run(request):
    return _port_run(request.param)


def _bound(p, n):
    """3 sqrt(2) sigma of a difference of two binomial fractions."""
    return 3.0 * np.sqrt(2.0) * np.sqrt(p * (1.0 - p) / n)


def test_emits_exact_quota(port_run):
    assert TOTAL <= port_run["emitted"] < TOTAL + SLAB // TILE


def test_energy_closure(port_run, jax_run):
    """The port accounts every emitted ray to 1e-4. tracer_tpu's jnp path
    rounds per-ray absorbed energy to bfloat16 in its one-hot accounting
    (engine._account), which leaves it about 2e-4 here: it is held to
    bench.py's 5e-3."""
    assert abs(energy_closure(port_run["accum"],
                              port_run["source_e"])) < 1e-4
    assert abs(jax_run["closure"]) < 5e-3


def test_receiver_fraction_matches_jax(port_run, jax_run):
    r = jax_run["rec_row"]
    p_j = jax_run["absorbed"][r] / jax_run["source_e"]
    p_p = float(port_run["accum"].absorbed[r]) / port_run["source_e"]
    assert 0.035 < p_p < 0.08
    assert abs(p_p - p_j) <= _bound(p_j, TOTAL), (p_p, p_j)


def test_heliostat_absorption_matches_jax(port_run, jax_run):
    r = jax_run["rec_row"]
    helio = np.arange(len(jax_run["absorbed"])) != r
    p_j = jax_run["absorbed"][helio].sum() / jax_run["source_e"]
    p_p = (port_run["accum"].absorbed.double().numpy()[helio].sum()
           / port_run["source_e"])
    assert p_p > 0.0
    assert abs(p_p - p_j) <= _bound(p_j, TOTAL), (p_p, p_j)


def test_flux_map_carries_receiver_energy(port_run, jax_run):
    accum = port_run["accum"]
    rec = float(accum.absorbed[jax_run["rec_row"]])
    hist = accum.flux[0]
    assert hist.shape == (50, 50)
    assert abs(float(hist.double().sum()) - rec) / rec < 5e-3
    flux, (ue, ve) = finalize(port_run["fspec"], hist, port_run["meta"])
    assert np.isfinite(flux).all() and flux.max() > 0
    np.testing.assert_allclose((ue[0], ue[-1], ve[0], ve[-1]),
                               (-5.5, 5.5, -5.5, 5.5))


def test_unported_dispatch_raises():
    """A source spec with an ambient scattering medium is not a mode of
    the culled kernel (ROADMAP B1); without culling the NSTTF scene takes
    the plain megakernel, which scatters (tests/test_torch_media.py)."""
    table, meta, info = nsttf.build_scene(device="cpu")
    source_fn = nsttf.make_source_fn(info, SLAB)
    spec = list(source_fn.pallas_spec)
    spec[16] = (0.1, 0.5)
    source_fn.pallas_spec = tuple(spec)
    with pytest.raises(NotImplementedError, match="ROADMAP B1"):
        trace_streaming(table, source_fn, torch.Generator(), TOTAL,
                        culling=object())


def test_chunked_drain_visits_every_live_lane():
    """With a chunk smaller than the slab, every live lane is drained once
    and what a chunk leaves alive goes to the residual."""
    from tracer_tpu_torch.engine import TraceAccum, _chunked_drain
    g = torch.Generator().manual_seed(0)
    e = torch.rand(1000, generator=g) * (torch.rand(1000, generator=g) > 0.5)
    seen = []

    def drain_fn(ce, cfields, accum):
        seen.append(cfields[0][ce > 0])
        return 0.5 * ce

    accum = TraceAccum.zeros(3, device="cpu")
    out = _chunked_drain(e, (torch.arange(1000),), drain_fn, 64, accum)
    assert (out == 0).all() and len(seen) == -(-int((e > 0).sum()) // 64)
    visited = torch.cat(seen)
    assert torch.equal(visited.sort().values,
                       torch.nonzero(e > 0).flatten())
    torch.testing.assert_close(float(accum.residual), 0.5 * float(e.sum()),
                               rtol=1e-5, atol=0)


def test_culling_of_another_scene_is_refused():
    table, meta, info = nsttf.build_scene(device="cpu")
    small, _, _ = nsttf.build_scene(n_heliostats=50, device="cpu")
    source_fn = nsttf.make_source_fn(info, SLAB)
    culling = build_block_culling(table, meta, source_fn.pallas_spec, SLAB)
    with pytest.raises(ValueError, match="this scene"):
        trace_streaming(small, source_fn, torch.Generator(), TOTAL,
                        culling=culling)
