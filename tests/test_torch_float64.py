"""float64 traces on every path of the port against tracer_tpu's float64
traces on the CPU (tracer_tpu traces float64 on its jnp paths; the
kernels of both packages are float32):

* ray_tracer on bench config 2 (a slope-error dish over a Lambertian
  absorber): per-row shares within 3 combined binomial sigma of
  tracer_tpu's ray_tracer, closure to 1e-9;
* trace_streaming of configs 1 and 3 (the megakernel's in float32) on the
  general path in float64, with a culling handed in and ignored: shares
  within 3 combined sigma of tracer_tpu's float64 trace_streaming,
  closure to 1e-9, the emission budget met exactly;
* the split stream (energy-splitting glass) in float64 against
  tracer_tpu's float64 split stream;
* one whole adaptive view-factor run of config 5's cavity in float64
  against tracer_tpu's, entry by entry within 3 combined sigma.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import engine as jax_engine
from tracer_tpu import sources as jax_sources
from tracer_tpu.analysis import view_factors as jvf
from tracer_tpu_torch.analysis import view_factors as pvf
from tracer_tpu_torch.culling import build_block_culling
from tracer_tpu_torch.engine import energy_closure, trace_streaming
from tracer_tpu_torch.kernels.bounce import TILE
from tracer_tpu_torch.models.bench_configs import (
    BENCH, BENCH_FLUX, bench_assembly, bench_scene, max_rounds,
    silver_table)
from test_torch_parallel import GLASS, _glass, _port_source, _within_3_sigma
from test_torch_view_factors import CAVITIES

torch.set_num_threads(1)

F64 = torch.float64
SLAB = 2 * TILE
TOTAL = 4 * SLAB


def _jax_table64(cfg):
    asm, extra = bench_assembly(tracer_tpu, cfg)
    return tracer_tpu.compile_scene(asm, dtype=jnp.float64,
                                    extra_features=extra)[0]


def _jax_source64(cfg, n):
    """Config ``cfg``'s source rays in float64 (tests/test_torch_megakernel
    .py's draw without its float32 cast)."""
    c = BENCH[cfg]

    def source_fn(key):
        if cfg != 3:
            return jax_sources.disk_bundle(
                key, n, center=c["center"], direction=c["direction"],
                radius=c["radius"], ang_range=c["ang_range"],
                flux=BENCH_FLUX)
        k1, k2 = jax.random.split(key)
        b = jax_sources.buie_sunshape(k1, n, center=c["center"],
                                      direction=c["direction"],
                                      radius=c["radius"], CSR=c["csr"],
                                      flux=BENCH_FLUX)
        wls = silver_table(tracer_tpu)[0]
        wl = jax.random.uniform(k2, (n,), minval=float(wls[0]),
                                maxval=float(wls[-1]))
        return b.replace(wavelength=wl, att_coeff=jnp.full((n,), c["att"]))
    return source_fn


def _shares(accum, source_e):
    return np.append(np.asarray(accum.absorbed, np.float64),
                     [float(accum.escaped), float(accum.medium)]) \
        / float(source_e)


def test_ray_tracer_float64_matches_tracer_tpu():
    """Config 2's dish (slope error) and Lambertian absorber through the
    host-stepped ray_tracer in float64, its nearest hits from the
    oracle."""
    n = 8192
    table, meta, src = bench_scene(2, n, device="cpu", dtype=F64)
    bundle = src(torch.Generator().manual_seed(2), device="cpu")
    bundle = bundle.replace(**{f: getattr(bundle, f).to(F64) for f in
                               ("pos", "dir", "energy", "wavelength",
                                "ref_index", "att_coeff", "scat_coeff",
                                "scat_g")})
    res = ptt.TracerEngine(table, meta).ray_tracer(
        bundle, reps=20, generator=torch.Generator().manual_seed(3))
    assert res.accum.absorbed.dtype == F64
    se = float(bundle.energy.sum())
    left = float(res.final.energy[res.final.alive].sum())
    assert abs(energy_closure(res.accum, se) - left / se) < 1e-9
    jt = _jax_table64(2)
    jres = tracer_tpu.TracerEngine(jt).ray_tracer(
        _jax_source64(2, n)(jax.random.PRNGKey(2)), reps=20,
        key=jax.random.PRNGKey(3))
    _within_3_sigma(_shares(res.accum, se)[:-1], n,
                    _shares(jres.accum, float(np.asarray(
                        jres.source.energy).sum()))[:-1], n)


@pytest.mark.parametrize("cfg", (1, 3), ids=("minidish", "spectral"))
def test_general_stream_float64_matches_tracer_tpu(cfg, caplog):
    """Configs 1 and 3 stream in float64 on the general path; a culling
    built for the float32 table is ignored with a warning."""
    t32, m32, src = bench_scene(cfg, SLAB, device="cpu")
    table, _, _ = bench_scene(cfg, SLAB, device="cpu", dtype=F64)
    kw = dict(max_rounds=max_rounds(cfg, 4),
              max_path=BENCH[cfg]["max_path"])
    cul = build_block_culling(t32, m32, src.pallas_spec, SLAB)
    with caplog.at_level(logging.WARNING, logger="tracer_tpu_torch"):
        acc, em, se = trace_streaming(table, src,
                                      torch.Generator().manual_seed(cfg),
                                      TOTAL, culling=cul, **kw)
    assert "culling ignored" in caplog.text
    assert acc.absorbed.dtype == F64 and int(em) == TOTAL
    assert abs(energy_closure(acc, se)) < 1e-9
    ja, jem, jse = jax_engine.trace_streaming(
        _jax_table64(cfg), _jax_source64(cfg, SLAB), jax.random.PRNGKey(0),
        total_rays=TOTAL, **kw)
    _within_3_sigma(_shares(acc, se), int(em), _shares(ja, jse), int(jem))
    if cfg == 3:
        assert float(acc.medium) / float(se) > 0.05


def test_split_stream_float64_matches_tracer_tpu():
    """The split stream in float64: closure to 1e-9, every ray emitted,
    per-row shares within 3 combined sigma of tracer_tpu's."""
    pt, _ = ptt.compile_scene(_glass(ptt), dtype=F64, device="cpu")
    jt, _ = tracer_tpu.compile_scene(_glass(tracer_tpu), dtype=jnp.float64)
    total = 4 * 512
    kw = dict(max_rounds=200, max_path=20)
    acc, em, se = trace_streaming(pt, _port_source(GLASS),
                                  torch.Generator().manual_seed(8), total,
                                  **kw)
    assert abs(energy_closure(acc, se)) < 1e-9 and int(em) == total
    ja, jem, jse = jax_engine.trace_streaming(
        jt, lambda k: jax_sources.disk_bundle(k, 512, **GLASS),
        jax.random.PRNGKey(8), total_rays=total, **kw)
    _within_3_sigma(_shares(acc, se), int(em), _shares(ja, jse), int(jem))


def test_view_factors_float64_match_tracer_tpu():
    """Config 5's cavity: the port's and tracer_tpu's adaptive view-factor
    runs in float64 agree entry by entry within 3 combined sigma of the
    fewest rays an element fired, and each row sums to 1."""
    a, fr, fd, cd, ef, ec = CAVITIES["config5"]
    kw = dict(num_rays=4000, precision=0.05, max_iters=4, min_iters=2,
              iters_per_call=2)
    prt = pvf.TwoNParametersCavityRTVF(
        a, fr, fd, cd, ef, ec, generator=torch.Generator().manual_seed(9),
        dtype=F64, device="cpu", **kw)
    jrt = jvf.TwoNParametersCavityRTVF(a, fr, fd, cd, ef, ec,
                                       key=jax.random.PRNGKey(9), **kw)
    # every element fired at least num_rays rays: the sigma of that count
    # bounds each entry's
    n = kw["num_rays"]
    _within_3_sigma(prt.VF_esperance, n, np.asarray(jrt.VF_esperance), n)
    np.testing.assert_allclose(prt.VF_esperance.sum(1), 1.0, atol=0.02)
