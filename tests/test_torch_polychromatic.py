"""Polychromatic rays on the port (tracer_tpu_torch) against tracer_tpu:
per-ray spectra (N, K) over one shared wavelength grid, filtered every
bounce by the spectral rows' absorptance tables (the outgoing energy is
the trapezoid of the filtered spectrum), scaled by every other kind's
energy ratio, and recorded per hit.

* the counterparts of tests/test_polychromatic.py's analytic cases, at
  its tolerances, in float64 on the CPU;
* the two-band mirror through both packages' ray_tracer from one numpy
  bundle: per-hit spectra, energies and the accumulators to 1e-9;
* the attenuating ambient medium scaling the spectrum, with_spectra's
  checks, carrying the spectra through concat, ``to`` and record="tags";
* the guards: trace_fused and trace_streaming refuse polychromatic
  bundles and sources, piecewise (theta, wl) rows refuse them, and a
  scene with energy-splitting interfaces refuses them where tracer_tpu
  fails on the reflected branches it builds without spectra.
"""
import jax
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu.bundle import RayBundle as JaxBundle
from tracer_tpu.engine import TracerEngine as JaxEngine
from tracer_tpu_torch.bundle import RayBundle, concatenate_rays
from tracer_tpu_torch.engine import (TraceOptions, TracerEngine, trace_fused,
                                     trace_streaming)

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")


def _two_band(n, grid):
    """Rays straight down; spectrum a blue box over a red box
    (tests/test_polychromatic.py:25)."""
    spectra = np.tile(np.where(grid < 600e-9, 2.0e9, 1.0e9), (n, 1))
    pos = np.tile([0.0, 0.0, 1.0], (n, 1))
    dirs = np.tile([0.0, 0.0, -1.0], (n, 1))
    return pos, dirs, spectra


def _port_bundle(n, grid):
    pos, dirs, spectra = _two_band(n, grid)
    return RayBundle.create(pos, dirs, **F64).with_spectra(grid, spectra)


def _mirror_scene(pkg, grid, alpha):
    """A 45-degree spectral mirror sending the beam to a recording
    receiver (tests/test_polychromatic.py:34-51)."""
    G, M, sp, sc = pkg.geometry, pkg.materials, pkg.spatial, pkg.scene
    mirror = sc.Surface(G.rect_plate(2.0, 2.0),
                        M.reflective_spectral(alpha, grid),
                        rotation=sp.rotx(-np.pi / 4)[:3, :3], name="mirror")
    rec = sc.Surface(G.rect_plate(4.0, 4.0),
                     M.with_accounting(M.absorber(one_sided=False),
                                       "location", "absorption",
                                       "polychromatic"),
                     location=[0.0, 3.0, 0.0],
                     rotation=sp.rotx(np.pi / 2)[:3, :3], name="rec")
    return sc.Assembly([sc.AssembledObject([mirror, rec])])


GRID = np.linspace(400e-9, 800e-9, 41)
ALPHA = np.where(GRID < 600e-9, 0.6, 0.1)


def test_with_spectra_sets_energy_and_checks_shapes():
    b = _port_bundle(3, GRID)
    assert b.spectra.shape == (3, 41) and b.spectral_grid.shape == (41,)
    np.testing.assert_allclose(b.energy.numpy(), np.trapezoid(
        b.spectra.numpy(), GRID, axis=1), rtol=1e-12)
    with pytest.raises(ValueError, match="spectra must be"):
        b.with_spectra(GRID, np.ones((2, 41)))
    both = concatenate_rays([b, b.to("cpu")])
    assert both.spectra.shape == (6, 41)
    assert torch.equal(both.spectral_grid, b.spectral_grid)
    mono = RayBundle.create(np.zeros((1, 3)), [[0.0, 0.0, 1.0]], **F64)
    with pytest.raises(ValueError, match="polychromatic and monochromatic"):
        b.concat(mono)


def test_two_band_receiver_matches_analytic():
    """tests/test_polychromatic.py:34-86 on the port: every per-hit
    spectrum, the receiver's power and the closure against the
    hand-computed trapezoids."""
    eng = TracerEngine(_mirror_scene(ptt, GRID, ALPHA), dtype=torch.float64,
                       device="cpu")
    n = 16
    bund = _port_bundle(n, GRID)
    s_in = bund.spectra[0].numpy()
    e_in = np.trapezoid(s_in, GRID)
    np.testing.assert_allclose(float(bund.energy[0]), e_in, rtol=1e-12)
    res = eng.ray_tracer(bund, reps=4,
                         generator=torch.Generator().manual_seed(0))
    s_expect = s_in * (1.0 - ALPHA)
    e_expect = np.trapezoid(s_expect, GRID)
    hits = res.hits_of("rec")
    assert hits["spectra"].shape == (n, len(GRID))
    np.testing.assert_allclose(hits["spectra"], 0.0, atol=1e-9)
    np.testing.assert_allclose(hits["e_in"], e_expect, rtol=1e-6)
    np.testing.assert_allclose(hits["absorbed"].sum(), n * e_expect,
                               rtol=1e-6)
    m_hits = res.hits_of("mirror")
    np.testing.assert_allclose(m_hits["spectra"], np.tile(s_expect, (n, 1)),
                               rtol=1e-6)
    np.testing.assert_allclose(m_hits["absorbed"].sum(),
                               n * (e_in - e_expect), rtol=1e-6)
    bal = res.energy_balance()
    np.testing.assert_allclose(bal["absorbed"] + bal["escaped"]
                               + bal["culled"] + bal["residual"]
                               + bal["medium"], n * e_in, rtol=1e-9)


def test_scalar_interactions_scale_spectra():
    """tests/test_polychromatic.py:89-104: a gray mirror of absorptivity
    0.25 scales the whole spectrum; the trapezoid identity holds."""
    grid = np.linspace(400e-9, 800e-9, 21)
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    eng = TracerEngine(sc.Assembly([sc.AssembledObject([sc.Surface(
        G.rect_plate(2.0, 2.0), M.reflective(0.25), name="mirror")])]),
        dtype=torch.float64, device="cpu")
    bund = _port_bundle(4, grid)
    res = eng.ray_tracer(bund, reps=1)
    rec = res.records[0]
    np.testing.assert_allclose(rec.spectra.numpy(),
                               0.75 * bund.spectra.numpy(), rtol=1e-6)
    np.testing.assert_allclose(np.trapezoid(rec.spectra.numpy(), grid,
                                            axis=1), rec.e_out.numpy(),
                               rtol=1e-6)


def test_two_band_mirror_equals_tracer_tpu():
    """The same numpy bundle through both packages' ray_tracer in
    float64: every record's spectra, energies and sids, the hits_of
    spectra and the accumulators to 1e-9."""
    n = 32
    pos, dirs, spectra = _two_band(n, GRID)
    # spread the rays over the mirror so the hits differ
    rng = np.random.default_rng(3)
    pos[:, :2] = rng.uniform(-0.5, 0.5, (n, 2))
    spectra = spectra * rng.uniform(0.5, 1.5, (n, 1))
    jb = JaxBundle.create(pos, dirs).with_spectra(GRID, spectra)
    jr = JaxEngine(_mirror_scene(tracer_tpu, GRID, ALPHA)).ray_tracer(
        jb, reps=4, key=jax.random.PRNGKey(0))
    pb = RayBundle.create(pos, dirs, **F64).with_spectra(GRID, spectra)
    pr = TracerEngine(_mirror_scene(ptt, GRID, ALPHA), dtype=torch.float64,
                      device="cpu").ray_tracer(pb, reps=4)
    assert len(pr.records) == len(jr.records) == 2
    for rec, jrec in zip(pr.records, jr.records):
        np.testing.assert_array_equal(rec.sid.numpy(), np.asarray(jrec.sid))
        for f in ("spectra", "e_in", "e_out", "absorbed"):
            np.testing.assert_allclose(getattr(rec, f).numpy(),
                                       np.asarray(getattr(jrec, f)),
                                       rtol=1e-9, atol=1e-9 * 2e9)
    for surf in ("mirror", "rec"):
        np.testing.assert_allclose(pr.hits_of(surf)["spectra"],
                                   jr.hits_of(surf)["spectra"], rtol=1e-9,
                                   atol=1e-9 * 2e9)
    np.testing.assert_allclose(pr.absorbed_by_logical(),
                               jr.absorbed_by_logical(), rtol=1e-9)
    np.testing.assert_allclose(float(pr.accum.escaped),
                               float(jr.accum.escaped), rtol=1e-9,
                               atol=1e-9 * float(pb.energy.sum()))


def test_attenuating_ambient_scales_spectra_and_tags_record():
    """Rays in an attenuating medium (a volumetric scene: an absorbing
    interface off the beam bounds the medium they start in) lose the
    same share of their spectrum as of their energy; record="tags" keeps
    the spectra of the tagged receiver's hits."""
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    rec = sc.Surface(G.rect_plate(4.0, 4.0),
                     M.receiver(M.absorber(one_sided=False)),
                     location=[0.0, 0.0, -1.0], name="rec")
    side = sc.Surface(G.rect_plate(1.0, 1.0), M.absorbant_interface(0.5),
                      location=[10.0, 0.0, 0.0], name="side")
    eng = TracerEngine(sc.Assembly([sc.AssembledObject([rec, side])]),
                       dtype=torch.float64, device="cpu")
    bund = _port_bundle(8, GRID).replace(att_coeff=torch.full((8,), 0.5,
                                                              **F64))
    res = eng.ray_tracer(bund, opts=TraceOptions(record="tags"))
    hits = res.hits_of("rec")
    trans = np.exp(-0.5 * 2.0)
    np.testing.assert_allclose(hits["e_in"], trans * bund.energy.numpy(),
                               rtol=1e-12)
    assert hits["spectra"].shape == (8, len(GRID))
    np.testing.assert_allclose(hits["spectra"], 0.0, atol=1e-6)
    bal = res.energy_balance()
    np.testing.assert_allclose(bal["medium"], (1 - trans)
                               * float(bund.energy.sum()), rtol=1e-12)
    assert abs(bal["closure"]) < 1e-9 * bal["source"]


def test_polychromatic_guards():
    """tests/test_polychromatic.py:107-123 on the port: trace_fused and
    trace_streaming refuse polychromatic bundles and sources, and
    piecewise (theta, wl) rows refuse them at trace time."""
    grid = np.linspace(400e-9, 800e-9, 11)
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    eng = TracerEngine(sc.Assembly([sc.AssembledObject([sc.Surface(
        G.rect_plate(2.0, 2.0), M.reflective(0.1))])]), device="cpu")
    bund = RayBundle.create(*_two_band(2, grid)[:2], device="cpu",
                            dtype=torch.float32).with_spectra(
        grid, _two_band(2, grid)[2])
    with pytest.raises(NotImplementedError, match="host-stepped"):
        trace_fused(eng.scene, bund)

    def source_fn(generator, device=None):
        return bund
    source_fn.num_rays = 2
    with pytest.raises(NotImplementedError, match="host-stepped"):
        trace_streaming(eng.scene, source_fn, torch.Generator(), 4)
    pw = sc.Surface(G.rect_plate(2.0, 2.0),
                    M.lambertian_directional_spectral_piecewise(
                        [0.0, np.pi / 2], [400e-9, 800e-9],
                        [[0.2, 0.3], [0.4, 0.5]]))
    eng2 = TracerEngine(sc.Assembly([sc.AssembledObject([pw])]),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="piecewise"):
        eng2.ray_tracer(bund, reps=1)


def _split_face(pkg):
    G, M, sc = pkg.geometry, pkg.materials, pkg.scene
    return sc.Assembly([sc.AssembledObject([
        sc.Surface(G.round_plate(1.0),
                   M.refractive_homogenous(1.0, 1.5, single_ray=False),
                   name="glass"),
        sc.Surface(G.round_plate(1.0), M.absorber(one_sided=False),
                   location=[0.0, 0.0, -1.0], name="rec")])])


def test_split_scene_refused_where_tracer_tpu_fails():
    """A polychromatic bundle in a scene with energy-splitting interfaces:
    tracer_tpu's _append_split_rays builds the reflected branches
    without spectra, so joining them to the bundle concatenates the
    spectra with None and fails (ROADMAP C, a recorded reference
    defect); the port refuses the pairing up front with a
    NotImplementedError that names it."""
    grid = np.linspace(400e-9, 800e-9, 11)
    pos, dirs, spectra = _two_band(4, grid)
    jb = JaxBundle.create(pos, dirs).with_spectra(grid, spectra)
    with pytest.raises(TypeError, match="NoneType"):
        JaxEngine(_split_face(tracer_tpu)).ray_tracer(
            jb, reps=3, key=jax.random.PRNGKey(0))
    pb = RayBundle.create(pos, dirs, **F64).with_spectra(grid, spectra)
    with pytest.raises(NotImplementedError, match="energy-splitting"):
        TracerEngine(_split_face(ptt), dtype=torch.float64,
                     device="cpu").ray_tracer(pb, reps=3)
