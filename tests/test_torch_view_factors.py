"""Config 5's path on the port (tracer_tpu_torch) against tracer_tpu on the
CPU: the view-factor and emission sources, build_two_n_cavity, the
batched view-factor fire, the adaptive Welford loop, the radiosity solve
and its differentiable twin, and the 2N cavity model.

* the four A3 sources (gray_source with each shape sampler) by their
  moments against tracer_tpu's at the 3-sigma level, their energies
  exactly;
* the cavity tables equal to tracer_tpu's;
* the exchange matrix of the batched fire, given the same rays, equal to
  tracer_tpu's to 1e-9 in float64 (the 2N cavity and a binned scheme);
* the adaptive loop, fed the same samples, equal to tracer_tpu's;
* whole runs in float64: the Holman cavity against its analytic view
  factors (atol 0.03) under the summation and reciprocity rules, the
  binned scheme of the same cavity, the four-parameter wrapper, the
  zero-depth step and its refusal, the per-element engine loop and the
  fallback to it for gray walls;
* radiosity_rtvf equal to tracer_tpu's to 1e-12 (the Holman and flux-BC
  cases), radiosity_rtvf_torch's values and gradients equal to
  radiosity_rtvf_jax's under jax.grad to 1e-9;
* TwoNParamCav.energy_balance as tests/models/test_model_zoo.py runs it,
  and TwoNParamCav against tracer_tpu's: bin_hits of float64 traces of
  the same rays, and bin_hits and energy_balance on the same records, VF
  and areas, to 1e-9.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracer_tpu import sources as jsrc
from tracer_tpu.analysis import radiosity as jrad
from tracer_tpu.analysis import view_factors as jvf
from tracer_tpu.scene import compile_scene as jax_compile
from tracer_tpu_torch import sources as psrc
from tracer_tpu_torch.analysis import radiosity as prad
from tracer_tpu_torch.analysis import view_factors as pvf
from tracer_tpu_torch.scene import compile_scene

torch.set_num_threads(1)

F64 = dict(dtype=torch.float64, device="cpu")
HOLMAN_VF = np.array([
    [0.0,    0.63,   0.195,  0.075,  0.1],
    [0.315,  0.37,   0.2175, 0.06,   0.0375],
    [0.0975, 0.2175, 0.37,   0.2175, 0.0975],
    [0.0375, 0.06,   0.2175, 0.37,   0.315],
    [0.1,    0.075,  0.195,  0.63,   0.0],
])
R = 0.01
# (aperture radius, frusta radii, frusta depths, cone depth, el_FRUs,
# el_CON): the Holman cavity, config 5 (benchmarks/suite.py:692-699), a
# zero-depth step, an inward cone
CAVITIES = {
    "holman": (R, [R, R, R], [R, R, R], 0.0, [1, 1, 1], 1),
    "config5": (0.3, [0.5, 0.5], [0.4, 0.4], 0.3, [2, 2], 2),
    "step": (1.0, [2.0, 2.0], [0.0, 1.0], 0.5, [1, 2], 2),
    "inward": (0.3, [0.5], [0.6], -0.2, [3], 2),
}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _close_means(a, b):
    """The column means of two samples agree at the 3-sigma level for the
    sample as a whole: each of the m columns within z combined standard
    errors, z the two-sided Bonferroni bound that keeps the chance of a
    false alarm over all m columns at 3 sigma's 0.27% (z = 3.71 for
    m = 13)."""
    from scipy.stats import norm
    a, b = np.atleast_2d(a.T).T, np.atleast_2d(b.T).T
    z = norm.isf(2 * norm.sf(3.0) / 2 / a.shape[1])
    se = np.sqrt(a.var(0) / len(a) + b.var(0) / len(b)) + 1e-15
    assert (np.abs(a.mean(0) - b.mean(0)) <= z * se).all(), (
        a.mean(0), b.mean(0), se, z)


def _moments(b):
    """Positions, directions and energies of a bundle as one numpy
    sample (rays by columns)."""
    return np.concatenate([np.asarray(b.pos), np.asarray(b.dir),
                           np.asarray(b.energy)[:, None],
                           np.asarray(b.pos) ** 2,
                           np.asarray(b.dir) ** 2], axis=1)


N = 20_000
SOURCES = {
    "vf_frustum": (
        lambda g: psrc.vf_frustum_bundle(g, N, 0.5, 0.3, 0.4, [0, 0, 0.1],
                                         [0, 0, 1.0], flux=2.0,
                                         angular_span=(0.2, 4.0), **F64),
        lambda k: jsrc.vf_frustum_bundle(k, N, 0.5, 0.3, 0.4, [0, 0, 0.1],
                                         [0, 0, 1.0], flux=2.0,
                                         angular_span=(0.2, 4.0))),
    "vf_frustum_out": (
        lambda g: psrc.vf_frustum_bundle(g, N, 0.2, 0.6, 0.3, [0, 0.1, 0],
                                         [0, 0.6, 0.8], rays_in=False,
                                         **F64),
        lambda k: jsrc.vf_frustum_bundle(k, N, 0.2, 0.6, 0.3, [0, 0.1, 0],
                                         [0, 0.6, 0.8], rays_in=False)),
    "vf_cylinder": (
        lambda g: psrc.vf_cylinder_bundle(g, N, 0.5, 0.4, [0, 0, 0.2],
                                          [0, 0, 1.0], flux=3.0, **F64),
        lambda k: jsrc.vf_cylinder_bundle(k, N, 0.5, 0.4, [0, 0, 0.2],
                                          [0, 0, 1.0], flux=3.0)),
    "gray_disk": (
        lambda g: psrc.gray_source(
            g, {"type": "disk", "kwargs": {"r_ext": 1.0, "r_int": 0.2}},
            [0, 0, 1.0], [0, 0.6, -0.8], N, {"type": "lambertian"}, 10.0,
            **F64),
        lambda k: jsrc.gray_source(
            k, {"type": "disk", "kwargs": {"r_ext": 1.0, "r_int": 0.2}},
            [0, 0, 1.0], [0, 0.6, -0.8], N, {"type": "lambertian"}, 10.0)),
    "gray_frustum": (
        lambda g: psrc.gray_source(
            g, {"type": "frustum", "kwargs": {"r0": 0.3, "r1": 0.5,
                                              "depth": 0.4}},
            [0, 0, 0], [0, 0, 1.0], N, {"type": "lambertian"}, 4.0,
            rays_direction=[0, 0.6, 0.8], **F64),
        lambda k: jsrc.gray_source(
            k, {"type": "frustum", "kwargs": {"r0": 0.3, "r1": 0.5,
                                              "depth": 0.4}},
            [0, 0, 0], [0, 0, 1.0], N, {"type": "lambertian"}, 4.0,
            rays_direction=[0, 0.6, 0.8])),
    **{f"gray_{kind}": (
        lambda g, kind=kind, kw=kw: psrc.gray_source(
            g, {"type": kind, "kwargs": kw}, [0.1, 0, 1.0], [0, 0.6, 0.8],
            N, {"type": "lambertian", "kwargs": {"ang_range": 1.2}}, 5.0,
            **F64),
        lambda k, kind=kind, kw=kw: jsrc.gray_source(
            k, {"type": kind, "kwargs": kw}, [0.1, 0, 1.0], [0, 0.6, 0.8],
            N, {"type": "lambertian", "kwargs": {"ang_range": 1.2}}, 5.0))
       for kind, kw in (
           ("rectangle", {"lx": 2.0, "ly": 0.5}),
           ("triangle", {"A": [0, 0, 0], "B": [1.0, 0, 0],
                         "C": [0.2, 0.7, 0]}),
           ("polygon", {"verts": [[0, 0], [2, 0], [2, 1], [1, 0.4],
                                  [0, 1]]}),
           ("cylinder", {"radius": 0.4, "height": 1.0, "inward": True}),
           ("sphere", {"radius": 0.3}))},
    "thermal": (
        lambda g: psrc.spectral_band_axisymmetrical_thermal_emission_source(
            g, np.tile([0.1, 0.2, 0.3], (N, 1)), [0.0, 0.6, 0.8], 2.0,
            np.linspace(0.0, np.pi / 2, 7),
            [0.9, 0.88, 0.85, 0.8, 0.7, 0.5, 0.2], 1200.0, N,
            [1e-6, 3e-6], ref_index=1.2, **F64),
        lambda k: jsrc.spectral_band_axisymmetrical_thermal_emission_source(
            k, np.tile([0.1, 0.2, 0.3], (N, 1)), [0.0, 0.6, 0.8], 2.0,
            np.linspace(0.0, np.pi / 2, 7),
            [0.9, 0.88, 0.85, 0.8, 0.7, 0.5, 0.2], 1200.0, N,
            [1e-6, 3e-6], ref_index=1.2)),
}


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_sources_moments_equal_tracer_tpu(name):
    """Positions, directions and energies by their means and second
    moments at the 3-sigma level (_close_means); total energy and the
    fixed fields (wavelength, index) exactly; unit directions."""
    port, jax_fn = SOURCES[name]
    got, want = port(_gen(1)), jax_fn(jax.random.PRNGKey(2))
    assert got.pos.dtype == torch.float64 and got.num_rays == N
    _close_means(_moments(got), _moments(want))
    np.testing.assert_allclose(float(got.energy.sum()),
                               float(np.asarray(want.energy).sum()),
                               rtol=1e-12)
    for f in ("wavelength", "ref_index"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-12)
    np.testing.assert_allclose(torch.linalg.norm(got.dir, dim=1).numpy(),
                               1.0, atol=1e-12)


@pytest.mark.parametrize("name", sorted(CAVITIES))
def test_cavity_tables_equal_tracer_tpu(name):
    a, fr, fd, cd = CAVITIES[name][:4]
    pt, pm = compile_scene(pvf.build_two_n_cavity(a, fr, fd, cd), **F64)
    jt, jm = jax_compile(jvf.build_two_n_cavity(a, fr, fd, cd),
                         dtype=jnp.float64)
    assert pm.names == jm.names and pt.groups == jt.groups
    for f in ("frame", "quadric", "ap_type", "ap_params", "opt_kind",
              "opt_params", "logical"):
        np.testing.assert_array_equal(getattr(pt, f).numpy(),
                                      np.asarray(getattr(jt, f)))


def _port_rtvf(name, num_rays, **kw):
    a, fr, fd, cd, ef, ec = CAVITIES[name]
    return pvf.TwoNParametersCavityRTVF(a, fr, fd, cd, ef, ec,
                                        num_rays=num_rays, **F64, **kw)


@pytest.mark.parametrize("name", ["config5", "step", "inward"])
def test_exchange_matrix_equals_tracer_tpu(name):
    """The batched fire given the same rays (the port's _concat_sources
    handed to both) gives tracer_tpu's exchange matrix to 1e-9."""
    a, fr, fd, cd, ef, ec = CAVITIES[name]
    prt = _port_rtvf(name, 3000, max_iters=1, generator=_gen(4))
    pos, dirs, e = prt._concat_sources(_gen(5))
    got = prt.fire_rays(pos, dirs, e).numpy()
    jrt = jvf.TwoNParametersCavityRTVF(a, fr, fd, cd, ef, ec,
                                       num_rays=3000, max_iters=1,
                                       iters_per_call=1,
                                       key=jax.random.PRNGKey(0))
    rays = tuple(jnp.asarray(x.numpy()) for x in (pos, dirs, e))
    jrt._concat_sources = lambda key: rays
    want = jrt._build_fire_all()(jax.random.PRNGKey(1))[0]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)
    assert got.sum(1).min() > 0.9


HOLMAN_SCHEME = np.array([
    [[0, 2 * np.pi], [0.0, 0.0], [0.0, R]],
    [[0, 2 * np.pi], [0.0, R], [R, R]],
    [[0, 2 * np.pi], [R, 2 * R], [R, R]],
    [[0, 2 * np.pi], [2 * R, 3 * R], [R, R]],
    [[0, 2 * np.pi], [3 * R, 3 * R], [0.0, R]],
])
HOLMAN_AREAS = np.array([np.pi * R ** 2] + [2 * np.pi * R * R] * 3
                        + [np.pi * R ** 2])
HOLMAN_RAYS_IN = np.array([True, True, True, True, False])


def test_binned_exchange_matrix_equals_tracer_tpu():
    """The binned scheme's window-binned fire, the same rays to both
    packages, to 1e-9."""
    prt = pvf.BinnedAxisymmetricRTVF(
        pvf.build_two_n_cavity(*CAVITIES["holman"][:4]), HOLMAN_SCHEME,
        HOLMAN_AREAS, num_rays=3000, rays_in=HOLMAN_RAYS_IN, max_iters=1,
        generator=_gen(6), **F64)
    pos, dirs, e = prt._concat_sources(_gen(7))
    got = prt.fire_rays(pos, dirs, e).numpy()
    jrt = jvf.BinnedAxisymmetricRTVF(
        jvf.build_two_n_cavity(*CAVITIES["holman"][:4]), HOLMAN_SCHEME,
        HOLMAN_AREAS, num_rays=3000, rays_in=HOLMAN_RAYS_IN, max_iters=1,
        iters_per_call=1, key=jax.random.PRNGKey(0))
    rays = tuple(jnp.asarray(x.numpy()) for x in (pos, dirs, e))
    jrt._concat_sources = lambda key: rays
    want = jrt._build_fire_all()(jax.random.PRNGKey(1))[0]
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def _bare(cls, n=5, num_rays=1000, precision=0.02):
    """A view-factor object with its statistics but no engine, for the
    gates."""
    rt = object.__new__(cls)
    rt.areas = HOLMAN_AREAS
    rt.precision, rt.precision_rec = precision, precision
    rt.precision_option = "absolute"
    rt._init_stats(n, num_rays)
    return rt


@pytest.mark.parametrize("option", ["absolute", "relative"])
def test_adaptive_loop_equals_tracer_tpu(option):
    """The same stream of samples through both packages' batched
    adaptive loops: equal iterations, estimates, deviations and ray
    counts (the Welford update and the three gates)."""
    rng = np.random.default_rng(8)
    samples = [HOLMAN_VF + rng.normal(0, 0.004, HOLMAN_VF.shape)
               for _ in range(64)]
    out = []
    for cls, loop in ((pvf.TwoNParametersCavityRTVF, "port"),
                      (jvf.TwoNParametersCavityRTVF, "jax")):
        rt = _bare(cls)
        rt.precision_option = option
        it = iter(samples)

        def fire(_):
            return np.stack([next(it) for _ in range(3)])
        rt._adaptive_loop_batched(None if loop == "port"
                                  else jax.random.PRNGKey(0), 40, 3, fire)
        out.append(rt)
    p, j = out
    assert p.iterations == j.iterations > 3
    for f in ("VF_esperance", "stdev_VF", "Qsum", "p", "ray_counts",
              "progress"):
        np.testing.assert_array_equal(getattr(p, f), getattr(j, f))


@pytest.fixture(scope="module")
def holman():
    return _port_rtvf("holman", 20000, precision=0.02, generator=_gen(9))


def test_holman_cavity_matches_analytic(holman):
    np.testing.assert_allclose(holman.VF_esperance, HOLMAN_VF, atol=0.03)


def test_holman_cavity_rules(holman):
    """tests/test_thermal.py's rules: summation, reciprocity A_i F_ij =
    A_j F_ji, the analytic areas."""
    vf, areas = holman.VF_esperance, holman.areas
    np.testing.assert_allclose(vf.sum(axis=1), 1.0, atol=0.02)
    AF = vf * areas[:, None]
    np.testing.assert_allclose(AF, AF.T, atol=0.02 * AF.max())
    np.testing.assert_allclose(areas[0], np.pi * R ** 2, rtol=1e-12)
    np.testing.assert_allclose(areas[1], 2 * np.pi * R * R, rtol=1e-12)
    assert 3 <= holman.iterations < 200


def test_binned_holman_cavity():
    """tests/test_fonar.py on the port: the binned scheme of the same
    cavity reproduces the analytic view factors."""
    rt = pvf.FONaR_RTVF(pvf.build_two_n_cavity(*CAVITIES["holman"][:4]),
                        HOLMAN_SCHEME, HOLMAN_AREAS, num_rays=20000,
                        precision=0.02, rays_in=HOLMAN_RAYS_IN,
                        generator=_gen(10), **F64)
    np.testing.assert_allclose(rt.VF_esperance, HOLMAN_VF, atol=0.035)
    np.testing.assert_allclose(rt.VF_esperance.sum(axis=1), 1.0, atol=0.02)


def test_four_parameters_cavity_wrapper():
    """tests/test_view_factors.py:6-15 on the port."""
    rt = pvf.FourParametersCavityRTVF(0.01, 0.01, 0.015, 0.01, 2, 2,
                                      num_rays=4000, precision=0.05,
                                      generator=_gen(0), **F64)
    assert rt.VF_esperance.shape[0] == 1 + 2 + 2
    np.testing.assert_allclose(rt.VF_esperance.sum(axis=1), 1.0, atol=0.03)


def test_zero_depth_flat_step_cavity():
    """tests/test_view_factors.py:18-39 on the port: finite view factors
    with a zero-depth step, and a multi-element step refused."""
    with pytest.raises(ValueError, match="zero-depth"):
        pvf.TwoNParametersCavityRTVF(1.0, [2.0, 2.0], [0.0, 1.0], 0.5,
                                     [2, 2], 2, num_rays=500, max_iters=2,
                                     **F64)
    rt = _port_rtvf("step", 1500, precision=0.05, max_iters=12,
                    generator=_gen(5))
    assert np.isfinite(rt.VF_esperance).all()
    np.testing.assert_allclose(rt.VF_esperance.sum(axis=1), 1.0, atol=0.1)


def test_per_element_loop_and_gray_fallback(caplog):
    """The per-element engine loop (batched=False) on the Holman cavity
    keeps the summation rule; gray walls send the batched class to it
    with tracer_tpu's warning."""
    rt = _port_rtvf("holman", 4000, precision=0.05, max_iters=6,
                    batched=False, generator=_gen(11))
    np.testing.assert_allclose(rt.VF_esperance.sum(axis=1), 1.0, atol=0.05)
    np.testing.assert_allclose(rt.VF_esperance, HOLMAN_VF, atol=0.06)
    import tracer_tpu_torch.materials as M
    gray = pvf.build_two_n_cavity(*CAVITIES["holman"][:4],
                                  optics=lambda: M.lambertian(0.5))
    with caplog.at_level(logging.WARNING, logger="tracer_tpu_torch"):
        rt = pvf.BinnedAxisymmetricRTVF(
            gray, HOLMAN_SCHEME, HOLMAN_AREAS, num_rays=500,
            rays_in=HOLMAN_RAYS_IN, max_iters=1, generator=_gen(12), **F64)
    assert any("absorptivity < 1" in r.message for r in caplog.records)
    assert rt.iterations == 1 and np.isfinite(rt.VF_esperance).all()


def _holman_bc():
    areas = np.array([np.pi * 1e-4] + [2 * np.pi * 1e-4] * 3
                     + [np.pi * 1e-4])
    eps = np.array([1.0, 0.6, 0.6, 0.6, 0.6])
    T = np.array([293.15, 1273.15, 1273.15, 1273.15, 1273.15])
    return areas, eps, T


def test_radiosity_equals_tracer_tpu():
    """radiosity_rtvf on tests/test_thermal.py's Holman case and its
    flux-BC case, every output to 1e-12; the Holman balance."""
    areas, eps, T = _holman_bc()
    cases = [((HOLMAN_VF, areas, eps), dict(T=T)),
             ((np.array([[0.0, 1.0], [1.0, 0.0]]), np.ones(2),
               np.array([0.8, 0.8])),
              dict(T=np.array([500.0, np.nan]),
                   inc_radiation=np.array([np.nan, 1000.0]))),
             ((HOLMAN_VF, areas, eps),
              dict(T=np.where(np.arange(5) == 2, np.nan, T),
                   inc_radiation=np.where(np.arange(5) == 2, 5e4, np.nan),
                   q_net=np.array([np.nan, 100.0, np.nan, np.nan,
                                   np.nan])))]
    for args, kw in cases:
        got = prad.radiosity_rtvf(*args, **kw)
        want = jrad.radiosity_rtvf(*args, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12)
    Q = prad.radiosity_rtvf(HOLMAN_VF, areas, eps, T=T)[-1]
    np.testing.assert_allclose(Q.sum(), 0.0, atol=1e-8 * np.abs(Q).max())
    assert Q[0] < 0.0 and (Q[1:] > 0.0).all()
    with pytest.raises(ValueError, match="no boundary condition"):
        prad.radiosity_rtvf(HOLMAN_VF, areas, eps)


def test_radiosity_torch_values_and_gradients_equal_jax():
    """radiosity_rtvf_torch against radiosity_rtvf_jax on mixed boundary
    conditions (one flux element, a black one, an enforced q_net): every
    output equal to 1e-9, and the gradient of the summed aperture loss
    and wall temperatures with respect to VF, eps, T and the incident
    flux equal to 1e-9 under jax.grad."""
    areas, eps, T = _holman_bc()
    has_T = np.array([True, True, False, True, True])
    inc = np.where(has_T, np.nan, 4e4)
    T = np.where(has_T, T, np.nan)
    q_net = (np.array([0.0, 50.0, 0.0, 0.0, 0.0]),
             np.array([False, True, False, False, False]))

    def loss_of(out):
        J, E, T_out, q, Q = out
        return Q[0] + 1e-3 * T_out.sum() + 1e-6 * J.sum()

    vals = (HOLMAN_VF, eps, np.nan_to_num(T), np.nan_to_num(inc))
    jout = jrad.radiosity_rtvf_jax(HOLMAN_VF, areas, eps, T, inc, has_T,
                                   q_net=q_net)
    tout = prad.radiosity_rtvf_torch(HOLMAN_VF, areas, eps, T, inc, has_T,
                                     q_net=q_net, device="cpu")
    for g, w in zip(tout, jout):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9)
    jgrad = jax.grad(lambda vf, e, t, i: loss_of(jrad.radiosity_rtvf_jax(
        vf, areas, e, t, i, has_T, q_net=q_net)),
        argnums=(0, 1, 2, 3))(*(jnp.asarray(v) for v in vals))
    tv = [torch.tensor(v, requires_grad=True) for v in vals]
    loss_of(prad.radiosity_rtvf_torch(tv[0], areas, tv[1], tv[2], tv[3],
                                      has_T, q_net=q_net)).backward()
    for t, g in zip(tv, jgrad):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-9,
                                   atol=1e-9 * np.abs(np.asarray(g)).max())


def test_two_n_cavity_energy_balance():
    """tests/models/test_model_zoo.py:66-89 on the port, in float64: the
    view factors' summation rule, the solar input binned to the elements,
    the aperture's loss and the blackbody bound."""
    from tracer_tpu_torch.engine import TracerEngine
    from tracer_tpu_torch.models.two_n_cavity import TwoNParamCav
    from tracer_tpu_torch.sources import solar_disk_bundle
    cav = TwoNParamCav(apertureRadius=0.3, frustaRadii=[0.5, 0.5],
                       frustaDepths=[0.4, 0.6], coneDepth=0.3,
                       eps_wall=0.87, el_FRUs=[1, 1], el_CON=1)
    cav.VF_sim(num_rays=10000, precision=0.02, generator=_gen(5), **F64)
    np.testing.assert_allclose(cav.VF.sum(axis=1), 1.0, atol=0.03)
    eng = TracerEngine(cav, **F64)
    sun = solar_disk_bundle(_gen(6), 20000, center=[0, 0, 0.01],
                            direction=[0, 0, 1.0], radius=0.29,
                            ang_range=0.05, flux=5e5, **F64)
    res = eng.ray_tracer(sun, reps=30, generator=_gen(7))
    out = cav.energy_balance(res, T_init=900.0)
    solar_in = out["solar_in"]
    assert solar_in[1:].sum() > 0.8 * float(sun.energy.sum())
    assert out["Q"][0] < 0 and out["emissive_losses"] > 0
    sigma = 5.6677e-8
    assert out["emissive_losses"] < sigma * 900 ** 4 * np.pi * 0.3 ** 2 * 1.5
    # a temperature model that cools the walls by their net input
    calls = []

    def model(net):
        calls.append(net)
        return 800.0 + 0.0 * net
    out2 = cav.energy_balance(res, temperature_model=model, T_init=900.0)
    assert len(calls) == 2 and (out2["T"][1:] == 800.0).all()
    assert out2["emissive_losses"] < out["emissive_losses"]


# a cavity whose frusta are sliced and whose cone is ringed, so every
# branch of the binning holds elements
CAV_2N = dict(apertureRadius=0.3, frustaRadii=[0.4, 0.5],
              frustaDepths=[0.3, 0.4], coneDepth=0.3, eps_wall=0.87,
              el_FRUs=[2, 3], el_CON=2)


@pytest.fixture(scope="module")
def two_n_cavities():
    """Both packages' TwoNParamCav on CAV_2N with the port's float64 view
    factors and areas, and the port's sun bundle."""
    from tracer_tpu.models.two_n_cavity import TwoNParamCav as JaxCav
    from tracer_tpu_torch.models.two_n_cavity import TwoNParamCav
    from tracer_tpu_torch.sources import solar_disk_bundle
    cav, jcav = TwoNParamCav(**CAV_2N), JaxCav(**CAV_2N)
    cav.VF_sim(num_rays=4000, precision=0.05, generator=_gen(8), **F64)
    jcav.VF, jcav.areas = cav.VF.copy(), cav.areas.copy()
    sun = solar_disk_bundle(_gen(9), 4000, center=[0, 0, 0.01],
                            direction=[0, 0, 1.0], radius=0.29,
                            ang_range=0.6, flux=5e5, **F64)
    return cav, jcav, sun


def _as_numpy_result(res):
    """A TraceResult's meta and records as tracer_tpu's bin_hits reads
    them (numpy arrays)."""
    from types import SimpleNamespace
    return SimpleNamespace(meta=res.meta, records=[SimpleNamespace(
        **{f: getattr(r, f).numpy()
           for f in ("sid", "alive_in", "hit", "absorbed")})
        for r in res.records])


@pytest.mark.parametrize("with_model", [False, True])
def test_two_n_cavity_equals_tracer_tpu(two_n_cavities, with_model):
    """TwoNParamCav against tracer_tpu's, in float64. One bounce of the
    same sun rays through both packages' engines (no random draw before
    the first hit): bin_hits equal to 1e-9. Then the port's trace of
    every bounce (Lambertian walls, light leaving by the aperture) handed
    to both bin_hits, and both energy_balance on it with the same view
    factors and areas, without and with a temperature model: solar_in,
    T, q, Q and the emissive losses equal to 1e-9."""
    import tracer_tpu
    from tracer_tpu.engine import TracerEngine as JaxEngine
    from tracer_tpu_torch.engine import TracerEngine
    cav, jcav, sun = two_n_cavities
    one = TracerEngine(cav, **F64).ray_tracer(sun, reps=1,
                                              generator=_gen(10))
    jone = JaxEngine(jcav).ray_tracer(tracer_tpu.RayBundle.create(
        **{f: np.asarray(getattr(sun, f)) for f in ("pos", "dir",
                                                    "energy")}), reps=1)
    got, want = cav.bin_hits(one), jcav.bin_hits(jone)
    assert (got[1:] > 0).all() and got.sum() > 0.5 * float(sun.energy.sum())
    np.testing.assert_allclose(got, want, rtol=1e-9,
                               atol=1e-9 * want.max())

    res = TracerEngine(cav, **F64).ray_tracer(sun, reps=30,
                                              generator=_gen(11))
    jres = _as_numpy_result(res)
    assert len(res.records) > 3 and cav.bin_hits(res)[0] > 0
    kw = dict(T_init=900.0)
    if with_model:
        kw["temperature_model"] = lambda net: 600.0 + 2e-3 * net
    out, jout = cav.energy_balance(res, **kw), jcav.energy_balance(jres, **kw)
    for k in ("solar_in", "T", "q", "Q", "emissive_losses"):
        w = np.asarray(jout[k])
        np.testing.assert_allclose(out[k], w, rtol=1e-9,
                                   atol=1e-9 * np.abs(w).max(), err_msg=k)
    if with_model:
        assert not np.allclose(out["T"][1:], 900.0)
