"""The port's utilities against tracer_tpu's on the CPU:

* sampling: the densities and CDFs of every distribution (``__call__``,
  ``pdf``, ``cdf``, ``f``, ``pdf_cos``, ``pdf_cossin``, the bilinear
  density, Henyey-Greenstein, the BDRF's DHR and its inverse tables and
  lookups) equal to tracer_tpu's to 1e-12 in float64, on NumPy input and
  on tensors; samples held statistically (torch's streams are not
  jax.random's), as tests/test_utils.py holds tracer_tpu's;
* io_utils: CSV histograms, binary sources and the SolTrace, Tonatiuh and
  Solstice importers, with the files one package writes read by the
  other, and VTK -> STL;
* compat: every base name and accountant token tracer_tpu's compat
  resolves, built through both packages, gives equal OpticsSpecs, and the
  same parameters are refused;
* RayBundle.inherit, select, compact_host and pad_to against tracer_tpu's;
* vector_utils and mathutils.transform_points / transform_dirs;
* viz.render: Renderer saves a PNG of the port's MiniDish and draws each
  row at its own frame; scene_tree; mesh_from_edges against tracer_tpu's.
"""
import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import compat as jax_compat
from tracer_tpu import io_utils as jax_io
from tracer_tpu import mathutils as jax_mu
from tracer_tpu import sampling as jax_sampling
from tracer_tpu import vector_utils as jax_vu
from tracer_tpu.bundle import RayBundle as JaxBundle
from tracer_tpu_torch import compat, io_utils, mathutils, sampling
from tracer_tpu_torch import vector_utils as vu
from tracer_tpu_torch.bundle import RayBundle

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = "cpu"


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _both(fn, x):
    """fn on NumPy float64 input and on a float64 tensor, each as NumPy."""
    t = fn(torch.as_tensor(x, dtype=torch.float64))
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float64
    return np.asarray(fn(np.asarray(x, dtype=float))), t.numpy()


# --------------------------------------------------------------- sampling

PW_XS = np.array([0.0, 1.0, 2.0, 3.0])
PW_YS = np.array([0.0, 2.0, 1.0, 3.0])
PROBE = np.array([-0.5, 0.0, 0.3, 1.0, 1.7, 2.5, 3.0, 3.4])


def test_pw_linear_density_and_cdf_match_jax():
    d = sampling.PWLinearDistribution(PW_XS, PW_YS)
    j = jax_sampling.PWLinearDistribution(PW_XS, PW_YS)
    np.testing.assert_array_equal(d.cdf_def, j.cdf_def)
    np.testing.assert_array_equal(d._inv, np.asarray(j._inv))
    for name in ("__call__", "pdf", "cdf", "PDF", "CDF"):
        want = np.asarray(getattr(j, name)(PROBE))
        for got in _both(getattr(d, name), PROBE):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15,
                                       err_msg=name)
    assert d.cdf(3.0) == pytest.approx(1.0, abs=1e-12)
    assert d.cdf(0.0) == pytest.approx(0.0, abs=1e-12)


def test_pw_linear_sampling_matches_pdf():
    """tests/test_utils.py:20's histogram check on the port's draws."""
    d = sampling.PWLinearDistribution(PW_XS, PW_YS)
    x, w = d.sample(_gen(0), 200_000, device=CPU)
    assert x.dtype == torch.float32 and torch.equal(w, torch.ones_like(w))
    hist, edges = np.histogram(x.numpy(), bins=60, range=(0, 3),
                               density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    np.testing.assert_allclose(hist, d.pdf(centers), atol=0.03)


@pytest.mark.parametrize("cls,fname,pname", [
    ("PWLinCosDistribution", "integ_cos", "pdf_cos"),
    ("PWLinCosSinDistribution", "integ_cs", "pdf_cossin")])
def test_pw_weighted_densities_match_jax(cls, fname, pname):
    xs = np.array([0.0, 0.4, 0.9, 1.4])
    ys = np.array([1.0, 2.0, 1.5, 3.0])
    d = getattr(sampling, cls)(xs, ys)
    j = getattr(jax_sampling, cls)(xs, ys)
    np.testing.assert_allclose(getattr(d, fname), getattr(j, fname),
                               rtol=1e-12)
    probe = np.linspace(-0.1, 1.5, 33)
    for name in ("f", pname, "pdf", "cdf"):
        want = np.asarray(getattr(j, name)(probe))
        for got in _both(getattr(d, name), probe):
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15,
                                       err_msg=name)


def test_lincossin_integral_exact():
    """tests/test_utils.py:536 on the port: the per-segment integrals
    against quadrature."""
    from scipy.integrate import quad
    xs = np.array([0.0, 0.4, 0.9, 1.4])
    ys = np.array([1.0, 2.0, 1.5, 3.0])
    d = sampling.PWLinCosSinDistribution(xs, ys)
    f = lambda x: np.interp(x, xs, ys) * np.cos(x) * np.sin(x)  # noqa
    for i in range(3):
        np.testing.assert_allclose(d.integ_cs[i], quad(f, xs[i], xs[i + 1])[0],
                                   atol=1e-10)
    np.testing.assert_allclose(d.pdf_cossin(0.65),
                               f(0.65) / quad(f, 0, 1.4)[0], rtol=1e-9)


def _weighted_mean_sigma(v, w):
    """Weighted mean of v and its standard error (ratio estimator)."""
    v, w = np.asarray(v, dtype=float), np.asarray(w, dtype=float)
    m = (v * w).sum() / w.sum()
    n = len(v)
    return m, math.sqrt(((w * (v - m)) ** 2).sum() * n / (n - 1)) / w.sum()


def test_pw_lincossin_weights():
    """The cos-weighted mean under the cos sin density is 2/3: within 3
    sigma of its estimate (tests/test_utils.py:34)."""
    xs = np.linspace(0.0, np.pi / 2, 20)
    d = sampling.PWLinCosSinDistribution(xs, np.ones_like(xs))
    x, w = d.sample(_gen(1), 50_000, dtype=torch.float64, device=CPU)
    assert float(w.mean()) == pytest.approx(1.0, rel=1e-12)
    m, s = _weighted_mean_sigma(np.cos(x.numpy()), w.numpy())
    assert abs(m - 2.0 / 3.0) < 3 * s + 1e-3, (m, s)


def test_pw_lincos_weights_and_importance_sampling():
    """PWLinCosDistribution's weighted mean of x against the density's
    quadrature mean within 3 sigma, and pw_linear_importance_sampling's
    weights finite with mean 1 (tests/test_utils.py:45)."""
    xs = np.linspace(0.0, np.pi / 2 - 0.05, 16)
    ys = 1.0 + 0.3 * xs
    d = sampling.PWLinCosDistribution(xs, ys)
    x, w = d.sample(_gen(5), 50_000, dtype=torch.float64, device=CPU)
    xf = np.linspace(xs[0], xs[-1], 20001)
    fx = np.interp(xf, xs, ys) * np.cos(xf)
    want = np.trapezoid(xf * fx, xf) / np.trapezoid(fx, xf)
    m, s = _weighted_mean_sigma(x.numpy(), w.numpy())
    assert abs(m - want) < 3 * s + 1e-4, (m, want, s)
    xi, wi = sampling.pw_linear_importance_sampling(d, _gen(7), 20_000,
                                                    device=CPU)
    assert bool(torch.isfinite(wi).all())
    assert float(wi.double().mean()) == pytest.approx(1.0, rel=1e-5)


def _bilinear(pkg):
    xu = np.linspace(0.0, 1.0, 8)
    yu = np.linspace(0.0, 2.0, 9)
    zs = 1.0 + np.add.outer(np.sin(xu), np.cos(yu)) ** 2
    return pkg.PWBilinearDistribution(xu, yu, zs)


def test_pw_bilinear_matches_jax():
    d, j = _bilinear(sampling), _bilinear(jax_sampling)
    np.testing.assert_allclose(d._y_inv, np.asarray(j._y_inv), rtol=1e-12)
    xq = np.array([0.0, 0.3, 0.5, 0.85, 1.0])
    yq = np.array([0.0, 0.7, 1.1, 1.9, 2.0])
    for name in ("__call__", "pdf"):
        want = getattr(j, name)(xq, yq)
        got = getattr(d, name)(xq, yq)
        np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=name)
        got_t = getattr(d, name)(torch.tensor(xq), torch.tensor(yq))
        np.testing.assert_allclose(got_t.numpy(), want, rtol=1e-12)
        for k in range(len(xq)):
            assert getattr(d, name)(float(xq[k]), float(yq[k])) == \
                pytest.approx(want[k], rel=1e-12)


def test_pw_bilinear_sampling_marginal_mean():
    """The weighted mean of x against the marginal's mean, within 3 sigma
    (tests/test_utils.py:61 holds it to 0.01)."""
    zb = np.outer(1.0 + 0.5 * np.linspace(0, 1, 8),
                  2.0 - np.linspace(0, 1, 9))
    db = sampling.PWBilinearDistribution(np.linspace(0, 1, 8),
                                         np.linspace(0, 2, 9), zb)
    x, y, w = db.sample(_gen(6), 50_000, dtype=torch.float64, device=CPU)
    assert bool(torch.isfinite(w).all()) and bool((y >= 0).all())
    xs_f = np.linspace(0, 1, 2001)
    mean_ref = np.trapezoid(xs_f * db.dist_x.pdf(xs_f), xs_f)
    m, s = _weighted_mean_sigma(x.numpy(), w.numpy())
    assert abs(m - mean_ref) < 3 * s + 1e-4, (m, mean_ref, s)


def test_henyey_greenstein_matches_jax():
    th = np.linspace(0.0, np.pi, 17)
    for g in (0.0, 0.6, -0.3):
        want = np.asarray(jax_sampling.HenyeyGreenstein(g)(th))
        got_n = sampling.HenyeyGreenstein(g)(th)
        got_t = sampling.HenyeyGreenstein(g)(torch.tensor(th)).numpy()
        np.testing.assert_allclose(got_n, want, rtol=1e-12)
        np.testing.assert_allclose(got_t, want, rtol=1e-12)
    hg = sampling.HenyeyGreenstein(0.6)
    t, phi = hg.sample(_gen(2), 200_000, dtype=torch.float64, device=CPU)
    c = np.cos(t.numpy())
    assert abs(c.mean() - 0.6) < 3 * c.std() / math.sqrt(len(c))
    assert 0.0 <= float(phi.min()) and float(phi.max()) < 2 * np.pi


def test_bdrf_tables_and_lookups_match_jax():
    """The host tables (theta_r and phi inverse CDFs, DHR), DHR between
    incidence rows and the _bilerp / _trilerp lookups equal tracer_tpu's
    to 1e-12 in float64."""
    th = np.linspace(0, np.pi / 2, 16)
    ph = np.linspace(0, 2 * np.pi, 33)
    ti = np.array([0.0, 0.7, np.pi / 2])
    b = np.stack([np.ones((16, 33)), 0.5 + np.outer(np.cos(th), np.ones(33)),
                  0.2 + np.cos(ph / 2.0)[None, :] ** 2 + 0 * th[:, None]])
    d = sampling.BDRFDistribution(th, ph, b, thetas_i=ti)
    j = jax_sampling.BDRFDistribution(th, ph, b, thetas_i=ti)
    for name in ("_thr_inv", "_phi_inv", "_dhr"):
        np.testing.assert_allclose(getattr(d, name),
                                   np.asarray(getattr(j, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    probe = np.array([0.0, 0.2, 0.7, 1.0, np.pi / 2, 2.0])
    want = np.asarray(j.dhr(probe))
    np.testing.assert_allclose(d.dhr(probe), want, rtol=1e-12)
    np.testing.assert_allclose(d.dhr(torch.tensor(probe)).numpy(), want,
                               rtol=1e-12)
    rng = np.random.default_rng(3)
    fi, fj, fk = (rng.uniform(-0.5, n + 0.5, 200) for n in (2, 15, 256))
    np.testing.assert_allclose(
        sampling._bilerp(torch.tensor(d._thr_inv), torch.tensor(fi),
                         torch.tensor(fk)).numpy(),
        np.asarray(jax_sampling._bilerp(jnp.asarray(j._thr_inv),
                                        jnp.asarray(fi), jnp.asarray(fk))),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        sampling._trilerp(torch.tensor(d._phi_inv), torch.tensor(fi),
                          torch.tensor(fj), torch.tensor(fk)).numpy(),
        np.asarray(jax_sampling._trilerp(jnp.asarray(j._phi_inv),
                                         jnp.asarray(fi), jnp.asarray(fj),
                                         jnp.asarray(fk))),
        rtol=1e-12, atol=1e-14)


def test_bdrf_distribution_lambertian():
    """tests/test_utils.py:389 on the port: DHR = rho, the mean cos 2/3
    and phi uniform, within 3 sigma of the draws."""
    rho = 0.8
    th = np.linspace(0, np.pi / 2, 46)
    ph = np.linspace(0, 2 * np.pi, 37)
    d = sampling.BDRFDistribution(th, ph, np.full((46, 37), rho / np.pi))
    np.testing.assert_allclose(float(d.dhr(0.3)), rho, rtol=2e-3)
    t, p = d.sample(_gen(0), ns=100_000, dtype=torch.float64, device=CPU)
    c, p = np.cos(t.numpy()), p.numpy()
    n = len(c)
    # the table's discretisation shifts the moments by ~1e-3
    assert abs(c.mean() - 2.0 / 3.0) < 3 * c.std() / math.sqrt(n) + 2e-3
    assert abs(p.mean() - np.pi) < 3 * p.std() / math.sqrt(n) + 1e-2
    h = np.histogram(p, bins=12, range=(0, 2 * np.pi))[0]
    assert h.min() > 0.8 * h.mean()


def test_bdrf_distribution_incidence_dependent():
    """tests/test_utils.py:404 on the port: at grazing incidence the phi
    lobe's forward share within 3 sigma of the analytic one, uniform at
    normal incidence."""
    th = np.linspace(0, np.pi / 2, 16)
    ph = np.linspace(0, 2 * np.pi, 33)
    b = np.zeros((2, 16, 33))
    b[0] = 1.0
    b[1] = 0.2 + np.cos(ph / 2.0)[None, :] ** 2
    d = sampling.BDRFDistribution(th, ph, b,
                                  thetas_i=np.array([0.0, np.pi / 2]))
    mid = float(d.dhr(np.pi / 4))
    np.testing.assert_allclose(mid, 0.5 * (d.dhr(0.0) + d.dhr(np.pi / 2)),
                               rtol=1e-6)
    n = 50_000
    for theta_i, want in ((np.pi / 2, (0.7 * np.pi + 1.0) / (1.4 * np.pi)),
                          (0.0, 0.5)):
        _, p = d.sample(_gen(1), theta_i=torch.full((n,), theta_i,
                                                    dtype=torch.float64),
                        dtype=torch.float64, device=CPU)
        p = p.numpy()
        share = ((p < np.pi / 2) | (p > 3 * np.pi / 2)).mean()
        # the 33-node table's trapezoids shift the share by < 5e-3
        assert abs(share - want) < 3 * math.sqrt(want * (1 - want) / n) \
            + 5e-3, (theta_i, share, want)


def test_shape_samplers_and_sampler_devices():
    """The new samplers give tensors on the device asked for and raise
    without a GPU when none is given (device None means the GPU)."""
    d = sampling.PWLinCosDistribution(np.linspace(0, 1, 5), np.ones(5))
    x, w = d.sample(_gen(0), 10, device=CPU)
    assert x.device.type == "cpu" and w.shape == (10,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            sampling.HenyeyGreenstein(0.3).sample(_gen(0), 10)


# ------------------------------------------------------------------- io

def _hist(ndim):
    if ndim == 2:
        return (np.arange(12, dtype=float).reshape(3, 4),
                (np.linspace(0, 1, 4), np.linspace(0, 2, 5)), ("x", "y"))
    return np.arange(5, dtype=float) * 0.5, np.linspace(0, 1, 6), "x"


@pytest.mark.parametrize("ndim", (1, 2))
@pytest.mark.parametrize("writer", ("port", "jax"))
def test_hist_csv_across_packages(tmp_path, ndim, writer):
    """A CSV histogram written by one package reads back equal through
    both, and the two writers give the same bytes."""
    hist, bins, labels = _hist(ndim)
    w = io_utils if writer == "port" else jax_io
    p = os.path.join(tmp_path, "h.csv")
    w.save_hist_data_csv(hist, bins, "flux", labels, "test run", p)
    q = os.path.join(tmp_path, "h2.csv")
    (jax_io if writer == "port" else io_utils).save_hist_data_csv(
        hist, bins, "flux", labels, "test run", q)
    assert open(p).read() == open(q).read()
    for r in (io_utils, jax_io):
        got, data, bl, dl, info = r.load_hist_data_csv(p)
        np.testing.assert_array_equal(data, hist)
        assert dl == "flux" and info == "test run"
        assert (tuple(bl) if ndim == 2 else bl) == labels
        for a, b in zip(got if ndim == 2 else [got],
                        bins if ndim == 2 else [bins]):
            np.testing.assert_array_equal(a, b)


def test_binary_source_across_packages(tmp_path):
    """tests/test_io_viz_compat.py:26 across packages: a source file
    written by tracer_tpu loads in the port (and as a port RayBundle on
    the CPU), rescaling and push-back give the same bytes."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(50, 3))
    d = rng.normal(size=(50, 3))
    e = rng.uniform(1, 2, size=50)
    p, q = (os.path.join(tmp_path, n) for n in ("jax_src", "port_src"))
    jax_io.binarize_source(p, v.T, d.T, e)
    io_utils.binarize_source(q, v, d, e)     # (n, 3): transposed inside
    assert open(p, "rb").read() == open(q, "rb").read()
    v2, d2, e2 = io_utils.load_source(p)
    np.testing.assert_array_equal(v2, v)
    np.testing.assert_array_equal(d2, d)
    np.testing.assert_array_equal(e2, e)
    b = io_utils.source_to_bundle(p, dtype=torch.float64, device=CPU)
    assert isinstance(b, RayBundle) and b.num_rays == 50
    np.testing.assert_array_equal(b.pos.numpy(), v)
    np.testing.assert_array_equal(b.energy.numpy(), e)
    assert io_utils.source_to_bundle(p, device=CPU).pos.dtype == \
        torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            io_utils.source_to_bundle(p)
    for mod, path in ((jax_io, p), (io_utils, q)):
        mod.rescale_source_energy([path], 100.0)
        mod.push_back_rays(path, 2.0)
    assert open(p, "rb").read() == open(q, "rb").read()
    v3, _, e3 = jax_io.load_source(q)
    np.testing.assert_allclose(v3, v - 2.0 * d, rtol=1e-12)
    assert abs(e3.sum() - 100.0) < 1e-9
    vs, ds, es = io_utils.load_sources([p, q])
    assert len(vs) == 100 and abs(es.sum() - 200.0) < 1e-9


def _same_sources(a, b):
    assert len(a) == len(b) > 0
    for pa, pb in zip(a, b):
        assert os.path.basename(pa) == os.path.basename(pb)
        assert open(pa, "rb").read() == open(pb, "rb").read()


def test_soltrace_import_across_packages(tmp_path):
    """tests/test_io_viz_compat.py:48's SolTrace dump imported by both
    packages: the same source files, byte for byte, with every kept ray
    and the power of each file."""
    rows = np.zeros((45, 8))
    rows[:, :3] = np.random.default_rng(1).normal(size=(45, 3))
    rows[:, 5] = -1.0
    rows[:, 6] = -1
    rows[:, 7] = 2
    rows[40:, 7] = 1            # another stage: dropped
    f = os.path.join(tmp_path, "st.csv")
    np.savetxt(f, rows, delimiter=",", header="soltrace")
    outs = [mod.import_soltrace([f], total_power=1000.0, rays_per_source=20,
                                target_dir=os.path.join(tmp_path, name))
            for mod, name in ((io_utils, "port"), (jax_io, "jax"))]
    _same_sources(*outs)
    v, d, e = io_utils.load_sources(outs[0])
    assert len(outs[0]) == 2 and len(v) == 40
    assert abs(e.sum() - 2000.0) < 1e-6


def test_tonatiuh_and_solstice_import_across_packages(tmp_path):
    """A Tonatiuh photon dump (6 doubles a ray, Y-up) and a Solstice
    solpaths VTK file import to the same source files through both
    packages; vtk_to_stl writes the same STL, which both load."""
    rng = np.random.default_rng(2)
    ton = os.path.join(tmp_path, "photons.dat")
    rng.normal(size=6 * 30).tofile(ton)
    outs = [mod.import_tonatiuh([ton], 500.0, 16,
                                os.path.join(tmp_path, "ton_" + name))
            for mod, name in ((io_utils, "port"), (jax_io, "jax"))]
    _same_sources(*outs)
    v, d, _ = io_utils.load_sources(outs[0])
    X = np.fromfile(ton)
    np.testing.assert_array_equal(v[:, 0], X[3::6])
    np.testing.assert_array_equal(d[:, 2], -X[1::6])

    res = os.path.join(tmp_path, "solstice")
    os.makedirs(res)
    pts = rng.normal(size=(12, 3))
    with open(os.path.join(res, "solpaths.vtk"), "w") as f:
        f.write("# vtk DataFile Version 2.0\nsolpaths\nASCII\n"
                "DATASET POLYDATA\nPOINTS 12 float\n")
        for p in pts:
            f.write(" ".join(repr(float(c)) for c in p) + "\n")
        f.write("LINES 4 16\n")
        for k in range(4):
            f.write(f"3 {3 * k} {3 * k + 1} {3 * k + 2}\n")
    for option in ("S", "E"):
        outs = [mod.import_solstice(res, 100.0, 3,
                                    os.path.join(tmp_path, name + option),
                                    option=option)
                for mod, name in ((io_utils, "sp"), (jax_io, "sj"))]
        _same_sources(*outs)
    vtk = os.path.join(tmp_path, "quads.vtk")
    with open(vtk, "w") as f:
        f.write("# vtk DataFile Version 2.0\nq\nASCII\nDATASET POLYDATA\n"
                "POINTS 6 float\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n2 0 0\n2 1 0\n"
                "POLYGONS 2 10\n4 0 1 2 3\n4 1 4 5 2\n")
    a, b = (os.path.join(tmp_path, n) for n in ("a.stl", "b.stl"))
    io_utils.vtk_to_stl(vtk, a)
    jax_io.vtk_to_stl(vtk, b)
    assert open(a, "rb").read() == open(b, "rb").read()
    verts, faces = ptt.stl_utils.load_stl(a)
    assert len(faces) == 4 and len(verts) == 6


def test_write_chunks_keeps_all_rays(tmp_path):
    """tests/test_utils.py:591 on the port."""
    rng = np.random.default_rng(0)
    pos = rng.normal(size=(249, 3))
    dirs = rng.normal(size=(249, 3))
    paths = io_utils._write_chunks(pos, dirs, 1000.0, 100, str(tmp_path))
    assert len(paths) == 3
    n_tot = 0
    for p in paths:
        v, d, e = io_utils.load_source(p)
        n_tot += len(e)
        np.testing.assert_allclose(e.sum(), 1000.0, rtol=1e-12)
    assert n_tot == 249


# ---------------------------------------------------------------- compat

# one call of every base factory of tracer_tpu's compat, each package's
# materials passed where a factory takes one
def _compat_args(pkg):
    M = pkg.materials
    return {
        "OneSidedRealReflective": ((0.1, 1e-3, True), {}),
        "OneSidedReflective": ((0.2,), {}),
        "RealReflective_IAM": ((0.1, 2e-3, 0.16), dict(c=1.5)),
        "RealReflective": ((0.05, 1e-3, False), {}),
        "ReflectiveSpectral": (([0.1, 0.2, 0.3], [400e-9, 600e-9, 900e-9]),
                               {}),
        "Reflective_spectral": (([0.4, 0.2], [400e-9, 900e-9]), {}),
        "Reflective_IAM": ((0.1, 0.16), {}),
        "Reflective": ((0.3,), {}),
        "BDRF_Cook_Torrance_isotropic": ((0.3, 1.5, 2.0), dict(R_Lam=0.5)),
        "Lambertian_piecewise_Specular_directional_axisymmetric_piecewise":
            (([0.0, 0.5, 1.5], [0.9, 0.8, 0.5], [0.1, 0.2, 0.4]), {}),
        "LambertianSpecular_directional_axisymmetric_piecewise":
            (([0.0, 0.5, 1.5], [0.9, 0.8, 0.5]), dict(specularity=0.3)),
        "Lambertian_directional_axisymmetric_piecewise_spectral":
            (([0.0, 1.5], [[0.9, 0.8], [0.7, 0.6]], [400e-9, 900e-9]), {}),
        "Lambertian_directional_axisymmetric_piecewise_Polychromatic":
            (([0.0, 1.5], [[0.9, 0.8], [0.7, 0.6]], [400e-9, 900e-9]), {}),
        "Lambertian_directional_axisymmetric_piecewise":
            (([0.0, 0.5, 1.5], [0.9, 0.8, 0.5]), {}),
        "LambertianSpecular": ((0.1, 0.6), {}),
        "LambertianSpecular_IAM": ((0.1, 0.6, 0.2), {}),
        "Lambertian_IAM": ((0.1, 0.16), dict(c=2.0)),
        "LambertianAbsorbant": ((0.3,), dict(ang_range=1.2)),
        "SemiLambertian": ((0.2,), dict(angular_range=1.0)),
        "Lambertian": ((0.25, 1.3), {}),
        "RefractiveTransmissiveHomogenous": ((1.0, 1.5, [0.0, 0.3]), {}),
        "RefractiveAbsorbantHomogenous": ((1.0, 1.5, 0.0, 0.4), {}),
        "RefractiveScatteringHomogenous": ((1.0, 1.5, 0.0, 0.5, 0.0, 0.8),
                                           {}),
        "RefractiveHomogenous": ((1.0, 1.33), dict(single_ray=False)),
        "FresnelConductorHomogenous": ((1.0, complex(0.2, 3.5)), {}),
        "Absorbant": ((0.3,), dict(n=1.2)),
        "Scattering": ((0.5, 0.7), dict(n=1.1)),
        "ScatteringAbsorbantPeriodicBoundary": ((1.0, 0.5, 0.9, 0.2), {}),
        "ScatteringPeriodicBoundary": ((1.0, 0.5, 0.9), {}),
        "AbsorbantPeriodicBoundary": ((1.0, 0.3), {}),
        "RefractiveScatteringAbsorbant": ((1.0, 1.52, 0.0, 0.5, 0.0, 0.9,
                                           0.0, 0.2), {}),
        "RefractiveScattering": ((1.0, 1.52, 0.1, 0.5, 0.2, 0.9), {}),
        "Refractive": ((1.0, 1.52), {}),
        "RefractiveAbsorbant": ((1.0, 1.52, 0.0, 0.25), {}),
        "PeriodicBoundary": ((2.0,), {}),
        "Transparent": ((), {}),
        "BiFacial": ((M.reflective(0.1), M.transparent()), {}),
    }


def _spec_fields(spec):
    return (spec.kind, np.asarray(spec.params), spec.flags, spec.record,
            None if spec.spectral_table is None
            else np.asarray(spec.spectral_table), spec.ambient_medium)


def _assert_same_spec(got, want, name):
    for a, b in zip(_spec_fields(got), _spec_fields(want)):
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(np.asarray(a), b, err_msg=name)
        else:
            assert a == b, name


def test_compat_bases_and_tokens_equal_jax():
    assert list(compat._BASES) == list(jax_compat._BASES)
    assert compat._TOKENS == jax_compat._TOKENS
    assert set(_compat_args(ptt)) == set(jax_compat._BASES)
    _assert_same_spec(compat.perfect_mirror, jax_compat.perfect_mirror,
                      "perfect_mirror")


@pytest.mark.parametrize("base", sorted(jax_compat._BASES))
def test_compat_names_build_equal_specs(base):
    """Each base alone and with accountant tokens (one, two and every
    token) resolves in both packages to equal OpticsSpecs."""
    args, kw = _compat_args(ptt)[base]
    jargs, jkw = _compat_args(tracer_tpu)[base]
    toks = sorted(jax_compat._TOKENS)
    for suffix in ("", "Receiver", "Detector", "AbsorberLocation",
                   "".join(toks)):
        name = base + suffix
        got = compat._resolve(name)(*args, **kw)
        want = jax_compat._resolve(name)(*jargs, **jkw)
        assert isinstance(got, ptt.materials.OpticsSpec), name
        _assert_same_spec(got, want, name)
    assert getattr(compat, base + "Receiver").__name__ == base + "Receiver"


def test_compat_refuses_what_jax_refuses():
    for name, args, kw in (
            ("LambertianAbsorbant", (0.3,), dict(attenuation_coefficient=1.0)),
            ("Absorbant", (0.3,), dict(scaling=2.0)),
            ("ScatteringPeriodicBoundary", (1.0, 0.5, 0.9),
             dict(scaling=0.5))):
        for mod in (compat, jax_compat):
            with pytest.raises(NotImplementedError):
                getattr(mod, name)(*args, **kw)
    for mod in (compat, jax_compat):
        with pytest.raises(AttributeError):
            mod.NoSuchOptics
        with pytest.raises(AttributeError):
            mod._resolve("ReflectiveNoSuchToken")


# ----------------------------------------------------- bundles and vectors

def _bundles(n=12):
    rng = np.random.default_rng(4)
    pos, d = rng.normal(size=(n, 3)), rng.normal(size=(n, 3))
    e = rng.uniform(0.5, 2.0, n)
    alive = rng.uniform(size=n) > 0.3
    jb = JaxBundle.create(pos=pos, dir=d, energy=e, alive=alive,
                          wavelength=np.full(n, 5e-7))
    pb = RayBundle.create(pos=pos, dir=d, energy=e, alive=alive,
                          wavelength=5e-7, dtype=torch.float64, device=CPU)
    return jb, pb


def _assert_same_bundle(pb, jb):
    from tracer_tpu_torch.bundle import FIELDS
    assert pb.num_rays == jb.num_rays
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)


def test_bundle_select_compact_pad_inherit_match_jax():
    jb, pb = _bundles()
    mask = np.arange(12) % 3 != 0
    _assert_same_bundle(pb.select(torch.as_tensor(mask)),
                        jb.select(jnp.asarray(mask)))
    _assert_same_bundle(pb.select(mask).compact_host(),
                        jb.select(jnp.asarray(mask)).compact_host())
    _assert_same_bundle(pb.pad_to(20), jb.pad_to(20))
    assert pb.pad_to(12) is pb
    with pytest.raises(ValueError):
        pb.pad_to(5)
    with pytest.raises(ValueError):
        jb.pad_to(5)
    got = pb.inherit(energy=pb.energy * 2)
    _assert_same_bundle(got, jb.inherit(energy=jb.energy * 2))
    assert float(pb.pad_to(20).total_energy()) == pytest.approx(
        float(jb.total_energy()), rel=1e-15)


def test_bundle_pad_and_compact_keep_the_spectral_grid():
    _, pb = _bundles(6)
    grid = torch.linspace(4e-7, 8e-7, 4, dtype=torch.float64)
    poly = pb.with_spectra(grid, torch.ones((6, 4), dtype=torch.float64))
    padded = poly.pad_to(9)
    assert padded.spectra.shape == (9, 4)
    assert torch.equal(padded.spectral_grid, grid)
    assert not bool(padded.spectra[6:].any())
    live = poly.compact_host()
    assert live.num_rays == int(poly.alive.sum())
    assert live.spectra.shape == (live.num_rays, 4)
    assert torch.equal(live.spectral_grid, grid)


def test_vector_utils_match_jax():
    """tests/test_utils.py:252 on the port, and every function against
    tracer_tpu's to 1e-12."""
    assert vu.get_angle([1, 0, 0], [0, 1, 0]) == pytest.approx(np.pi / 2)
    np.testing.assert_allclose(vu.project_on_plane([[1.0, 1.0, 3.0]],
                                                   [0, 0, 1.0]),
                               [[1, 1, 0]], atol=1e-12)
    np.testing.assert_allclose(vu.aabb([[0, 0, 0], [1, 2, -1]]),
                               [[0, 0, -1], [1, 2, 0]])
    np.testing.assert_allclose(vu.rotate_z_to_normal([[0, 0, 1.0]],
                                                     [1.0, 0, 0]),
                               [[1, 0, 0]], atol=1e-12)
    assert vu.AABB is vu.aabb
    rng = np.random.default_rng(5)
    a, b = rng.normal(size=(20, 3)), rng.normal(size=(20, 3))
    n = b / np.linalg.norm(b, axis=1, keepdims=True)
    assert vu.get_angle(a[0], b[0]) == pytest.approx(
        jax_vu.get_angle(a[0], b[0]), rel=1e-12)
    for got, want in (
            (vu.get_angles(a, b), jax_vu.get_angles(a, b)),
            (vu.rotate_z_to_normal(a, n[0]),
             jax_vu.rotate_z_to_normal(a, n[0])),
            (vu.rotate_z_to_normal(a, n), jax_vu.rotate_z_to_normal(a, n)),
            (vu.project_on_plane(a, b[0], b[1]),
             jax_vu.project_on_plane(a, b[0], b[1])),
            (vu.aabb(a), jax_vu.aabb(a)),
            (vu.rotate_z_to_normal_t(torch.tensor(a), n[0]).numpy(),
             jax_vu.rotate_z_to_normal(a, n[0]))):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_transform_points_and_dirs_match_jax():
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(16, 3))
    one = ptt.spatial.generate_transform([0.3, -0.2, 0.9], 0.7, [1.0, 2, 3])
    many = np.stack([ptt.spatial.generate_transform(rng.normal(size=3),
                                                    rng.uniform(0, 3),
                                                    rng.normal(size=3))
                     for _ in range(16)])
    for frame in (one, many):
        for name in ("transform_points", "transform_dirs"):
            got = getattr(mathutils, name)(torch.tensor(frame),
                                           torch.tensor(pts))
            want = getattr(jax_mu, name)(jnp.asarray(frame),
                                         jnp.asarray(pts))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-12, atol=1e-14, err_msg=name)


# ------------------------------------------------------------------- viz

def _minidish(pkg):
    asm = pkg.models.tau_minidish.MiniDish(5.0, 6.25, 0.9, 6.95, 0.4, 0.7,
                                           0.9)
    asm.set_transform(pkg.spatial.rotx(-np.pi / 4))
    return asm


def test_renderer_saves_png(tmp_path):
    """tests/test_io_viz_compat.py:72 on the port's MiniDish: geometry,
    flux-textured receivers and 50 ray paths saved as a PNG;
    scene_tree names the dish."""
    import tracer_tpu_torch.models.tau_minidish  # noqa: F401
    from tracer_tpu_torch.sources import solar_disk_bundle
    from tracer_tpu_torch.viz.render import Renderer, scene_tree
    asm = _minidish(ptt)
    eng = ptt.engine.TracerEngine(asm, device=CPU)
    x = -1.0 / math.sqrt(2.0)
    sun = solar_disk_bundle(_gen(0), 500, center=[0, 7.0, 7.0],
                            direction=[0, x, x], radius=3.0,
                            ang_range=0.005, flux=1000.0, device=CPU)
    res = eng.ray_tracer(sun, reps=5)
    r = Renderer(eng)
    r.show_geom(fluxmap_from=res)
    r.show_rays(res, max_rays=50)
    out = os.path.join(tmp_path, "scene.png")
    r.save(out)
    assert os.path.getsize(out) > 10_000
    tree = scene_tree(asm)
    assert "Surface 'dish'" in tree and "Assembly" in tree
    import tracer_tpu.models.tau_minidish  # noqa: F401
    from tracer_tpu.viz.render import scene_tree as jax_scene_tree
    assert tree == jax_scene_tree(_minidish(tracer_tpu))


def test_show_geom_draws_each_row_at_its_own_frame():
    """tests/test_io_viz_compat.py:99 on the port: the flat receiver sorts
    before the dish, and each mesh is drawn at its own row's frame."""
    from tracer_tpu_torch.viz.render import Renderer
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    dish = sc.Surface(G.parabolic_dish(diameter=2.0, focal_length=1.5),
                      M.reflective(0.1), name="dish")
    rec = sc.Surface(G.round_plate(0.2), M.absorber(),
                     location=[0.0, 0.0, 1.5], name="rec")
    table, meta = ptt.compile_scene(
        sc.Assembly([sc.AssembledObject([dish, rec])]),
        dtype=torch.float64, device=CPU)
    assert meta.names[int(meta.row_logical[0])] == "rec"
    r = Renderer((table, meta))
    drawn = []
    r.ax.plot_surface = lambda X, Y, Z, **kw: drawn.append(
        (np.asarray(X), np.asarray(Y), np.asarray(Z)))
    r.show_geom()
    assert len(drawn) == 2
    for X, Y, Z in drawn:
        if float(np.hypot(X, Y).max()) < 0.5:
            np.testing.assert_allclose(Z, 1.5, atol=1e-9)
        else:
            assert float(np.abs(Z).max()) < 0.5


@pytest.mark.parametrize("kind,extent", [
    ("rect", dict(w=2.0, h=1.0)),
    ("round", dict(re=1.0, ri=0.2)),
    ("parabolic_dish", dict(R=1.0, qa=0.2)),
    ("finite_cylinder", dict(R=0.5, h=1.0)),
    ("conical_frustum", dict(z1=0.0, z2=1.0, c=0.5, a=-1.0)),
    ("sphere", dict(R=1.2))])
def test_mesh_from_edges_matches_jax(kind, extent):
    from tracer_tpu.viz.render import mesh_from_edges as jax_mesh
    from tracer_tpu_torch.analysis.fluxmap import edges_of
    from tracer_tpu_torch.viz.render import mesh_from_edges
    ue, ve = edges_of(kind, extent, 6)
    for got, want in zip(mesh_from_edges(kind, extent, ue, ve),
                         jax_mesh(kind, extent, ue, ve)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    with pytest.raises(NotImplementedError):
        mesh_from_edges("triangle", {}, ue, ve)
