"""The port's shade pass against tracer_tpu's shade.shade.

* float64, no slope error, on the MiniDish with rays that hit every row
  from the front and from behind (one-sided kills): both the row-gather
  branch (aux None, the oracle path) and the aux branch (K3's shading
  data, here from its plain version run in float64) equal tracer_tpu's to
  1e-12;
* slope error: the spread of the reflected direction, E|dr|^2 =
  4 sigma^2 (1 + cos^2 theta) for the bivariate model and half that for
  the radial one, within 3 standard errors, on both branches and for
  tracer_tpu.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import optics as jax_optics
from tracer_tpu.kernels.shade import shade as jax_shade
from tracer_tpu.models.tau_minidish import MiniDish as JaxMiniDish
from tracer_tpu.scene import compile_scene as jax_compile
from tracer_tpu_torch.kernels import intersect as ki
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.kernels.bounce import pack_rows
from tracer_tpu_torch import optics
from tracer_tpu_torch.kernels.shade import shade
from tracer_tpu_torch.models.tau_minidish import MiniDish
from test_torch_gpu import fuzz_rays

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

FIELDS = ("out_pos", "out_dir", "out_energy", "absorbed", "local_pt",
          "normal", "backside")


def _minidish(pkg_minidish, sp):
    asm = pkg_minidish(5.0, 6.25, 0.9, 6.95, 0.4, 0.7, 0.9)
    asm.set_transform(sp.rotx(-np.pi / 4))
    return asm


def _jax_aux(aux):
    return {k: jnp.asarray(v.numpy()) for k, v in aux.items()}


@pytest.mark.parametrize("branch", ("gather", "aux"))
def test_shade_matches_jax_float64(branch):
    jt, _ = jax_compile(_minidish(JaxMiniDish, tracer_tpu.spatial),
                        dtype=jnp.float64)
    pt, pm = ptt.compile_scene(_minidish(MiniDish, ptt.spatial),
                               dtype=torch.float64, device="cpu")
    pos, dirs = (torch.tensor(a).double() for a in fuzz_rays(pm, 8192, 3))
    n = pos.shape[0]
    if branch == "gather":
        t, sid = ki.nearest_hit(pt, pos, dirs)
        aux = None
    else:
        t, sid, aux = kn.nearest_hit_ref(pack_rows(pt, torch.float64), pos,
                                         dirs, pt.groups, 1e-6)
    rng = np.random.default_rng(0)
    e = torch.tensor(rng.uniform(0.5, 2.0, n))
    wl, ri = torch.zeros(n, dtype=torch.float64), torch.ones(
        n, dtype=torch.float64)
    got = shade(pt, sid, t, pos, dirs, e, wl, ri,
                torch.Generator().manual_seed(0), aux=aux)
    want = jax_shade(jt, jnp.asarray(sid.numpy()), jnp.asarray(t.numpy()),
                     jnp.asarray(pos.numpy()), jnp.asarray(dirs.numpy()),
                     jnp.asarray(e.numpy()), jnp.asarray(wl.numpy()),
                     jnp.asarray(ri.numpy()), jax.random.PRNGKey(0),
                     aux=None if aux is None else _jax_aux(aux))
    hit = (sid >= 0).numpy()
    assert hit.mean() > 0.2
    backside = np.asarray(want.backside)[hit]
    assert backside.any() and not backside.all()
    for f in FIELDS:
        np.testing.assert_allclose(getattr(got, f).numpy()[hit],
                                   np.asarray(getattr(want, f))[hit],
                                   rtol=1e-12, atol=1e-12, err_msg=f)
    # one-sided rows kill back-face hits
    assert (got.out_energy.numpy()[hit][backside] == 0).any()


def _slope_plate(pkg, sigma, bi_var):
    G, M, sc = pkg.geometry, pkg.materials, pkg.scene
    plate = sc.Surface(G.rect_plate(4.0, 4.0),
                       M.reflective(0.1, sigma=sigma, bi_var=bi_var),
                       name="plate")
    return sc.Assembly([sc.AssembledObject([plate])])


def _spread(d, r1, r0):
    """|r1 - r0|^2 / (1 + cos^2 theta): cos theta from d.r0 = -cos 2."""
    cos2 = (1.0 - (d * r0).sum(1)) / 2.0
    return ((r1 - r0) ** 2).sum(1) / (1.0 + cos2)


@pytest.mark.parametrize("bi_var", (True, False), ids=("bivar", "radial"))
def test_slope_error_spread(bi_var):
    sigma = 2e-3
    want = (4.0 if bi_var else 2.0) * sigma ** 2
    n = 20000
    rng = np.random.default_rng(4)
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.2
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pos = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.5, 1.5, n),
                    np.zeros(n)], axis=1) - 3.0 * d
    tp, td = torch.tensor(pos), torch.tensor(d)
    e, wl, ri = (torch.ones(n, dtype=torch.float64),
                 torch.zeros(n, dtype=torch.float64),
                 torch.ones(n, dtype=torch.float64))
    results = []
    for branch in ("gather", "aux"):
        out = []
        for s in (sigma, 0.0):
            pt, _ = ptt.compile_scene(_slope_plate(ptt, s, bi_var),
                                      dtype=torch.float64, device="cpu")
            if branch == "gather":
                t, sid = ki.nearest_hit(pt, tp, td)
                aux = None
            else:
                t, sid, aux = kn.nearest_hit_ref(
                    pack_rows(pt, torch.float64), tp, td, pt.groups, 1e-6)
            assert (sid == 0).all()
            out.append(shade(pt, sid, t, tp, td, e, wl, ri,
                             torch.Generator().manual_seed(9),
                             aux=aux).out_dir.numpy())
        results.append(_spread(d, *out))
    jout = []
    for s in (sigma, 0.0):
        jt, _ = jax_compile(_slope_plate(tracer_tpu, s, bi_var),
                            dtype=jnp.float64)
        t, sid = ki.nearest_hit(ptt.compile_scene(
            _slope_plate(ptt, s, bi_var), dtype=torch.float64,
            device="cpu")[0], tp, td)
        jout.append(np.asarray(jax_shade(
            jt, jnp.asarray(sid.numpy()), jnp.asarray(t.numpy()),
            jnp.asarray(pos), jnp.asarray(d), jnp.ones(n), jnp.zeros(n),
            jnp.ones(n), jax.random.PRNGKey(2)).out_dir))
    results.append(_spread(d, *jout))
    for x in results:
        se = x.std() / math.sqrt(n)
        assert abs(x.mean() - want) < 3 * se, (x.mean(), want, se)


def test_optics_laws_match_jax():
    """Reflection, Snell refraction (with total internal reflection) and
    the dielectric Fresnel reflectance, float64, to 1e-12."""
    rng = np.random.default_rng(11)
    n = 4096
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    n1, n2 = rng.uniform(1.0, 1.8, n), rng.uniform(1.0, 1.8, n)
    td, tn, t1, t2 = (torch.tensor(a) for a in (d, nrm, n1, n2))
    jd, jn, j1, j2 = (jnp.asarray(a) for a in (d, nrm, n1, n2))
    np.testing.assert_allclose(optics.reflections(td, tn).numpy(),
                               np.asarray(jax_optics.reflections(jd, jn)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(optics.fresnel(td, tn, t1, t2).numpy(),
                               np.asarray(jax_optics.fresnel(jd, jn, j1, j2)),
                               rtol=1e-12, atol=1e-12)
    ok, t = optics.refractions(t1, t2, td, tn)
    jok, jt = jax_optics.refractions(j1, j2, jd, jn)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.any() and not ok.all()
    np.testing.assert_allclose(t.numpy()[ok.numpy()],
                               np.asarray(jt)[ok.numpy()], rtol=1e-12,
                               atol=1e-12)
