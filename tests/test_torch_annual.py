"""The port's field analyses (tracer_tpu_torch.analysis.annual, .losses,
.estimator) against tracer_tpu's.

* the solar geometry and the daylight-weighted sun grid equal to 1e-12;
* Estimator and mcrt_to_ci equal on the same inputs;
* field_losses on a four-heliostat field (one heliostat hoisted onto
  another's beam line, tests/test_sandia.py:38) traced by both packages'
  ray_tracer on one float64 scene and bundle carried across: specular
  one-sided mirrors and an absorbing receiver, so the first two records
  see no random draw and the attributions agree to 1e-9, both audits ~0;
* efficiency_sweep on tests/test_annual.py's two-heliostat field at two
  sun positions, culled (K1's plain version) and not (K2's), within 3
  binomial sigma of tracer_tpu's float64 sweep, closures below 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu.analysis import annual as jannual
from tracer_tpu.analysis import estimator as jest
from tracer_tpu.analysis import losses as jlosses
from tracer_tpu.engine import TracerEngine as JaxEngine
from tracer_tpu.models.heliostat_field import HeliostatField as JaxField
from tracer_tpu.models.one_sided_mirror import (
    one_sided_receiver as jax_receiver)
from tracer_tpu.sources import disk_bundle as jax_disk_bundle
from tracer_tpu_torch import bundle_from_jax, scene_from_jax
from tracer_tpu_torch.analysis import annual, estimator, losses
from tracer_tpu_torch.bundle import FIELDS
from tracer_tpu_torch.engine import TracerEngine
from tracer_tpu_torch.models.heliostat_field import HeliostatField
from tracer_tpu_torch.models.one_sided_mirror import one_sided_receiver

torch.set_num_threads(1)

TABLE = ("frame", "inv_frame", "quadric", "ap_type", "ap_params",
         "opt_kind", "opt_flags", "opt_params", "spectral_wl",
         "spectral_ab", "logical")
STATIC = ("groups", "kinds_present", "flags_present", "slope_flags_present",
          "features", "ambient_medium", "iam_c")
PHI = np.deg2rad(35.0)


@pytest.mark.parametrize("day", (1.0, 81.0, 172.25, 200.5, 354.75))
def test_solar_geometry_matches_tracer_tpu(day):
    np.testing.assert_allclose(annual.solar_declination(day),
                               jannual.solar_declination(day), atol=1e-12)
    hours = np.linspace(5.0, 19.0, 29)
    for lat in (PHI, -PHI, np.deg2rad(70.0)):
        for a, b in zip(annual.solar_angles(lat, day, hours),
                        jannual.solar_angles(lat, day, hours)):
            np.testing.assert_allclose(a, b, atol=1e-12)


@pytest.mark.parametrize("lat,days,hours", ((PHI, 12, 8), (-PHI, 6, 7),
                                            (np.deg2rad(75.0), 12, 5)))
def test_annual_sun_grid_matches_tracer_tpu(lat, days, hours):
    g = annual.annual_sun_grid(lat, n_days=days, n_hours=hours)
    jg = jannual.annual_sun_grid(lat, n_days=days, n_hours=hours)
    assert g.shape == jg.shape and g.shape[1] == 3
    np.testing.assert_allclose(g, jg, atol=1e-12)
    np.testing.assert_allclose(g.excluded, jg.excluded, atol=1e-12)


def test_estimator_and_mcrt_to_ci_match_tracer_tpu():
    rng = np.random.default_rng(4)
    values = rng.normal(3.0, 0.5, (40, 3))
    weights = rng.uniform(0.5, 2.0, (40, 1))
    ests = []
    for mod in (estimator, jest):
        e = mod.Estimator(n_sigma=2.5)
        for k in range(0, 40, 8):
            e.update(values[k:k + 8], weights[k:k + 8])
        ests.append(e)
    a, b = ests
    assert a.count == b.count == 40
    for k in ("wsum", "mean", "m2", "variance", "std_of_mean", "ci"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    assert a.converged(0.05) == b.converged(0.05)

    def batch(i):
        return np.array([1.0 + 0.01 * np.sin(i), 2.0 + 0.03 * np.cos(3 * i)])
    ra = estimator.mcrt_to_ci(batch, rel_tol=0.002, min_batches=3)
    rb = jest.mcrt_to_ci(batch, rel_tol=0.002, min_batches=3)
    assert ra.count == rb.count and 3 <= ra.count < 1000
    np.testing.assert_array_equal(ra.mean, rb.mean)
    np.testing.assert_array_equal(ra.ci, rb.ci)


def _field_assembly(pkg_field, pkg_receiver, sp, asm_cls, positions,
                    zenith, sigma=0.0):
    field = pkg_field(positions, width=6.1, height=6.1, absorptivity=0.1,
                      sigma=sigma, bi_var=True)
    field.set_aim_height(60.0)
    normals = field.track_sun(azimuth=0.0, zenith=zenith)
    _, rec = pkg_receiver(11.0, 11.0)
    aim = np.array([0.0, 0.7, -0.714])
    aim /= np.linalg.norm(aim)
    rec.set_transform(sp.translate(0, 0, 60.0)
                      @ sp._homog(sp.rotation_to_z(aim)))
    return asm_cls(objects=[rec], subassemblies=[field]), normals


def test_field_losses_match_tracer_tpu():
    positions = np.array([[0.0, 100.0, 0.0], [0.0, 50.0, 30.0],
                          [20.0, 80.0, 0.0], [-20.0, 75.0, 0.0]])
    zen = np.pi / 6
    sun = jannual.solar_vector(0.0, zen)
    jasm, normals = _field_assembly(JaxField, jax_receiver,
                                    tracer_tpu.spatial, tracer_tpu.Assembly,
                                    positions, zen)
    pasm, p_normals = _field_assembly(HeliostatField, one_sided_receiver,
                                      ptt.spatial, ptt.Assembly, positions,
                                      zen)
    np.testing.assert_array_equal(normals, p_normals)
    jt, jm = tracer_tpu.scene.compile_scene(jasm, dtype=jnp.float64)
    _, pm = ptt.compile_scene(pasm, dtype=torch.float64, device="cpu")
    assert pm.names == jm.names
    np.testing.assert_array_equal(pm.row_logical, jm.row_logical)
    b = jax_disk_bundle(jax.random.PRNGKey(0), 8192,
                        center=positions.mean(axis=0) + sun * 300.0,
                        direction=(-sun).tolist(), radius=140.0,
                        ang_range=1e-3, flux=1000.0)
    jres = JaxEngine(jt, jm).ray_tracer(b, reps=4,
                                        key=jax.random.PRNGKey(1))
    tn = {f: np.asarray(getattr(jt, f)) for f in TABLE}
    tn.update({f: getattr(jt, f) for f in STATIC})
    pres = TracerEngine(scene_from_jax(tn, device="cpu", dtype=torch.float64),
                        pm).ray_tracer(
        bundle_from_jax({f: np.asarray(getattr(b, f)) for f in FIELDS},
                        device="cpu"), reps=4,
        generator=torch.Generator().manual_seed(1))
    areas = losses.projected_areas(normals, sun, 6.1 ** 2)
    np.testing.assert_array_equal(
        areas, jlosses.projected_areas(normals, sun, 6.1 ** 2))
    got = losses.field_losses(pres, flux=1000.0, proj_areas=areas)
    want = jlosses.field_losses(jres, flux=1000.0, proj_areas=areas)
    assert sorted(got) == sorted(want)
    src = want["source"]
    for k, v in want.items():
        if k.startswith("audit"):
            continue
        np.testing.assert_allclose(got[k], v, rtol=1e-9, atol=1e-9 * src,
                                   err_msg=k)
    assert abs(got["audit_source"]) < 1e-9 * src
    assert np.abs(got["audit_per_heliostat"]).max() < 1e-9 * src
    inc = got["incoming"]
    assert (inc > 0).all()
    # heliostat 0's beam is intercepted by heliostat 1: mostly blocked
    assert got["blocked"][0] > 0.8 * (inc[0] - got["mirror"][0])
    assert got["delivered"][2] > 0.5 * (inc[2] - got["mirror"][2])


@pytest.fixture(scope="module")
def sweeps():
    """tests/test_annual.py's two-heliostat field at its two positions:
    tracer_tpu's float64 sweep, then the port's float32 sweep unculled
    and culled, 12,288 rays a position (4 ray tiles)."""
    positions = np.array([[0.0, 60.0, 0.0], [10.0, 80.0, 0.0]])
    angles = np.array([[np.pi, 0.3, 100.0], [0.75 * np.pi, 0.6, 50.0]])
    n = 4 * 3072
    out = {}
    for name, pkg_field, pkg_rec, sp, asm_cls in (
            ("jax", JaxField, jax_receiver, tracer_tpu.spatial,
             tracer_tpu.Assembly),
            ("port", HeliostatField, one_sided_receiver, ptt.spatial,
             ptt.Assembly)):
        field = pkg_field(positions, width=6.1, height=6.1,
                          absorptivity=0.05, sigma=0.0, bi_var=True)
        field.set_aim_height(30.0)
        _, rec = pkg_rec(11.0, 11.0)
        center = positions.mean(axis=0)
        aim_dir = np.array([center[0], center[1], -30.0 * 0.75])
        aim_dir /= np.linalg.norm(aim_dir)
        rec.set_transform(sp.translate(0, 0, 30.0)
                          @ sp._homog(sp.rotation_to_z(aim_dir)))
        asm = asm_cls(objects=[rec], subassemblies=[field])
        kw = dict(total_mirror_area=2 * 6.1 * 6.1, rays_per_position=n,
                  slab=n, max_path=4)
        if name == "jax":
            out["jax"] = jannual.efficiency_sweep(
                asm, field, angles, dtype=jnp.float64,
                key=jax.random.PRNGKey(3), **kw)
        else:
            for cull in (False, True):
                out[("port", cull)] = annual.efficiency_sweep(
                    asm, field, angles, use_culling=cull, generator=3,
                    device="cpu", **kw)
    return positions, angles, n, out


@pytest.mark.parametrize("cull", (False, True), ids=("unculled", "culled"))
def test_efficiency_sweep_matches_tracer_tpu(sweeps, cull):
    positions, angles, n, out = sweeps
    got, want = out[("port", cull)], out["jax"]
    np.testing.assert_allclose(np.abs(got["closure"]), 0.0, atol=1e-4)
    np.testing.assert_allclose(got["cosine_eff"], want["cosine_eff"],
                               rtol=1e-12)
    for k in ("azimuth", "zenith", "weight"):
        np.testing.assert_array_equal(got[k], want[k])
    eff, cos_eff = got["efficiency"], got["cosine_eff"]
    assert ((0.0 < eff) & (eff < 1.0)).all()
    assert (eff <= cos_eff + 1e-9).all() and (eff > 0.5 * cos_eff).all()
    # each position's receiver share of the disk's power is a binomial
    # fraction of n rays in both packages, scaled by what a ray keeps off
    # its mirror (every ray carries the same energy and the receiver
    # absorbs all that reaches it). At this size (sigma ~4% of it) the
    # two positions' 1.7% apart are not ordered
    disk_kw = annual.field_disk_source(positions, [0.0, 0.0, 1.0],
                                       n).disk_power / 1e3
    frac_p = got["receiver_kw"] / disk_kw
    frac_j = want["receiver_kw"] / disk_kw
    sigma = np.sqrt((frac_j * (1 - frac_j) + frac_p * (1 - frac_p)) / n)
    assert (np.abs(frac_p - frac_j) < 3.0 * sigma).all(), (frac_p, frac_j,
                                                          sigma)
    np.testing.assert_allclose(
        got["annual_efficiency"],
        (eff * angles[:, 2]).sum() / angles[:, 2].sum(), rtol=1e-12)
    assert (got["build_s"] > 0).all() and (got["trace_s"] > 0).all()
