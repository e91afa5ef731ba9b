"""The model library and the STL pipeline against tracer_tpu on the CPU
(tests/models/test_model_zoo.py:15-64 and test_triangulated.py:18-70 are
the counterparts):

* the compiled tables of PETAL, SG4, a one-module solar simulator, the
  seven-module layout and the pyramid mesh equal tracer_tpu's to 1e-12
  in float64;
* the same float64 rays, drawn once with NumPy, through both engines:
  ``absorbed_by_logical`` (PETAL, SG4, meshes), ``SG4.get_all_hits`` and
  ``Target.evaluate_fluxmap`` (a simulator without slope error, so that
  the trace draws nothing) agree to 1e-9;
* the lamps statistically, since jax.random and torch streams differ:
  emitted power and Zhu's component counts and energies exact, the
  position and direction moments of 200,000 rays within a joint 3 sigma
  (each of the m moments within the Bonferroni z of 0.27% / m) of
  tracer_tpu's draws;
* ``simulate(save_dir=...)`` writes files whose header rows equal
  tracer_tpu's, and a map whose total is within 3 sigma of tracer_tpu's;
* STL files written by one package load in the other; the parametric
  meshes equal; the traced meshes agree lane by lane.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import norm

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu import stl_utils as jax_stl
from tracer_tpu.bundle import RayBundle as JaxBundle
from tracer_tpu.engine import TracerEngine as JaxEngine
from tracer_tpu.models import petal_dish as jax_petal
from tracer_tpu.models import sg4 as jax_sg4
from tracer_tpu.models import solar_simulator as jax_sim
from tracer_tpu.models import triangulated_surface as jax_tri
from tracer_tpu_torch import stl_utils
from tracer_tpu_torch.bundle import RayBundle
from tracer_tpu_torch.engine import TracerEngine
from tracer_tpu_torch.models import petal_dish, sg4, solar_simulator
from tracer_tpu_torch.models import triangulated_surface

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

CPU = "cpu"
TABLE = ("frame", "inv_frame", "quadric", "ap_type", "ap_params",
         "opt_kind", "opt_flags", "opt_params", "logical")
STATIC = ("groups", "kinds_present", "flags_present", "slope_flags_present",
          "features", "ambient_medium", "iam_c")
PYRAMID_VERTS = np.array([[0.0, 0.0, 1.0], [1, 1, 0], [-1, 1, 0],
                          [-1, -1, 0], [1, -1, 0]], dtype=float)
PYRAMID_FACES = np.array([[0, 1, 2], [0, 2, 3], [0, 3, 4], [0, 4, 1]])


def _petal(mod):
    return mod.PETAL(diameter=5.0, focal_length=6.25, dish_opt_eff=0.9,
                     receiver_pos=6.95, receiver_side=0.4,
                     homogenizer_depth=0.7, homog_opt_eff=0.9)


def _sg4(mod):
    return mod.SG4(dishDiameter=25.0, dishFocus=13.4, absMirrors=0.1,
                   sigma=2e-3)


def _one_module(mod, slope_error=2.5e-3, target_z=1.8, bins=11):
    b = np.linspace(-0.1, 0.1, bins)
    target = mod.Target(0.2, 0.2, location=[0, 0, target_z],
                        normal=[0, 0, -1.0], binx=b, biny=b)
    return mod.SolarSimulator(
        modules_positions=[[0.0, 0.0, 0.0]],
        modules_directions=[[0.0, 0.0, 1.0]],
        modules_dicts=[dict(a=0.4, b=0.4, c=0.5, zlim=(-0.49, -0.1),
                            slope_error=slope_error,
                            lampdict={"model": "Zhu", "P_elec": 7e3})],
        targets=[target])


def _seven(mod):
    """The seven-module layout (solar_simulator.high_flux_simulator), built
    with either package's classes."""
    sim = solar_simulator.high_flux_simulator()
    if mod is solar_simulator:
        return sim
    t = sim.targets[0]
    target = mod.Target(0.2, 0.2, location=t.get_location(),
                        normal=[0.0, 0.0, -1.0], binx=t.binx, biny=t.biny)
    return mod.SolarSimulator(
        [m.location for m in sim.modules],
        [m.aiming_vector for m in sim.modules],
        [dict(a=0.4, b=0.4, c=1.0, zlim=(-0.99, -0.6),
              lampdict={"model": "Zhu"}) for _ in sim.modules], [target])


def _pyramid(mod, pkg):
    obj = mod.TriangulatedSurface(
        PYRAMID_VERTS, PYRAMID_FACES,
        pkg.materials.receiver(pkg.materials.reflective(1.0)))
    return pkg.scene.Assembly(objects=[obj])


MODELS = {
    "petal": lambda port: _petal(petal_dish if port else jax_petal),
    "sg4": lambda port: _sg4(sg4 if port else jax_sg4),
    "simulator": lambda port: _one_module(solar_simulator if port
                                          else jax_sim),
    "seven_modules": lambda port: _seven(solar_simulator if port
                                         else jax_sim),
    "pyramid": lambda port: (_pyramid(triangulated_surface, ptt) if port
                             else _pyramid(jax_tri, tracer_tpu)),
}


def _engines(name):
    pe = TracerEngine(MODELS[name](True), dtype=torch.float64, device=CPU)
    je = JaxEngine(MODELS[name](False), dtype=jnp.float64)
    return pe, je


@pytest.mark.parametrize("name", sorted(MODELS))
def test_tables_equal(name):
    pe, je = _engines(name)
    for f in TABLE:
        np.testing.assert_allclose(getattr(pe.scene, f).numpy(),
                                   np.asarray(getattr(je.scene, f)),
                                   rtol=1e-12, atol=1e-15, err_msg=f)
    for f in STATIC:
        assert getattr(pe.scene, f) == getattr(je.scene, f), f
    assert pe.meta.names == je.meta.names
    np.testing.assert_array_equal(pe.meta.row_logical, je.meta.row_logical)


def test_seven_module_layout():
    """Every module's second focus is the target's centre; the rims (0.32
    m, 0.317 m ahead of each lamp) do not meet: the nearest rim centres
    are 0.758 m apart against two rim radii of 0.64 m; the table holds
    the seven ellipsoids in the general-quadric class and the target."""
    sim = solar_simulator.high_flux_simulator()
    assert len(sim.modules) == 7 and len(sim.targets) == 1
    rims = []
    for m in sim.modules:
        u = m.aiming_vector
        assert m.reflector.focal_dist == pytest.approx(1.8330303, rel=1e-6)
        np.testing.assert_allclose(m.location + m.reflector.focal_dist * u,
                                   0.0, atol=1e-12)
        rims.append(m.location + 0.31652 * u)
    gaps = [np.linalg.norm(p - q) for i, p in enumerate(rims)
            for q in rims[i + 1:]]
    assert min(gaps) == pytest.approx(0.7585, abs=1e-3)
    assert min(gaps) > 2 * 0.32
    assert sim.targets[0].fluxmap.count == 0
    table, _ = ptt.compile_scene(sim, dtype=torch.float64, device=CPU)
    assert table.num_rows == 8
    assert {g[3] for g in table.groups} == {"flat", "quadric"}


def _sun(n, center, radius, seed):
    """A numpy disk of parallel rays (1e-3 rad of spread) down -z."""
    rng = np.random.default_rng(seed)
    r = radius * np.sqrt(rng.uniform(size=n))
    a = rng.uniform(0, 2 * np.pi, n)
    pos = np.stack([r * np.cos(a), r * np.sin(a), np.zeros(n)], 1) \
        + np.asarray(center, dtype=float)
    d = rng.normal(size=(n, 3)) * 1e-3
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    e = np.full(n, 1000.0 * np.pi * radius ** 2 / n)
    return pos, d, e


def _trace(name, pos, d, e, reps):
    pe, je = _engines(name)
    pres = pe.ray_tracer(RayBundle.create(pos=pos, dir=d, energy=e,
                                          dtype=torch.float64, device=CPU),
                         reps=reps)
    jres = je.ray_tracer(JaxBundle.create(pos=jnp.asarray(pos),
                                          dir=jnp.asarray(d),
                                          energy=jnp.asarray(e)),
                         reps=reps, key=jax.random.PRNGKey(1))
    return pres, jres


def test_petal_absorbed_equal():
    """tests/models/test_model_zoo.py:15: the receiver takes more than 10
    kW of the 5 m hexagonal dish's light, closure 0; both packages'
    per-surface absorbed energy on the same rays to 1e-9."""
    pres, jres = _trace("petal", *_sun(8000, [0, 0, 10.0], 3.0, 0), 20)
    got, want = pres.absorbed_by_logical(), jres.absorbed_by_logical()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    rec = got[pres.meta.index_of("receiver")]
    assert rec > 0.5 * pres.energy_balance()["source"]
    assert abs(pres.energy_balance()["closure"]) < 1e-9 * 28000


def test_sg4_get_all_hits_equal():
    """tests/models/test_model_zoo.py:31: both layers absorb (the inner
    dish 0.1 mm above the outer shadows it inside 10 m), and
    get_all_hits' points and energies equal tracer_tpu's on the same
    rays to 1e-9 (absorption happens at the first hit, which draws
    nothing; the reflected rays leave)."""
    pres, jres = _trace("sg4", *_sun(6000, [0, 0, 30.0], 13.0, 2), 3)
    ps, js = _sg4(sg4), _sg4(jax_sg4)
    hits, absorbed = ps.get_all_hits(pres)
    jhits, jabsorbed = js.get_all_hits(jres)
    np.testing.assert_allclose(hits, jhits, rtol=0, atol=1e-9)
    np.testing.assert_allclose(absorbed, jabsorbed, rtol=1e-9)
    assert ps.total_abs == pytest.approx(js.total_abs, rel=1e-9)
    assert ps.total_abs > 0
    ab = pres.absorbed_by_logical()
    assert ab[pres.meta.index_of("dish_inner")] > 0
    assert ab[pres.meta.index_of("dish_outer")] > 0
    np.testing.assert_allclose(ab, jres.absorbed_by_logical(), rtol=1e-9)


def _lamp_rays(n, seed, location=(0.0, 0.0, 0.0)):
    """Rays leaving near a lamp at ``location``, isotropic."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(n, 3)) * 1e-3 + np.asarray(location)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return pos, d, np.full(n, 4200.0 / n)


def test_target_fluxmap_equal():
    """Target.evaluate_fluxmap on both packages' traces of the same rays
    through a one-module simulator without slope error, with the target
    at the second focus (0.6 m) and non-centred bins (the bin-centre
    shift): the map equal to 1e-9, its integral the target's recorded
    incident energy."""
    def build(mod):
        sim = _one_module(mod, slope_error=0.0, target_z=0.6, bins=21)
        t = sim.targets[0]
        t.binx = t.binx + 0.02            # the plate keeps its span
        return sim, t
    psim, pt = build(solar_simulator)
    jsim, jt = build(jax_sim)
    pos, d, e = _lamp_rays(6000, 3)
    pres = TracerEngine(psim, dtype=torch.float64, device=CPU).ray_tracer(
        RayBundle.create(pos=pos, dir=d, energy=e, dtype=torch.float64,
                         device=CPU), reps=20)
    jres = JaxEngine(jsim, dtype=jnp.float64).ray_tracer(
        JaxBundle.create(pos=jnp.asarray(pos), dir=jnp.asarray(d),
                         energy=jnp.asarray(e)), reps=20,
        key=jax.random.PRNGKey(0))
    pm = np.asarray(pt.evaluate_fluxmap(pres).mean)
    jm = np.asarray(jt.evaluate_fluxmap(jres).mean)
    assert pm.shape == (20, 20)
    np.testing.assert_allclose(pm, jm, rtol=1e-9, atol=1e-9 * jm.max())
    e_in = pres.hits_of("target")["e_in"].sum()
    assert e_in > 0.1 * e.sum()
    assert (pm * pt.areas).sum() == pytest.approx(e_in, rel=1e-9)


def _moments(pos, d):
    """Means of each coordinate of pos and dir, and of their squares."""
    x = np.concatenate([pos, d, pos ** 2, d ** 2], axis=1)
    return x.mean(0), x.var(0, ddof=1), len(x)


def _assert_moments_close(a, b):
    (ma, va, na), (mb, vb, nb) = a, b
    z = np.abs(ma - mb) / np.sqrt(va / na + vb / nb)
    z_max = norm.ppf(1.0 - 0.0027 / (2 * len(z)))
    assert (z < z_max).all(), (z, z_max)


LAMPS = {
    "Zhu": (dict(P_elec=6e3, alpha_s=0.25, beta_c1=0.05, gamma_c2=0.6),
            "SimulatorLampZhu"),
    "Bader": (dict(P_elec=2.5e3), "SimulatorLampBader"),
}


@pytest.mark.parametrize("model", sorted(LAMPS))
def test_lamp_power_counts_and_moments(model):
    """A lamp aimed off the axis at an offset location: emitted power
    exact, per-ray energies (Zhu's per-fraction unit, fractions not
    summing to 1) equal to tracer_tpu's, position and direction moments
    within a joint 3 sigma of tracer_tpu's draws."""
    kw, cls = LAMPS[model]
    aim = np.array([0.3, -0.2, 0.933])
    kw = dict(kw, location=(0.3, -0.2, 1.0),
              direction=aim / np.linalg.norm(aim))
    lamp = getattr(solar_simulator, cls)(**kw)
    jlamp = getattr(jax_sim, cls)(**kw)
    n = 200_000
    b = lamp.generate_rays(torch.Generator().manual_seed(1), n,
                           part_load=0.8, dtype=torch.float64, device=CPU)
    jb = jlamp.generate_rays(jax.random.PRNGKey(1), n, part_load=0.8)
    assert b.num_rays == n and b.pos.dtype == torch.float64
    assert float(b.energy.sum()) == pytest.approx(0.8 * lamp.P, rel=1e-12)
    np.testing.assert_allclose(b.energy.numpy(), np.asarray(jb.energy),
                               rtol=1e-12)
    if model == "Zhu":
        n_s, n_c1, n_c2 = lamp.counts(n)
        assert (n_s, n_c1) == (int(n * 0.25), int(n * 0.05))
        e = b.energy.numpy()
        assert len(np.unique(e[:n_s])) == len(np.unique(e[n_s:n_s + n_c1])) \
            == len(np.unique(e[n_s + n_c1:])) == 1
        assert e[:n_s].sum() == pytest.approx(0.8 * lamp.P * 0.25 / 0.9,
                                              rel=1e-12)
    _assert_moments_close(_moments(b.pos.numpy(), b.dir.numpy()),
                          _moments(np.asarray(jb.pos), np.asarray(jb.dir)))
    np.testing.assert_allclose(np.linalg.norm(b.dir.numpy(), axis=1), 1.0,
                               atol=1e-12)


def test_fire_lamp_in_the_module_frame():
    """fire_lamp turns the lamp's rays into the module's frame on the
    device: the same draws as the lamp's, rotated onto the aiming vector
    and moved to the first focus, equal to rotate_z_to_normal's NumPy
    rotation to 1e-12; moments within a joint 3 sigma of tracer_tpu's."""
    aim = np.array([0.5, 0.0, 0.8660254037844386])
    kw = dict(a=0.4, b=0.4, c=1.0, zlim=(-0.99, -0.6),
              lampdict={"model": "Zhu"}, first_focus_location=(1.0, 2.0, 3.0),
              aiming_vector=aim)
    m = solar_simulator.SolarSimulatorModule(**kw)
    jm = jax_sim.SolarSimulatorModule(**kw)
    n = 100_000
    got = m.fire_lamp(torch.Generator().manual_seed(3), n,
                      dtype=torch.float64, device=CPU)
    raw = m.lamp.generate_rays(torch.Generator().manual_seed(3), n,
                               dtype=torch.float64, device=CPU)
    np.testing.assert_allclose(
        got.pos.numpy(),
        ptt.vector_utils.rotate_z_to_normal(raw.pos.numpy(), aim)
        + [1.0, 2.0, 3.0], rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        got.dir.numpy(),
        ptt.vector_utils.rotate_z_to_normal(raw.dir.numpy(), aim),
        rtol=0, atol=1e-12)
    jb = jm.fire_lamp(jax.random.PRNGKey(3), n)
    _assert_moments_close(_moments(got.pos.numpy(), got.dir.numpy()),
                          _moments(np.asarray(jb.pos), np.asarray(jb.dir)))


def test_simulate_writes_tracer_tpu_files(tmp_path):
    """tests/models/test_model_zoo.py:46 on both packages: the same
    fluxmap_0.csv and confidence_intervals_0.csv headers, maps of the
    same shape, finite and not empty; and with the target at the second
    focus, the target's power within 3 combined sigma of tracer_tpu's
    (binomial in the rays that reach it)."""
    out = {}
    for port in (True, False):
        sim = _one_module(solar_simulator if port else jax_sim)
        d = tmp_path / ("port" if port else "jax")
        if port:
            sim.simulate(nrays=20000, ray_batch=10000, save_dir=str(d),
                         generator=torch.Generator().manual_seed(4),
                         dtype=torch.float64, device=CPU)
        else:
            sim.simulate(nrays=20000, ray_batch=10000, save_dir=str(d),
                         key=jax.random.PRNGKey(4))
        flux = np.asarray(sim.targets[0].fluxmap.mean)
        assert np.isfinite(flux).all() and flux.sum() > 0
        assert sim.targets[0].fluxmap.count == 2
        out[port] = {n: open(d / n).read().splitlines()
                     for n in ("fluxmap_0.csv", "confidence_intervals_0.csv")}
    for name, lines in out[True].items():
        assert lines[:2] == out[False][name][:2], name
        assert len(lines) == len(out[False][name]) == 12
        assert [len(r.split(",")) for r in lines] == \
            [len(r.split(",")) for r in out[False][name]]
    power = {}
    for port in (True, False):
        sim = _one_module(solar_simulator if port else jax_sim,
                          target_z=0.6, bins=11)
        n = 20_000
        if port:
            sim.simulate(nrays=n, ray_batch=n,
                         generator=torch.Generator().manual_seed(5),
                         dtype=torch.float64, device=CPU)
        else:
            sim.simulate(nrays=n, ray_batch=n, key=jax.random.PRNGKey(5))
        t = sim.targets[0]
        power[port] = float((np.asarray(t.fluxmap.mean) * t.areas).sum())
    p = np.array([power[True], power[False]]) / 4200.0
    sigma = math.sqrt(2 * p.mean() * (1 - p.mean()) / n)
    assert p.min() > 0.05 and abs(p[0] - p[1]) < 3 * sigma, (p, sigma)


def test_simulator_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device None means it")
    sim = _one_module(solar_simulator)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        sim.simulate(100, ray_batch=100)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        sim.modules[0].fire_lamp(torch.Generator(), 10)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        solar_simulator.SimulatorLampBader().generate_rays(
            torch.Generator(), 10)


# ------------------------------------------------------------------ meshes

def test_pyramid_intercepts_rays():
    """tests/models/test_triangulated.py:18: rays down onto the pyramid's
    faces hit, one beside it misses, one logical surface of 4 rows takes
    2 W; tracer_tpu's sids equal."""
    pos = np.array([[0.3, 0.0, 3.0], [0.0, -0.4, 3.0], [2.0, 2.0, 3.0]])
    d = np.tile([0.0, 0.0, -1.0], (3, 1))
    pres, jres = _trace("pyramid", pos, d, np.ones(3), 1)
    sid = pres.records[0].sid.numpy()
    assert (sid[:2] >= 0).all() and sid[2] == -1
    np.testing.assert_array_equal(sid, np.asarray(jres.records[0].sid))
    assert pres.absorbed_by_logical().shape == (1,)
    np.testing.assert_allclose(pres.absorbed_by_logical()[0], 2.0,
                               rtol=1e-12)


@pytest.mark.parametrize("gen,args", [
    ("cylinder_verts_faces", (1.0, 2.0, 12, 3, False)),
    ("cylinder_verts_faces", (0.5, 1.0, 48, 20, True)),
    ("disc_verts_faces", (1.0, 12, 3, 0.0)),
    ("disc_verts_faces", (1.0, 12, 3, 0.3)),
    ("rectangle_verts_faces", (2.0, 1.0, 3, 4))])
def test_mesh_generators_equal(gen, args):
    v, f = getattr(stl_utils, gen)(*args)
    jv, jf = getattr(jax_stl, gen)(*args)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(f, jf)


def test_stl_files_across_packages(tmp_path):
    """tests/models/test_triangulated.py:40: a binary STL written by
    either package is the same bytes and reloads in both with every
    triangle; an ASCII STL loads equal in both."""
    verts, faces = stl_utils.cylinder_verts_faces(1.0, 2.0, angbins=12,
                                                  lbins=3)
    a, b = str(tmp_path / "port.stl"), str(tmp_path / "jax.stl")
    stl_utils.make_stl(a, verts, faces)
    jax_stl.make_stl(b, verts, faces)
    assert open(a, "rb").read() == open(b, "rb").read()
    tri = np.sort(verts[faces].reshape(-1, 3), axis=0)
    for load in (stl_utils.load_stl, jax_stl.load_stl):
        v2, f2 = load(a)
        assert len(f2) == len(faces)
        np.testing.assert_allclose(np.sort(v2[f2].reshape(-1, 3), axis=0),
                                   tri, atol=1e-6)
    ascii_path = str(tmp_path / "ascii.stl")
    with open(ascii_path, "w") as f:
        f.write("solid pyramid\n")
        for face in PYRAMID_FACES:
            f.write(" facet normal 0 0 0\n  outer loop\n")
            for k in face:
                f.write("   vertex " + " ".join(
                    repr(float(c)) for c in PYRAMID_VERTS[k]) + "\n")
            f.write("  endloop\n endfacet\n")
        f.write("endsolid pyramid\n")
    v, fc = stl_utils.load_stl(ascii_path)
    jv, jfc = jax_stl.load_stl(ascii_path)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(fc, jfc)
    np.testing.assert_array_equal(v[fc], PYRAMID_VERTS[PYRAMID_FACES])


def test_stl_traced_across_packages(tmp_path):
    """tests/models/test_triangulated.py:48: a meshed plate written by
    tracer_tpu, loaded into the port's scene (one logical surface of 18
    triangle rows named after the file) absorbs every ray, as tracer_tpu's
    load of the port's file does, lane by lane."""
    verts, faces = stl_utils.rectangle_verts_faces(2.0, 2.0, nx=3, ny=3)
    a, b = str(tmp_path / "plate.stl"), str(tmp_path / "jplate.stl")
    jax_stl.make_stl(a, verts, faces)
    stl_utils.make_stl(b, verts, faces)
    obj = stl_utils.load_stl_into_tracer(a, ptt.materials.reflective(1.0))
    jobj = jax_stl.load_stl_into_tracer(b, tracer_tpu.materials.reflective(
        1.0))
    assert obj.surfaces[0].name == "plate.stl"
    assert len(obj.surfaces[0].geometries) == 18
    pe = TracerEngine(ptt.scene.Assembly(objects=[obj]), dtype=torch.float64,
                      device=CPU)
    je = JaxEngine(tracer_tpu.scene.Assembly(objects=[jobj]),
                   dtype=jnp.float64)
    n = 100
    rng = np.random.default_rng(1)
    pos = np.concatenate([rng.uniform(-0.9, 0.9, (n, 2)), np.ones((n, 1))],
                         axis=1)
    d = np.tile([0, 0, -1.0], (n, 1))
    pres = pe.ray_tracer(RayBundle.create(pos=pos, dir=d,
                                          dtype=torch.float64, device=CPU),
                         reps=1)
    jres = je.ray_tracer(JaxBundle.create(pos=jnp.asarray(pos),
                                          dir=jnp.asarray(d)), reps=1,
                         key=jax.random.PRNGKey(2))
    assert (pres.records[0].sid.numpy() >= 0).all()
    np.testing.assert_allclose(pres.absorbed_by_logical().sum(), n,
                               rtol=1e-9)
    np.testing.assert_allclose(pres.records[0].hit.numpy(),
                               np.asarray(jres.records[0].hit), atol=1e-12)


def test_stl_cylinder_hit_share():
    """The STL receiver of chip_smoke's phase 16 at a small size: a
    48-gon cylinder wall (1,920 rows) under rays perpendicular to its axis
    over a window 1.2 m wide: every ray that meets the mesh meets the
    wall, and the hit share is the 48-gon's projected width over 1.2 m
    within 3 binomial sigma; the float32 trace (K3's plain version) hits
    the same rows as the float64 oracle but on edge ties."""
    verts, faces = stl_utils.cylinder_verts_faces(0.5, 1.0, angbins=48,
                                                  lbins=20)
    assert (len(verts), len(faces)) == (1008, 1920)
    obj = stl_utils.make_stl_tracer_object(
        verts, faces, ptt.materials.receiver(ptt.materials.absorber()),
        name="cad")
    asm = ptt.scene.Assembly(objects=[obj])
    n = 4096
    rng = np.random.default_rng(7)
    pos = np.stack([np.full(n, -2.0), rng.uniform(-0.6, 0.6, n),
                    rng.uniform(-0.45, 0.45, n)], 1)
    d = np.tile([1.0, 0.0, 0.0], (n, 1))
    width = verts[:, 1].max() - verts[:, 1].min()
    share = {}
    sids = {}
    for dt in (torch.float64, torch.float32):
        eng = TracerEngine(asm, dtype=dt, device=CPU)
        res = eng.ray_tracer(RayBundle.create(pos=pos, dir=d, dtype=dt,
                                              device=CPU), reps=2)
        assert eng.scene.num_rows == 1920
        sids[dt] = res.records[0].sid.numpy()
        share[dt] = float((sids[dt] >= 0).mean())
        bal = res.energy_balance()
        assert abs(bal["closure"]) < 1e-5 * bal["source"]
    p = width / 1.2
    assert abs(share[torch.float64] - p) < 3 * math.sqrt(p * (1 - p) / n)
    differ = sids[torch.float64] != sids[torch.float32]
    assert differ.sum() <= 0.01 * n


def test_hits_of_keys_pick_fields():
    """hits_of(surface, keys=...) returns the picked fields (and the
    bounce index) equal to the full query's, and refuses a field that no
    record holds."""
    pos, d, e = _sun(2000, [0, 0, 10.0], 3.0, 5)
    pres, _ = _trace("petal", pos, d, e, 20)
    full = pres.hits_of("receiver")
    some = pres.hits_of("receiver", keys=("local", "e_in"))
    assert set(some) == {"local", "e_in", "bounce"}
    for k in some:
        np.testing.assert_array_equal(some[k], full[k])
    with pytest.raises(KeyError):
        pres.hits_of("receiver", keys=("spectra",))
