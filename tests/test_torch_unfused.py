"""The unfused shade, the optics helpers and the volumetric bounce against
tracer_tpu on the CPU, float64.

* the optics helpers (Fresnel against absorbing media and conductors,
  Hartmann dispersion, Beer-Lambert attenuation, the real-index
  reflectance) equal tracer_tpu's to 1e-12; the free-path sampler's mean
  is 1 / sigma within 3 standard errors;
* ``shade`` on a row of plates, one optics per plate, every kind and
  feature of materials.K_*: lanes whose outcome draws nothing equal
  tracer_tpu's to 1e-9 (the spectral, IAM, conductor and piecewise
  absorptances, periodic teleports, transparent rows, the energy split and
  its reflected branch, the medium toggle of index-matched interfaces);
  the random ones (Lambertian lobes, Cook-Torrance, frosted glass) by the
  means of their absorbed share and outgoing cosine within 3 combined
  standard errors; the roulette's reflected share within 3 binomial sigma
  of the mean Fresnel R; the aux branch (K3's shading data, its plain
  version run in float64) equal to the gather branch on the same lanes
  and draws;
* the volumetric bounce: Beer-Lambert through an absorbing slab against
  the analytic transmission, and tests/test_volumetrics.py's mean free
  path and Henyey-Greenstein forward bias within 3 sigma.
"""
import importlib
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
from tracer_tpu_torch import optics
from tracer_tpu_torch.kernels import intersect as ki
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.kernels.bounce import pack_rows
from tracer_tpu_torch.kernels.shade import shade

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

F64 = torch.float64


def _t(a):
    return torch.tensor(np.asarray(a), dtype=F64)


# ---------------------------------------------------------------------------
# optics helpers
# ---------------------------------------------------------------------------

def test_optics_helpers_match_jax():
    rng = np.random.default_rng(0)
    n = 512
    th = rng.uniform(0.0, 1.5, n)
    n2, k2 = rng.uniform(0.1, 3.0, n), rng.uniform(0.0, 8.0, n)
    m2 = n2 + 1j * k2
    want = jax_optics.fresnel_to_attenuating(1.2, jnp.asarray(m2),
                                             jnp.asarray(th))
    for arg in ((_t(n2), _t(k2)), torch.tensor(m2)):
        got = optics.fresnel_to_attenuating(1.2, arg, _t(th))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                       atol=1e-15)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nrm = rng.normal(size=(n, 3))
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    got = optics.fresnel_conductor(_t(d), _t(nrm), (_t(n2), _t(k2)), 1.1)
    want = jax_optics.fresnel_conductor(jnp.asarray(d), jnp.asarray(nrm),
                                        jnp.asarray(m2), 1.1)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-15)
    wl = rng.uniform(4e-7, 8e-7, n)
    hart = (1.5, 1e-8, 1e-7, 2e-9, 5e-8)
    np.testing.assert_allclose(
        optics.refr_idx_hartmann(_t(wl), *hart).numpy(),
        np.asarray(jax_optics.refr_idx_hartmann(jnp.asarray(wl), *hart)),
        rtol=1e-12)
    path, e = rng.uniform(0.0, 2.0, n), rng.uniform(0.5, 2.0, n)
    np.testing.assert_allclose(
        optics.attenuations(_t(path), 1e-7, 5e-7, _t(e)).numpy(),
        np.asarray(jax_optics.attenuations(jnp.asarray(path), 1e-7, 5e-7,
                                           jnp.asarray(e))), rtol=1e-12)
    np.testing.assert_allclose(
        optics.R_from_n_k(1.0, 1.5, _t(th)).numpy(),
        np.asarray(jax_optics.R_from_n_k(1.0, 1.5, jnp.asarray(th))),
        rtol=1e-12)


def test_sample_scattering_free_paths():
    """Mean free path 1 / sigma within 3 standard errors; lanes without
    scattering take the intersection distance and never scatter; no
    infinite path."""
    n, sigma = 40_000, 2.0
    g = torch.Generator().manual_seed(3)
    sig = torch.where(torch.arange(n) % 4 == 0, 0.0, sigma).to(F64)
    t_hit = torch.full((n,), 0.7, dtype=F64)
    t_hit[1::2] = math.inf
    scat, s = optics.sample_scattering(g, sig, t_hit)
    assert torch.isfinite(s[sig > 0]).all()
    assert not scat[sig <= 0].any()
    assert torch.equal(s[sig <= 0], t_hit[sig <= 0])
    free = s[(sig > 0) & torch.isinf(t_hit)]
    assert abs(float(free.mean()) - 1 / sigma) <= 3 / sigma / math.sqrt(
        free.numel())
    assert torch.equal(scat, s < t_hit)


# ---------------------------------------------------------------------------
# shade: a row of plates, one optics each
# ---------------------------------------------------------------------------

_PW_TH = [0.0, 0.5, 1.0, 0.5 * np.pi]


def _spectral(pkg):
    wls = np.linspace(4e-7, 8e-7, 9)
    return pkg.materials.reflective_spectral(0.05 + 0.8 * (wls - 4e-7) / 4e-7,
                                             wls)


def _silver(pkg):
    oc = importlib.import_module(f"{pkg.__name__}.optical_constants")
    return pkg.materials.fresnel_conductor_homogenous(
        1.0, oc.from_sopra("AG"))


# name -> (optics builders, wavelength band, split_mode, deterministic
# plates (every output), plates whose absorbed share is deterministic)
CASES = {
    "iam_mixed": ((lambda p: p.materials.iam(p.materials.reflective(0.1),
                                             1.0, c=1.0),
                   lambda p: p.materials.iam(p.materials.reflective(0.2),
                                             0.5, c=2.0),
                   lambda p: p.materials.iam(p.materials.lambertian(0.3),
                                             0.8, c=1.5)),
                  None, False, (0, 1), (2,)),
    "spectral": ((_spectral, lambda p: p.materials.reflective(0.1)),
                 (3.5e-7, 8.5e-7), False, (0, 1), ()),
    "conductor": ((_silver, lambda p: p.materials.fresnel_conductor_homogenous(
        1.0, 0.2 + 3.0j)), (3e-7, 2.5e-6), False, (0, 1), ()),
    "periodic_transparent": ((lambda p: p.materials.periodic_boundary(2.0),
                              lambda p: p.materials.transparent(),
                              lambda p: p.materials.absorber()),
                             None, False, (0, 1, 2), ()),
    "split": ((lambda p: p.materials.refractive_homogenous(
        1.0, 1.5, single_ray=False, att2=0.2),
               lambda p: p.materials.refractive_homogenous(
        1.0, 1.3, single_ray=False)), None, True, (0, 1), ()),
    "dispersive_split": ((lambda p: p.materials.refractive_material(
        1.0, ([4e-7, 7e-7], [1.6, 1.4]), single_ray=False),),
                         (3.5e-7, 7.5e-7), True, (0,), ()),
    "media_toggle": ((lambda p: p.materials.scattering_interface(
        0.3, g=0.5, att_inside=0.1),
                      lambda p: p.materials.absorbant_interface(0.2)),
                     None, False, (0, 1), ()),
    "lambertian_family": ((lambda p: p.materials.lambertian(0.3),
                           lambda p: p.materials.lambertian(
                               0.2, ang_range=0.5, one_sided=True),
                           lambda p: p.materials.lambertian_specular(0.2, 0.4),
                           lambda p: p.materials.semi_lambertian(
                               0.25, ang_range=1.0)),
                          None, False, (), (0, 1, 2, 3)),
    "piecewise": ((lambda p: p.materials.lambertian_directional_piecewise(
        _PW_TH, [0.1, 0.2, 0.4, 0.9], specularity=0.3),
                   lambda p: p.materials.lambertian_directional_piecewise(
        _PW_TH, [0.2, 0.3, 0.3, 0.6], specularity=[0.1, 0.2, 0.5, 0.8]),
                   lambda p: p.materials
                   .lambertian_directional_spectral_piecewise(
        [0.0, 0.8, 0.5 * np.pi], [4e-7, 6e-7, 8e-7],
        [[0.1, 0.2, 0.3], [0.3, 0.4, 0.5], [0.6, 0.8, 0.9]])),
                  (4e-7, 8e-7), False, (), (0, 1, 2)),
    "cook_torrance": ((lambda p: p.materials.bdrf_cook_torrance(
        0.3, 1.2, 7.0, 0.9),), None, False, (), ()),
    "frosted_split": ((lambda p: p.materials.refractive_homogenous(
        1.0, 1.5, sigma=0.05, single_ray=False),), None, True, (), ()),
    "roulette": ((lambda p: p.materials.refractive_homogenous(1.0, 1.5),),
                 None, False, (), (0,)),
}


def zoo(builders):
    """build(pkg): one round plate of radius 0.5 per optics, at x = 2 i."""
    def build(pkg):
        return pkg.Assembly([pkg.AssembledObject([
            pkg.Surface(pkg.geometry.round_plate(0.5), b(pkg),
                        location=[2.0 * i, 0.0, 0.0], name=f"p{i}")
            for i, b in enumerate(builders)])]), ()
    return build


def zoo_lanes(n_plates: int, n: int, seed: int, band, inside: bool):
    """Rays aimed at a random point of a random plate from above or
    below, 0.05-1.3 rad off the axis, from 1 m away; their wavelength in
    ``band`` (else 0), energy in [0.5, 2], index 1 and, with ``inside``,
    half of them in the medium (0.1, 0.3, 0.5) of the toggle case."""
    rng = np.random.default_rng(seed)
    plate = rng.integers(0, n_plates, n)
    r = 0.4 * np.sqrt(rng.uniform(size=n))
    a = rng.uniform(0.0, 2.0 * np.pi, n)
    pts = np.stack([2.0 * plate + r * np.cos(a), r * np.sin(a),
                    np.zeros(n)], axis=1)
    th = rng.uniform(0.05, 1.3, n)
    ph = rng.uniform(0.0, 2.0 * np.pi, n)
    down = np.where(rng.uniform(size=n) < 0.5, -1.0, 1.0)
    d = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph),
                  down * np.cos(th)], axis=1)
    wl = (rng.uniform(*band, n) if band is not None else np.zeros(n))
    med = np.zeros((3, n))
    if inside:
        med[:, rng.uniform(size=n) < 0.5] = np.array([[0.1], [0.3], [0.5]])
    return dict(pos=pts - d, dirs=d, e=rng.uniform(0.5, 2.0, n), wl=wl,
                ri=np.ones(n), med=med, plate=plate)


def _shade(builders, lanes, split_mode, branch="gather", gen_seed=0):
    """The port's shade (float64) of the zoo of ``builders`` on ``lanes``,
    nearest hits from the oracle (``branch`` "gather") or K3's plain
    version with its aux ("aux"). Returns (t, sid, result)."""
    asm, _ = zoo(builders)(ptt)
    pt, _ = ptt.compile_scene(asm, dtype=F64, device="cpu")
    pos, dirs = _t(lanes["pos"]), _t(lanes["dirs"])
    if branch == "gather":
        t, sid = ki.nearest_hit(pt, pos, dirs)
        aux = None
    else:
        t, sid, aux = kn.nearest_hit_ref(pack_rows(pt, F64), pos, dirs,
                                         pt.groups, 1e-6)
    res = shade(pt, sid, t, pos, dirs, _t(lanes["e"]), _t(lanes["wl"]),
                _t(lanes["ri"]), torch.Generator().manual_seed(gen_seed),
                medium=tuple(_t(m) for m in lanes["med"]), aux=aux,
                split_mode=split_mode)
    return t, sid, res


def _shade_case(name, n=6000, **kw):
    builders, band, split_mode, _, _ = CASES[name]
    lanes = zoo_lanes(len(builders), n, 0, band, name == "media_toggle")
    return (lanes, *_shade(builders, lanes, split_mode, **kw))


def _jax_case(name, lanes, t, sid):
    builders, _, split_mode, _, _ = CASES[name]
    jasm, _ = zoo(builders)(tracer_tpu)
    jt, _ = tracer_tpu.compile_scene(jasm, dtype=jnp.float64)
    j = {k: jnp.asarray(v) for k, v in lanes.items()}
    return jax_shade(jt, jnp.asarray(sid.numpy()), jnp.asarray(t.numpy()),
                     j["pos"], j["dirs"], j["e"], j["wl"], j["ri"],
                     jax.random.PRNGKey(1), medium=tuple(j["med"]),
                     split_mode=split_mode)


def _fields(res):
    """The shade result's per-lane arrays, by name."""
    out = {k: np.asarray(getattr(res, k)) for k in (
        "out_pos", "out_dir", "out_energy", "out_ref_index", "absorbed",
        "local_pt", "normal", "backside")}
    for k, m in zip(("att", "scat", "g"), res.out_medium):
        out[k] = np.asarray(m)
    if res.split is not None:
        for k, v in zip(("s_mask", "s_e", "s_dir"), res.split):
            out[k] = np.asarray(v)
    return out


def _moments(f, lanes, on):
    """(absorbed share, outgoing cosine with the shading normal) of the
    lanes ``on``."""
    a = f["absorbed"][on] / lanes["e"][on]
    c = (f["out_dir"][on] * f["normal"][on]).sum(1)
    return a, c


@pytest.mark.parametrize("name", sorted(CASES))
def test_shade_kind_matches_jax(name):
    """Every kind and feature against tracer_tpu's shade (float64): the
    deterministic lanes to 1e-9, the random ones by their means."""
    det, share = CASES[name][3:]
    lanes, t, sid, res = _shade_case(name)
    hit = sid.numpy() >= 0
    assert hit.mean() > 0.99
    got = _fields(res)
    want = _fields(_jax_case(name, lanes, t, sid))
    assert set(got) == set(want)
    plate = lanes["plate"]
    for i in range(len(CASES[name][0])):
        on = hit & (plate == i)
        assert on.sum() > 300
        keys = (tuple(got) if i in det
                else ("absorbed", "local_pt", "normal", "backside")
                if i in share else ("local_pt", "normal", "backside"))
        for k in keys:
            np.testing.assert_allclose(got[k][on], want[k][on], rtol=1e-9,
                                       atol=1e-12, err_msg=f"{name} {i} {k}")
        if i in det:
            continue
        for g_m, w_m in zip(_moments(got, lanes, on),
                            _moments(want, lanes, on)):
            se = math.sqrt((g_m.var() + w_m.var()) / on.sum()) + 1e-12
            assert abs(g_m.mean() - w_m.mean()) <= 3 * se, (name, i)
    if name == "split":
        # the branch takes R E and leaves nothing absorbed
        assert got["s_mask"][hit].all()
        assert (got["absorbed"][hit] == 0.0).all()
    if name == "media_toggle":
        # index-matched: every lane crosses into the other medium
        inside = lanes["med"][0] > 0
        assert (got["att"][hit & ~inside] > 0).all()
        assert (got["att"][hit & inside] == 0).all()


def test_roulette_share_matches_fresnel():
    """The roulette reflects within 3 binomial sigma of the lanes' mean
    Fresnel R, which the split mode's branch energy gives lane by lane
    (held against tracer_tpu in test_shade_kind_matches_jax)."""
    lanes, _, sid, res = _shade_case("roulette", n=20_000)
    _, sid2, split = _shade(
        (lambda p: p.materials.refractive_homogenous(1.0, 1.5,
                                                     single_ray=False),),
        lanes, True)
    assert torch.equal(sid, sid2)
    hit = (sid >= 0).numpy()
    R = (split.split[1] / _t(lanes["e"])).numpy()[hit]
    reflected = ((res.out_dir * res.normal).sum(1) > 0).numpy()[hit]
    sigma = math.sqrt((R * (1 - R)).sum()) / hit.sum()
    assert abs(reflected.mean() - R.mean()) <= 3 * sigma
    assert 0.03 < R.mean() < 0.3


@pytest.mark.parametrize("name", ("iam_mixed", "spectral", "conductor",
                                  "split", "dispersive_split", "piecewise",
                                  "cook_torrance", "frosted_split",
                                  "lambertian_family"))
def test_aux_branch_equals_gather(name):
    """K3's aux (its plain version in float64) gives the shade the same
    outputs as the row gather, on the same lanes and draws: the kinds
    that read parameters past p0 and p1 gather their row there."""
    builders, band, split_mode = CASES[name][:3]
    lanes = zoo_lanes(len(builders), 6000, 0, band, False)
    _, sid, got = _shade(builders, lanes, split_mode, "aux", 5)
    _, sid_g, want = _shade(builders, lanes, split_mode, "gather", 5)
    assert torch.equal(sid, sid_g)
    hit = sid.numpy() >= 0
    g, w = _fields(got), _fields(want)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_allclose(g[k][hit], w[k][hit], rtol=1e-9,
                                   atol=1e-12, err_msg=k)


# ---------------------------------------------------------------------------
# the volumetric bounce (tests/test_volumetrics.py's scenes on the port)
# ---------------------------------------------------------------------------

def slab_scene(entry):
    """tests/test_volumetrics.py's slab_scene on the port: the interface
    ``entry`` at z = 1 and z = 0 (10 x 10 m), a receiving absorber at
    z = -5."""
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    return sc.Assembly([
        sc.AssembledObject([sc.Surface(G.rect_plate(10.0, 10.0), entry,
                                       location=[0.0, 0.0, 1.0],
                                       name="entry")]),
        sc.AssembledObject([sc.Surface(G.rect_plate(10.0, 10.0), entry,
                                       name="exit")]),
        sc.AssembledObject([sc.Surface(G.rect_plate(10.0, 10.0),
                                       M.receiver(M.reflective(1.0)),
                                       location=[0.0, 0.0, -5.0],
                                       name="det")])])


def _beam(n):
    return ptt.RayBundle.create(torch.tensor([[0.1, 0.2, 2.0]]).repeat(n, 1),
                                torch.tensor([[0.0, 0.0, -1.0]]).repeat(n, 1),
                                dtype=F64, device="cpu")


def test_beer_lambert_slab():
    """A 1 m slab of attenuation 0.7 / m transmits exp(-0.7) to the
    receiver; the medium takes the rest; closure ~0 (float64)."""
    att, n = 0.7, 1000
    eng = ptt.TracerEngine(slab_scene(ptt.materials.absorbant_interface(att)),
                           dtype=F64, device="cpu")
    res = eng.ray_tracer(_beam(n), reps=10)
    np.testing.assert_allclose(res.hits_of("det")["absorbed"].sum() / n,
                               np.exp(-att), rtol=1e-9)
    bal = res.energy_balance()
    np.testing.assert_allclose(bal["medium"] / n, 1.0 - np.exp(-att),
                               rtol=1e-9)
    assert abs(bal["closure"]) < 1e-9 * n


def test_scattering_free_path_and_hg_bias():
    """In a 1 m scattering slab the share that reaches the far face
    unscattered is exp(-sigma L) within 3 binomial sigma (sigma 1.5); with
    g = 0.7 (sigma 5) the scattered rays' mean cosine to their travel
    direction is g within 3 standard errors, as tracer_tpu's
    tests/test_volumetrics.py asserts to 0.01 and 0.05."""
    n = 20_000
    M = ptt.materials
    eng = ptt.TracerEngine(slab_scene(M.scattering_interface(1.5)),
                           dtype=F64, device="cpu")
    res = eng.ray_tracer(_beam(n), reps=2,
                         generator=torch.Generator().manual_seed(1))
    rec = res.records[1]
    alive = rec.alive_in.numpy()
    reached = np.isin(rec.sid.numpy(), res._rows_of("exit")) & alive
    p = math.exp(-1.5)
    assert abs(reached.sum() / alive.sum() - p) <= 3 * math.sqrt(
        p * (1 - p) / alive.sum())
    assert abs(res.energy_balance()["closure"]) < 1e-9 * n
    g = 0.7
    eng = ptt.TracerEngine(slab_scene(M.scattering_interface(5.0, g=g)),
                           dtype=F64, device="cpu")
    res = eng.ray_tracer(_beam(n), reps=3,
                         generator=torch.Generator().manual_seed(2))
    r1, r2 = res.records[1], res.records[2]
    scat = (r1.sid.numpy() < 0) & r2.alive_in.numpy()
    assert scat.sum() > 10_000
    cos = (r1.dir_in.numpy()[scat] * r2.dir_in.numpy()[scat]).sum(1)
    assert abs(cos.mean() - g) <= 3 * cos.std() / math.sqrt(scat.sum())
