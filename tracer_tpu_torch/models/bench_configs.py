"""Bench configurations 1-3 and 6-8 of the repo's suite
(benchmarks/suite.py:77, :142, :189, :267, :360, :432), built with the
port's host API.

1. the TAU MiniDish rotated by -pi/4 under a pillbox disk sun;
2. a 2 m, f = 1.5 m dish with 2 mrad bivariate slope error over a 0.1 m
   one-sided Lambertian absorber, under a pillbox disk sun;
3. a 1 m silver mirror (spectral absorptance from silver's n,k table,
   1 mrad slope error) tilted pi/8 toward a 0.6 m absorber, under a Buie
   sun with a wavelength band, in a 0.3/m attenuating medium;
6. a 0.5 m spherical glass lens (n 1.5, R1 0.3 m, R2 -0.3 m, 2 cm thick,
   single-ray Fresnel roulette) over a two-sided 0.3 m receiver at its
   focal plane, under a 0.1 m pillbox beam (the suite's megakernel
   variant);
7. a 1 x 1 m Cook-Torrance target (alpha 0.3, m 1.2 + 7i, R_lam 0.9)
   scattering into an absorbing two-sided 3 m hemisphere, under a 0.4 m
   pillbox beam tilted 0.2 off the axis;
8. a closed 6 x 6 x 4 m box of six Lambertian walls (absorptivity 0.7)
   filled with a Henyey-Greenstein medium (attenuation 0.15/m,
   scattering 0.4/m, g 0.6) declared by the source spec;
"8b". the same box with the medium bounded between two index-matched
   scattering_interface sheets at z = 1 and 3 m (suite.py:517: per-lane
   medium ids), under a source without an ambient medium;
"6s". config 6's lens with energy-splitting interfaces (single_ray=False)
   over the same receiver, the suite's "split stream" (suite.py:338-351);
"7g". config 7's scene glazed: a flat 1.2 x 1.2 m glass cover (n 1 | 1.5,
   roulette) at z = -1 m between the beam and the target;
9. one gradient step of the spot-RMS loss on a 2 m, f = 2 m dish
   (absorptivity 0.05) with a 0.5 m Lambertian receiver at its focus,
   under an annular beam, with respect to the focal length
   (suite.py:569-644: diff_gradient_step and config9_diff_gradient);
"9b". one gradient step of the receiver spot-RMS loss through the
   219-row NSTTF table with respect to a global beam tilt
   (suite.py:647-683): the differentiable bounce's fast winner, K3 under
   no_grad.

Configs 9 and 9b run diff.trace_diff under torch.autograd
(:func:`diff_gradient_step`, :func:`field_gradient_step`). The others run
the plain streaming megakernel, ``engine.trace_streaming``
without culling, but "6s": a scene with energy-splitting interfaces
streams on the general path, with or without a spec (the suite traces it
without, :func:`without_spec`); config 7's source without its spec runs
the general streaming path too, as the suite's second measurement of it
does. The assembly and spec builders take the package they
build with (``pkg``): this package, or tracer_tpu, whose host API is the
same, so a parity test can build both twins from one definition. This
module never imports tracer_tpu: a caller that wants it passes it in.
"""
from __future__ import annotations

import importlib
import statistics
import time

import numpy as np
import torch

import tracer_tpu_torch as ptt

# the sun's centre, direction, radius, pillbox half-angle or Buie CSR, the
# ambient medium (attenuation [1/m]; HG scattering [1/m] and asymmetry),
# the trace's per-ray bounce budget, and its round budget (a, b): the
# suite's max_rounds = a * emission rounds + b
_D = 1.0 / np.sqrt(2.0)
_BOX = dict(center=[0.0, 0.0, 3.7], direction=[0.0, 0.0, -1.0],
            radius=1.5, ang_range=0.2, max_path=24, round_budget=(24, 200))
BENCH = {
    1: dict(center=[0.0, 7.0, 7.0], direction=[0.0, -_D, -_D], radius=3.0,
            ang_range=0.005, max_path=20, round_budget=(4, 80)),
    2: dict(center=[0.0, 0.0, 3.0], direction=[0.0, 0.0, -1.0],
            radius=1.05, ang_range=4.65e-3, max_path=20,
            round_budget=(4, 80)),
    3: dict(center=[0.0, 0.0, 2.0], direction=[0.0, 0.0, -1.0],
            radius=0.95, csr=0.02, att=0.3, max_path=8,
            round_budget=(4, 80)),
    6: dict(center=[0.0, 0.0, 0.5], direction=[0.0, 0.0, -1.0],
            radius=0.1, ang_range=1e-4, max_path=20, round_budget=(8, 80)),
    7: dict(center=[0.0, 0.0, -2.0], direction=[0.0, 0.2, 0.98],
            radius=0.4, ang_range=1e-3, max_path=20, round_budget=(8, 80)),
    8: dict(_BOX, att=0.15, scat=0.4, g=0.6),
    "8b": dict(_BOX, medium=dict(scat=0.4, g=0.6, att=0.15)),
}
BENCH["6s"] = dict(BENCH[6])
BENCH["7g"] = dict(BENCH[7])
BENCH_FLUX = 1000.0


def _mod(pkg, name):
    return importlib.import_module(f"{pkg.__name__}.{name}")


def silver_table(pkg):
    """Config 3's mirror: wavelengths (32 over the table's part of 350 nm -
    2.4 um) and silver's normal-incidence absorptance 1 - R(n, k)."""
    mat = _mod(pkg, "optical_constants").from_sopra("AG")
    wls = np.linspace(max(350e-9, mat.l_min), min(2400e-9, mat.l_max), 32)
    m = mat.m(wls)
    n, k = m.real, np.abs(m.imag)
    return wls, 1.0 - ((n - 1.0) ** 2 + k ** 2) / ((n + 1.0) ** 2 + k ** 2)


def bench_assembly(pkg, cfg):
    """(assembly, extra compile features) of bench configuration ``cfg``,
    built with the package ``pkg``."""
    G, M, sp, sc = (_mod(pkg, m)
                    for m in ("geometry", "materials", "spatial", "scene"))
    if cfg == 1:
        asm = _mod(pkg, "models.tau_minidish").MiniDish(
            5.0, 6.25, 0.9, 6.95, 0.4, 0.7, 0.9)
        asm.set_transform(sp.rotx(-np.pi / 4))
        return asm, ()
    if cfg == 2:
        dish = sc.Surface(G.parabolic_dish(2.0, 1.5),
                          M.reflective(0.1, sigma=2e-3, bi_var=True,
                                       one_sided=True), name="dish")
        rec = sc.Surface(G.round_plate(0.10),
                         M.detector(M.lambertian(0.9, one_sided=True)),
                         name="rec", location=[0.0, 0.0, 1.5],
                         rotation=sp.rotx(np.pi)[:3, :3])
        return sc.Assembly([sc.AssembledObject([dish, rec])]), ()
    if cfg in (6, "6s"):
        lens = _mod(pkg, "models.spherical_lens").SphericalLens(
            diameter=0.5, depth=0.02, R1=0.3, R2=-0.3, refr_idx=1.5,
            single_ray=cfg == 6)
        rec = sc.Surface(G.round_plate(0.3), M.absorber(one_sided=False),
                         location=[0.0, 0.0, -lens.focal_length()],
                         name="rec")
        return sc.Assembly([lens, sc.AssembledObject([rec])]), ()
    if cfg in (7, "7g"):
        target = sc.Surface(G.rect_plate(1.0, 1.0),
                            M.bdrf_cook_torrance(0.3, 1.2, 7.0, 0.9),
                            name="target")
        dome = sc.Surface(G.hemisphere(3.0), M.absorber(one_sided=False),
                          name="dome")
        surfs = [target, dome]
        if cfg == "7g":
            surfs.append(sc.Surface(G.rect_plate(1.2, 1.2),
                                    M.refractive_homogenous(1.0, 1.5),
                                    location=[0.0, 0.0, -1.0],
                                    name="cover"))
        return sc.Assembly([sc.AssembledObject(surfs)]), ()
    if cfg in (8, "8b"):
        return _box(G, M, sp, sc, cfg)
    wls, abss = silver_table(pkg)
    mirror = sc.Surface(G.round_plate(1.0),
                        M.reflective_spectral(abss, wls, sigma=1e-3),
                        rotation=sp.rotx(-np.pi / 8)[:3, :3], name="mirror")
    refl = np.array([0.0, np.sin(np.pi / 4), np.cos(np.pi / 4)])
    rec = sc.Surface(G.round_plate(0.6), M.absorber(), name="rec",
                     location=(1.6 * refl).tolist(),
                     rotation=sp.rotation_to_z(-refl))
    return sc.Assembly([sc.AssembledObject([mirror, rec])]), ("volumetric",)


def _box(G, M, sp, sc, cfg):
    """Config 8's enclosure: floor, ceiling and four walls, all Lambertian
    with absorptivity 0.7; "8b" adds the two medium-bounding sheets
    (suite.py:449-535)."""
    def lam():
        return M.lambertian(absorptivity=0.7)
    surfs = [sc.Surface(G.rect_plate(6.0, 6.0), lam(), name="floor"),
             sc.Surface(G.rect_plate(6.0, 6.0), lam(), location=[0, 0, 4.0],
                        name="ceil")]
    if cfg == "8b":
        m = BENCH[cfg]["medium"]
        surfs += [sc.Surface(G.rect_plate(6.0, 6.0),
                             M.scattering_interface(m["scat"], g=m["g"],
                                                    att_inside=m["att"]),
                             location=[0, 0, z], name=name)
                  for z, name in ((3.0, "m1"), (1.0, "m2"))]
    # roty walls: local x -> global z (4 tall); rotx walls: local x stays
    # global x (6 wide), local y -> global z (4 tall)
    for i, (x, y, w, h, rot) in enumerate([
            (3.0, 0.0, 4.0, 6.0, sp.roty(np.pi / 2)),
            (-3.0, 0.0, 4.0, 6.0, sp.roty(-np.pi / 2)),
            (0.0, 3.0, 6.0, 4.0, sp.rotx(-np.pi / 2)),
            (0.0, -3.0, 6.0, 4.0, sp.rotx(np.pi / 2))]):
        surfs.append(sc.Surface(G.rect_plate(w, h), lam(),
                                location=[x, y, 2.0], rotation=rot[:3, :3],
                                name=f"wall{i}"))
    extra = ("volumetric",) if cfg == 8 else ()
    return sc.Assembly([sc.AssembledObject(surfs)]), extra


def max_rounds(cfg, rounds: int) -> int:
    """The suite's round budget of configuration ``cfg`` for ``rounds``
    emission rounds."""
    a, b = BENCH[cfg]["round_budget"]
    return a * rounds + b


def bench_spec(pkg, cfg, slab: int):
    """The static source spec of bench configuration ``cfg``, built with
    the package ``pkg``: a pillbox disk (config 8's with its ambient
    medium) or a Buie disk with config 3's band and attenuation."""
    src, c = _mod(pkg, "sources"), BENCH[cfg]
    if cfg == 3:
        wls = silver_table(pkg)[0]
        return src.buie_sunshape_pallas_spec(
            slab, c["center"], c["direction"], c["radius"], c["csr"],
            BENCH_FLUX, wl_band=(float(wls[0]), float(wls[-1])),
            ambient_att=c["att"])
    return src.disk_pillbox_pallas_spec(
        slab, c["center"], c["direction"], c["radius"], c["ang_range"],
        BENCH_FLUX, ambient_att=c.get("att", 0.0),
        ambient_scat=c.get("scat", 0.0), ambient_g=c.get("g", 0.0))


def bench_scene(cfg, slab: int, device=None, dtype=torch.float32):
    """(table, meta, source_fn) of bench configuration ``cfg`` on the port,
    on the GPU unless ``device`` says otherwise, the table in ``dtype``
    (a float64 table streams on the general path): ``source_fn(generator,
    device=None)`` draws a float32 slab of the rays its ``pallas_spec``
    regenerates, and ``num_rays`` is the slab."""
    asm, extra = bench_assembly(ptt, cfg)
    table, meta = ptt.compile_scene(asm, extra_features=extra, dtype=dtype,
                                    device=device)
    spec = bench_spec(ptt, cfg, slab)
    c = BENCH[cfg]

    def source_fn(generator, device=None):
        if cfg != 3:
            b = ptt.sources.disk_bundle(
                generator, slab, c["center"], c["direction"], c["radius"],
                c["ang_range"], flux=BENCH_FLUX, device=device)
            if cfg != 8:
                return b
            return b.replace(
                att_coeff=torch.full_like(b.energy, c["att"]),
                scat_coeff=torch.full_like(b.energy, c["scat"]),
                scat_g=torch.full_like(b.energy, c["g"]))
        b = ptt.sources.buie_sunshape(generator, slab, c["center"],
                                      c["direction"], c["radius"], c["csr"],
                                      flux=BENCH_FLUX, device=device)
        lo, hi = spec[13]
        wl = lo + (hi - lo) * torch.rand(slab, generator=generator)
        return b.replace(wavelength=wl.to(b.pos.device),
                         att_coeff=torch.full_like(b.energy, c["att"]))

    source_fn.pallas_spec = spec
    source_fn.num_rays = slab
    return table, meta, source_fn


def without_spec(source_fn):
    """``source_fn`` without its ``pallas_spec``: trace_streaming then
    draws its slab every round on the general path."""
    def general(generator, device=None):
        return source_fn(generator, device=device)
    general.num_rays = source_fn.num_rays
    return general


def _cast(b, dtype, device):
    """A bundle's float fields in ``dtype`` on ``device``."""
    b = b.to(device)
    return b.replace(**{f: getattr(b, f).to(dtype) for f in
                        ("pos", "dir", "energy", "wavelength", "ref_index",
                         "att_coeff", "scat_coeff", "scat_g")})


def dish_beam(n_rays: int, dtype=torch.float32, device=None):
    """Config 9's annular beam (R 0.95 to 0.45 m, 5 m above the dish,
    1e-4 rad, 1 kW/m^2), seed 9."""
    return ptt.sources.disk_bundle(
        torch.Generator().manual_seed(9), n_rays, center=[0.0, 0.0, 5.0],
        direction=[0.0, 0.0, -1.0], radius=0.95, radius_in=0.45,
        ang_range=1e-4, flux=1000.0, dtype=dtype, device=device)


def diff_gradient_step(n_rays: int, bounces: int = 3,
                       checkpoint: bool = True, dtype=torch.float32,
                       device=None, beam=None):
    """Config 9's step (benchmarks/suite.py:569): ``step(f)`` returns the
    spot-RMS loss of the dish's receiver and its gradient with respect to
    the focal length ``f`` (a float), by trace_diff and
    torch.autograd.grad (:func:`_grad_step`). The beam (seed 9, or
    ``beam`` cast to ``dtype`` on the scene's device) and the trace's seed
    (10) are fixed, so every call traces the same realization. Returns
    (step, scene, beam)."""
    G, M, sp, sc = (_mod(ptt, m)
                    for m in ("geometry", "materials", "spatial", "scene"))
    from .. import diff
    f0 = 2.0
    dish = sc.Surface(G.parabolic_dish(2.0, f0), M.reflective(0.05),
                      name="dish")
    recv = sc.Surface(G.rect_plate(0.5, 0.5), M.lambertian(0.95),
                      location=[0.0, 0.0, f0],
                      rotation=sp.rotx(np.pi)[:3, :3], name="receiver")
    table, meta = sc.compile_scene(
        sc.Assembly([sc.AssembledObject([dish, recv])]), dtype=dtype,
        device=device)
    d_rows = np.nonzero(meta.row_logical == meta.index_of("dish"))[0]
    r_rows = np.nonzero(meta.row_logical == meta.index_of("receiver"))[0]
    if beam is None:
        beam = dish_beam(n_rays, dtype, table.device)
    beam = _cast(beam, dtype, table.device)

    def loss(f):
        q = 1.0 / (4.0 * f)
        z = torch.zeros_like(q)
        quad = torch.stack([q, q, z, z, z, z, z, z, z - 0.5, z])
        t = diff.with_rows(table, d_rows, quadric=quad[None])
        _, mom = diff.trace_diff(t, beam, 10, bounces=bounces,
                                 checkpoint=checkpoint)
        return diff.spot_rms(mom, r_rows)
    return _grad_step(loss, dtype, table.device, r_rows), table, beam


def field_gradient_step(n_rays: int = 1 << 20, bounces: int = 2,
                        checkpoint: bool = True, dtype=torch.float32,
                        device=None):
    """Config 9b's step (benchmarks/suite.py:647): ``step(a)`` returns
    the receiver spot-RMS loss through the NSTTF field (218 heliostats
    and the receiver, 219 rows) and its gradient with respect to a global
    beam tilt ``a`` about x. The beam is a 160 m disk 300 m up the sun
    ray at 4.65 mrad (seed 0), the trace's seed 1. Returns (step, scene,
    beam), step as :func:`diff_gradient_step`'s."""
    from .. import diff
    from .nsttf import build_scene
    table, meta, info = build_scene(218, dtype=dtype, device=device)
    rec_lid = next(i for i, nm in enumerate(meta.names)
                   if nm.startswith("rec"))
    r_rows = np.nonzero(np.asarray(meta.row_logical) == rec_lid)[0]
    sun = info["sun"]
    beam = ptt.sources.disk_bundle(
        torch.Generator().manual_seed(0), n_rays,
        center=info["field_center"] + sun * 300.0, direction=-sun,
        radius=160.0, ang_range=4.65e-3, flux=1000.0, dtype=dtype,
        device=table.device)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=dtype,
                      device=table.device).expand_as(beam.dir)
    side = torch.linalg.cross(ex, beam.dir, dim=1)

    def loss(a):
        d = beam.dir + a * side
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        _, mom = diff.trace_diff(table, beam.replace(dir=d), 1,
                                 bounces=bounces, checkpoint=checkpoint)
        return diff.spot_rms(mom, r_rows)
    return _grad_step(loss, dtype, table.device, r_rows), table, beam


def _grad_step(loss, dtype, device, receiver_rows):
    """``step(x)``: the loss at the float ``x`` and its gradient, by
    torch.autograd.grad; ``step.loss`` is the loss of a tensor and
    ``step.receiver_rows`` the table rows it reads."""
    def step(x):
        x = torch.tensor(float(x), dtype=dtype, device=device,
                         requires_grad=True)
        v = loss(x)
        (g,) = torch.autograd.grad(v, x)
        return v.detach(), g
    step.loss = loss
    step.receiver_rows = receiver_rows
    return step


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _time_step(step, params, device) -> dict:
    """One warm-up call at params[0] (loss finite and positive, gradient
    finite and not 0, as the suite asserts), then one timed call at each
    of params[1:], each ending in a device synchronization. Returns the
    warm-up's loss and gradient and the walls."""
    loss, g = step(params[0])
    _sync(device)
    loss, g = float(loss), float(g)
    if not (np.isfinite(loss) and loss > 0.0):
        raise AssertionError(f"loss {loss}")
    if not (np.isfinite(g) and abs(g) > 0.0):
        raise AssertionError(f"gradient {g}")
    walls = []
    for p in params[1:]:
        t0 = time.perf_counter()
        step(p)
        _sync(device)
        walls.append(time.perf_counter() - t0)
    return dict(loss=loss, grad=g, walls=walls,
                wall=statistics.median(walls))


def config9_diff_gradient(n_rays: int = 1 << 20, bounces: int = 3,
                          device=None) -> dict:
    """Config 9 (benchmarks/suite.py:608): the throughput of the focal-
    length gradient step, source rays per second of wall, the median of
    three calls after a warm-up, with the loss and gradient of the
    warm-up (f = 1.7)."""
    step, table, _ = diff_gradient_step(n_rays, bounces, device=device)
    r = _time_step(step, [1.7 + 0.01 * i for i in range(4)], table.device)
    return dict(metric="diff_gradient_trace_throughput",
                value=n_rays / r["wall"] / 1e6, unit="Mrays/s",
                bounces=bounces, **r)


def config9b_diff_gradient_field(n_rays: int = 1 << 20, bounces: int = 2,
                                 device=None) -> dict:
    """Config 9b (benchmarks/suite.py:647): the throughput of the
    beam-tilt gradient step through the NSTTF field, as config 9's."""
    step, table, _ = field_gradient_step(n_rays, bounces, device=device)
    r = _time_step(step, [1e-4 * i for i in range(4)], table.device)
    return dict(metric="diff_gradient_field_throughput",
                value=n_rays / r["wall"] / 1e6, unit="Mrays/s",
                bounces=bounces, n_rows=int(table.num_rows), **r)
