"""Bench configurations 1-3, 6 and 8 of the repo's suite
(benchmarks/suite.py:77, :142, :189, :267, :432), built with the port's
host API.

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
8. a closed 6 x 6 x 4 m box of six Lambertian walls (absorptivity 0.7)
   filled with a Henyey-Greenstein medium (attenuation 0.15/m,
   scattering 0.4/m, g 0.6) declared by the source spec;
"8b". the same box with the medium bounded between two index-matched
   scattering_interface sheets at z = 1 and 3 m (suite.py:517: per-lane
   medium ids), under a source without an ambient medium.

Each runs the plain streaming megakernel, ``engine.trace_streaming``
without culling. The assembly and spec builders take the package they
build with (``pkg``): this package, or tracer_tpu, whose host API is the
same, so a parity test can build both twins from one definition. This
module never imports tracer_tpu: a caller that wants it passes it in.
"""
from __future__ import annotations

import importlib

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
    8: dict(_BOX, att=0.15, scat=0.4, g=0.6),
    "8b": dict(_BOX, medium=dict(scat=0.4, g=0.6, att=0.15)),
}
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
    if cfg == 6:
        lens = _mod(pkg, "models.spherical_lens").SphericalLens(
            diameter=0.5, depth=0.02, R1=0.3, R2=-0.3, refr_idx=1.5)
        rec = sc.Surface(G.round_plate(0.3), M.absorber(one_sided=False),
                         location=[0.0, 0.0, -lens.focal_length()],
                         name="rec")
        return sc.Assembly([lens, sc.AssembledObject([rec])]), ()
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


def bench_scene(cfg, slab: int, device=None):
    """(table, meta, source_fn) of bench configuration ``cfg`` on the port,
    on the GPU unless ``device`` says otherwise: ``source_fn(generator,
    device=None)`` draws a slab of the rays its ``pallas_spec``
    regenerates, and ``num_rays`` is the slab."""
    asm, extra = bench_assembly(ptt, cfg)
    table, meta = ptt.compile_scene(asm, extra_features=extra, device=device)
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
