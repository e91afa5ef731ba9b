"""The host flux map against tracer_tpu on the CPU:

* fluxmap (and uv_project) equal to tracer_tpu's on the same energies
  and local points for every kind of supported_kinds();
* bench config 2 (benchmarks/suite.py:174-181: a slope-error dish over a
  Lambertian absorber, ``ray_tracer(record="tags")`` then
  ``surface_fluxmap``) at 16,384 rays through both packages' ray_tracer:
  the receiver's share within 3 combined binomial sigma, the map times
  its cell areas summing to the receiver's absorbed energy, and
  surface_fluxmap equal to tracer_tpu's fluxmap on the port's records.
"""
import math

import jax
import numpy as np
import pytest
import torch

import tracer_tpu
import tracer_tpu_torch as ptt
from tracer_tpu.analysis import fluxmap as jax_fluxmap
from tracer_tpu.engine import TraceOptions as JaxOptions
from tracer_tpu.engine import TracerEngine as JaxEngine
from tracer_tpu_torch.analysis import fluxmap
from tracer_tpu_torch.engine import TraceOptions, TracerEngine
from tracer_tpu_torch.models.bench_configs import BENCH, bench_assembly

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

# one geometry of each kind flux maps bin, built with either package
GEOMETRIES = {
    "rect": lambda G: G.rect_plate(2.0, 1.0),
    "extruded_rect": lambda G: G.extruded_rect_plate(2.0, 1.5, [0.3, 0.1],
                                                     0.5, 0.4),
    "perforated_rect": lambda G: G.perforated_rect_plate(
        2.0, 1.5, [[0.3, 0.1], [-0.5, -0.2]], [0.2, 0.3]),
    "round": lambda G: G.round_plate(1.0, 0.2),
    "cut_round": lambda G: G.straight_cut_round_plate(1.0, 0.3),
    "parabolic_dish": lambda G: G.parabolic_dish(2.0, 1.5),
    "finite_cylinder": lambda G: G.finite_cylinder(1.0, 2.0),
    "rect_cut_cylinder": lambda G: G.rect_cut_cylinder(1.0, 2.0, 0.8, 0.9),
    "conical_frustum": lambda G: G.conical_frustum(0.0, 1.0, 1.5, 0.4),
    "sphere": lambda G: G.sphere(1.2),
    "hemisphere": lambda G: G.hemisphere(1.2),
    "spherical_rect_facet": lambda G: G.spherical_rect_facet(1.2, 1.0, 0.8),
}


def test_supported_kinds_equal_jax():
    assert fluxmap.supported_kinds() == jax_fluxmap.supported_kinds()
    assert set(GEOMETRIES) == set(fluxmap.supported_kinds())


@pytest.mark.parametrize("kind", sorted(GEOMETRIES))
def test_fluxmap_matches_jax(kind):
    geom = GEOMETRIES[kind](ptt.geometry)
    jgeom = GEOMETRIES[kind](tracer_tpu.geometry)
    assert geom.kind == jgeom.kind == kind
    rng = np.random.default_rng(len(kind))
    local = rng.normal(size=(5000, 3)) * 0.7
    if kind in ("sphere", "hemisphere", "spherical_rect_facet"):
        local *= 1.2 / np.linalg.norm(local, axis=1, keepdims=True)
    e = rng.uniform(0.0, 2.0, 5000)
    for got, want in zip(fluxmap.uv_project(kind, geom.extent, local),
                         jax_fluxmap.uv_project(kind, jgeom.extent, local)):
        np.testing.assert_array_equal(got, want)
    flux, edges = fluxmap.fluxmap(geom, e, local, resolution=12)
    jflux, jedges = jax_fluxmap.fluxmap(jgeom, e, local, resolution=12)
    np.testing.assert_allclose(flux, jflux, rtol=1e-12, atol=0)
    for a, b in zip(edges, jedges):
        np.testing.assert_array_equal(a, b)
    assert flux.sum() > 0
    empty, _ = fluxmap.fluxmap(geom, [], np.zeros((0, 3)), resolution=4)
    assert not empty.any()


def _config2_beam(pkg, n, key_or_gen):
    c = BENCH[2]
    if pkg is tracer_tpu:
        return tracer_tpu.sources.disk_bundle(
            key_or_gen, n, center=c["center"], direction=c["direction"],
            radius=c["radius"], ang_range=c["ang_range"], flux=1000.0)
    return ptt.sources.disk_bundle(key_or_gen, n, c["center"],
                                   c["direction"], c["radius"],
                                   c["ang_range"], flux=1000.0,
                                   device="cpu")


def test_config2_flux_map_matches_jax():
    n = 16_384
    asm, _ = bench_assembly(ptt, 2)
    eng = TracerEngine(asm, device="cpu")
    beam = _config2_beam(ptt, n, torch.Generator().manual_seed(3))
    res = eng.ray_tracer(beam, generator=torch.Generator().manual_seed(4),
                         opts=TraceOptions(max_bounces=20, record="tags"))
    src = float(beam.total_energy())
    bal = res.energy_balance()
    assert abs(bal["closure"]) < 1e-5 * src
    flux, _ = fluxmap.surface_fluxmap(res, "rec", resolution=20)
    geom = res.meta.surfaces[res.meta.index_of("rec")].geometries[0]
    areas = fluxmap.areas_of(geom.kind, geom.extent, 20)
    rec = float(res.absorbed_by_logical()[res.meta.index_of("rec")])
    assert abs((flux * areas).sum() - rec) <= 1e-5 * rec
    # the records carry only the tagged receiver's hits
    assert all(bool(np.isin(r.sid.numpy()[r.alive_in.numpy()],
                            res._rows_of("rec")).all())
               for r in res.records)
    hits = res.hits_of("rec")
    jgeom = tracer_tpu.geometry.round_plate(0.10)     # the receiver
    want, _ = jax_fluxmap.fluxmap(jgeom, hits["absorbed"], hits["local"], 20)
    np.testing.assert_allclose(flux, want, rtol=1e-12, atol=0)
    # tracer_tpu's record path on the same scene and beam (float64)
    jasm, _ = bench_assembly(tracer_tpu, 2)
    jbeam = _config2_beam(tracer_tpu, n, jax.random.PRNGKey(3))
    jres = JaxEngine(jasm).ray_tracer(
        jbeam, key=jax.random.PRNGKey(4),
        opts=JaxOptions(max_bounces=20, record="tags"))
    jflux, _ = jax_fluxmap.surface_fluxmap(jres, "rec", resolution=20)
    jsrc = float(np.asarray(jbeam.energy).sum())
    q = float(jres.absorbed_by_logical()[jres.meta.index_of("rec")]) / jsrc
    p = rec / src
    assert abs(p - q) <= 3 * math.sqrt(q * (1 - q) * 2 / n), (p, q)
    assert p > 0.5
    # the peaks agree to the cells' counting noise
    peak, jpeak = flux.max(), jflux.max()
    assert abs(peak - jpeak) < 0.25 * jpeak
