"""The system under test: tracer_tpu_torch, driven only through its public
entry points, at the sizes a configuration file and a traffic file give.

``build`` compiles the configuration's scene and its source (and, for a
culled trace, the culling) and returns a ``Study``; ``Study.run(seed)``
runs one study: the entry the traffic names, from a source draw to its
accumulators.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .reference import scene as ref_scene

def counters() -> dict:
    """The port's launch counters: a streaming round is a K1 or K2 launch
    (or an oracle drain bounce); a trace_fused bounce is a K3 launch."""
    from tracer_tpu_torch import engine
    from tracer_tpu_torch.kernels import bounce, nearest
    return {"bounce_reflect_culled": bounce.bounce_reflect_culled.launches,
            "bounce_reflect": bounce.bounce_reflect.launches,
            "nearest_hit": nearest.nearest_hit.launches,
            "oracle_bounce": engine._oracle_bounce.launches}


def _pads(cfg) -> np.ndarray:
    pads = np.loadtxt(ref_scene.ROOT / cfg["pads_file"], delimiter=",",
                      ndmin=2)
    return pads[:cfg["heliostats"]["count"]]


def _heliostat_field(cfg, device):
    """(table, meta, source spec arguments) of a tracked field."""
    from tracer_tpu_torch import spatial
    from tracer_tpu_torch.models.heliostat_field import (HeliostatField,
                                                         solar_vector)
    from tracer_tpu_torch.models.one_sided_mirror import one_sided_receiver
    from tracer_tpu_torch.scene import Assembly, compile_scene
    pads, hel = _pads(cfg), cfg["heliostats"]
    field = HeliostatField(pads, width=hel["width_m"],
                           height=hel["height_m"],
                           absorptivity=hel["absorptivity"],
                           sigma=hel["slope_error_rad"],
                           bi_var=hel["slope_model"] == "bivariate")
    field.set_aim_height(cfg["tower"]["aim_height_m"])
    sun_cfg = cfg["sun"]
    field.track_sun(azimuth=sun_cfg["azimuth_rad"],
                    zenith=sun_cfg["zenith_rad"])
    rec_cfg = cfg["receiver"]
    _, rec = one_sided_receiver(rec_cfg["width_m"], rec_cfg["height_m"],
                                absorptivity=rec_cfg["absorptivity"])
    centre = pads.mean(axis=0)
    facing = np.array([centre[0], centre[1],
                       -rec_cfg["normal_toward_depth_factor"]
                       * cfg["tower"]["aim_height_m"]])
    frame = np.eye(4)
    frame[:3, :3] = spatial.rotation_to_z(facing / np.linalg.norm(facing))
    frame[2, 3] = rec_cfg["centre_height_m"]
    rec.set_transform(frame)
    table, meta = compile_scene(Assembly(objects=[rec],
                                         subassemblies=[field]),
                                device=device)
    sun = solar_vector(sun_cfg["azimuth_rad"], sun_cfg["zenith_rad"])
    disk = cfg["source_disk"]
    radius = float(np.max(np.hypot(pads[:, 0] - centre[0],
                                   pads[:, 1] - centre[1]))
                   + disk["margin_m"])
    source = dict(centre=centre + sun * disk["distance_m"], direction=-sun,
                  radius=radius, dni=sun_cfg["dni_w_m2"], sunshape="buie",
                  csr=sun_cfg["csr"])
    return table, meta, source


def _minidish(cfg, device):
    from tracer_tpu_torch import spatial
    from tracer_tpu_torch.models.tau_minidish import MiniDish
    from tracer_tpu_torch.scene import compile_scene
    dish, rec, hom = cfg["dish"], cfg["receiver"], cfg["homogenizer"]
    asm = MiniDish(dish["diameter_m"], dish["focal_length_m"],
                   dish["optical_efficiency"], rec["position_m"],
                   rec["side_m"], hom["depth_m"], hom["optical_efficiency"],
                   rec["aspect"])
    asm.set_transform(spatial.rotx(cfg["tilt_about_x_rad"]))
    table, meta = compile_scene(asm, device=device)
    sun = cfg["sun"]
    source = dict(centre=np.asarray(sun["centre_m"], dtype=float),
                  direction=np.asarray(sun["direction"], dtype=float),
                  radius=sun["radius_m"], dni=sun["dni_w_m2"],
                  sunshape="pillbox", half_angle=sun["half_angle_rad"])
    return table, meta, source


SCENES = {"heliostat_field": _heliostat_field, "minidish": _minidish}


def _source_fn(src: dict, slab: int):
    """The port's disk source of ``slab`` rays a draw: a callable with the
    spec its kernels regenerate from (``pallas_spec``) and ``num_rays``."""
    from tracer_tpu_torch import sources
    if src["sunshape"] == "buie":
        spec = sources.buie_sunshape_pallas_spec(
            slab, src["centre"], src["direction"], src["radius"],
            src["csr"], src["dni"])

        def draw(generator, device=None):
            return sources.buie_sunshape(
                generator, slab, src["centre"], src["direction"],
                src["radius"], src["csr"], flux=src["dni"], device=device)
    else:
        spec = sources.disk_pillbox_pallas_spec(
            slab, src["centre"], src["direction"], src["radius"],
            src["half_angle"], src["dni"])

        def draw(generator, device=None):
            return sources.solar_disk_bundle(
                generator, slab, src["centre"], src["direction"],
                src["radius"], src["half_angle"], flux=src["dni"],
                device=device)
    draw.pallas_spec = spec
    draw.num_rays = slab
    return draw


@dataclasses.dataclass
class Study:
    """One configuration under one traffic mix, built on a device:
    ``run(seed)`` is one call, returning its outputs as device tensors
    without waiting for them."""
    meta: object
    run: object
    slab: int                   # rays that carry the source's power
    build_s: float

    def categories(self, names) -> np.ndarray:
        """(S,) index into ``names`` of each table row's surface."""
        return np.asarray([names.index(self.meta.names[int(k)])
                           for k in self.meta.row_logical])


def build(cfg: dict, traffic: dict, device) -> Study:
    """Compile the scene (and the culling a culled trace uses) on the
    host and the device, timed as ``build_s``."""
    from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
    t0 = time.perf_counter()
    table, meta, src = SCENES[cfg["kind"]](cfg, device)
    res = traffic.get("flux_resolution")
    fspecs = (flux_plan(meta, "receiver", resolution=res),) if res else ()
    entry = ENTRIES[traffic["entry"]]
    run, slab = entry(table, meta, src, traffic, fspecs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return Study(meta, run, slab, time.perf_counter() - t0)


def _streaming(table, meta, src, traffic, fspecs):
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.engine import trace_streaming
    from tracer_tpu_torch.parallel import trace_streaming_sharded
    slab = traffic["slab"]
    source_fn = _source_fn(src, slab)
    culling = (build_block_culling(table, meta, source_fn.pallas_spec, slab)
               if traffic.get("culling") else None)
    total = traffic["slabs_per_call"] * slab

    kw = dict(max_rounds=traffic["max_rounds"], max_path=traffic["max_path"],
              min_energy=traffic["min_energy"], culling=culling,
              fluxspecs=fspecs)

    def run(seed: int, total: int = total) -> dict:
        if traffic["entry"] == "trace_streaming_sharded":
            # every rank passes the same arguments; the accumulators come
            # back summed over the ranks
            accum, emitted, source_e = trace_streaming_sharded(
                table, source_fn, seed, total, **kw)
        else:
            accum, emitted, source_e = trace_streaming(
                table, source_fn, torch.Generator().manual_seed(seed),
                total_rays=total, **kw)
        return dict(absorbed=accum.absorbed, escaped=accum.escaped,
                    lost=accum.culled + accum.residual + accum.medium,
                    flux=accum.flux[0] if fspecs else None,
                    emitted=emitted, source_e=source_e)
    return run, slab


def _fused(table, meta, src, traffic, fspecs):
    from tracer_tpu_torch.engine import trace_fused
    n = traffic["rays"]
    source_fn = _source_fn(src, n)

    def run(seed: int) -> dict:
        gen = torch.Generator(device=table.device).manual_seed(seed)
        bundle = source_fn(gen, device=table.device)
        source_e = bundle.energy.sum(dtype=torch.float64)
        emitted = (bundle.energy > 0.0).sum()
        final, accum = trace_fused(table, bundle, generator=gen,
                                   max_bounces=traffic["max_bounces"],
                                   min_energy=traffic["min_energy"],
                                   fluxspecs=fspecs)
        return dict(absorbed=accum.absorbed, escaped=accum.escaped,
                    lost=(accum.culled + accum.residual + accum.medium
                          + final.total_energy()),
                    flux=accum.flux[0] if fspecs else None,
                    emitted=emitted, source_e=source_e)
    return run, n


ENTRIES = {"trace_streaming": _streaming,
           "trace_streaming_sharded": _streaming, "trace_fused": _fused}


def call_seed(seed: int, i: int) -> int:
    """The seed of call ``i`` of a run seeded ``seed`` (any integer)."""
    words = np.random.SeedSequence([abs(int(seed)), int(seed < 0), i]
                                   ).generate_state(2, dtype=np.uint32)
    return (int(words[0]) << 30) ^ int(words[1])
