"""Trace engines (the PyTorch port of tracer_tpu/engine.py).

* :func:`trace_streaming` -- the streaming Monte-Carlo trace with
  in-kernel ray regeneration. The ray population lives in a fixed slab of
  lanes; each round one fused bounce kernel refills the dead lanes from
  the source, intersects, shades, and the engine accounts the round's
  absorbed energy per surface row. Two dispatches are ported:

  - with ``culling`` (the NSTTF field), the relevancy-culled trace: one
    tile of TILE lanes per equal-area source cell (culling.py), each
    tile's dead lanes regenerated up to its exact emission quota and
    tested against the tile's candidate rows only (K1). Rays that survive
    a demoted surface or reach their tile's corridor depth are *parked*
    and re-traced against the full scene in a drain phase (K2), so
    culling changes the cost, never the physics;
  - without it, the plain megakernel (bench configs 1-3): every round K2
    regenerates every dead lane and tests every row; the emission loop
    stops once ``total_rays`` are emitted and a compacted tail drains
    the survivors.
* :meth:`TracerEngine.ray_tracer` -- the host-stepped bounce loop with
  per-bounce records, stopping when the bundle dies.
* :func:`trace_fused` -- the same bounce without records, accumulators and
  device flux maps only.

Both bundle traces run :func:`_bounce_step`: nearest hit (K3 for float32,
the float64 oracle on CPU tensors), shade, account. Every loop runs on the
host and reads one value from the device per bounce or round.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import List, Optional

import numpy as np
import torch

from . import materials as _M
from .analysis import device_fluxmap as _dfm
from .bundle import RayBundle
from .device import resolve
from .kernels.bounce import (TILE, bounce_reflect, bounce_reflect_culled,
                             pack_rows, source_params, source_pose)
from .kernels.intersect import nearest_hit_aux
from .kernels.shade import check_supported, shade
from .scene import Assembly, SceneMeta, SceneTable, compile_scene

log = logging.getLogger("tracer_tpu_torch")


@dataclasses.dataclass
class TraceAccum:
    """Device-side energy bookkeeping (per scene-table row)."""

    absorbed: torch.Tensor   # (S,) energy deposited per surface row
    hits: torch.Tensor       # (S,) number of ray hits per surface row
    escaped: torch.Tensor    # () energy that left the scene
    culled: torch.Tensor     # () energy dropped by the min_energy threshold
    medium: torch.Tensor     # () energy absorbed by participating media
    residual: torch.Tensor   # () energy still on live rays at exit
    flux: tuple = ()         # per-FluxSpec (nu, nv) device flux histograms

    @classmethod
    def zeros(cls, n_rows: int, dtype=torch.float32, device=None,
              fluxspecs: tuple = ()) -> "TraceAccum":
        """Zeroed accumulators on ``device`` (None means the GPU,
        device.default_device)."""
        device = resolve(device)

        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(absorbed=z(n_rows), hits=z(n_rows), escaped=z(),
                   culled=z(), medium=z(), residual=z(),
                   flux=_dfm.zeros_for(fluxspecs, dtype=dtype,
                                       device=device))

    def to(self, device) -> "TraceAccum":
        return TraceAccum(**{
            f.name: (tuple(h.to(device) for h in v) if f.name == "flux"
                     else v.to(device))
            for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)})


def _bivar_mode(scene: SceneTable):
    """Static slope-error model: True when every slope-error row carries
    F_BIVAR, False when none does, "mixed" otherwise (only sigma > 0 rows
    vote)."""
    bv = [bool(f & _M.F_BIVAR) for f in scene.slope_flags_present]
    if not bv or not any(bv):
        return False
    return True if all(bv) else "mixed"


def _row_sums(sid, values, n_rows: int):
    """(S,) per-row sums of ``values`` over the lanes with sid >= 0.

    Up to 64 rows (tracer_tpu's small-scene threshold): one masked
    reduction per row, which sums in a tree, so a row that takes millions
    of small values in one bounce keeps float32 accuracy. More rows: an
    index_add_ into a fresh buffer, so adding a round's sum to the running
    total keeps each atomic add small next to the bin it lands in."""
    if n_rows <= 64:
        rows = torch.arange(n_rows, device=sid.device, dtype=sid.dtype)
        return torch.where(sid[None, :] == rows[:, None], values,
                           0.0).sum(1)
    idx = _dfm.spread_misses(sid >= 0, sid, n_rows)
    out = torch.zeros(n_rows + _dfm.N_SPILL, dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, idx, values)[:n_rows]


def _account(accum: TraceAccum, sid, escaped, absorbed_ray, energy,
             count_hits: bool = False) -> None:
    """Per-surface energy accounting for one bounce, in place; with
    ``count_hits`` also the number of hits per row."""
    n_rows = accum.absorbed.shape[0]
    accum.escaped += torch.where(escaped, energy, 0.0).sum()
    accum.absorbed += _row_sums(sid, absorbed_ray, n_rows)
    if count_hits:
        accum.hits += _row_sums(sid, (sid >= 0).to(accum.hits.dtype),
                                n_rows)


def _chunked_drain(e, fields, drain_fn, cap: int, accum):
    """Drain the sparse survivors of a slab to death in compacted chunks:
    top-k the ``cap`` highest-energy lanes, gather their ``fields`` (None
    stays None), zero them in the slab, and hand the chunk to
    ``drain_fn(ce, cfields, accum)`` (which returns the energy its round
    budget left alive, added to ``accum.residual``). Repeats until the
    slab is dead."""
    if cap >= e.shape[0]:
        ce = drain_fn(e, fields, accum)
        accum.residual += ce.sum()
        return torch.zeros_like(e)
    e = e.clone()
    while bool((e > 0.0).any()):
        ce, idx = torch.topk(e, cap)
        cfields = tuple(None if f is None else f[idx] for f in fields)
        e[idx] = 0.0
        ce = drain_fn(ce, cfields, accum)
        accum.residual += ce.sum()
    return e


def _seed(generator) -> int:
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator))


def _drain_cap(slab: int) -> int:
    """Chunk capacity of the plain megakernel's compacted tail: slab // 8,
    rounded up to whole tiles (tracer_tpu/engine.py:878)."""
    return max(TILE, -(-(slab // 8) // TILE) * TILE)


def _trace_streaming_megakernel(
        scene: SceneTable, source_spec, src_frame, generator,
        total_rays: int, slab: int, max_rounds: int, max_path: int,
        min_energy: float, t_eps: float, disc_eps: float, bivar,
        one_sided: bool, slope: bool, lambertian: bool, spectral: bool,
        fluxspecs: tuple = ()):
    """Plain streaming megakernel (tracer_tpu/engine.py:957): each round
    K2 refills every dead lane of the slab from the source (pose
    ``src_frame``), intersects every row and shades. The emission loop
    reads the dead count once per round and stops once ``total_rays`` are
    emitted (the last round may overshoot by up to one slab; ``emitted``
    is exact); the survivors then drain in compacted chunks of
    _drain_cap(slab) lanes, each for at most max_path + 1 rounds. Rays
    older than ``max_path`` bounces, and hits that leave less than
    ``min_energy``, are culled with their energy accounted. Returns
    (accum, rays emitted, source energy)."""
    dev = scene.device
    e_ray = float(source_spec[5])
    ambient_att = float(source_spec[14]) if len(source_spec) > 14 else 0.0
    rows = pack_rows(scene)
    tab = (torch.stack([scene.spectral_wl, scene.spectral_ab], dim=1)
           .to(torch.float32).contiguous() if spectral else None)
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.zeros((slab, 3), **f32)
    dirs = torch.zeros((slab, 3), **f32)
    dirs[:, 2] = 1.0
    e = torch.zeros((slab,), **f32)
    wl = torch.zeros((slab,), **f32) if spectral else None
    age = torch.zeros((slab,), dtype=torch.int32, device=dev)
    accum = TraceAccum.zeros(scene.num_rows, device=dev, fluxspecs=fluxspecs)
    kernel_args = dict(disc_eps=disc_eps, bivar=bivar, one_sided=one_sided,
                       slope=slope, lambertian=lambertian,
                       source_spec=source_spec, spectral_tab=tab,
                       ambient_att=ambient_att, src_frame=src_frame)

    def one_round(pos, dirs, e, e_before, wl, age, regen: bool):
        """One K2 round and its accounting, any number of lanes (the
        emission loop and the compacted tail share it)."""
        outs = bounce_reflect(rows, _seed(generator), pos, dirs, e,
                              scene.groups, t_eps, regen=regen,
                              wavelength=wl, **kernel_args)
        pos, dirs, e_new, sid, absorbed = outs[:5]
        if wl is not None:
            wl = outs[5]
        hit = sid >= 0
        _account(accum, sid, (e_before > 0.0) & ~hit, absorbed, e_before)
        _dfm.accumulate(accum.flux, fluxspecs, scene, sid, pos, absorbed)
        if ambient_att > 0.0:
            # the kernel reports surface absorption only: the medium took
            # the rest of each hit segment's loss
            accum.medium += torch.where(hit, e_before - absorbed - e_new,
                                        0.0).sum()
        low = hit & (e_new <= min_energy)
        accum.culled += torch.where(low, e_new, 0.0).sum()
        e_new = torch.where(hit & ~low, e_new, 0.0)
        # the per-ray bounce budget
        age = torch.where(e_before > 0.0, age + 1, 0)
        over = (e_new > 0.0) & (age >= max_path)
        accum.culled += torch.where(over, e_new, 0.0).sum()
        return pos, dirs, torch.where(over, 0.0, e_new), wl, age

    emitted = 0
    i = 0
    while i < max_rounds and emitted < total_rays:
        reborn = e <= 0.0
        emitted += int(reborn.sum())
        e_before = torch.where(reborn, e_ray, e)
        age = torch.where(reborn, 0, age)      # fresh rays restart their age
        pos, dirs, e, wl, age = one_round(pos, dirs, e, e_before, wl, age,
                                          True)
        i += 1

    def drain_fn(ce, cfields, accum):
        cpos, cdirs, cwl, cage = cfields
        for _ in range(max_path + 1):
            if not bool((ce > 0.0).any()):
                break
            cpos, cdirs, ce, cwl, cage = one_round(cpos, cdirs, ce, ce, cwl,
                                                   cage, False)
        return ce

    e = _chunked_drain(e, (pos, dirs, wl, age), drain_fn, _drain_cap(slab),
                       accum)
    # exact closure on any exit: energy still alive is accounted
    accum.residual += e.sum()
    return (accum, torch.tensor(emitted, dtype=torch.int64),
            torch.tensor(emitted * e_ray, dtype=torch.float64))


def _trace_streaming_megakernel_culled(
        scene: SceneTable, generator, lists, counts, cells, cell_bounds,
        quota_b, age_caps, source_spec, group_offsets, slab: int,
        max_rounds: int, max_path: int, min_energy: float, t_eps: float,
        bivar, one_sided: bool, slope: bool, demote_rows: tuple,
        fluxspecs: tuple = ()):
    """Relevancy-culled streaming trace (tracer_tpu/engine.py:1158): each
    tile owns one equal-area source cell and intersects only its static
    candidate list; per-tile quotas keep the stratified emission
    unbiased. Returns (accum, rays emitted, source energy)."""
    dev = scene.device
    nb = lists.shape[0]
    assert slab == nb * TILE, "culled path needs ray count == nb * TILE"
    e_ray = float(source_spec[5])
    rows = pack_rows(scene)
    S = scene.num_rows
    f32 = dict(dtype=torch.float32, device=dev)

    pos = torch.zeros((slab, 3), **f32)
    dirs = torch.zeros((slab, 3), **f32)
    dirs[:, 2] = 1.0
    e = torch.zeros((slab,), **f32)
    age = torch.zeros((slab,), dtype=torch.int32, device=dev)
    parked = torch.zeros((slab,), dtype=torch.bool, device=dev)
    emitted_b = torch.zeros((nb,), dtype=torch.int32, device=dev)
    accum = TraceAccum.zeros(S, device=dev, fluxspecs=fluxspecs)
    demote = torch.zeros((S,), dtype=torch.bool, device=dev)
    demote[list(demote_rows)] = True
    age_cap_lane = age_caps.repeat_interleave(TILE)
    kernel_args = dict(groups=scene.groups, group_offsets=group_offsets,
                       t_eps=t_eps, bivar=bivar, one_sided=one_sided,
                       slope=slope)
    i = 0

    def round_state():
        """Per-tile dead and live-unparked lane counts, and whether any
        tile can still make progress."""
        dead_b = (e <= 0.0).view(nb, TILE).sum(1, dtype=torch.int32)
        lu = (e > 0.0) & ~parked
        lu_b = lu.view(nb, TILE).sum(1, dtype=torch.int32)
        can_emit = (emitted_b < quota_b) & ((dead_b > 0) | (lu_b > 0))
        return dead_b, lu_b, bool(can_emit.any() | lu.any())

    def drain_fn(ce, cfields, accum):
        """Trace a compacted chunk against the FULL scene until it dies
        or its round budget runs out; returns the energy left."""
        cpos, cdirs, cage = cfields
        for _ in range(max_path + 1):
            if not bool((ce > 0.0).any()):
                break
            cpos, cdirs, ne, sid, absorbed = bounce_reflect(
                rows, _seed(generator), cpos, cdirs, ce, scene.groups,
                t_eps, bivar=bivar, one_sided=one_sided, slope=slope)
            hit = sid >= 0
            _account(accum, sid, (ce > 0.0) & ~hit, absorbed, ce)
            _dfm.accumulate(accum.flux, fluxspecs, scene, sid, cpos,
                            absorbed)
            low = hit & (ne <= min_energy)
            accum.culled += torch.where(low, ne, 0.0).sum()
            ne = torch.where(hit & ~low, ne, 0.0)
            cage = torch.where(ce > 0.0, cage + 1, cage)
            over = (ne > 0.0) & (cage >= max_path)
            accum.culled += torch.where(over, ne, 0.0).sum()
            ce = torch.where(over, 0.0, ne)
        return ce

    cap = min(slab, 64 * TILE)
    # emit -> drain cycles: the main loop exits when no tile can make
    # progress (quota done, or every remaining tile fully parked); the
    # drain then clears the parked lanes so emission can resume
    while i < max_rounds and bool((emitted_b < quota_b).any()
                                  | (e > 0.0).any()):
        while i < max_rounds:
            dead_b, lu_b, go = round_state()
            if not go:
                break
            remaining_b = torch.clamp(quota_b - emitted_b, min=0)
            n_new = torch.minimum(dead_b, remaining_b)
            active_b = ((n_new > 0) | (lu_b > 0)).to(torch.int32)
            emitted_b += n_new
            # the engine-side twin of the kernel's dead-lane rank
            dead = (e <= 0.0).view(nb, TILE)
            rank = torch.cumsum(dead.to(torch.int32), dim=1) - 1
            reborn = (dead & (rank < remaining_b[:, None])).view(slab)
            e_before = torch.where(reborn, e_ray, e)
            age = torch.where(reborn, 0, age)

            npos, ndirs, ne, sid, absorbed = bounce_reflect_culled(
                rows, lists, counts, cells, cell_bounds, _seed(generator),
                remaining_b, active_b, pos, dirs, e,
                source_spec=source_spec, **kernel_args)
            # parked lanes are frozen: the kernel traces them anyway, but
            # their results are discarded until the drain
            sid = torch.where(parked, -1, sid)
            absorbed = torch.where(parked, 0.0, absorbed)
            hit = sid >= 0
            _account(accum, sid, ~parked & (e_before > 0.0) & ~hit,
                     absorbed, e_before)
            _dfm.accumulate(accum.flux, fluxspecs, scene, sid, npos,
                            absorbed)
            low = hit & (ne <= min_energy)
            accum.culled += torch.where(low, ne, 0.0).sum()
            ne = torch.where(hit & ~low, ne, 0.0)
            age = torch.where(~parked & (e_before > 0.0), age + 1, age)
            # park survivors of demoted rows and rays at the age cap
            demote_hit = hit & demote[sid.clamp(min=0).long()]
            newly = ~parked & (ne > 0.0) & (demote_hit
                                            | (age >= age_cap_lane))
            pos = torch.where(parked[:, None], pos, npos)
            dirs = torch.where(parked[:, None], dirs, ndirs)
            e = torch.where(parked, e, ne)
            parked = parked | newly
            i += 1
        # drain: re-trace every live lane (parked or not) against the
        # full scene; the zeroed slab resumes emitting
        e = _chunked_drain(e, (pos, dirs, age), drain_fn, cap, accum)
        parked = torch.zeros_like(parked)
    # max_rounds exhaustion can leave live lanes: account, don't drop
    accum.residual += e.sum()
    emitted = emitted_b.sum(dtype=torch.int64)
    return accum, emitted, emitted.to(torch.float64) * e_ray


# optics kinds the plain megakernel's K2 shades (ROADMAP B2 stage b); the
# rest wait for their stages
_K2_KINDS = {_M.K_REFLECT, _M.K_LAMBERTIAN, _M.K_REFLECT_SPECTRAL}
_K2_LATER = {_M.K_REFRACTIVE: "B2 stage c", _M.K_COOK_TORRANCE: "B2 stage d",
             _M.K_LAMBERTIAN_SPECULAR: "B2 stage d",
             _M.K_SEMI_LAMBERTIAN: "B2 stage d",
             _M.K_TRANSPARENT: "B2 stage d",
             _M.K_FRESNEL_CONDUCTOR: "B2 stage e", _M.K_PERIODIC: "B2 stage e",
             _M.K_LAMBERTIAN_PIECEWISE: "B2 stage e"}
# scene features whose kernel modes wait for a later K2 stage
_FEATURES_LATER = {"iam": "B2 stage e", "iam_nonmirror": "A10",
                   "fresnel_conductor": "B2 stage e",
                   "conductor_dispersive": "B2 stage e",
                   "lambertian_piecewise": "B2 stage e",
                   "dispersive": "B2 stage c", "refractive_slope": "B2 stage c",
                   "split": "A10", "bifacial": "C"}


def trace_streaming(scene: SceneTable, source_fn, generator: torch.Generator,
                    total_rays: int, max_rounds: int = 10_000,
                    max_path: int = 100, min_energy: float = 1e-6,
                    t_eps=None, disc_eps: float = 1e-6, culling=None,
                    fluxspecs: tuple = ()):
    """Streaming wavefront trace with in-kernel ray regeneration
    (tracer_tpu/engine.py:1625), on the device that holds ``scene``.

    ``source_fn(generator, device=None)`` returns a float32 RayBundle of
    the slab size and carries the static ``pallas_spec`` the kernels
    regenerate from and ``num_rays``, the slab size; ``generator`` (a CPU
    torch.Generator) draws every round's kernel seed. ``total_rays`` caps
    how many source rays are emitted; ``max_path`` is the per-ray bounce
    budget. ``fluxspecs`` (device_fluxmap.FluxSpec tuple) accumulates
    receiver flux maps into ``accum.flux``.

    Returns (accum, emitted, source_e): energy accumulators, rays
    emitted, total energy emitted, with source_e == absorbed + escaped +
    culled + medium + residual to float32 tolerance.

    Two dispatches are ported, both for a bakeable source spec (a disk
    source, with an optional wavelength band and ambient attenuation):

    * ``culling`` given (culling.BlockCulling built for this scene, source
      and slab): the relevancy-culled trace, for K_REFLECT rows without a
      band or an ambient medium;
    * ``culling`` None: the plain megakernel, for K_REFLECT, K_LAMBERTIAN
      and K_REFLECT_SPECTRAL rows (spectral rows need the source's band),
      with the spec's ambient attenuation (a "volumetric" scene needs it).

    Everything else raises NotImplementedError naming its ROADMAP item."""
    spec = getattr(source_fn, "pallas_spec", None)
    if getattr(scene, "ambient_medium", ()):
        raise NotImplementedError("scene-declared ambient media are not "
                                  "ported yet (ROADMAP A8)")
    if spec is None:
        raise NotImplementedError(
            "sources without a bakeable spec need the general streaming "
            "path, not ported yet (ROADMAP A10)")
    if scene.frame.dtype != torch.float32:
        raise NotImplementedError("float64 traces are not ported yet "
                                  "(ROADMAP A4)")
    n = source_fn.num_rays
    kinds = set(scene.kinds_present)
    later = sorted(kinds - _K2_KINDS)
    if later:
        raise NotImplementedError(
            f"optics kind {later[0]} in the streaming kernels is not ported "
            f"yet (ROADMAP {_K2_LATER.get(later[0], 'A9')})")
    later = sorted(set(scene.features) & set(_FEATURES_LATER))
    if later:
        raise NotImplementedError(
            f"scene feature {later[0]!r} in the streaming kernels is not "
            f"ported yet (ROADMAP {_FEATURES_LATER[later[0]]})")
    source_params(spec)              # refuses rect sources and scattering
    band = spec[13] if len(spec) > 13 else None
    att = float(spec[14]) if len(spec) > 14 else 0.0
    spectral = _M.K_REFLECT_SPECTRAL in kinds
    if spectral and band is None:
        raise NotImplementedError(
            "spectral rows without a source band need the general streaming "
            "path, not ported yet (ROADMAP A10)")
    if "volumetric" in scene.features and att <= 0.0:
        raise NotImplementedError(
            "volumetric scenes without the spec's ambient attenuation need "
            "the general streaming path, not ported yet (ROADMAP A10)")
    te = 3e-4 if t_eps is None else t_eps   # float32 default_t_eps
    common = dict(max_rounds=max_rounds, max_path=max_path,
                  min_energy=min_energy, t_eps=te, bivar=_bivar_mode(scene),
                  one_sided="one_sided" in scene.features,
                  slope="slope_error" in scene.features,
                  fluxspecs=fluxspecs)
    if culling is None:
        spec_c, frame = _spec_frame_split(spec)
        return _trace_streaming_megakernel(
            scene, spec_c, torch.as_tensor(frame, device=scene.device),
            generator, total_rays, n, disc_eps=disc_eps,
            lambertian=_M.K_LAMBERTIAN in kinds, spectral=spectral,
            **common)
    if kinds != {_M.K_REFLECT} or band is not None or att:
        raise NotImplementedError(
            "the culled kernel takes K_REFLECT rows without a wavelength "
            "band or an ambient medium; its other modes are not ported yet "
            "(ROADMAP B1)")
    nb = culling.nb
    if n != nb * TILE:
        raise ValueError(
            f"culling was built for {nb * TILE} rays (nb={nb} blocks x "
            f"TILE={TILE}) but the source slab is {n}")
    # the kernel reads rows by these ids: they must fit this scene
    widths = np.diff(list(culling.group_offsets) + [culling.lists.shape[1]])
    if (culling.lists.max() >= scene.num_rows
            or culling.counts.shape[1] != len(scene.groups)
            or (culling.counts > widths).any()):
        raise ValueError("culling does not match this scene's rows and "
                         "groups: build it for this scene")
    dev = scene.device

    def dev_i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    return _trace_streaming_megakernel_culled(
        scene, generator, dev_i32(culling.lists), dev_i32(culling.counts),
        torch.arange(nb, dtype=torch.int32, device=dev),
        torch.as_tensor(culling.cell_bounds, dtype=torch.float32,
                        device=dev),
        dev_i32(culling.block_quota(total_rays)), dev_i32(culling.age_caps),
        source_spec=spec, group_offsets=culling.group_offsets, slab=n,
        demote_rows=culling.demote_rows, **common)


def _spec_frame_split(spec):
    """Split a bakeable disk spec into (canonical static spec, (21,)
    float32 pose: centre xyz, row-major position rotation, row-major
    direction rotation) (tracer_tpu/engine.py:1892; rect sources, whose
    pose carries its own direction frame, wait for ROADMAP A3). The pose
    is K2's operand instead of a constant, so traces that differ only by
    the source's aim share the same spec; the spec's pose slots hold
    None."""
    spec_c = list(spec)
    spec_c[0] = spec_c[1] = spec_c[2] = spec_c[3] = None
    return tuple(spec_c), source_pose(spec)


def energy_closure(accum: TraceAccum, source_e) -> float:
    """(source - absorbed - escaped - culled - medium - residual) / source:
    the relative energy the accounting lost (bench.py's guard)."""
    se = float(source_e)
    tot = (float(accum.absorbed.double().sum()) + float(accum.escaped)
           + float(accum.culled) + float(accum.medium)
           + float(accum.residual))
    return (se - tot) / se if se else math.nan


# ---------------------------------------------------------------------------
# bundle traces: host-stepped ray_tracer and trace_fused
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BounceRecord:
    """Per-bounce, per-ray-slot record (genealogy and accounting data).
    Slot i in bounce b descends from slot i in bounce b-1 (fixed slab)."""

    sid: torch.Tensor        # (N,) hit surface row, -1 = escaped/dead
    t: torch.Tensor          # (N,) hit distance
    hit: torch.Tensor        # (N,3) global hit point
    local: torch.Tensor      # (N,3) local-frame hit point
    dir_in: torch.Tensor     # (N,3)
    dir_out: torch.Tensor    # (N,3)
    e_in: torch.Tensor       # (N,)
    e_out: torch.Tensor      # (N,)
    absorbed: torch.Tensor   # (N,)
    backside: torch.Tensor   # (N,) bool
    alive_in: torch.Tensor   # (N,) bool: slot carried a live ray
    wavelength: Optional[torch.Tensor] = None   # (N,) per-hit wavelength
    normal: Optional[torch.Tensor] = None       # (N,3) shading normal
    spectra: Optional[torch.Tensor] = None      # not ported (A10)
    split: Optional[tuple] = None               # not ported (A9)
    bounce: Optional[int] = None    # bounce index
    slot: Optional[torch.Tensor] = None  # (K,) slab slot of each entry of
    #   a compacted (record="tags") record

    def replace(self, **changes) -> "BounceRecord":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "BounceRecord":
        return self.replace(**{
            f.name: v.to(device) for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),) if torch.is_tensor(v)})


@dataclasses.dataclass
class TraceOptions:
    max_bounces: int = 100
    min_energy: float = 1e-6
    t_eps: float = None   # None -> kernels.intersect.default_t_eps(dtype)
    disc_eps: float = 1e-6
    block: int = 64       # rows per step of the float64 oracle
    # True: full per-bounce records; "tags": only hits on surfaces whose
    # OpticsSpec carries record tags (materials.receiver / detector), and
    # no device-to-host copy in bounces that hit none; False: no records
    record: object = True


def _refuse_unported(scene, bundle: RayBundle) -> None:
    check_supported(scene)
    if bundle.pos.device != scene.device:
        raise ValueError(f"the bundle is on {bundle.pos.device}, the scene "
                         f"on {scene.device}")


def _bounce_step(scene: SceneTable, bundle: RayBundle, accum: TraceAccum,
                 generator: torch.Generator, min_energy: float, t_eps,
                 disc_eps: float, block: int, count_hits: bool = True,
                 need_local: bool = True, split_mode: bool = False,
                 cand=None, force_jnp: bool = False, spectral_alpha=None):
    """One bounce: nearest hit, shade, account (``accum`` in place).
    Returns (bundle', accum, record). tracer_tpu's fused K2 branch, its
    volumetric media, polychromatic spectra and Kd candidates are not
    ported (ROADMAP A8, A9, A10) and raise."""
    if cand is not None or spectral_alpha is not None or split_mode:
        raise NotImplementedError("Kd candidates, polychromatic spectra "
                                  "and energy splitting are not ported yet "
                                  "(ROADMAP A9/A10)")
    alive = bundle.alive & (bundle.energy > 0.0)
    t, sid, aux = nearest_hit_aux(scene, bundle.pos, bundle.dir,
                                  t_eps=t_eps, disc_eps=disc_eps,
                                  block=block, need_local=need_local,
                                  force_jnp=force_jnp)
    sid = torch.where(alive, sid, -1)
    hit = sid >= 0
    escaped = alive & ~hit
    res = shade(scene, sid, t, bundle.pos, bundle.dir, bundle.energy,
                bundle.wavelength, bundle.ref_index, generator,
                medium=(bundle.att_coeff, bundle.scat_coeff, bundle.scat_g),
                aux=aux)
    e_in = torch.where(hit, bundle.energy, 0.0)
    e_out = torch.where(hit, res.out_energy, 0.0)
    absorbed_ray = torch.where(hit, res.absorbed, 0.0)
    _account(accum, sid, escaped, absorbed_ray, bundle.energy, count_hits)
    low = hit & (e_out <= min_energy)
    accum.culled += torch.where(low, e_out, 0.0).sum()
    alive_next = hit & ~low
    out_att, out_scat, out_g = res.out_medium
    h3 = hit[:, None]
    new_bundle = bundle.replace(
        pos=torch.where(h3, res.out_pos, bundle.pos),
        dir=torch.where(h3, res.out_dir, bundle.dir),
        energy=torch.where(alive_next, e_out, 0.0),
        ref_index=torch.where(hit, res.out_ref_index, bundle.ref_index),
        att_coeff=torch.where(hit, out_att, bundle.att_coeff),
        scat_coeff=torch.where(hit, out_scat, bundle.scat_coeff),
        scat_g=torch.where(hit, out_g, bundle.scat_g),
        alive=alive_next)
    rec = BounceRecord(
        sid=sid, t=t, hit=res.out_pos, local=res.local_pt,
        dir_in=bundle.dir, dir_out=res.out_dir, e_in=e_in, e_out=e_out,
        absorbed=absorbed_ray, backside=res.backside & hit, alive_in=alive,
        wavelength=bundle.wavelength, normal=res.normal)
    return new_bundle, accum, rec


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


@dataclasses.dataclass
class TraceResult:
    """Host-side result: final bundle, accumulators (on the CPU),
    per-bounce records (on the CPU)."""

    scene: SceneTable
    meta: Optional[SceneMeta]
    final: RayBundle
    accum: TraceAccum
    records: List[BounceRecord]
    source: RayBundle

    def _rows_of(self, surface) -> np.ndarray:
        """Scene-table row ids of a logical surface (index or name)."""
        if self.meta is None:
            raise ValueError("no SceneMeta attached")
        if isinstance(surface, str):
            surface = self.meta.index_of(surface)
        return np.nonzero(self.meta.row_logical == surface)[0]

    def hits_of(self, surface) -> dict:
        """Every hit on a logical surface across bounces as numpy arrays:
        global and local hit points, absorbed, incident and outgoing
        energy, incoming direction, backside flag, wavelength, shading
        normal and bounce index (the reference's accountant queries)."""
        rows = list(self._rows_of(surface))
        keys = ("hit", "local", "absorbed", "e_in", "e_out", "dir_in",
                "backside", "wavelength", "normal")
        out = {k: [] for k in keys + ("bounce",)}
        for b, rec in enumerate(self.records):
            mask = np.isin(_np(rec.sid), rows) & _np(rec.alive_in)
            if not mask.any():
                continue
            for k in keys:
                out[k].append(_np(getattr(rec, k))[mask])
            out["bounce"].append(np.full(
                mask.sum(), b if rec.bounce is None else int(rec.bounce)))
        vec3 = ("hit", "local", "dir_in", "normal")
        return {k: (np.concatenate(v) if v
                    else np.empty((0, 3) if k in vec3 else (0,)))
                for k, v in out.items()}

    def absorbed_by_logical(self) -> np.ndarray:
        """Absorbed energy aggregated to logical surfaces."""
        rows = _np(self.accum.absorbed).astype(np.float64)
        if self.meta is None:
            return rows
        out = np.zeros(self.meta.row_logical.max() + 1)
        np.add.at(out, self.meta.row_logical, rows)
        return out

    def energy_balance(self) -> dict:
        src = float(self.source.total_energy())
        absorbed = float(self.accum.absorbed.double().sum())
        escaped = float(self.accum.escaped)
        culled = float(self.accum.culled)
        residual = (float(self.final.total_energy())
                    + float(self.accum.residual))
        medium = float(self.accum.medium)
        return dict(source=src, absorbed=absorbed, escaped=escaped,
                    culled=culled, medium=medium, residual=residual,
                    closure=src - absorbed - escaped - culled - medium
                    - residual)

    def ray_history(self, slot: int) -> list:
        """One ray slot through the bounces: the full path with full
        records, only its recorded hits with record="tags"."""
        hist = []
        for b, rec in enumerate(self.records):
            alive = _np(rec.alive_in)
            if rec.slot is not None:
                pos = [p for p in np.nonzero(_np(rec.slot) == slot)[0]
                       if alive[p]]
                if not pos:
                    continue
                i = int(pos[0])
            else:
                if not alive[slot]:
                    break
                i = slot
            hist.append(dict(
                bounce=b if rec.bounce is None else int(rec.bounce),
                sid=int(rec.sid[i]), hit=_np(rec.hit[i]),
                e_in=float(rec.e_in[i]), e_out=float(rec.e_out[i])))
        return hist


def _compact_record(rec: BounceRecord, mask, n_hits: int,
                    bounce: int) -> BounceRecord:
    """The ``mask``-selected slots of a record gathered on the device into
    a buffer of the next power of two >= n_hits entries (padding: sid -1,
    alive_in False); ``slot`` keeps each entry's slab index."""
    n = mask.shape[0]
    k = min(1 << max(n_hits - 1, 0).bit_length(), n)
    idx = torch.zeros(k, dtype=torch.int64, device=mask.device)
    idx[:n_hits] = torch.nonzero(mask).flatten()[:k]
    valid = torch.arange(k, device=mask.device) < n_hits

    def take(a):
        return None if a is None else a[idx]
    return BounceRecord(
        sid=torch.where(valid, rec.sid[idx], -1), t=take(rec.t),
        hit=take(rec.hit), local=take(rec.local), dir_in=take(rec.dir_in),
        dir_out=take(rec.dir_out),
        e_in=torch.where(valid, rec.e_in[idx], 0.0),
        e_out=torch.where(valid, rec.e_out[idx], 0.0),
        absorbed=torch.where(valid, rec.absorbed[idx], 0.0),
        backside=rec.backside[idx] & valid,
        alive_in=rec.alive_in[idx] & valid,
        wavelength=take(rec.wavelength), normal=take(rec.normal),
        bounce=bounce, slot=idx.to(torch.int32))


def _generator_for(scene, generator):
    """``generator``, or one on the scene's device seeded with 0."""
    if generator is None:
        generator = torch.Generator(device=scene.device).manual_seed(0)
    return generator


class TracerEngine:
    """Drives the host-stepped trace of a scene (the reference engine's
    API: construct with an Assembly, then ray_tracer(bundle, reps,
    min_energy)) on the compiled table."""

    def __init__(self, assembly_or_table, meta: Optional[SceneMeta] = None,
                 dtype=torch.float32, device=None):
        """An Assembly is compiled on ``device`` (None means the GPU,
        device.default_device); a SceneTable is used where it lies."""
        if isinstance(assembly_or_table, Assembly):
            self.scene, self.meta = compile_scene(assembly_or_table,
                                                  dtype=dtype, device=device)
        else:
            self.scene = assembly_or_table
            self.meta = meta
        self.tree: Optional[TraceResult] = None

    def ray_tracer(self, bundle: RayBundle, reps: int = 100,
                   min_energy: float = 1e-6,
                   generator: Optional[torch.Generator] = None,
                   opts: Optional[TraceOptions] = None,
                   accel=None) -> TraceResult:
        """Host-stepped trace with per-bounce records; stops when the
        bundle dies. ``generator`` (on the scene's device) draws the
        shading randomness; None means one seeded with 0. ``accel`` (the
        Kd-tree candidate mode) is not ported yet (ROADMAP A10)."""
        if accel:
            raise NotImplementedError("accel (Kd-tree candidates) is not "
                                      "ported yet (ROADMAP A10)")
        scene = self.scene
        _refuse_unported(scene, bundle)
        opts = opts or TraceOptions(max_bounces=reps, min_energy=min_energy)
        generator = _generator_for(scene, generator)
        accum = TraceAccum.zeros(scene.num_rows, dtype=bundle.pos.dtype,
                                 device=scene.device)
        records: List[BounceRecord] = []
        source = bundle
        recording_rows = None
        if opts.record == "tags":
            if self.meta is None:
                raise ValueError("record='tags' needs a SceneMeta")
            tagged = [r for r, lid in enumerate(self.meta.row_logical)
                      if self.meta.surfaces[int(lid)].optics.record]
            recording_rows = torch.tensor(tagged, dtype=torch.int32,
                                          device=scene.device)
        for b in range(opts.max_bounces):
            bundle, accum, rec = _bounce_step(
                scene, bundle, accum, generator,
                min_energy=opts.min_energy, t_eps=opts.t_eps,
                disc_eps=opts.disc_eps, block=opts.block)
            if recording_rows is not None:
                if len(recording_rows):
                    mask = torch.isin(rec.sid, recording_rows)
                    n_hits = int(mask.sum())
                    if n_hits:
                        records.append(_compact_record(
                            rec, mask, n_hits, b).to("cpu"))
            elif opts.record:
                records.append(rec.replace(bounce=b).to("cpu"))
            if not bool(bundle.alive.any()):
                break
        result = TraceResult(scene=scene, meta=self.meta, final=bundle,
                             accum=accum.to("cpu"), records=records,
                             source=source)
        residual = float(result.final.total_energy())
        if residual > 0.0:
            log.warning("%.3g energy (%.2f%% of source) still alive after "
                        "%d bounces", residual, 100.0 * residual
                        / max(float(source.total_energy()), 1e-300),
                        opts.max_bounces)
        self.tree = result
        return result


def trace_fused(scene: SceneTable, bundle: RayBundle,
                generator: Optional[torch.Generator] = None,
                max_bounces: int = 100, min_energy: float = 1e-6,
                t_eps=None, disc_eps: float = 1e-6, block: int = 64,
                fluxspecs: tuple = ()):
    """Trace without records: accumulators only, plus the device flux
    histograms of ``fluxspecs`` (device_fluxmap.FluxSpec tuple) in
    ``accum.flux``. A host loop of :func:`_bounce_step` that reads one
    flag from the device per bounce (tracer_tpu runs the same loop as one
    jitted while_loop). Returns (final bundle, accum)."""
    _refuse_unported(scene, bundle)
    generator = _generator_for(scene, generator)
    accum = TraceAccum.zeros(scene.num_rows, dtype=bundle.pos.dtype,
                             device=scene.device, fluxspecs=fluxspecs)
    for _ in range(max_bounces):
        if not bool(bundle.alive.any()):
            break
        bundle, accum, rec = _bounce_step(
            scene, bundle, accum, generator, min_energy=min_energy,
            t_eps=t_eps, disc_eps=disc_eps, block=block)
        _dfm.accumulate(accum.flux, fluxspecs, scene, rec.sid, rec.hit,
                        rec.absorbed)
    return bundle, accum
