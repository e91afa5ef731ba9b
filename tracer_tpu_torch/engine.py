"""Trace engines (the PyTorch port of tracer_tpu/engine.py).

* :func:`trace_streaming` -- the streaming Monte-Carlo trace with
  in-kernel ray regeneration. The ray population lives in a fixed slab of
  lanes; each round one fused bounce kernel refills the dead lanes from
  the source, intersects, shades, and the engine accounts the round's
  absorbed energy per surface row. Three dispatches are ported:

  - with ``culling`` for a cullable scene (the NSTTF fields: flat or
    curved mirrors, disk or rect sources, spectral, conductor, IAM,
    Lambertian and bifacial rows, an attenuating ambient), the
    relevancy-culled trace: one tile of TILE lanes per equal-area source
    cell (culling.py), each tile's dead lanes regenerated up to its exact
    emission quota and tested against the tile's candidate rows only
    (K1). Rays that survive a demoted surface or reach their tile's
    corridor depth are *parked* and re-traced against the full scene in a
    drain phase (K2), so culling changes the cost, never the physics;
  - without it, for a bakeable source, the plain megakernel (bench
    configs 1-3 and 6-8): every round K2 regenerates every dead lane and
    tests every row, with a per-lane refractive index and medium id where
    the scene's refractive rows need them; the emission loop stops once
    ``total_rays`` are emitted and a compacted tail drains the survivors;
  - for any other source, and for scenes with energy-splitting
    interfaces or mixed IAM exponents, the general path: every round the
    source draws a slab whose rays refill the free lanes, around one
    bounce (_bounce_step: K2's fused branch where the scene allows it,
    else K3 and the shade); in a splitting scene each lane's reflected
    branch waits in its overflow slot until the lane is free.
* :meth:`TracerEngine.ray_tracer` -- the host-stepped bounce loop with
  per-bounce records, stopping when the bundle dies; in a splitting scene
  the reflected branches join the bundle as new rays. With ``accel`` a
  Kd tree (accel.KdTree) gives every ray its candidate rows once a
  bounce; a polychromatic bundle's spectra are filtered every bounce.
* :func:`trace_fused` -- the same bounce without records, accumulators and
  device flux maps only.

Both bundle traces run :func:`_bounce_step`: nearest hit (K3 for float32,
the float64 oracle on either device, or the Kd candidates), free paths in
volumetric media, shade, the spectral filter, account. On CUDA float32
bundles in the scenes K2's shade covers, trace_fused runs
:func:`_bounce_step_epilogue` instead: K3, then the K3 epilogue
(kernels/epilogue.py), one kernel that shades, writes the next ray state,
accounts and bins the flux maps (_epilogue_ok is the gate). Every loop
runs on the host and reads one value from the device per bounce or
round.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import math
import time
from typing import List, Optional

import numpy as np
import torch

from . import materials as _M
from . import telemetry
from .analysis import device_fluxmap as _dfm
from .bundle import RayBundle, concatenate_rays
from .device import resolve
from .kernels import epilogue as _epi
from .kernels.bounce import (EXTRA_MODES, MAX_STAGE_FLOATS, POSE_FLOATS,
                             TILE, _modes, bounce_reflect,
                             bounce_reflect_culled, media_flags, pack_rows,
                             row_width, source_pose)
from .kernels.intersect import (default_t_eps, nearest_hit_aux,
                                nearest_hit_candidates)
from .kernels.shade import shade
from .mathutils import rotate_to_normal, safe_sqrt
from .optics import sample_scattering
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
    index_add_ into fresh bins, each row's spread over _BIN_COPIES copies
    by lane (a receiver takes millions of nearly equal values a round,
    which one float32 bin rounds the same way each time: 1.4e-4 of the
    curved field's source), so adding a round's sum to the running total
    keeps each add small next to its bin."""
    if n_rows <= 64:
        rows = torch.arange(n_rows, device=sid.device, dtype=sid.dtype)
        return torch.where(sid[None, :] == rows[:, None], values,
                           0.0).sum(1)
    n_bins = n_rows + _dfm.N_SPILL
    idx = (_dfm.spread_misses(sid >= 0, sid, n_rows)
           + _bin_copy_offsets(sid.shape[0], n_bins, sid.device))
    out = torch.zeros(_BIN_COPIES * n_bins, dtype=values.dtype,
                      device=values.device)
    out.index_add_(0, idx, values)
    return out.view(_BIN_COPIES, n_bins).sum(0)[:n_rows]


_BIN_COPIES = 32


@functools.lru_cache(maxsize=8)
def _bin_copy_offsets(n: int, n_bins: int, device) -> torch.Tensor:
    """(n,) int64 offset of each lane's copy of the bins: lane l adds into
    copy l % _BIN_COPIES."""
    lane = torch.arange(n, device=device)
    return (lane % _BIN_COPIES) * n_bins


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
    with telemetry.span("drain") as sp:
        if cap >= e.shape[0]:
            sp.set(chunks=1)
            ce = drain_fn(e, fields, accum)
            accum.residual += ce.sum()
            return torch.zeros_like(e)
        e = e.clone()
        chunks = 0
        while telemetry.read((e > 0.0).any()):
            ce, idx = torch.topk(e, cap)
            cfields = tuple(None if f is None else f[idx] for f in fields)
            # a fill, not e[idx] = 0.0, whose value would be copied from
            # the host and wait for the queue
            e.index_fill_(0, idx, 0.0)
            ce = drain_fn(ce, cfields, accum)
            accum.residual += ce.sum()
            chunks += 1
        sp.set(chunks=chunks)
        return e


def _seed(generator) -> int:
    return int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                             device=generator.device))


def _drain_cap(slab: int) -> int:
    """Chunk capacity of the plain megakernel's compacted tail: slab // 8,
    rounded up to whole tiles (tracer_tpu/engine.py:878)."""
    return max(TILE, -(-(slab // 8) // TILE) * TILE)


def _trace_streaming_megakernel(
        scene: SceneTable, source_spec, src_frame, generator,
        total_rays: int, slab: int, max_rounds: int, max_path: int,
        min_energy: float, t_eps: float, disc_eps: float, bivar,
        one_sided: bool, slope: bool, lambertian: bool, spectral: bool,
        fluxspecs: tuple = (), refractive: bool = False,
        refr_disp: bool = False, refr_frost: bool = False, media=None,
        extra=None, backside_miss: bool = False):
    """Plain streaming megakernel (tracer_tpu/engine.py:957): each round
    K2 refills every dead lane of the slab from the source (pose
    ``src_frame``), intersects every row and shades. The emission loop
    reads the dead count once per round and stops once ``total_rays`` are
    emitted (the last round may overshoot by up to one slab; ``emitted``
    is exact); the survivors then drain in compacted chunks of
    _drain_cap(slab) lanes, each for at most max_path + 1 rounds. Rays
    older than ``max_path`` bounces, and hits that leave less than
    ``min_energy``, are culled with their energy accounted. With
    ``refractive`` a per-lane index threads through K2 (fresh rays start
    at 1); with ``media`` (_bake_media's pair) a per-lane medium id too
    (fresh rays start in medium 0, the ambient). A lane that scattered in
    its medium (sid -2) lives on like a hit. ``extra`` holds K2's stage
    (d)/(e) switches (_k2_extra); the conductor and piecewise rows read
    the spectral table with or without a wavelength lane;
    ``backside_miss`` the bifacial rows' one-sided test. Returns (accum,
    rays emitted, source energy)."""
    dev = scene.device
    e_ray = float(source_spec[5])
    ambient_att, ambient_scat, ambient_g = _spec_medium(source_spec)
    att_on, scat_on = (media_flags(media) if media is not None
                       else (ambient_att > 0.0, ambient_scat > 0.0))
    rows = pack_rows(scene)
    extra = extra or {}
    tab = (_k2_table(scene) if spectral or extra.get("conductor")
           or extra.get("piecewise") else None)
    f32 = dict(dtype=torch.float32, device=dev)
    pos = torch.zeros((slab, 3), **f32)
    dirs = torch.zeros((slab, 3), **f32)
    dirs[:, 2] = 1.0
    e = torch.zeros((slab,), **f32)
    wl = torch.zeros((slab,), **f32) if spectral else None
    ri = torch.ones((slab,), **f32) if refractive else None
    mid = torch.zeros((slab,), **f32) if media is not None else None
    age = torch.zeros((slab,), dtype=torch.int32, device=dev)
    accum = TraceAccum.zeros(scene.num_rows, device=dev, fluxspecs=fluxspecs)
    kernel_args = dict(disc_eps=disc_eps, bivar=bivar, one_sided=one_sided,
                       slope=slope, lambertian=lambertian,
                       source_spec=source_spec, spectral_tab=tab,
                       ambient_att=ambient_att, src_frame=src_frame,
                       refr_frost=refr_frost, refr_disp=refr_disp,
                       ambient_scat=ambient_scat, ambient_g=ambient_g,
                       media=media, backside_miss=backside_miss, **extra)

    def one_round(pos, dirs, e, e_before, lanes, age, regen: bool):
        """One K2 round and its accounting, any number of lanes (the
        emission loop and the compacted tail share it); ``lanes`` is the
        (wavelength, index, medium id) triple, None where off."""
        wl, ri, mid = lanes
        with telemetry.span("launch"):
            outs = bounce_reflect(rows, _seed(generator), pos, dirs, e,
                                  scene.groups, t_eps, regen=regen,
                                  wavelength=wl, ref_index=ri,
                                  medium_id=mid, **kernel_args)
        with telemetry.span("account"):
            pos, dirs, e_new, sid, absorbed = outs[:5]
            rest = iter(outs[5:])
            lanes = tuple(None if x is None else next(rest) for x in lanes)
            # a live lane that scattered (sid -2) is on no surface but alive
            live_hit = (sid >= 0) | (sid == -2) if scat_on else sid >= 0
            _account(accum, sid, (e_before > 0.0) & ~live_hit, absorbed,
                     e_before)
            _dfm.accumulate(accum.flux, fluxspecs, scene, sid, pos,
                            absorbed)
            if att_on:
                # the kernel reports surface absorption only: the medium
                # took the rest of each hit or scattering segment's loss
                accum.medium += torch.where(
                    live_hit, e_before - absorbed - e_new, 0.0).sum()
            low = live_hit & (e_new <= min_energy)
            accum.culled += torch.where(low, e_new, 0.0).sum()
            e_new = torch.where(live_hit & ~low, e_new, 0.0)
            # the per-ray bounce budget
            age = torch.where(e_before > 0.0, age + 1, 0)
            over = (e_new > 0.0) & (age >= max_path)
            accum.culled += torch.where(over, e_new, 0.0).sum()
            return pos, dirs, torch.where(over, 0.0, e_new), lanes, age

    lanes = (wl, ri, mid)
    emitted = 0
    i = 0
    while i < max_rounds and emitted < total_rays:
        # every lane carries energy in: the dead ones regenerate
        with telemetry.span("round", kernel="k2", lanes=slab, live=slab):
            reborn = e <= 0.0
            emitted += telemetry.read(reborn.sum())
            e_before = torch.where(reborn, e_ray, e)
            age = torch.where(reborn, 0, age)  # fresh rays restart their age
            pos, dirs, e, lanes, age = one_round(pos, dirs, e, e_before,
                                                 lanes, age, True)
        i += 1

    def drain_fn(ce, cfields, accum):
        cpos, cdirs, cage, *clanes = cfields
        clanes = tuple(clanes)
        for _ in range(max_path + 1):
            live = telemetry.count(ce > 0.0)
            if not live:
                break
            with telemetry.span("round", kernel="k2", lanes=len(ce),
                                live=live):
                cpos, cdirs, ce, clanes, cage = one_round(
                    cpos, cdirs, ce, ce, clanes, cage, False)
        return ce

    e = _chunked_drain(e, (pos, dirs, age, *lanes), drain_fn,
                       _drain_cap(slab), accum)
    # exact closure on any exit: energy still alive is accounted
    accum.residual += e.sum()
    return (accum, torch.tensor(emitted, dtype=torch.int64),
            torch.tensor(emitted * e_ray, dtype=torch.float64))


def _trace_streaming_megakernel_culled(
        scene: SceneTable, generator, lists, counts, cells, cell_bounds,
        quota_b, age_caps, source_spec, group_offsets, slab: int,
        max_rounds: int, max_path: int, min_energy: float, t_eps: float,
        disc_eps: float, bivar, one_sided: bool, slope: bool,
        demote_rows: tuple, fluxspecs: tuple = (), spectral: bool = False,
        modes=None, park_aureole: bool = False, order=None, row_map=None,
        demote_mask=None, drain_oracle: bool = False):
    """Relevancy-culled streaming trace (tracer_tpu/engine.py:1158): each
    tile owns one equal-area source cell and intersects only its static
    candidate list; per-tile quotas keep the stratified emission
    unbiased. ``spectral`` threads a wavelength lane through the rounds,
    the parking and the drain (fresh rays draw it from the spec's band);
    ``modes`` holds K1's epilogue switches (kernels.bounce.CULLED_MODES),
    which the drain's K2 takes too. With an ambient attenuation the medium
    takes each hit segment's loss beyond the surfaces'. With
    ``park_aureole`` (the culling's) K1 flags the hits of aureole-born
    lanes, and their survivors park for the drain. ``order`` is the tile
    order of these ``lists``, which K1 dispatches by (None: K1 derives
    it).

    The per-tile arrays may be a rank's block range of the global layout
    (parallel.trace_streaming_sharded): ``cells`` then carries the global
    tile ids, so each tile draws its own random stream wherever it runs.
    With ``row_map`` ((S_loc,) int64, a rank's or segment's local->global
    row map, culling.mesh_segment_shards) the lists and ``demote_rows``
    hold LOCAL row ids: K1 gets the gathered table rows[row_map], and the
    winners' rows map back to global ones before they are accounted.
    ``demote_mask`` ((S_loc,) bool) adds demoted rows as data. The drain
    always traces the FULL scene: K2, or with ``drain_oracle`` (a table
    past K2's stage) the oracle's nearest hit and the unfused shade on
    the rays' device (tracer_tpu's drain_jnp). Returns (accum, rays
    emitted, source energy)."""
    dev = scene.device
    nb = lists.shape[0]
    assert slab == nb * TILE, "culled path needs ray count == nb * TILE"
    modes = modes or {}
    e_ray = float(source_spec[5])
    att_on = modes.get("ambient_att", 0.0) > 0.0
    rows = pack_rows(scene)
    rows_k = rows if row_map is None else rows[row_map]
    S = scene.num_rows
    f32 = dict(dtype=torch.float32, device=dev)
    tab = _k2_table(scene) if spectral or modes.get("conductor") else None

    pos = torch.zeros((slab, 3), **f32)
    dirs = torch.zeros((slab, 3), **f32)
    dirs[:, 2] = 1.0
    e = torch.zeros((slab,), **f32)
    wl = torch.zeros((slab,), **f32) if spectral else None
    age = torch.zeros((slab,), dtype=torch.int32, device=dev)
    parked = torch.zeros((slab,), dtype=torch.bool, device=dev)
    emitted_b = torch.zeros((nb,), dtype=torch.int32, device=dev)
    accum = TraceAccum.zeros(S, device=dev, fluxspecs=fluxspecs)
    demote = torch.zeros((rows_k.shape[0],), dtype=torch.bool, device=dev)
    demote[list(demote_rows)] = True
    if demote_mask is not None:
        demote |= demote_mask
    drain_gen = (torch.Generator(device=dev).manual_seed(_seed(generator))
                 if drain_oracle else None)
    age_cap_lane = age_caps.repeat_interleave(TILE)
    shared = dict(t_eps=t_eps, disc_eps=disc_eps, bivar=bivar,
                  one_sided=one_sided, slope=slope, spectral_tab=tab,
                  **modes)
    i = 0

    def round_state():
        """Per-tile dead and live-unparked lane counts, and whether any
        tile can still make progress."""
        dead_b = (e <= 0.0).view(nb, TILE).sum(1, dtype=torch.int32)
        lu = (e > 0.0) & ~parked
        lu_b = lu.view(nb, TILE).sum(1, dtype=torch.int32)
        can_emit = (emitted_b < quota_b) & ((dead_b > 0) | (lu_b > 0))
        return dead_b, lu_b, telemetry.read(can_emit.any() | lu.any())

    def drain_fn(ce, cfields, accum):
        """Trace a compacted chunk against the FULL scene until it dies
        or its round budget runs out; returns the energy left."""
        cpos, cdirs, cage, cwl = cfields
        for _ in range(max_path + 1):
            live = telemetry.count(ce > 0.0)
            if not live:
                break
            with telemetry.span("round",
                                kernel="oracle" if drain_oracle else "k2",
                                lanes=len(ce), live=live):
                with telemetry.span("launch"):
                    if drain_oracle:
                        cpos, cdirs, ne, sid, absorbed = _oracle_bounce(
                            scene, cpos, cdirs, ce, cwl, drain_gen, t_eps,
                            disc_eps, modes.get("ambient_att", 0.0))
                    else:
                        outs = bounce_reflect(rows, _seed(generator), cpos,
                                              cdirs, ce, scene.groups,
                                              wavelength=cwl, **shared)
                        cpos, cdirs, ne, sid, absorbed = outs[:5]
                        if cwl is not None:
                            cwl = outs[5]
                with telemetry.span("account"):
                    hit = sid >= 0
                    _account(accum, sid, (ce > 0.0) & ~hit, absorbed, ce)
                    _dfm.accumulate(accum.flux, fluxspecs, scene, sid, cpos,
                                    absorbed)
                    if att_on:
                        accum.medium += torch.where(hit, ce - absorbed - ne,
                                                    0.0).sum()
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
    while i < max_rounds and telemetry.read((emitted_b < quota_b).any()
                                            | (e > 0.0).any()):
        while i < max_rounds:
            dead_b, lu_b, go = round_state()
            if not go:
                break
            with telemetry.span("round", kernel="k1", lanes=slab) as sp:
                remaining_b = torch.clamp(quota_b - emitted_b, min=0)
                n_new = torch.minimum(dead_b, remaining_b)
                if telemetry.enabled():
                    # the unparked lanes with energy and the reborn ones,
                    # each tile's, summed when the spans are collected
                    sp.set(live=(lu_b, n_new))
                active_b = ((n_new > 0) | (lu_b > 0)).to(torch.int32)
                emitted_b += n_new
                # the engine-side twin of the kernel's dead-lane rank
                dead = (e <= 0.0).view(nb, TILE)
                rank = torch.cumsum(dead.to(torch.int32), dim=1) - 1
                reborn = (dead & (rank < remaining_b[:, None])).view(slab)
                e_before = torch.where(reborn, e_ray, e)
                age = torch.where(reborn, 0, age)

                with telemetry.span("launch"):
                    outs = bounce_reflect_culled(
                        rows_k, lists, counts, cells, cell_bounds,
                        _seed(generator), remaining_b, active_b, pos, dirs,
                        e, scene.groups, group_offsets,
                        source_spec=source_spec, wavelength=wl,
                        park_aureole=park_aureole, order=order, **shared)
                with telemetry.span("account"):
                    npos, ndirs, ne, sid, absorbed = outs[:5]
                    # parked lanes are frozen: the kernel traces them
                    # anyway, but their results are discarded until the
                    # drain
                    sid = torch.where(parked, -1, sid)
                    absorbed = torch.where(parked, 0.0, absorbed)
                    # a hit of a lane born into the aureole arrives encoded
                    # as -(row + 16): account it like any other and park
                    # the survivor, since the disc-sized closure does not
                    # cover its reflected cone
                    aur_hit = sid <= -16
                    sid = torch.where(aur_hit, -sid - 16, sid)
                    hit = sid >= 0
                    demote_hit = hit & demote[sid.clamp(min=0).long()]
                    if row_map is not None:
                        sid = torch.where(
                            hit, row_map[sid.clamp(min=0).long()]
                            .to(torch.int32), sid)
                    _account(accum, sid, ~parked & (e_before > 0.0) & ~hit,
                             absorbed, e_before)
                    _dfm.accumulate(accum.flux, fluxspecs, scene, sid, npos,
                                    absorbed)
                    if att_on:
                        # the kernel reports surface absorption only: the
                        # medium took the rest of each (unparked) hit
                        # segment's loss
                        accum.medium += torch.where(
                            hit, e_before - absorbed - ne, 0.0).sum()
                    low = hit & (ne <= min_energy)
                    accum.culled += torch.where(low, ne, 0.0).sum()
                    ne = torch.where(hit & ~low, ne, 0.0)
                    age = torch.where(~parked & (e_before > 0.0), age + 1,
                                      age)
                    # park survivors of demoted rows, of aureole-born
                    # lanes' first bounce and rays at the age cap
                    newly = ~parked & (ne > 0.0) & (demote_hit | aur_hit
                                                    | (age >= age_cap_lane))
                    pos = torch.where(parked[:, None], pos, npos)
                    dirs = torch.where(parked[:, None], dirs, ndirs)
                    e = torch.where(parked, e, ne)
                    if spectral:
                        wl = torch.where(parked, wl, outs[5])
                    parked = parked | newly
            i += 1
        # drain: re-trace every live lane (parked or not) against the
        # full scene; the zeroed slab resumes emitting
        e = _chunked_drain(e, (pos, dirs, age, wl), drain_fn, cap, accum)
        parked = torch.zeros_like(parked)
    # max_rounds exhaustion can leave live lanes: account, don't drop
    accum.residual += e.sum()
    emitted = emitted_b.sum(dtype=torch.int64)
    return accum, emitted, emitted.to(torch.float64) * e_ray


def _oracle_bounce(scene, pos, dirs, e, wl, generator, t_eps: float,
                   disc_eps: float, ambient_att: float):
    """One bounce of the culled drain without K2 (tracer_tpu/engine.py
    :1402-1425): the oracle's nearest hit over the full scene and the
    unfused shade, in the rays' dtype on their device, the ambient's
    Beer-Lambert loss taken over each hit segment first. Returns (pos,
    dir, energy, sid, absorbed) as K2 does: misses keep their state.
    Each call adds one to ``_oracle_bounce.launches``, so that a run can
    show its oracle drain bounces beside K2's launches."""
    from .kernels.intersect import nearest_hit
    _oracle_bounce.launches += 1
    t, sid = nearest_hit(scene, pos, dirs, t_eps=t_eps, disc_eps=disc_eps,
                         use_pallas=False)
    sid = torch.where(e > 0.0, sid, -1)
    hit = sid >= 0
    e_att = e
    if ambient_att > 0.0:
        e_att = torch.where(hit, e * torch.exp(
            -ambient_att * torch.where(hit, t, 0.0)), e)
    zeros = torch.zeros_like(e)
    res = shade(scene, sid, t, pos, dirs, e_att,
                zeros if wl is None else wl, torch.ones_like(e), generator,
                medium=(zeros, zeros, zeros))
    h3 = hit[:, None]
    return (torch.where(h3, res.out_pos, pos),
            torch.where(h3, res.out_dir, dirs),
            torch.where(hit, res.out_energy, e), sid,
            torch.where(hit, res.absorbed, 0.0))


_oracle_bounce.launches = 0


# optics kinds K2 shades (tracer_tpu/engine.py:1746-1757): the plain
# megakernel takes a scene of these kinds with a bakeable source; the
# others (K_ABSORBER) and the sources without a spec take the general path
_K2_KINDS = {_M.K_REFLECT, _M.K_LAMBERTIAN, _M.K_REFLECT_SPECTRAL,
             _M.K_REFRACTIVE, _M.K_COOK_TORRANCE, _M.K_LAMBERTIAN_SPECULAR,
             _M.K_SEMI_LAMBERTIAN, _M.K_TRANSPARENT, _M.K_FRESNEL_CONDUCTOR,
             _M.K_PERIODIC, _M.K_LAMBERTIAN_PIECEWISE}
# kinds of _bounce_step's fused branch (tracer_tpu/engine.py:261-274;
# refractive rows join without volumetric media or dispersion, and in a
# splitting scene only under split_mode)
_FUSED_KINDS = _K2_KINDS - {_M.K_REFLECT_SPECTRAL, _M.K_REFRACTIVE}
# kinds the culled trace takes (tracer_tpu/engine.py:1781-1786): the
# specular corridor analysis covers mirrors whose reflection keeps its
# direction cone (conductors, IAM-modified ones) and Lambertian rows,
# whose scattered rays culling parks
_CULLED_KINDS = {_M.K_REFLECT, _M.K_LAMBERTIAN, _M.K_REFLECT_SPECTRAL,
                 _M.K_FRESNEL_CONDUCTOR}


def _iam_mode(scene):
    """False without IAM rows; else the scene's one Martin-Ruiz exponent c
    as a truthy float, K2's ``iam`` switch (tracer_tpu/engine.py:120;
    compile_scene tags mixed exponents "iam_nonmirror")."""
    if "iam" not in scene.features:
        return False
    return float(getattr(scene, "iam_c", 1.0)) or 1.0


def _k2_extra(scene) -> dict:
    """K2's stage (d)/(e) switches for ``scene`` (tracer_tpu/engine.py
    :1732-1745, :315-321)."""
    kinds = set(scene.kinds_present)
    return dict(cook_torrance=_M.K_COOK_TORRANCE in kinds,
                lam_specular=_M.K_LAMBERTIAN_SPECULAR in kinds,
                semi_lambertian=_M.K_SEMI_LAMBERTIAN in kinds,
                transparent=_M.K_TRANSPARENT in kinds,
                conductor=_M.K_FRESNEL_CONDUCTOR in kinds,
                iam=_iam_mode(scene), periodic=_M.K_PERIODIC in kinds,
                piecewise=_M.K_LAMBERTIAN_PIECEWISE in kinds)


def _k2_table(scene) -> torch.Tensor:
    """The scene's (L, 2) float32 spectral table as K2 reads it."""
    return (torch.stack([scene.spectral_wl, scene.spectral_ab], dim=1)
            .to(torch.float32).contiguous())


def _k2_needs_wl(scene) -> bool:
    """Whether K2's conductor or piecewise rows read a wavelength lane
    (dispersive conductors, bilinear (theta, wl) grids); the constant
    ones read the table at wavelength 0."""
    kinds, features = set(scene.kinds_present), set(scene.features)
    return ((_M.K_FRESNEL_CONDUCTOR in kinds
             and "conductor_dispersive" in features)
            or (_M.K_LAMBERTIAN_PIECEWISE in kinds
                and "lambertian_piecewise_spectral" in features))


def _k2_fits(scene, media=None) -> bool:
    """Whether K2 can stage the scene's rows, table and media in one
    block's shared memory (tracer_tpu's pallas_rows_fit, for this card)."""
    S = scene.num_rows
    n = (S * row_width(scene) + 2 * scene.spectral_wl.shape[0]
         + POSE_FLOATS)
    if media is not None:
        n += 3 * len(media[0]) + 2 * S
    return n <= MAX_STAGE_FLOATS


def _bake_media(scene, spec_att: float, spec_scat: float, spec_g: float):
    """The static ``(media_tab, media_rows)`` pair of K2's media mode
    (tracer_tpu/engine.py:1513): medium 0 is the ambient (the source
    spec's coefficients); every K_REFRACTIVE row contributes its two side
    media (opt_params 6..11: att, scat and g of sides 1 and 2),
    deduplicated by value in the scene's dtype, so that a lane's id
    compare mirrors the medium-tuple compare of the host-stepped shade.
    ``media_rows`` holds (row, side-1 id, side-2 id) per refractive
    row."""
    okind = scene.opt_kind.cpu().numpy()
    oprm = scene.opt_params.cpu().numpy()
    tab = [tuple(float(np.asarray(v, dtype=oprm.dtype))
                 for v in (spec_att, spec_scat, spec_g))]
    rows_map = []
    for s in np.nonzero(okind == _M.K_REFRACTIVE)[0]:
        ids = []
        for cols in ((6, 8, 10), (7, 9, 11)):
            m = tuple(float(oprm[s, c]) for c in cols)
            if m not in tab:
                tab.append(m)
            ids.append(tab.index(m))
        rows_map.append((int(s), ids[0], ids[1]))
    return tuple(tab), tuple(rows_map)


def _spec_medium(spec):
    """(attenuation, HG scattering coefficient, HG asymmetry) of a source
    spec's ambient medium (slots 14 and 16)."""
    att = float(spec[14]) if len(spec) > 14 else 0.0
    med = spec[16] if len(spec) > 16 else None
    return (att, float(med[0]) if med else 0.0,
            float(med[1]) if med else 0.0)


def _media_for(scene, spec):
    """The media pair when the scene's refractive rows bound volumetric
    media (tracer_tpu/engine.py:1607), else None: energy-splitting scenes
    stay on the general path."""
    if (_M.K_REFRACTIVE not in scene.kinds_present
            or "volumetric" not in scene.features
            or "split" in scene.features):
        return None
    return _bake_media(scene, *_spec_medium(spec))


def _apply_scene_ambient(scene, spec, source_fn):
    """Fold a scene-declared ambient medium (SceneTable.ambient_medium,
    which the periodic-medium composites carry) into the source
    (tracer_tpu/engine.py:1552): the spec's ambient slots (14 the
    attenuation, 16 the HG (scattering, g)) for the megakernel, and the
    medium fields of every bundle the source draws for the general path.
    A spec that declares another nonzero ambient medium is refused.
    Returns (spec, source_fn)."""
    am = getattr(scene, "ambient_medium", ())
    if not am:
        return spec, source_fn
    att, sc, g = (float(v) for v in am)
    if spec is not None:
        sp = list(spec) + [None] * (17 - len(spec))
        cur_med = sp[16] or (0.0, 0.0)
        cur = (float(sp[14] or 0.0), float(cur_med[0]),
               float(cur_med[1]) if len(cur_med) > 1 else 0.0)
        if any(cur) and cur != (att, sc, g):
            raise ValueError(f"source spec declares ambient medium {cur} but "
                             f"the scene's optics declare {(att, sc, g)}")
        sp[14], sp[16] = att, (sc, g)
        spec = tuple(sp)
    base = source_fn

    def wrapped(generator, device=None):
        b = base(generator, device=device)
        return b.replace(att_coeff=torch.full_like(b.att_coeff, att),
                         scat_coeff=torch.full_like(b.scat_coeff, sc),
                         scat_g=torch.full_like(b.scat_g, g))

    wrapped.num_rays = base.num_rays
    if spec is not None:
        wrapped.pallas_spec = spec
    return spec, wrapped


def _ambient_bundle(scene, bundle: RayBundle) -> RayBundle:
    """The bundle paths' twin of _apply_scene_ambient
    (tracer_tpu/engine.py:1592): rays whose medium fields are unset start
    in the scene-declared ambient medium."""
    am = getattr(scene, "ambient_medium", ())
    if not am:
        return bundle
    att, sc, g = (float(v) for v in am)
    unset = (bundle.att_coeff == 0.0) & (bundle.scat_coeff == 0.0)
    return bundle.replace(
        att_coeff=torch.where(unset, att, bundle.att_coeff),
        scat_coeff=torch.where(unset, sc, bundle.scat_coeff),
        scat_g=torch.where(unset, g, bundle.scat_g))


def trace_streaming(scene: SceneTable, source_fn, generator: torch.Generator,
                    total_rays: int, max_rounds: int = 10_000,
                    max_path: int = 100, min_energy: float = 1e-6,
                    t_eps=None, disc_eps: float = 1e-6, block: int = 64,
                    culling=None, fluxspecs: tuple = ()):
    """Streaming wavefront trace with ray regeneration
    (tracer_tpu/engine.py:1625), on the device that holds ``scene``.

    ``source_fn(generator, device=None)`` returns a float32 RayBundle of
    the slab size and declares ``num_rays``, the slab size, and, when its
    rays can be drawn inside the kernels, the static ``pallas_spec``;
    ``generator`` (a CPU torch.Generator) draws every round's kernel seed.
    ``total_rays`` caps how many source rays are emitted; ``max_path`` is
    the per-ray bounce budget. ``fluxspecs`` (device_fluxmap.FluxSpec
    tuple) accumulates receiver flux maps into ``accum.flux``. A
    scene-declared ambient medium is folded into the source first.
    ``block`` (tracer_tpu's surfaces per scan step of its jnp path) is
    accepted and ignored: the kernels here scan every row.

    Returns (accum, emitted, source_e): energy accumulators, rays
    emitted, total energy emitted, with source_e == absorbed + escaped +
    culled + medium + residual to float32 tolerance.

    Three dispatches, as tracer_tpu's:

    * ``culling`` given (culling.BlockCulling built for this scene, source
      and slab) for a cullable scene (_cullable: a disk or rect spec
      without HG scattering, rows of _CULLED_KINDS, a band where a
      wavelength is read): the relevancy-culled trace, K1 every round and
      K2 on the drain. For any other scene the culling is ignored with a
      warning, as tracer_tpu does;
    * a bakeable disk spec and rows of K2's kinds (_K2_KINDS; spectral,
      dispersive, dispersive-conductor and bilinear piecewise rows need
      the spec's band, volumetric scenes an ambient medium or media bound
      by refractive rows; no energy-splitting interfaces): the plain
      megakernel, K2 with in-kernel regeneration;
    * otherwise the general path: the source drawn every round around
      _bounce_step's bounce (K2's fused branch where the scene allows it).
      A scene with energy-splitting interfaces (single_ray=False) streams
      there with true splitting: K2's refr_split outputs fill one
      overflow slot per lane.

    Bifacial rows reject rays that reach their back (backside_miss) on
    every path. Mixed IAM exponents (K2 takes one) and splitting scenes
    with volumetric media or dispersive interfaces take the general path's
    unfused bounce, K3 and the shade. A float64 scene takes the general
    path on either device, its nearest hits from the float64 oracle and
    its accumulators in float64; a ``culling`` is then ignored with a
    warning (the kernels are float32, tracer_tpu/engine.py:1760-1767)."""
    with telemetry.call("trace_streaming", total_rays):
        return _trace_streaming(scene, source_fn, generator, total_rays,
                                max_rounds, max_path, min_energy, t_eps,
                                disc_eps, culling, fluxspecs)


def _trace_streaming(scene, source_fn, generator, total_rays, max_rounds,
                     max_path, min_energy, t_eps, disc_eps, culling,
                     fluxspecs):
    """trace_streaming's dispatch, inside its call span."""
    spec = getattr(source_fn, "pallas_spec", None)
    spec, source_fn = _apply_scene_ambient(scene, spec, source_fn)
    if scene.frame.dtype != torch.float32:
        # K1 and K2 are float32: a float64 scene streams on the general
        # path (nearest hits from the oracle, the unfused shade), as
        # tracer_tpu's kernel_ok gate sends it to its jnp path
        if culling is not None:
            log.warning("culling ignored: %s scene takes the general "
                        "streaming path", scene.frame.dtype)
        return _trace_streaming_general(
            scene, source_fn, generator, total_rays, max_rounds, max_path,
            min_energy, t_eps, disc_eps, fluxspecs=fluxspecs)
    n = source_fn.num_rays
    kinds = set(scene.kinds_present)
    features = set(scene.features)
    te = 3e-4 if t_eps is None else t_eps   # float32 default_t_eps
    common = dict(max_rounds=max_rounds, max_path=max_path,
                  min_energy=min_energy, t_eps=te, bivar=_bivar_mode(scene),
                  one_sided="one_sided" in features,
                  slope="slope_error" in features,
                  fluxspecs=fluxspecs)
    if culling is not None:
        if _cullable(scene, spec):
            return _trace_culled(scene, spec, culling, generator,
                                 total_rays, n, common, disc_eps)
        log.warning("culling ignored: scene/source not megakernel-eligible "
                    "(kinds=%s features=%s)", scene.kinds_present,
                    scene.features)
    band = spec[13] if spec is not None and len(spec) > 13 else None
    att, scat, _ = _spec_medium(spec) if spec is not None else (0, 0, 0)
    refractive = _M.K_REFRACTIVE in kinds
    refr_disp = refractive and "dispersive" in features
    spectral = (_M.K_REFLECT_SPECTRAL in kinds or refr_disp
                or _k2_needs_wl(scene))
    media = _media_for(scene, spec) if spec is not None else None
    vol_ok = ("volumetric" not in features or media is not None
              or ((att > 0.0 or scat > 0.0) and "dispersive" not in features))
    if (spec is not None and kinds <= _K2_KINDS
            and (band is not None or not spectral) and vol_ok
            and "split" not in features and "iam_nonmirror" not in features
            and _k2_fits(scene, media)):
        spec_c, frame = _spec_frame_split(spec)
        return _trace_streaming_megakernel(
            scene, spec_c, torch.as_tensor(frame, device=scene.device),
            generator, total_rays, n, disc_eps=disc_eps,
            lambertian=_M.K_LAMBERTIAN in kinds, spectral=spectral,
            refractive=refractive, refr_disp=refr_disp,
            refr_frost=refractive and "refractive_slope" in features,
            media=media, extra=_k2_extra(scene),
            backside_miss="bifacial" in features, **common)
    return _trace_streaming_general(
        scene, source_fn, generator, total_rays, max_rounds, max_path,
        min_energy, t_eps, disc_eps, fluxspecs=fluxspecs)


def _culled_wl(scene) -> bool:
    """Whether the culled trace threads a wavelength lane: spectral rows
    or dispersive conductors read it."""
    kinds, features = set(scene.kinds_present), set(scene.features)
    return (_M.K_REFLECT_SPECTRAL in kinds
            or (_M.K_FRESNEL_CONDUCTOR in kinds
                and "conductor_dispersive" in features))


def _cullable(scene, spec) -> bool:
    """tracer_tpu's ``cullable`` gate (tracer_tpu/engine.py:1746-1786)
    less its backend test (the port's kernels serve both devices): a
    spec, rows of _CULLED_KINDS, the spec's band wherever a wavelength is
    read (spectral rows, dispersive conductors), no HG scattering in the
    spec (it redirects anywhere: no corridor closes), volumetric scenes
    only as the spec's ambient attenuation, one IAM exponent."""
    if spec is None:
        return False
    kinds, features = set(scene.kinds_present), set(scene.features)
    band = spec[13] if len(spec) > 13 else None
    att, scat, _ = _spec_medium(spec)
    vol_ok = ("volumetric" not in features
              or (att > 0.0 and "dispersive" not in features))
    return (kinds <= _CULLED_KINDS
            and (band is not None or not _culled_wl(scene))
            and scat == 0.0 and vol_ok and "iam_nonmirror" not in features)


def _trace_culled(scene, spec, culling, generator, total_rays, n, common,
                  disc_eps):
    """trace_streaming's culled dispatch for a cullable scene: the
    culling's whole layout on this device (_run_culled)."""
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
    return _run_culled(
        scene, spec, generator, common, disc_eps, lists=culling.lists,
        counts=culling.counts, cells=np.arange(nb),
        cell_bounds=culling.cell_bounds,
        quota=culling.block_quota(total_rays), age_caps=culling.age_caps,
        group_offsets=culling.group_offsets,
        demote_rows=culling.demote_rows, park_aureole=culling.park_aureole,
        order=culling.order)


def _run_culled(scene, spec, generator, common, disc_eps, *, lists, counts,
                cells, cell_bounds, quota, age_caps, group_offsets,
                demote_rows=(), park_aureole: bool = False, order=None,
                row_map=None, demote_mask=None):
    """The culled trace of the tiles given by the host arrays ``lists``,
    ``counts``, ``cells`` (global tile ids), ``cell_bounds``, ``quota``
    and ``age_caps`` (a whole layout, or a rank's block range or segment
    of it, with its ``row_map`` and ``demote_mask``), copied to the
    scene's device: K1's modes from the scene's kinds and features
    (tracer_tpu/engine.py:1794-1806), the wavelength lane where spectral
    or dispersive-conductor rows read it, and the drain on K2 or, for a
    table past K2's stage, through the oracle."""
    kinds, features = set(scene.kinds_present), set(scene.features)
    modes = dict(lambertian=_M.K_LAMBERTIAN in kinds,
                 ambient_att=_spec_medium(spec)[0],
                 conductor=_M.K_FRESNEL_CONDUCTOR in kinds,
                 iam=_iam_mode(scene), backside_miss="bifacial" in features)
    dev = scene.device
    drain_oracle = not _k2_fits(scene)
    if drain_oracle:
        log.warning("the table's %d rows are past K2's stage: the culled "
                    "drain runs through the oracle and the unfused shade "
                    "in PyTorch, counted in _oracle_bounce.launches",
                    scene.num_rows)

    def dev_i32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=dev)

    return _trace_streaming_megakernel_culled(
        scene, generator, dev_i32(lists), dev_i32(counts), dev_i32(cells),
        torch.as_tensor(np.asarray(cell_bounds), dtype=torch.float32,
                        device=dev),
        dev_i32(quota), dev_i32(age_caps), source_spec=spec,
        group_offsets=tuple(group_offsets), slab=len(lists) * TILE,
        demote_rows=tuple(demote_rows), disc_eps=disc_eps,
        spectral=_culled_wl(scene), modes=modes, park_aureole=park_aureole,
        order=None if order is None else dev_i32(order),
        row_map=(None if row_map is None else torch.as_tensor(
            np.asarray(row_map), dtype=torch.int64, device=dev)),
        demote_mask=(None if demote_mask is None else torch.as_tensor(
            np.asarray(demote_mask), dtype=torch.bool, device=dev)),
        drain_oracle=drain_oracle, **common)


# the per-ray state fields of a streaming slab that regeneration moves
# together (tracer_tpu/engine.py:1920)
_RAY_FIELDS = ("pos", "dir", "energy", "wavelength", "ref_index",
               "att_coeff", "scat_coeff", "scat_g")


def _where_ray_fields(mask, new: RayBundle, old: RayBundle) -> RayBundle:
    """Per-lane select of every ray-state field: mask ? new : old
    (tracer_tpu/engine.py:1924)."""
    upd = {}
    for f in _RAY_FIELDS:
        a, b = getattr(new, f), getattr(old, f)
        upd[f] = torch.where(mask[:, None] if b.ndim == 2 else mask, a, b)
    return old.replace(**upd)


def _trace_streaming_general(scene: SceneTable, source_fn,
                             generator: torch.Generator, total_rays: int,
                             max_rounds: int, max_path: int,
                             min_energy: float, t_eps, disc_eps: float,
                             fluxspecs: tuple = ()):
    """The general streaming path (tracer_tpu/engine.py:1938), for sources
    without a bakeable spec and scenes the megakernel does not take: a
    host loop whose rounds refill a prefix of the free lanes, up to the
    emission budget, from a fresh slab of ``source_fn``, run one
    _bounce_step (K2's fused branch where _fused_ok allows it; otherwise
    K3, the media and the shade) with the flux maps, and cull rays past
    ``max_path``. The slab is drawn on the scene's device from a
    generator seeded by ``generator``, which also draws the bounces'
    seeds.

    A scene with energy-splitting interfaces streams with true splitting:
    every bounce runs K2's refr_split mode, or the shade's split_mode
    where the scene does not fuse, so a lane that splits carries on
    refracted and its reflected branch parks in the lane's overflow slot
    (_merge_split). Each round first places every parked branch into
    its own lane if that lane is free (_place_overflow), before fresh
    source rays refill the rest, so the population never grows. Branches
    past ``max_path`` are culled with their energy accounted.

    The slab traces in the scene's dtype (a float64 scene casts the
    source's rays to float64), and the accumulators follow it. One device
    read a round (emitted, live and parked counts). Energy still alive at
    ``max_rounds``, parked branches included, goes to the residual, so the
    closure is exact. Returns (accum, emitted, source energy)."""
    split = "split" in scene.features
    dev = scene.device
    n = source_fn.num_rays
    src_gen = torch.Generator(device=dev).manual_seed(_seed(generator))
    dtype = scene.frame.dtype

    def draw():
        # the slab traces in the scene's dtype
        with telemetry.span("draw", rays=n):
            b = source_fn(src_gen, device=dev)
            if b.pos.dtype == dtype:
                return b
            return b.replace(**{f: getattr(b, f).to(dtype) for f in
                                _RAY_FIELDS})
    fresh = draw()
    if fresh.spectra is not None:
        # tracer_tpu/engine.py:1687-1691; the spec'd paths draw their rays
        # in the kernels from the spec, which carries no spectra
        raise NotImplementedError(
            "polychromatic sources trace on the host-stepped "
            "TracerEngine.ray_tracer path; the streaming paths are "
            "monochromatic — sample wavelengths instead")
    if fresh.num_rays != n:
        raise ValueError(f"source_fn drew {fresh.num_rays} rays, declared "
                         f"{n}")
    bundle = fresh.replace(alive=torch.zeros_like(fresh.alive),
                           energy=torch.zeros_like(fresh.energy))
    accum = TraceAccum.zeros(scene.num_rows, dtype=fresh.pos.dtype,
                             device=dev, fluxspecs=fluxspecs)
    age = torch.zeros((n,), dtype=torch.int32, device=dev)
    source_e = torch.zeros((), dtype=torch.float64, device=dev)
    if split:
        # each lane's overflow slot (empty) and its branch's age; the
        # merges draw from their own generator
        ovf, ovf_age = bundle, torch.zeros_like(age)
        merge_gen = torch.Generator(device=dev).manual_seed(
            _seed(generator))
    # the bounce's kernel: K2's fused branch, else K3 (float32) or the
    # float64 oracle, and the unfused shade
    kernel = ("k2" if _fused_ok(scene, split) else
              "k3" if dtype == torch.float32 else "oracle")
    emitted, live, parked, i = 0, 0, 0, 0
    while i < max_rounds and (emitted < total_rays or live or parked):
        with telemetry.span("round", kernel=kernel, lanes=n) as sp:
            if split:
                bundle, age, ovf = _place_overflow(bundle, age, ovf,
                                                   ovf_age)
            n_new = torch.zeros((), dtype=torch.int64, device=dev)
            if emitted < total_rays:
                if i:
                    fresh = draw()
                free = ~bundle.alive
                rank = torch.cumsum(free.to(torch.int32), 0)
                refill = free & (rank <= total_rays - emitted)
                bundle = _where_ray_fields(refill, fresh, bundle).replace(
                    alive=bundle.alive | refill)
                age = torch.where(refill, 0, age)
                n_new = refill.sum()
                source_e += torch.where(refill, fresh.energy, 0.0).sum(
                    dtype=torch.float64)
            if telemetry.enabled():
                sp.set(live=bundle.alive.sum())
            prev = bundle
            bundle, accum, rec = _bounce_step(
                scene, bundle, accum, generator, min_energy=min_energy,
                t_eps=t_eps, disc_eps=disc_eps, block=64, count_hits=False,
                need_local=False, split_mode=split)
            with telemetry.span("account"):
                if split:
                    ovf, ovf_age = _merge_split(ovf, ovf_age, prev, age, rec,
                                                accum, min_energy, merge_gen)
                _dfm.accumulate(accum.flux, fluxspecs, scene, rec.sid,
                                rec.hit, rec.absorbed)
                # the per-ray bounce budget
                age = age + 1
                over = bundle.alive & (age >= max_path)
                accum.culled += torch.where(over, bundle.energy, 0.0).sum()
                bundle = bundle.replace(alive=bundle.alive & ~over)
                counts = [n_new, bundle.alive.sum()]
                if split:
                    ovf = _cull_overflow(ovf, ovf_age, max_path, accum)
                    counts.append(ovf.alive.sum())
            new, live, *rest = telemetry.read(torch.stack(counts))
            parked = rest[0] if split else 0
            emitted += new
        i += 1
    accum.residual += torch.where(bundle.alive, bundle.energy, 0.0).sum()
    if split:
        accum.residual += torch.where(ovf.alive, ovf.energy, 0.0).sum()
    return accum, torch.tensor(emitted, dtype=torch.int64), source_e


def _place_overflow(bundle: RayBundle, age, ovf: RayBundle, ovf_age):
    """Each lane's parked branch takes the lane the round it is free
    (tracer_tpu/engine.py:1999): elementwise selects, no cross-lane
    moves, and before regeneration, so fresh rays never starve a branch.
    The branch's path already holds the bounce that split it: its age is
    ``ovf_age + 1``. Returns (bundle, age, ovf)."""
    place = ovf.alive & ~bundle.alive
    bundle = _where_ray_fields(place, ovf, bundle).replace(
        alive=bundle.alive | place)
    age = torch.where(place, ovf_age + 1, age)
    ovf = ovf.replace(alive=ovf.alive & ~place,
                      energy=torch.where(place, 0.0, ovf.energy))
    return bundle, age, ovf


def _cull_overflow(ovf: RayBundle, ovf_age, max_path: int,
                   accum: TraceAccum) -> RayBundle:
    """Cull the parked branches that would resume past the bounce budget
    (``ovf_age + 1 >= max_path``, tracer_tpu/engine.py:2073), their
    energy accounted in ``accum`` (in place)."""
    over = ovf.alive & (ovf_age + 1 >= max_path)
    accum.culled += torch.where(over, ovf.energy, 0.0).sum()
    return ovf.replace(alive=ovf.alive & ~over)


def _merge_split(ovf: RayBundle, ovf_age, prev: RayBundle, age_now, rec,
                 accum: TraceAccum, min_energy: float,
                 generator: torch.Generator):
    """Park this round's reflected branches (``rec.split``) in their
    lanes' overflow slots (tracer_tpu/engine.py:2027), ``accum`` in
    place. Branches of at most ``min_energy`` are culled with their energy
    accounted. A lane whose slot is still occupied merges the two
    branches: it keeps the new one with probability s_e / (e_ovf + s_e)
    (a uniform of ``generator``) and carries their sum, which is unbiased.
    A branch starts at the hit point along its reflected direction with
    the incidence side's ray fields (``prev``, the bundle before the
    bounce) and its parent's age ``age_now``. Returns (ovf, ovf_age)."""
    s_mask, s_e, s_dir = rec.split
    ok = s_mask & (s_e > min_energy)
    accum.culled += torch.where(s_mask & ~ok, s_e, 0.0).sum()
    both = ovf.alive & ok
    tot = ovf.energy + s_e
    u = torch.rand(s_e.shape, generator=generator, dtype=s_e.dtype,
                   device=s_e.device)
    take_new = both & (u * tot < s_e)
    new_store = (ok & ~ovf.alive) | take_new
    sec = prev.replace(pos=rec.hit, dir=s_dir)
    ovf = _where_ray_fields(new_store, sec, ovf).replace(
        energy=torch.where(both, tot,
                           torch.where(ok & ~ovf.alive, s_e, ovf.energy)),
        alive=ovf.alive | ok)
    return ovf, torch.where(new_store, age_now, ovf_age)


def _spec_frame_split(spec):
    """Split a bakeable spec into (canonical static spec, (21,) float32
    pose: centre xyz, row-major position rotation, row-major direction
    rotation, an oblique rect source's rays_rot) (tracer_tpu/engine.py
    :1892). The pose is K2's operand instead of a constant, so traces
    that differ only by the source's aim share the same spec; the spec's
    pose slots, and a rect marker's rays_rot, hold None."""
    spec_c = list(spec)
    spec_c[0] = spec_c[1] = spec_c[2] = spec_c[3] = None
    rect = spec[15] if len(spec) > 15 else None
    if rect is not None:
        spec_c[15] = (rect[0], rect[1], None) + tuple(rect[3:])
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
    spectra: Optional[torch.Tensor] = None      # (N, K) outgoing spectra
    #   of a polychromatic bundle
    split: Optional[tuple] = None   # refr_split bounces: (lanes that split,
    #   reflected branch energy (N,), its direction (N,3))
    bounce: Optional[int] = None    # bounce index
    slot: Optional[torch.Tensor] = None  # (K,) slab slot of each entry of
    #   a compacted (record="tags") record

    def replace(self, **changes) -> "BounceRecord":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "BounceRecord":
        def move(v):
            return (tuple(a.to(device) for a in v) if isinstance(v, tuple)
                    else v.to(device))
        return self.replace(**{
            f.name: move(v) for f in dataclasses.fields(self)
            for v in (getattr(self, f.name),)
            if torch.is_tensor(v) or isinstance(v, tuple)})


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


def _check_device(scene, bundle: RayBundle) -> None:
    if bundle.pos.device != scene.device:
        raise ValueError(f"the bundle is on {bundle.pos.device}, the scene "
                         f"on {scene.device}")


def _fused_ok(scene: SceneTable, split_mode: bool = False) -> bool:
    """The gate of _bounce_step's fused K2 branch (tracer_tpu/engine.py
    :261-282) less its backend test: every kind fusable (refractive rows
    without dispersion, and in a scene with energy-splitting interfaces
    only under ``split_mode``, where K2 splits them: its roulette would
    drop the reflected share), no volumetric media, one IAM exponent,
    float32, and rows that fit K2's stage."""
    kinds, features = set(scene.kinds_present), set(scene.features)
    fusable = _FUSED_KINDS
    if "dispersive" not in features and ("split" not in features
                                         or split_mode):
        fusable = fusable | {_M.K_REFRACTIVE}
    return (kinds <= fusable and "volumetric" not in features
            and "iam_nonmirror" not in features
            and scene.frame.dtype == torch.float32 and _k2_fits(scene))


def _bounce_step_fused(scene: SceneTable, bundle: RayBundle,
                       accum: TraceAccum, generator: torch.Generator,
                       min_energy: float, t_eps, disc_eps: float,
                       count_hits: bool, split_mode: bool = False):
    """_bounce_step's fused branch (tracer_tpu/engine.py:283-362): one K2
    bounce, no regeneration, on CUDA tensors the kernel and on CPU tensors
    its plain version; with ``split_mode`` in a scene with F_SPLIT
    interfaces K2 splits them (refr_split) and the record's ``split``
    holds the reflected branches. The record carries no local hit point,
    normal or distance (t is 0 on hits)."""
    kinds, features = set(scene.kinds_present), set(scene.features)
    refractive = _M.K_REFRACTIVE in kinds
    refr_split = refractive and split_mode and "split" in features
    extra = _k2_extra(scene)
    need_wl = _k2_needs_wl(scene)
    with telemetry.span("launch"):
        outs = bounce_reflect(
            pack_rows(scene), _seed(generator), bundle.pos, bundle.dir,
            bundle.energy, scene.groups, 3e-4 if t_eps is None else t_eps,
            disc_eps, bivar=_bivar_mode(scene),
            one_sided="one_sided" in features,
            slope="slope_error" in features,
            lambertian=_M.K_LAMBERTIAN in kinds,
            wavelength=bundle.wavelength if need_wl else None,
            spectral_tab=(_k2_table(scene) if extra["conductor"]
                          or extra["piecewise"] else None),
            ref_index=bundle.ref_index if refractive else None,
            refr_frost=refractive and "refractive_slope" in features,
            refr_split=refr_split, backside_miss="bifacial" in features,
            **extra)
    new_pos, new_dir, new_e, sid, absorbed = outs[:5]
    new_ri = outs[5 + int(need_wl)] if refractive else bundle.ref_index
    alive = bundle.alive & (bundle.energy > 0.0)
    sid = torch.where(alive, sid, -1)
    hit = sid >= 0
    e_in = torch.where(hit, bundle.energy, 0.0)
    e_out = torch.where(hit, new_e, 0.0)
    absorbed_ray = torch.where(hit, absorbed, 0.0)
    _account(accum, sid, alive & ~hit, absorbed_ray, bundle.energy,
             count_hits)
    low = hit & (e_out <= min_energy)
    accum.culled += torch.where(low, e_out, 0.0).sum()
    alive_next = hit & ~low
    h3 = hit[:, None]
    new_bundle = bundle.replace(
        pos=torch.where(h3, new_pos, bundle.pos),
        dir=torch.where(h3, new_dir, bundle.dir),
        energy=torch.where(alive_next, e_out, 0.0),
        ref_index=torch.where(hit, new_ri, bundle.ref_index),
        alive=alive_next)
    rec_split = None
    if refr_split:
        s_e, s_dir = outs[-2:]
        s_mask = alive & (s_e > 0.0)
        rec_split = (s_mask, torch.where(s_mask, s_e, 0.0), s_dir)
    zeros3 = torch.zeros_like(bundle.pos)
    rec = BounceRecord(
        sid=sid, t=torch.where(hit, 0.0, math.inf), hit=new_pos,
        local=zeros3, dir_in=bundle.dir, dir_out=new_dir, e_in=e_in,
        e_out=e_out, absorbed=absorbed_ray, backside=torch.zeros_like(hit),
        alive_in=alive, wavelength=bundle.wavelength, normal=zeros3,
        split=rec_split)
    return new_bundle, accum, rec


def _epilogue_takes(scene: SceneTable, bundle: RayBundle,
                    fluxspecs: tuple = ()) -> bool:
    """The K3 epilogue's gate less its device test: a float32
    monochromatic bundle that tracks no gradient, in a scene that passes
    _fused_ok (the kinds K2's shade covers, no volumetric media, no
    dispersion, no energy splitting, one IAM exponent, rows that fit K2's
    stage), with flux specs the kernel bins (kernels.epilogue.takes)."""
    tensors = (bundle.pos, bundle.dir, bundle.energy,
               *(v for v in vars(scene).values()
                 if isinstance(v, torch.Tensor)))
    return (bundle.pos.dtype == torch.float32 and bundle.spectra is None
            and not (torch.is_grad_enabled()
                     and any(v.requires_grad for v in tensors))
            and _fused_ok(scene)
            and _epi.takes(scene.num_rows, fluxspecs))


def _epilogue_ok(scene: SceneTable, bundle: RayBundle,
                 fluxspecs: tuple = ()) -> bool:
    """Whether trace_fused takes the K3 epilogue (csrc/epilogue.cu): CUDA
    tensors and _epilogue_takes. Every other trace (CPU tensors, float64,
    records, media, dispersion, gradients) keeps the plain bounce, the
    kernel's twin."""
    return bundle.pos.is_cuda and _epilogue_takes(scene, bundle, fluxspecs)


def _epilogue_plan(scene: SceneTable, bundle: RayBundle, generator,
                   min_energy: float, fluxspecs: tuple) -> "_epi.Epilogue":
    """One trace_fused call's epilogue state, its modes from K2's helpers
    (_bivar_mode, _k2_extra, _k2_needs_wl) as _bounce_step_fused takes
    them. The Philox seed is drawn from ``generator`` only where the
    scene's kinds draw."""
    from .kernels import build
    kinds, features = set(scene.kinds_present), set(scene.features)
    refractive = _M.K_REFRACTIVE in kinds
    extra = _k2_extra(scene)
    lambertian = _M.K_LAMBERTIAN in kinds
    modes = _modes(_bivar_mode(scene), "one_sided" in features,
                   "slope_error" in features, lambertian, 0.0,
                   refractive and "refractive_slope" in features, False,
                   False, 0.0, 0.0, "bifacial" in features,
                   tuple(extra[k] for k in EXTRA_MODES))
    draws = ("slope_error" in features or lambertian or refractive
             or any(extra[k] for k in ("cook_torrance", "lam_specular",
                                       "semi_lambertian", "piecewise")))
    dev = bundle.pos.device
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    return _epi.Epilogue(
        pack_rows(scene), {k: getattr(bundle, k) for k in _epi.RAY_FIELDS},
        fluxspecs, modes, refractive=refractive,
        wavelength=bundle.wavelength if _k2_needs_wl(scene) else None,
        spectral_tab=(_k2_table(scene) if extra["conductor"]
                      or extra["piecewise"] else None),
        min_energy=min_energy, seed=_seed(generator) if draws else 0,
        lib=build.load(), stream=stream)


def _bounce_step_epilogue(scene: SceneTable, bundle: RayBundle,
                          plan: "_epi.Epilogue", bounce: int, t_eps: float,
                          disc_eps: float) -> RayBundle:
    """trace_fused's bounce on the card: K3 (nearest.nearest_hit, without
    the local hit point, which nothing reads here) and the K3 epilogue,
    which shades, writes the next ray state into ``plan.out`` and adds the
    bounce's accounting and flux bins to ``plan``'s partial table. Returns
    the next bundle."""
    from .kernels import nearest
    with telemetry.span("launch"):
        t, sid, aux = nearest.nearest_hit(
            plan.rows, bundle.pos, bundle.dir, scene.groups, t_eps,
            disc_eps, need_local=False,
            backside_miss="bifacial" in scene.features)
    with telemetry.span("shade", kernel=True):
        out = _epi.k3_epilogue(plan, bounce, t, sid, aux,
                               {k: getattr(bundle, k)
                                for k in _epi.RAY_FIELDS})
    return bundle.replace(**out)


def _media_step(bundle: RayBundle, alive, sid, t, accum: TraceAccum,
                generator: torch.Generator):
    """The volumetric part of a bounce (tracer_tpu/engine.py:403-446):
    an exponential free path from each lane's scattering coefficient; the
    lanes whose path ends before their surface hit scatter there instead
    (sid -1); every live lane is Beer-Lambert attenuated over the distance
    it travels, the loss added to ``accum.medium`` (in place), and a
    polychromatic lane's spectrum scaled with it. Returns
    (attenuated bundle, sid, scattered mask, scattering points, their
    Henyey-Greenstein directions about the travel direction)."""
    t_hit = torch.where(sid >= 0, t, math.inf)
    hits_first, free_path = sample_scattering(generator, bundle.scat_coeff,
                                              t_hit)
    scattered = alive & hits_first
    sid = torch.where(scattered, -1, sid)
    travel = torch.minimum(free_path, t_hit)
    att_ok = torch.isfinite(travel) & (bundle.att_coeff > 0.0)
    trans = torch.exp(-bundle.att_coeff * torch.where(att_ok, travel, 0.0))
    energy = torch.where(alive & att_ok, bundle.energy * trans,
                         bundle.energy)
    accum.medium += torch.where(alive, bundle.energy - energy, 0.0).sum()
    spectra = bundle.spectra
    if spectra is not None:
        # the gray ambient medium scales the whole spectrum
        spectra = spectra * torch.where(alive & att_ok, trans,
                                        1.0)[:, None]
    g = bundle.scat_g

    def uniform():
        return torch.rand(g.shape, generator=generator, dtype=g.dtype,
                          device=generator.device).to(g.device)
    # Henyey-Greenstein polar cosine; |g| < 1e-9 scatters isotropically
    u = uniform() * 2.0 - 1.0
    iso = g.abs() < 1e-9
    g2 = g * g
    hg = (1.0 + g2 - ((1.0 - g2) / (1.0 + g * u)) ** 2) / (
        2.0 * torch.where(iso, 1.0, g))
    cos_th = torch.where(iso, u, hg).clamp(-1.0, 1.0)
    sin_th = safe_sqrt(1.0 - cos_th ** 2)
    phi = uniform() * (2.0 * math.pi)
    d_scat = rotate_to_normal(torch.stack([sin_th * torch.cos(phi),
                                           sin_th * torch.sin(phi), cos_th],
                                          dim=1), bundle.dir)
    p_scat = bundle.pos + torch.where(scattered, free_path,
                                      0.0)[:, None] * bundle.dir
    return (bundle.replace(energy=energy, spectra=spectra), sid, scattered,
            p_scat, d_scat)


# rows from which the differentiable bounce picks each ray's winner with
# K3 and recomputes only its distance (tracer_tpu/engine.py:371-397);
# below it the brute force costs less than the recompute's gathers
FAST_WINNER_ROWS = 48


def _fast_winner(scene: SceneTable, bundle: RayBundle, t_eps, disc_eps,
                 block: int):
    """The differentiable bounce's nearest hit on scenes of
    FAST_WINNER_ROWS rows or more (tracer_tpu/engine.py:371-397): the
    winner's row is chosen under no_grad by nearest_hit (K3 on float32
    rays, on the card its CUDA kernel, which launches or raises; the
    float64 oracle otherwise), an integer with no gradient, and its
    distance is recomputed on the live tensors by _candidate_t, so the
    O(N S) brute force never enters the backward pass. Lanes where the
    recompute's epsilon ordering rejects the kernel's winner keep the
    kernel's distance (no gradient there, a set of measure zero) instead
    of feeding inf downstream.

    _candidate_t gathers each ray's row by index_select, whose backward
    is index_add_ into the (S, ...) tables. tracer_tpu replaces that
    scatter by a one-hot matmul (_take_rows) because a TPU serialises
    scatter-adds; on the card it is an atomic add of a few floats a lane
    into a table of S rows, so the port keeps it (its cost is measured,
    chip_smoke.py phase 15)."""
    from .kernels.intersect import _candidate_t, default_t_eps, nearest_hit
    te = default_t_eps(bundle.pos.dtype) if t_eps is None else t_eps
    with torch.no_grad():
        t_ng, sid = nearest_hit(scene, bundle.pos.detach(),
                                bundle.dir.detach(), t_eps=te,
                                disc_eps=disc_eps, block=block)
    t = _candidate_t(scene, sid, bundle.pos, bundle.dir, te, disc_eps)
    return torch.where((sid >= 0) & ~torch.isfinite(t), t_ng, t), sid


def _bounce_step(scene: SceneTable, bundle: RayBundle, accum: TraceAccum,
                 generator: torch.Generator, min_energy: float, t_eps,
                 disc_eps: float, block: int, count_hits: bool = True,
                 need_local: bool = True, split_mode: bool = False,
                 cand=None, force_jnp: bool = False, spectral_alpha=None):
    """One bounce: nearest hit, the media (_media_step, in a volumetric
    scene), shade, account (``accum`` in place). Returns (bundle', accum,
    record). Without ``need_local`` a scene that passes _fused_ok takes
    the fused K2 branch (_bounce_step_fused): on CUDA tensors the kernel,
    on CPU tensors its plain version, where tracer_tpu's CPU backend takes
    its jnp path; ray_tracer and trace_fused keep need_local, and every
    other scene takes K3 and the shade. ``split_mode`` splits the
    energy-splitting interfaces (K2's refr_split or the shade's split
    mode): the record's ``split`` carries the reflected branches; without
    it they roulette. A lane that scattered in its medium lives on at the
    event point (sid -1).

    ``cand`` (N, K) int32, the Kd tree's per-ray candidate rows padded
    with -1, replaces the brute-force nearest hit by
    nearest_hit_candidates (no aux: the shade gathers its rows).
    ``force_jnp`` (diff.trace_diff) keeps every step differentiable: the
    oracle's brute force below FAST_WINNER_ROWS rows, _fast_winner from
    there, no aux and never the fused branch. ``accum`` is written in
    place, so a differentiable caller passes fresh accumulators. A
    polychromatic bundle's spectra are filtered (tracer_tpu/engine.py
    :459-479): rows with a spectral absorptance table (``spectral_alpha``,
    _rows_alpha_on_grid's pair) multiply the spectrum by 1 - alpha on the
    grid and their outgoing energy becomes its trapezoid integral; every
    other kind scales it by its energy ratio."""
    if (cand is None and not need_local and not force_jnp
            and _fused_ok(scene, split_mode)):
        return _bounce_step_fused(scene, bundle, accum, generator,
                                  min_energy, t_eps, disc_eps, count_hits,
                                  split_mode)
    alive = bundle.alive & (bundle.energy > 0.0)
    with telemetry.span("launch"):
        if cand is not None:
            t, sid = nearest_hit_candidates(scene, cand, bundle.pos,
                                            bundle.dir, t_eps=t_eps,
                                            disc_eps=disc_eps)
            aux = None
        elif force_jnp and scene.num_rows >= FAST_WINNER_ROWS:
            t, sid = _fast_winner(scene, bundle, t_eps, disc_eps, block)
            aux = None
        else:
            t, sid, aux = nearest_hit_aux(scene, bundle.pos, bundle.dir,
                                          t_eps=t_eps, disc_eps=disc_eps,
                                          block=block,
                                          need_local=need_local,
                                          force_jnp=force_jnp)
    sid = torch.where(alive, sid, -1)
    volumetric = "volumetric" in scene.features
    if volumetric:
        bundle, sid, scattered, p_scat, d_scat = _media_step(
            bundle, alive, sid, t, accum, generator)
    hit = sid >= 0
    escaped = alive & ~hit
    if volumetric:
        escaped = escaped & ~scattered
    with telemetry.span("shade", kernel=False):
        res = shade(scene, sid, t, bundle.pos, bundle.dir, bundle.energy,
                    bundle.wavelength, bundle.ref_index, generator,
                    medium=(bundle.att_coeff, bundle.scat_coeff,
                            bundle.scat_g),
                    aux=aux, split_mode=split_mode)
    e_in = torch.where(hit, bundle.energy, 0.0)
    e_out = torch.where(hit, res.out_energy, 0.0)
    absorbed_ray = torch.where(hit, res.absorbed, 0.0)
    new_spectra = None
    if bundle.spectra is not None:
        ratio = torch.where(e_in > 0.0, e_out / e_in.clamp(min=1e-30), 0.0)
        if spectral_alpha is not None:
            has_tab, alpha = spectral_alpha       # (S,) bool, (S, K)
            s0 = sid.clamp(min=0).long()
            ht = hit & has_tab[s0]
            fac = torch.where(ht[:, None], 1.0 - alpha[s0], ratio[:, None])
        else:
            ht = torch.zeros_like(hit)
            fac = ratio[:, None]
        new_spectra = torch.where(hit[:, None], bundle.spectra * fac,
                                  bundle.spectra)
        e_spec = torch.trapezoid(new_spectra, bundle.spectral_grid, dim=1)
        e_out = torch.where(ht, e_spec, e_out)
        absorbed_ray = torch.where(ht, e_in - e_out, absorbed_ray)
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
    if volumetric:
        # scattered lanes move to the event point along their HG
        # direction and stay alive with their attenuated energy
        s3 = scattered[:, None]
        new_bundle = new_bundle.replace(
            pos=torch.where(s3, p_scat, new_bundle.pos),
            dir=torch.where(s3, d_scat, new_bundle.dir),
            energy=torch.where(scattered, bundle.energy, new_bundle.energy),
            alive=new_bundle.alive | scattered)
    if new_spectra is not None:
        new_bundle = new_bundle.replace(spectra=new_spectra)
    rec_split = None
    if res.split is not None:
        s_rows, s_e, s_dir = res.split
        s_mask = hit & s_rows
        rec_split = (s_mask, torch.where(s_mask, s_e, 0.0), s_dir)
    rec = BounceRecord(
        sid=sid, t=t, hit=res.out_pos, local=res.local_pt,
        dir_in=bundle.dir, dir_out=res.out_dir, e_in=e_in, e_out=e_out,
        absorbed=absorbed_ray, backside=res.backside & hit, alive_in=alive,
        wavelength=bundle.wavelength, normal=res.normal, split=rec_split,
        spectra=new_spectra)
    return new_bundle, accum, rec


def _append_split_rays(bundle: RayBundle, prev: RayBundle,
                       rec: BounceRecord, accum: TraceAccum,
                       min_energy: float) -> RayBundle:
    """Append the reflected branches of the bounce's energy-splitting
    interfaces (``rec.split``) to the bundle as new rays
    (tracer_tpu/engine.py:811), on the bundle's device: each starts at its
    hit point along the reflected direction, in the incidence medium
    (``prev``, the bundle before the bounce), with ``parent`` its
    originating slot. Branches of at most ``min_energy`` are culled with
    their energy added to ``accum.culled`` (in place)."""
    mask, sec_e, sec_dir = rec.split
    keep = mask & (sec_e > min_energy)
    accum.culled += torch.where(mask & ~keep, sec_e, 0.0).sum()
    idx = torch.nonzero(keep).flatten()
    if not idx.numel():
        return bundle
    sec = RayBundle(
        pos=rec.hit[idx], dir=sec_dir[idx], energy=sec_e[idx],
        wavelength=prev.wavelength[idx], ref_index=prev.ref_index[idx],
        att_coeff=prev.att_coeff[idx], scat_coeff=prev.scat_coeff[idx],
        scat_g=prev.scat_g[idx],
        alive=torch.ones(idx.shape, dtype=torch.bool, device=idx.device),
        parent=idx.to(torch.int32))
    return concatenate_rays([bundle, sec])


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

    def hits_of(self, surface, keys=None) -> dict:
        """Every hit on a logical surface across bounces as numpy arrays:
        global and local hit points, absorbed, incident and outgoing
        energy, incoming direction, backside flag, wavelength, shading
        normal and bounce index (the reference's accountant queries), and
        the outgoing ``spectra`` (n_hits, K) when any record has them.
        ``keys`` picks some of these fields (and the bounce index), so a
        caller that bins one of them copies only what it reads."""
        rows = list(self._rows_of(surface))
        every = ("hit", "local", "absorbed", "e_in", "e_out", "dir_in",
                 "backside", "wavelength", "normal")
        if any(rec.spectra is not None for rec in self.records):
            every = every + ("spectra",)
        if keys is None:
            keys = every
        elif set(keys) - set(every):
            raise KeyError(f"no hit field {sorted(set(keys) - set(every))}")
        out = {k: [] for k in tuple(keys) + ("bounce",)}
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
        records, only its recorded hits with record="tags". A slot that a
        splitting interface appended starts at the bounce after its
        split."""
        hist = []
        for b, rec in enumerate(self.records):
            alive = _np(rec.alive_in)
            if rec.slot is None and slot >= len(alive):
                continue
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
        spectra=take(rec.spectra), bounce=bounce, slot=idx.to(torch.int32))


def _rows_alpha_on_grid(scene, meta, grid):
    """Host precompute of a polychromatic trace (tracer_tpu/engine.py
    :191-228): (has_tab (S,) bool, alpha (S, K)) on the scene's device,
    every K_REFLECT_SPECTRAL row's absorptance table interpolated onto
    the bundle's wavelength grid, so the bounce's spectral filter is one
    gather and a product. Other kinds keep their scalar energy ratio;
    piecewise (theta, wl) rows need per-angle spectra and are refused."""
    if "lambertian_piecewise_spectral" in scene.features:
        raise NotImplementedError(
            "polychromatic bundles with piecewise (theta, wl) spectral "
            "rows are not supported: their filter depends on the "
            "incidence angle per hit; use K_REFLECT_SPECTRAL tables or "
            "trace monochromatic wavelength samples")
    kinds = (meta.host_opt_kind if meta is not None
             and meta.host_opt_kind is not None else _np(scene.opt_kind))
    prm = (meta.host_opt_params if meta is not None
           and meta.host_opt_params is not None else _np(scene.opt_params))
    g = _np(torch.as_tensor(grid)).astype(np.float64)
    wl_tab = _np(scene.spectral_wl).astype(np.float64)
    ab_tab = _np(scene.spectral_ab).astype(np.float64)
    has = np.zeros(len(kinds), dtype=bool)
    alpha = np.zeros((len(kinds), len(g)))
    for r in np.nonzero(kinds == _M.K_REFLECT_SPECTRAL)[0]:
        start, ln = int(round(prm[r, 0])), int(round(prm[r, 1]))
        has[r] = True
        alpha[r] = np.interp(g, wl_tab[start:start + ln],
                             ab_tab[start:start + ln])
    return (torch.as_tensor(has, device=scene.device),
            torch.as_tensor(alpha, dtype=torch.as_tensor(grid).dtype,
                            device=scene.device))


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
        shading randomness; None means one seeded with 0. In a scene with
        energy-splitting interfaces every bounce splits them, and the
        reflected branches join the bundle as new rays
        (_append_split_rays), so the bundle grows.

        ``accel`` None traces brute force (K3 for float32 rays);
        "lightweight" (or True) builds a Kd tree over the scene rows
        (accel.KdTree) and every bounce traverses it on the host for
        per-ray candidate rows (_candidates), which nearest_hit_candidates
        then tests alone: the same hits, only the cost changes. A
        polychromatic bundle (``bundle.spectra``) is filtered every bounce
        and its records carry the outgoing spectra; in a scene with
        energy-splitting interfaces it is refused."""
        scene = self.scene
        if bundle.spectra is not None and "split" in scene.features:
            raise NotImplementedError(
                "polychromatic bundles in a scene with energy-splitting "
                "interfaces are refused: tracer_tpu's _append_split_rays "
                "builds the reflected branches without spectra and fails "
                "(a reference defect, ROADMAP C)")
        bundle = _ambient_bundle(scene, bundle)
        _check_device(scene, bundle)
        opts = opts or TraceOptions(max_bounces=reps, min_energy=min_energy)
        generator = _generator_for(scene, generator)
        tree = None
        if accel:
            if self.meta is None:
                raise ValueError("accel needs a SceneMeta (row geometry)")
            from .accel import KdTree
            t0 = time.perf_counter()
            tree = KdTree(self.meta)
            log.info("kdtree build: %d rows, %d nodes, %.3f s",
                     scene.num_rows, len(tree.nodes),
                     time.perf_counter() - t0)
        spectral_alpha = (None if bundle.spectra is None else
                          _rows_alpha_on_grid(scene, self.meta,
                                              bundle.spectral_grid))
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
        use_split = "split" in scene.features
        for b in range(opts.max_bounces):
            t0 = time.perf_counter()
            prev = bundle
            cand = None if tree is None else self._candidates(tree, bundle)
            bundle, accum, rec = _bounce_step(
                scene, bundle, accum, generator,
                min_energy=opts.min_energy, t_eps=opts.t_eps,
                disc_eps=opts.disc_eps, block=opts.block,
                split_mode=use_split, cand=cand,
                spectral_alpha=spectral_alpha)
            if rec.split is not None:
                bundle = _append_split_rays(bundle, prev, rec, accum,
                                            opts.min_energy)
            if recording_rows is not None:
                if len(recording_rows):
                    mask = torch.isin(rec.sid, recording_rows)
                    n_hits = int(mask.sum())
                    if n_hits:
                        records.append(_compact_record(
                            rec, mask, n_hits, b).to("cpu"))
            elif opts.record:
                records.append(rec.replace(bounce=b).to("cpu"))
            n_alive = int(bundle.alive.sum())
            if log.isEnabledFor(logging.INFO):
                log.info("bounce %d: trace time %.4f s, %d/%d rays alive%s",
                         b, time.perf_counter() - t0, n_alive,
                         bundle.num_rays,
                         "" if cand is None
                         else f", {cand.shape[1]} candidates/ray")
            if n_alive == 0:
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

    @staticmethod
    def _candidates(tree, bundle: RayBundle) -> torch.Tensor:
        """(N, K) int32 candidate rows of every ray on the bundle's device
        from a host traversal of ``tree`` (tracer_tpu/engine.py:767-780):
        pos, dir and alive copied to the host once, dead lanes given none,
        each ray's rows in ascending order, padded with -1 to a width K
        bucketed to a power of two."""
        mask = tree.traversal(_np(bundle.pos), _np(bundle.dir))   # (S, N)
        mask[:, ~_np(bundle.alive)] = False
        per_ray = mask.sum(axis=0)
        k = max(int(per_ray.max(initial=0)), 1)
        k = 1 << (k - 1).bit_length()
        ray, row = np.nonzero(mask.T)          # by ray, then by row
        first = np.cumsum(per_ray) - per_ray
        cand = np.full((mask.shape[1], k), -1, dtype=np.int32)
        cand[ray, np.arange(len(ray)) - first[ray]] = row
        return torch.as_tensor(cand, device=bundle.pos.device)


def trace_fused(scene: SceneTable, bundle: RayBundle,
                generator: Optional[torch.Generator] = None,
                max_bounces: int = 100, min_energy: float = 1e-6,
                t_eps=None, disc_eps: float = 1e-6, block: int = 64,
                fluxspecs: tuple = ()):
    """Trace without records: accumulators only, plus the device flux
    histograms of ``fluxspecs`` (device_fluxmap.FluxSpec tuple) in
    ``accum.flux``. A host loop of :func:`_bounce_step` that reads one
    flag from the device per bounce (tracer_tpu runs the same loop as one
    jitted while_loop); where _epilogue_ok holds (CUDA float32 bundles,
    the kinds K2's shade covers), of :func:`_bounce_step_epilogue`, whose
    draws come from K2's Philox stream seeded once a call from
    ``generator`` (and only where the scene's kinds draw). The bundle
    keeps its size, so energy-splitting interfaces roulette here
    (unbiased, as tracer_tpu's); ray_tracer splits them. Polychromatic
    bundles are refused: they trace on ray_tracer. Returns (final bundle,
    accum)."""
    if bundle.spectra is not None:
        raise NotImplementedError(
            "polychromatic bundles trace on the host-stepped "
            "TracerEngine.ray_tracer path (per-bounce spectral filtering "
            "and records); the fused and streaming paths are "
            "monochromatic — sample wavelengths instead")
    with telemetry.call("trace_fused", bundle.num_rays):
        bundle = _ambient_bundle(scene, bundle)
        _check_device(scene, bundle)
        generator = _generator_for(scene, generator)
        accum = TraceAccum.zeros(scene.num_rows, dtype=bundle.pos.dtype,
                                 device=scene.device, fluxspecs=fluxspecs)
        if _epilogue_ok(scene, bundle, fluxspecs):
            plan = _epilogue_plan(scene, bundle, generator, min_energy,
                                  fluxspecs)
            te = default_t_eps(torch.float32) if t_eps is None else t_eps
            for b in range(max_bounces):
                live = telemetry.count(bundle.alive)
                if not live:
                    break
                with telemetry.span("round", kernel="k3",
                                    lanes=bundle.num_rays, live=live):
                    bundle = _bounce_step_epilogue(scene, bundle, plan, b,
                                                   te, disc_eps)
            with telemetry.span("account"):
                plan.finish(accum)
            return bundle, accum
        kernel = "k3" if bundle.pos.dtype == torch.float32 else "oracle"
        for _ in range(max_bounces):
            live = telemetry.count(bundle.alive)
            if not live:
                break
            with telemetry.span("round", kernel=kernel,
                                lanes=bundle.num_rays, live=live):
                bundle, accum, rec = _bounce_step(
                    scene, bundle, accum, generator, min_energy=min_energy,
                    t_eps=t_eps, disc_eps=disc_eps, block=block)
                with telemetry.span("account"):
                    _dfm.accumulate(accum.flux, fluxspecs, scene, rec.sid,
                                    rec.hit, rec.absorbed)
        return bundle, accum
