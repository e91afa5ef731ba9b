"""Multi-device tracing over torch.distributed (the PyTorch port of
tracer_tpu/parallel.py).

tracer_tpu shards the ray axis over a ``jax.sharding.Mesh`` with the
scene replicated, runs the fused or streaming trace on every shard with a
folded PRNG key, and sums the accumulators with ``psum``. Here the mesh is
a ``torch.distributed`` process group of one rank a device: ``group=None``
means the default group, and with no group set up, a world of one. Every
rank holds the scene and calls the same function; each traces its own
share with a generator derived from (seed, rank) (:func:`rank_generator`,
as tracer_tpu folds the axis index into its key), and one collective at
the end sums the accumulators, the flux maps, the emitted count and the
source energy. Results depend on the rank count only up to Monte-Carlo
statistics, as tracer_tpu's do.

tracer_tpu's culled workers also sum a flag every round (``sync_axis``)
so that every device runs the same number of rounds, which the Pallas
interpreter's barrier needs. Here a rank's rounds touch nothing of the
other ranks', so there is no per-round collective: each rank runs its
own loop to its own end, and the reduced results equal the sum of the
ranks' traces run one by one in one process (tests/test_torch_parallel.py
holds them so).

The ranks' kernels are K3 (trace_sharded, through trace_fused), K2
(trace_streaming_sharded without culling, and the culled drain) and K1
(the culled blocks), unchanged: a rank whose kernel fails to build or
launch raises, and a rank without its device raises (the scene lies where
the caller compiled it). On the card, one rank a card takes NCCL; two
ranks on one card take gloo, which reduces CUDA tensors too. Build the
kernels (kernels.build.load) before spawning ranks, so that they do not
race on the build directory.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from . import materials as _M
from . import telemetry
from .bundle import FIELDS, RayBundle, concatenate_rays
from .engine import (TraceAccum, _apply_scene_ambient, _bivar_mode,
                     _run_culled, trace_fused, trace_streaming)
from .kernels.bounce import tile_order


def default_group(group=None):
    """``group``, else the default process group, else None (no group set
    up: a world of one)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def rank_and_size(group=None) -> tuple:
    """(rank, world size) in ``group`` (default_group's)."""
    pg = default_group(group)
    return (0, 1) if pg is None else (pg.rank(), pg.size())


def rank_generator(seed: int, rank: int, device=None) -> torch.Generator:
    """The generator of ``rank`` for ``seed`` on ``device`` (None: the
    CPU), seeded by a hash of the pair (NumPy's SeedSequence), the
    counterpart of tracer_tpu's ``fold_in(key, axis_index)``."""
    state = np.random.SeedSequence([int(seed), int(rank)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator(device=device or "cpu").manual_seed(
        int(state) >> 1)


def _all_reduce(tensors, group) -> list:
    """The sums of ``tensors`` over the group: one collective on a float64
    buffer on their device, each sum back in its tensor's dtype. No group:
    the tensors themselves."""
    pg = default_group(group)
    if pg is None:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    dist.all_reduce(flat, group=pg)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _accum_tensors(accum: TraceAccum) -> list:
    return [getattr(accum, f.name) for f in dataclasses.fields(accum)
            if f.name != "flux"] + list(accum.flux)


def _accum_from(accum: TraceAccum, tensors) -> TraceAccum:
    names = [f.name for f in dataclasses.fields(accum) if f.name != "flux"]
    out = dict(zip(names, tensors))
    out["flux"] = tuple(tensors[len(names):])
    return TraceAccum(**out)


def reduce_results(accum: TraceAccum, *scalars, group=None):
    """Sum ``accum`` (every field, the flux maps included) and the tensors
    ``scalars`` (emitted counts, source energies) over the group. Returns
    (accum, *scalars)."""
    parts = _accum_tensors(accum)
    with telemetry.span("reduce", rank=rank_and_size(group)[0]):
        red = _all_reduce(parts + [torch.as_tensor(x).to(parts[0].device)
                                   for x in scalars], group)
    n = len(parts)
    return (_accum_from(accum, red[:n]),
            *(r.to(torch.as_tensor(x).device)
              for r, x in zip(red[n:], scalars)))


def _add(a: TraceAccum, b: TraceAccum) -> TraceAccum:
    return _accum_from(a, [x + y for x, y in zip(_accum_tensors(a),
                                                 _accum_tensors(b))])


def _shard(bundle: RayBundle, lo: int, hi: int) -> RayBundle:
    """Rays [lo, hi) of ``bundle`` (a polychromatic one keeps its grid)."""
    return bundle.replace(**{f: getattr(bundle, f)[lo:hi]
                             for f in FIELDS + ("spectra",)
                             if getattr(bundle, f) is not None})


def trace_sharded(scene, bundle: RayBundle, seed: int = 0, group=None,
                  max_bounces: int = 100, min_energy: float = 1e-6,
                  t_eps=None, disc_eps: float = 1e-6, block: int = 64,
                  fluxspecs: tuple = ()):
    """Trace ``bundle`` with its ray axis sharded over the ranks of
    ``group`` (tracer_tpu/parallel.py:32): every rank passes the same
    global bundle, traces its contiguous shard through trace_fused (K3 on
    float32 rays) with rank_generator(seed, rank) on the scene's device,
    and the accumulators, flux maps included, are summed over the ranks.

    Returns (the rank's final shard, the summed accumulators). The bundle
    size must divide by the rank count."""
    rank, n_dev = rank_and_size(group)
    if bundle.num_rays % n_dev:
        raise ValueError(f"{bundle.num_rays} rays not divisible by "
                         f"{n_dev} devices; pad the bundle")
    per = bundle.num_rays // n_dev
    with telemetry.call("trace_sharded", per, rank=rank):
        final, accum = trace_fused(
            scene, _shard(bundle, rank * per, (rank + 1) * per),
            rank_generator(seed, rank, scene.device),
            max_bounces=max_bounces, min_energy=min_energy, t_eps=t_eps,
            disc_eps=disc_eps, block=block, fluxspecs=fluxspecs)
        return final, reduce_results(accum, group=group)[0]


def trace_streaming_sharded(scene, source_fn, seed: int, total_rays: int,
                            group=None, max_rounds: int = 10_000,
                            max_path: int = 100, min_energy: float = 1e-6,
                            t_eps=None, disc_eps: float = 1e-6,
                            block: int = 64, culling=None,
                            fluxspecs: tuple = (),
                            _force_row_shards: bool = False,
                            _force_mesh_segments: int = 0):
    """Streaming trace sharded over the ranks of ``group``
    (tracer_tpu/parallel.py:70); every rank passes the same arguments.

    Without ``culling`` every rank runs trace_streaming on its own slab
    (``source_fn``'s, the per-rank slab) for ceil(total_rays / D) rays
    with rank_generator(seed, rank).

    With ``culling`` (built for the GLOBAL slab of nb blocks, nb % D ==
    0) rank d traces blocks [d*nb/D, (d+1)*nb/D) of the culled layout with
    their global tile ids, quotas and corridor depths: K1 every round, K2
    (or the oracle, for a table past K2's stage) on the drain. With a
    mesh-targeted culling (``mesh_devices > 1``), or with
    ``_force_row_shards`` / ``_force_mesh_segments`` (test hooks), the
    rank's range runs in culling.mesh_segment_shards' sequential
    segments, each with K1 on the rank's row shard rows[row_map] and its
    demote mask. The scene must be megakernel-eligible as in tracer_tpu
    (its refusals, word for word) and float32 (K1's dtype).

    Returns (accum, emitted, source_e), each summed over the ranks."""
    rank, n_dev = rank_and_size(group)
    with telemetry.call("trace_streaming_sharded", -(-total_rays // n_dev),
                        rank=rank):
        return _trace_streaming_sharded(
            scene, source_fn, seed, total_rays, group, rank, n_dev,
            max_rounds, max_path, min_energy, t_eps, disc_eps, block,
            culling, fluxspecs, _force_row_shards, _force_mesh_segments)


def _trace_streaming_sharded(scene, source_fn, seed, total_rays, group,
                             rank, n_dev, max_rounds, max_path, min_energy,
                             t_eps, disc_eps, block, culling, fluxspecs,
                             _force_row_shards, _force_mesh_segments):
    """trace_streaming_sharded on rank ``rank`` of ``n_dev``, inside its
    call span."""
    if culling is None:
        per_dev = -(-total_rays // n_dev)
        accum, emitted, source_e = trace_streaming(
            scene, source_fn, rank_generator(seed, rank), per_dev,
            max_rounds=max_rounds, max_path=max_path, min_energy=min_energy,
            t_eps=t_eps, disc_eps=disc_eps, block=block,
            fluxspecs=fluxspecs)
        return reduce_results(accum, emitted, source_e, group=group)

    nb = culling.nb
    if nb % n_dev:
        raise ValueError(f"{nb} source cells not divisible by {n_dev} "
                         "devices; choose a slab with a divisible block "
                         "count")
    from .culling import mesh_segment_shards
    use_segments = (_force_row_shards or _force_mesh_segments
                    or culling.mesh_devices > 1)
    segs = (mesh_segment_shards(culling, scene, n_dev,
                                force_n_seg=_force_mesh_segments)
            if use_segments else None)
    spec = getattr(source_fn, "pallas_spec", None)
    if spec is None:
        raise ValueError("culled sharded streaming needs a source with a "
                         "pallas_spec")
    spec, source_fn = _apply_scene_ambient(scene, spec, source_fn)
    quota = culling.block_quota(total_rays)
    kinds, features = set(scene.kinds_present), set(scene.features)
    spectral_scene = _M.K_REFLECT_SPECTRAL in kinds
    fc_wl = (_M.K_FRESNEL_CONDUCTOR in kinds
             and "conductor_dispersive" in features)
    spec_band = spec[13] if len(spec) > 13 else None
    uncullable = kinds - {_M.K_REFLECT, _M.K_LAMBERTIAN,
                          _M.K_REFLECT_SPECTRAL, _M.K_FRESNEL_CONDUCTOR}
    if uncullable or "iam_nonmirror" in features:
        raise ValueError(
            f"scene kinds {sorted(uncullable)} (or non-mirror IAM bases) "
            "are not culled-megakernel eligible; use "
            "trace_streaming_sharded without culling")
    if (spectral_scene or fc_wl) and spec_band is None:
        raise ValueError("spectral scene needs a source spec with a "
                         "wl_band (buie_sunshape_pallas_spec(..., "
                         "wl_band=...)) for the culled sharded path")
    spec_med = spec[16] if len(spec) > 16 else None
    if spec_med and float(spec_med[0]) > 0.0:
        raise ValueError("ambient HG scattering (spec ambient_scat > 0) "
                         "is not culled-megakernel eligible; use "
                         "trace_streaming_sharded without culling")
    if scene.frame.dtype != torch.float32:
        raise ValueError("the culled sharded trace runs K1, which is "
                         "float32: compile the scene in float32 or trace "
                         "without culling")

    common = dict(max_rounds=max_rounds, max_path=max_path,
                  min_energy=min_energy,
                  t_eps=3e-4 if t_eps is None else t_eps,
                  bivar=_bivar_mode(scene),
                  one_sided="one_sided" in features,
                  slope="slope_error" in features, fluxspecs=fluxspecs)
    generator = rank_generator(seed, rank)

    def run(blocks, lists, counts, group_offsets, **shard):
        return _run_culled(
            scene, spec, generator, common, disc_eps, lists=lists,
            counts=counts, cells=blocks,
            cell_bounds=culling.cell_bounds[blocks], quota=quota[blocks],
            age_caps=culling.age_caps[blocks], group_offsets=group_offsets,
            park_aureole=culling.park_aureole,
            order=tile_order(torch.as_tensor(counts)).numpy(), **shard)

    if segs is None:
        nbl = nb // n_dev
        blocks = np.arange(rank * nbl, (rank + 1) * nbl)
        results = [run(blocks, culling.lists[blocks],
                       culling.counts[blocks], culling.group_offsets,
                       demote_rows=culling.demote_rows)]
    else:
        results = []
        for sg in segs:
            chunk = sg["lists"].shape[0] // n_dev
            mine = slice(rank * chunk, (rank + 1) * chunk)
            results.append(run(sg["blocks"][mine], sg["lists"][mine],
                               sg["counts"][mine], sg["group_offsets"],
                               row_map=sg["row_maps"][rank],
                               demote_mask=sg["demote_masks"][rank]))
    accum, emitted, source_e = results[0]
    for a, em, se in results[1:]:
        accum, emitted, source_e = _add(accum, a), emitted + em, \
            source_e + se
    return reduce_results(accum, emitted, source_e, group=group)


def multi_ray_sim(scene, bundles, seed: int = 0, group=None, **trace_kw):
    """The reference's TracerEngineMP.multi_ray_sim
    (tracer_engine_mp.py:19; tracer_tpu/parallel.py:295): the bundles
    concatenated into one, padded with dead rays to a multiple of the
    rank count, and traced by :func:`trace_sharded`."""
    bundle = concatenate_rays(bundles)
    n_dev = rank_and_size(group)[1]
    if bundle.num_rays % n_dev:
        bundle = bundle.pad_to(-(-bundle.num_rays // n_dev) * n_dev)
    return trace_sharded(scene, bundle, seed, group, **trace_kw)


class TracerEngineMP:
    """The reference's process-pool engine (tracer/tracer_engine_mp.py:9;
    tracer_tpu/parallel.py:310): construct with an Assembly, call
    multi_ray_sim(sources); the processes are the ranks of ``group`` and
    the merge is one all-reduce. The scene compiles in ``dtype`` on
    ``device`` (None: the GPU)."""

    def __init__(self, assembly, group=None, dtype=torch.float32,
                 device=None):
        from .engine import TracerEngine
        self._engine = TracerEngine(assembly, dtype=dtype, device=device)
        self.scene = self._engine.scene
        self.meta = self._engine.meta
        self.group = group
        self.itmax = 100
        self.minener = 1e-6

    def multi_ray_sim(self, sources, procs: Optional[int] = None,
                      seed: int = 0):
        """Trace several source bundles over the ranks (``procs`` is
        accepted for signature parity; the group's size governs the
        parallelism). Returns (the rank's final shard, accum) and stores
        accum on self."""
        del procs
        final, accum = multi_ray_sim(self.scene, sources, seed, self.group,
                                     max_bounces=self.itmax,
                                     min_energy=self.minener)
        self.accum = accum
        return final, accum
