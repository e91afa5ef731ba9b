"""Differentiable tracing: reverse-mode gradients through the trace (the
PyTorch port of tracer_tpu/diff.py).

The compiled scene is a struct of tensors (SceneTable) and the bounce
step (engine._bounce_step with ``force_jnp``) is torch code, so a
fixed-bounce-count loop makes the whole trace one autograd graph of
(scene, bundle). Uses:

  - heliostat aim optimization (focus/center the receiver spot),
  - optical design (lens curvature / refractive index vs spot size),
  - slope-error or alignment calibration against a measured flux map.

What the pathwise (fixed-seed, reparameterized) gradient does and does
not see
------------------------------------------------------------------------
With the seed held fixed, every sampled decision (Russian-roulette
branches, Lambertian and slope-error draws, free paths) is a
deterministic function of the uniforms, so the trace is piecewise-smooth
in the scene parameters and ``torch.autograd.grad`` returns the exact
derivative of that realization: the standard reparameterization
estimator. It captures everything that moves continuously with the
parameters: hit positions, path lengths, Fresnel/Snell splits, absorbed
fractions, Beer-Lambert factors. It does not capture boundary terms: a
ray switching discretely to another surface (or aperture side)
contributes a jump the pathwise estimator ignores. Objectives built from
hit-position moments (spot radius, centroid offset, :func:`spot_rms`)
are dominated by the continuous term and optimize well; pure
interception objectives (energy on a plate of constant absorptivity) are
piecewise constant along rays and need a smooth surrogate.

Every bounce runs the differentiable path: the oracle's brute force on
small scenes, and from engine.FAST_WINNER_ROWS rows the winner's row
chosen under no_grad by the nearest-hit kernel (K3 on float32 rays on the
card) with its distance recomputed on the live tensors
(engine._fast_winner). No kernel has a backward: the winner's row is an
integer and carries no gradient. Use float64 on the CPU for gradient
checks and float32 on the card for optimization loops.

No reference anchor: the reference has no gradient capability.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Union

import torch
from torch.utils.checkpoint import checkpoint as _checkpoint

from .analysis import device_fluxmap as _dfm
from .bundle import RayBundle
from .engine import TraceAccum, _BIN_COPIES, _bin_copy_offsets, _bounce_step
from .mathutils import normalize, rotation_to_z
from .scene import SceneTable

# per-row accumulation switches from masked reductions to an index_add
# past this many rows (tracer_tpu's small-scene threshold)
_SMALL_ROWS = 64


@dataclasses.dataclass
class MomentAccum:
    """Per-row energy-weighted moments of the local hit coordinates.

    e_in      (S,)   incident energy
    absorbed  (S,)   absorbed energy (the moment weight)
    m1        (S,3)  sum of absorbed * local
    m2        (S,3)  sum of absorbed * local**2

    Local (surface-frame) coordinates make the moments flux-map
    statistics: the energy-weighted centroid of row r is m1[r] /
    absorbed[r] and the mean squared spot radius about a point c is (m2 -
    2 c m1 + c^2 absorbed) / absorbed, both differentiable.

    These are conditional statistics over the rays that land on the row:
    if an update pushes the whole spot off the surface, the captured
    power goes to zero and spot_rms degenerates to 0, a spurious minimum
    the pathwise gradient will not climb out of. Keep steps bounded
    (Adam), start inside the capture basin, or add a capture penalty on
    ``absorbed``.
    """

    e_in: torch.Tensor
    absorbed: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor

    @classmethod
    def zeros(cls, n_rows: int, dtype=torch.float32,
              device=None) -> "MomentAccum":
        def z(*shape):
            return torch.zeros(shape, dtype=dtype, device=device)
        return cls(e_in=z(n_rows), absorbed=z(n_rows), m1=z(n_rows, 3),
                   m2=z(n_rows, 3))


class DiffFluxSpec(NamedTuple):
    """A differentiable flux map: absorbed energy soft-binned (bilinear
    splat) over the local (x, y) coordinates of hits on ``rows``.

    The bilinear splat is piecewise linear in the hit position, so the
    map has gradients with respect to scene parameters, the basis of
    flux-map fitting (aim or slope calibration against a measured map).
    Hits outside [xlim] x [ylim] are dropped, their gradient too.

    rows   tuple of table row ids
    xlim   (xmin, xmax) in surface-local coordinates
    ylim   (ymin, ymax)
    shape  (nu, nv) bins
    """

    rows: tuple
    xlim: tuple
    ylim: tuple
    shape: tuple


def _splat(grid, spec: DiffFluxSpec, sid, local, w):
    """Bilinear-splat w at local (x, y) into grid for sid in spec.rows:
    the corner weights of a point are the hat functions max(0, 1 - |g -
    u|) at the integer bin centres, so the splat is one (nu, N) @ (N, nv)
    product of hat-weight matrices (tracer_tpu/diff.py:115), the partial
    splats at the grid's edge included."""
    nu, nv = spec.shape
    on = torch.zeros_like(sid, dtype=torch.bool)
    for r in spec.rows:
        on = on | (sid == r)
    x, y = local[:, 0], local[:, 1]
    gx = (x - spec.xlim[0]) / (spec.xlim[1] - spec.xlim[0]) * nu - 0.5
    gy = (y - spec.ylim[0]) / (spec.ylim[1] - spec.ylim[0]) * nv - 0.5
    f = dict(dtype=grid.dtype, device=grid.device)
    zero = torch.zeros((), **f)
    wu = torch.maximum(zero, 1.0 - (gx[:, None]
                                    - torch.arange(nu, **f)[None, :]).abs())
    wv = torch.maximum(zero, 1.0 - (gy[:, None]
                                    - torch.arange(nv, **f)[None, :]).abs())
    wm = torch.where(on, w, 0.0).to(grid.dtype)
    return grid + (wu * wm[:, None]).T @ wv


def _row_sums(payload, sid, n_rows: int):
    """Per-row sums (S, K) of payload (N, K) grouped by sid; sid < 0
    (miss) contributes nothing and the integer sid carries no gradient.
    Up to _SMALL_ROWS rows one masked reduction a row, as tracer_tpu
    sums them; more rows an out-of-place index_add into the bin copies
    of engine._row_sums (a receiver row takes up to a million nearly
    equal float32 values a bounce, which one bin would round the same
    way each time), whose backward is a gather."""
    if n_rows <= _SMALL_ROWS:
        return torch.stack([
            torch.where((sid == r)[:, None], payload, 0.0).sum(0)
            for r in range(n_rows)])
    n_bins = n_rows + _dfm.N_SPILL
    idx = (_dfm.spread_misses(sid >= 0, sid, n_rows)
           + _bin_copy_offsets(sid.shape[0], n_bins, sid.device))
    out = torch.zeros((_BIN_COPIES * n_bins, payload.shape[1]),
                      dtype=payload.dtype, device=payload.device)
    out = out.index_add(0, idx, payload)
    return out.view(_BIN_COPIES, n_bins, -1).sum(0)[:n_rows]


def _base_seed(seed_or_generator) -> int:
    """An int seed, or one drawn from a torch.Generator."""
    if isinstance(seed_or_generator, torch.Generator):
        g = seed_or_generator
        return int(torch.randint(0, 1 << 62, (1,), generator=g,
                                 device=g.device))
    return int(seed_or_generator)


def _bounce_seed(base: int, b: int) -> int:
    """Bounce ``b``'s seed (tracer_tpu splits its key per bounce)."""
    return (base + 0x9E3779B97F4A7C15 * (b + 1)) % (1 << 63)


def trace_diff(scene: SceneTable, bundle: RayBundle,
               seed_or_generator: Union[int, torch.Generator], bounces: int,
               disc_eps: float = 1e-6, t_eps=None, fluxspecs: tuple = (),
               checkpoint: bool = False):
    """Fixed-bounce-count differentiable trace (tracer_tpu/diff.py:164).

    Runs ``bounces`` bounce steps of the general engine path pinned to
    its differentiable route (``force_jnp``), with ``min_energy=0`` (the
    energy cull is a discontinuity, so dead rays just carry zero energy),
    and folds every bounce's hits into per-row accumulators on the fly.

    Returns ``(accum, moments)``: a TraceAccum (absorbed, escaped,
    medium, culled; residual is what the final bundle still carries) and
    a MomentAccum. With ``fluxspecs`` (a tuple of DiffFluxSpec) returns
    ``(accum, moments, grids)``, grids[i] spec i's soft-binned (nu, nv)
    flux map. All are differentiable functions of every float tensor of
    ``scene`` and ``bundle``; build the perturbed scene inside the loss
    (:func:`with_rows`, :func:`frame_to`) and take
    ``torch.autograd.grad``.

    Randomness: bounce b draws from a generator seeded by (seed, b), made
    inside the bounce on the bundle's device; a torch.Generator given as
    ``seed_or_generator`` yields the seed. ``checkpoint=True``
    recomputes each bounce in the backward pass
    (torch.utils.checkpoint, non-reentrant) instead of keeping its
    intermediates: memory of one bounce for about twice the forward
    work. The recompute draws the same uniforms because its generator is
    made from the same seed inside the bounce (checkpoint restores only
    the default generators, not an explicit one), and it runs K3 again
    on the scenes that take the fast winner.

    Each bounce accumulates into fresh tensors, summed outside it, and
    nothing of the caller's scene or bundle is written.
    """
    dtype, dev = bundle.pos.dtype, bundle.pos.device
    n_rows = scene.num_rows
    base = _base_seed(seed_or_generator)

    def body(b, bund):
        gen = torch.Generator(device=dev).manual_seed(_bounce_seed(base, b))
        acc = TraceAccum.zeros(n_rows, dtype=dtype, device=dev)
        bund, acc, rec = _bounce_step(
            scene, bund, acc, gen, min_energy=0.0, t_eps=t_eps,
            disc_eps=disc_eps, block=64, count_hits=False, need_local=True,
            split_mode=False, force_jnp=True)
        hit = rec.alive_in & (rec.sid >= 0)
        w = torch.where(hit, rec.absorbed, 0.0)
        payload = torch.cat(
            [torch.where(hit, rec.e_in, 0.0)[:, None], w[:, None],
             w[:, None] * rec.local, w[:, None] * rec.local ** 2], dim=1)
        rows = _row_sums(payload, rec.sid, n_rows)
        grids = tuple(
            _splat(torch.zeros(sp.shape, dtype=dtype, device=dev), sp,
                   rec.sid, rec.local, w) for sp in fluxspecs)
        return bund, acc, rows, grids

    accum = TraceAccum.zeros(n_rows, dtype=dtype, device=dev)
    mom = MomentAccum.zeros(n_rows, dtype=dtype, device=dev)
    grids = tuple(torch.zeros(s.shape, dtype=dtype, device=dev)
                  for s in fluxspecs)
    for b in range(bounces):
        if checkpoint:
            bundle, acc, rows, gr = _checkpoint(body, b, bundle,
                                                use_reentrant=False)
        else:
            bundle, acc, rows, gr = body(b, bundle)
        accum = dataclasses.replace(
            accum, absorbed=accum.absorbed + acc.absorbed,
            escaped=accum.escaped + acc.escaped,
            culled=accum.culled + acc.culled,
            medium=accum.medium + acc.medium)
        mom = MomentAccum(e_in=mom.e_in + rows[:, 0],
                          absorbed=mom.absorbed + rows[:, 1],
                          m1=mom.m1 + rows[:, 2:5], m2=mom.m2 + rows[:, 5:8])
        grids = tuple(g + d for g, d in zip(grids, gr))
    accum = dataclasses.replace(accum, residual=accum.residual + torch.where(
        bundle.alive, bundle.energy, 0.0).sum())
    if fluxspecs:
        return accum, mom, grids
    return accum, mom


# ---- differentiable scene editing ---------------------------------------

def rigid_inverse(frame: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid homogeneous transform(s) (..., 4, 4): [R|t] ->
    [R^T | -R^T t], differentiable (no linear solve)."""
    R = frame[..., :3, :3]
    t = frame[..., :3, 3]
    Rt = R.transpose(-1, -2)
    ti = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, ti[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=frame.dtype,
                          device=frame.device).expand(
                              frame.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def with_rows(scene: SceneTable, rows, frame=None, quadric=None,
              opt_params=None) -> SceneTable:
    """A new SceneTable with per-row parameters replaced: the bridge from
    a design parameter to the traced table (tracer_tpu/diff.py:255).
    ``rows`` is a sequence or tensor of table row ids; each given value
    must broadcast to the rows' slice shape. The tables are rebuilt out
    of place (``index_put``), so the caller's table is never written and
    the gradient reaches the values. Frames must be rigid: inverses come
    from :func:`rigid_inverse` (a scaled or sheared frame needs a real
    inverse and a re-derived normal transform; compile the scene with it
    instead)."""
    idx = torch.as_tensor(rows, dtype=torch.long,
                          device=scene.device).reshape(-1)

    def put(table, values):
        values = torch.as_tensor(values, dtype=table.dtype,
                                 device=table.device)
        return table.index_put((idx,), values.expand(
            (idx.shape[0],) + tuple(table.shape[1:])))

    changes = {}
    if frame is not None:
        frame = torch.as_tensor(frame, dtype=scene.frame.dtype,
                                device=scene.device)
        changes.update(frame=put(scene.frame, frame),
                       inv_frame=put(scene.inv_frame, rigid_inverse(frame)))
    if quadric is not None:
        changes["quadric"] = put(scene.quadric, quadric)
    if opt_params is not None:
        changes["opt_params"] = put(scene.opt_params, opt_params)
    return dataclasses.replace(scene, **changes)


def frame_to(normal, location, dtype=torch.float64) -> torch.Tensor:
    """Rigid local->global 4x4 whose local +Z is ``normal`` (need not be
    unit), placed at ``location``: the differentiable frame constructor
    (mathutils.rotation_to_z underneath, spatial.rotation_to_z's
    new-X-in-old-XY convention, so a frame built here matches what
    compile_scene baked for the same pose, and normal == +-Z falls back
    to the X-axis frame instead of NaN)."""
    n = normalize(torch.as_tensor(normal, dtype=dtype))
    R = rotation_to_z(n)
    loc = torch.as_tensor(location, dtype=dtype, device=R.device)
    top = torch.cat([R, loc[:, None]], dim=1)
    return torch.cat([top, torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=dtype,
                                        device=R.device)], dim=0)


# ---- loss helpers --------------------------------------------------------

def _rows(mom: MomentAccum, rows) -> torch.Tensor:
    return torch.as_tensor(rows, dtype=torch.long,
                           device=mom.m1.device).reshape(-1)


def spot_rms(mom: MomentAccum, rows, center=(0.0, 0.0)) -> torch.Tensor:
    """Energy-weighted mean squared distance of the local (x, y) hit
    coordinates from ``center`` over the table rows ``rows``: the
    differentiable spot-size and aiming loss. E[|r - c|^2] expands into
    the accumulated moments, so no per-ray data is needed."""
    idx = _rows(mom, rows)
    p = mom.absorbed[idx].sum()
    m1 = mom.m1[idx].sum(0)
    m2 = mom.m2[idx].sum(0)
    c = torch.as_tensor(center, dtype=mom.m1.dtype, device=mom.m1.device)
    num = (m2[0] - 2.0 * c[0] * m1[0] + c[0] ** 2 * p
           + m2[1] - 2.0 * c[1] * m1[1] + c[1] ** 2 * p)
    return num / p.clamp(min=torch.finfo(mom.m1.dtype).tiny)


def spot_centroid(mom: MomentAccum, rows) -> torch.Tensor:
    """Energy-weighted centroid of the local hit coordinates over the
    table rows ``rows`` (3-vector; z is 0 for flat receivers)."""
    idx = _rows(mom, rows)
    p = mom.absorbed[idx].sum()
    return mom.m1[idx].sum(0) / p.clamp(min=torch.finfo(mom.m1.dtype).tiny)
