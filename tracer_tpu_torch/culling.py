"""Per-block relevancy culling for the culled streaming trace (the
PyTorch port's copy of tracer_tpu/culling.py).

The source disk (or rectangle) is partitioned into equal-area cells, one
per ray tile of TILE lanes (one CUDA thread block of the culled bounce kernel),
and a *static* per-block candidate list is computed once, before the
trace, that provably covers every surface a ray born in that cell can hit
while it remains on the fast path.

Soundness invariant
-------------------
A ray emitted from cell b with at most ``age_cap - 1`` completed specular
bounces, all of them off non-demoted surfaces, can only hit surfaces in
``lists[b]``. This holds because

  * the cell's emission beam (cell bounding sphere swept along the source
    direction cone) conservatively covers every first segment, and
  * the candidate set is closed under specular reflection: for every
    candidate with outgoing energy, the reflected direction cone (incident
    cone mirrored about the surface's normal cone, widened by ``k_sigma``
    standard deviations of its slope error) is swept from its bounding
    sphere and the surfaces met are added, breadth-first up to
    ``age_cap`` bounces.

Surfaces whose reflected cone cannot be kept narrow (normal spread + slope
error wider than ``w_cap``) are *demoted*: the engine parks their surviving
rays and re-traces them against the full surface list in a drain phase.
Rays older than ``age_cap`` are parked the same way.

With ``park_aureole`` (Buie sources, on request) the invariant splits by
emission angle: the FIRST-segment sweep covers the full sunshape cone
(every first hit of every ray, aureole included, is in ``lists[b]``),
while the specular CLOSURE covers only rays within the solar-disc cone;
the culled kernel marks the hits of lanes born into the aureole by an
encoded sid, and the engine parks their survivors for the exact drain,
like demoted-surface survivors.

The TPU build's single-device scalar-memory budget (sequential
segments, corridor degrades) does not exist on the GPU and is left out:
for scenes that fit the TPU budget the lists are identical to
tracer_tpu's. The mesh layouts of the sharded trace are ported
(``build_block_culling(mesh_devices=D)``, ``mesh_segment_shards``,
``device_row_shards``): rank d of D owns blocks [d*nb/D, (d+1)*nb/D),
split into uniform sequential segments that each ship only the rows
their lists reference. Their sizes follow tracer_tpu's budget
(``smem_need_bytes``, ``max_smem_bytes``), so the layouts equal
tracer_tpu's array for array; whether a segment fits the card is the
business of the kernels' own stage checks. The analysis is pure NumPy.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .accel import _row_geometries, _row_points
from .kernels.bounce import tile_order
from . import materials as M
from . import telemetry


@dataclasses.dataclass(frozen=True)
class BlockCulling:
    """Static per-block candidate lists for the culled megakernel.

    lists   (nb, sum(W_g)) int32 global row ids, partitioned into static
            per-group column segments [group_offsets[g], +W_g) so the
            kernel's per-group specialized loops can index them; -1 pads
    counts  (nb, G) int32 valid entries per block per group
    group_offsets (G,) static column offset of each group's segment
    cell_bounds (nb, 4) float32 equal-area source cell of each block: a
            disk's [a0, a1, th0, th1] with a = (r/R)^2 the area fraction
            (sample r = R*sqrt(a0 + u*(a1-a0))) and th the polar angle
            bounds, or a rect's [x0, x1, y0, y1] in local metres
    cell_of_block (nb,) int32 which of the n_cells cells each block serves
            (several blocks may share one cell — load balancing: cells
            whose rays survive bounces emit their quota more slowly, so
            they get proportionally more blocks; blocks of one cell sample
            identical bounds with independent PRNG streams)
    n_cells number of distinct equal-area cells (<= nb)
    age_caps (nb,) int32 per-block corridor depth: a block's rays park
            after this many bounces on the fast path
    demote_rows rows whose surviving rays are parked (wide scatterers)
    park_aureole the closure is sized to the solar-disc cone: the culled
            trace parks the survivors of aureole-born lanes' first bounce
    mesh_devices the rank count a mesh-targeted build serves
            (parallel.trace_streaming_sharded); 1 for one device
    order   (nb,) int32 the blocks by descending candidate count (a stable
            argsort of -counts.sum(1)): the order in which K1 dispatches
            them on the card, so the longest lists start first; None (a
            culling built with tracer_tpu's fields) derives it from
            ``counts``
    """

    lists: np.ndarray
    counts: np.ndarray
    cell_bounds: np.ndarray
    cell_of_block: np.ndarray
    n_cells: int
    age_caps: np.ndarray
    group_offsets: tuple
    demote_rows: tuple
    stats: dict
    park_aureole: bool = False
    mesh_devices: int = 1
    order: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.order is None:
            object.__setattr__(self, "order", tile_order(
                torch.as_tensor(self.counts)).numpy())

    @property
    def nb(self) -> int:
        return self.lists.shape[0]

    @property
    def age_cap(self) -> int:
        return int(self.age_caps.max())

    def block_quota(self, total_rays: int) -> np.ndarray:
        """Exact per-block emission budgets: each cell's equal-area quota
        ceil(total / n_cells), split across its blocks (first blocks take
        the remainder). Uniform source density holds exactly because every
        cell emits exactly its quota regardless of how many blocks feed
        it."""
        cell_quota = -(-total_rays // self.n_cells)
        q = np.zeros(self.nb, dtype=np.int64)
        for c in range(self.n_cells):
            blocks = np.nonzero(self.cell_of_block == c)[0]
            base, rem = divmod(cell_quota, len(blocks))
            q[blocks] = base
            q[blocks[:rem]] += 1
        return q.astype(np.int32)


def _largest_remainder_counts(ideal: np.ndarray, nb: int):
    """Spread ``nb`` cells over bands proportionally to ``ideal`` with
    largest-remainder rounding and a min-1 guard; returns None when the
    guard cannot absorb the overshoot (caller skips that band count)."""
    n = np.maximum(np.floor(ideal).astype(int), 1)
    while n.sum() > nb:                                # min-1 overshoot
        i = int(np.argmax(n - ideal))
        if n[i] <= 1:
            return None
        n[i] -= 1
    rem = nb - n.sum()
    order = np.argsort(ideal - n)[::-1]
    for i in order[:rem]:
        n[i] += 1
    return n


def disk_cells(nb: int) -> np.ndarray:
    """Equal-area partition of the unit disk into ``nb`` annular-sector
    cells of near-unit aspect ratio, for ANY nb (no factorization needed —
    a prime nb must not degenerate into full-radius pie wedges, whose huge
    bounding spheres would destroy the corridor analysis).

    Searches over the ring count m: sectors are spread over m rings
    proportionally to ring area (largest-remainder rounding, so cells stay
    exactly equal-area via the cumulative-count boundaries), and the m
    with the best worst-ring aspect (arc/width) wins. Returns (nb, 4)
    float32 rows [a0, a1, th0, th1] with a = r^2 the cumulative area
    fraction."""
    def ring_counts(m: int):
        w = np.arange(1, 2 * m, 2, dtype=np.float64)   # equal-width rings
        return _largest_remainder_counts(nb * w / w.sum(), nb)

    def worst_aspect(n):
        c = np.concatenate([[0], np.cumsum(n)]) / nb
        r = np.sqrt(c)
        width = np.diff(r)
        arc = 2.0 * np.pi * 0.5 * (r[:-1] + r[1:]) / n
        a = np.maximum(arc, width) / np.maximum(np.minimum(arc, width),
                                                1e-12)
        return float(a.max())

    best = None
    for m in range(1, int(2 * math.sqrt(nb)) + 2):
        n = ring_counts(m)
        if n is None:
            continue
        a = worst_aspect(n)
        if best is None or a < best[0]:
            best = (a, n)
    n = best[1]
    cells = []
    done = 0
    for k in n:
        a0 = done / nb
        a1 = (done + k) / nb
        for j in range(k):
            cells.append((a0, a1,
                          2.0 * np.pi * j / k, 2.0 * np.pi * (j + 1) / k))
        done += k
    return np.asarray(cells, dtype=np.float32)


def smem_need_bytes(table, nb: int, width: int,
                    n_rows: Optional[int] = None) -> int:
    """tracer_tpu's budget of one culled-kernel call on a TPU
    (tracer_tpu/culling.py:215): the bytes of scalar memory that ``nb``
    blocks with a candidate layout ``width`` columns wide need, the packed
    rows (``n_rows`` of them, all by default) included, every array padded
    to 128 in its minor dimension. The mesh layouts are sized by it, so
    that they equal tracer_tpu's; the card's own limits are the kernels'
    stage checks."""
    def pad(x: int) -> int:
        return -(-x // 128) * 128
    K = _TPU_ROW_F + 6 * table.ap_params.shape[1]
    S = table.ap_params.shape[0] if n_rows is None else n_rows
    rows_bytes = K * pad(S) * 4
    n_tab = int(table.spectral_wl.shape[0])
    misc = ((8 + len(table.groups)) * pad(nb) * 4
            + 2 * pad(max(n_tab, 2)) * 4 + 64 * 1024)
    return rows_bytes + misc + width * pad(nb) * 4


# floats of a packed row before its aperture slots in tracer_tpu's table
_TPU_ROW_F = 30


def rect_cells(nb: int, w: float = 1.0, h: float = 1.0) -> np.ndarray:
    """Equal-area partition of the unit square into ``nb`` grid cells of
    near-unit physical aspect for a w x h rectangle, any nb (the rect twin
    of disk_cells, for rect sources; tracer_tpu/culling.py:244). Returns
    (nb, 4) float32 rows of fractional bounds [u0, u1, v0, v1]; rows are
    horizontal bands whose heights are proportional to their cell counts,
    so every cell has area w*h/nb exactly."""
    def row_counts(m: int):
        return _largest_remainder_counts(np.full(m, nb / m), nb)

    def worst_aspect(n):
        cw = w / n                      # cell width per row
        ch = h * n / nb                 # row height (equal-area)
        a = np.maximum(cw, ch) / np.maximum(np.minimum(cw, ch), 1e-12)
        return float(a.max())

    best = None
    for m in range(1, int(2 * math.sqrt(nb * max(h / max(w, 1e-12), 0.25)))
                   + 2):
        n = row_counts(m)
        if n is None:
            continue
        a = worst_aspect(n)
        if best is None or a < best[0]:
            best = (a, n)
    n = best[1]
    cells = []
    v = 0.0
    for k in n:
        dv = k / nb
        for j in range(k):
            cells.append((j / k, (j + 1) / k, v, v + dv))
        v += dv
    return np.asarray(cells, dtype=np.float32)


def _row_spheres(meta, resolution: int = 8) -> np.ndarray:
    """(S, 4) world bounding spheres [cx, cy, cz, r] of every table row."""
    out = []
    for g, frame in zip(_row_geometries(meta), meta.frames):
        pts = _row_points(g, frame, resolution)
        c = 0.5 * (pts.min(axis=0) + pts.max(axis=0))
        r = float(np.linalg.norm(pts - c, axis=1).max())
        out.append([c[0], c[1], c[2], r])
    return np.asarray(out)


def _row_normal_cones(table, meta, resolution: int = 8) -> tuple:
    """Per-row mean world normal and angular spread (axis (S,3), beta (S,)).
    Normals come from the quadric gradient at mesh sample points pushed
    through the row frame — exact (beta = 0) for planes."""
    quads = (meta.host_quadric if meta.host_quadric is not None
             else np.asarray(table.quadric))
    axes = np.zeros((len(meta.frames), 3))
    betas = np.zeros(len(meta.frames))
    from .viz.render import mesh_of
    for i, (g, frame) in enumerate(zip(_row_geometries(meta), meta.frames)):
        q = quads[i]
        A = np.array([[q[0], q[3], q[4]],
                      [q[3], q[1], q[5]],
                      [q[4], q[5], q[2]]])
        b = q[6:9]
        x, y, z = mesh_of(g, resolution)
        pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        grad = pts @ A.T + b  # 0.5 * gradient; direction is all that matters
        nrm = np.linalg.norm(grad, axis=1, keepdims=True)
        grad = grad / np.where(nrm > 0, nrm, 1.0)
        world = grad @ frame[:3, :3].T
        mean = world.mean(axis=0)
        mn = np.linalg.norm(mean)
        if mn < 1e-12:  # closed surface (e.g. full sphere): no mean normal
            axes[i] = np.array([0.0, 0.0, 1.0])
            betas[i] = np.pi
            continue
        mean /= mn
        cosd = np.clip(world @ mean, -1.0, 1.0)
        axes[i] = mean
        betas[i] = float(np.arccos(cosd.min()))
    return axes, betas


def _reflect(d: np.ndarray, n: np.ndarray) -> np.ndarray:
    r = d - 2.0 * np.dot(d, n) * n
    nr = np.linalg.norm(r)
    return r / (nr if nr > 0 else 1.0)


def _cone_sweep_hits(spheres: np.ndarray, c0, r0: float, axis, alpha: float,
                     margin: float) -> np.ndarray:
    """Which bounding spheres intersect the volume swept by a direction
    cone (axis, half-angle alpha) from a start sphere (c0, r0). Exact for
    spheres up to the tan() linearization; conservative by margin.
    (lat^2 = |d|^2 - t^2 — no (S, 3) temporary.)"""
    d = spheres[:, :3] - np.asarray(c0)
    t = d @ np.asarray(axis)
    lat2 = np.maximum((d * d).sum(axis=1) - t * t, 0.0)
    reach = (r0 + np.maximum(t, 0.0) * math.tan(min(alpha, 1.4))
             + spheres[:, 3] + margin)
    ahead = t + spheres[:, 3] + margin >= 0.0
    return ahead & (lat2 <= reach * reach)


def _cone_sweep_hits_batch(C: np.ndarray, r: np.ndarray,
                           c_norm2: np.ndarray,
                           c0s: np.ndarray, r0s: np.ndarray,
                           axes: np.ndarray, alphas: np.ndarray,
                           margin: float) -> np.ndarray:
    """Batched _cone_sweep_hits: B cones against all S spheres in two
    (S, 3) x (3, B) GEMMs + elementwise math — one numpy dispatch per BFS
    LEVEL instead of one per cone (the per-call overhead of ~900k scalar
    sweeps dominated multi-k-row culling builds). All float32 (the sweep
    is conservative by ``margin`` >> f32 eps). C (S, 3) f32 centers,
    r (S,) radii, c_norm2 (S,) |C|^2. Returns (B, S) bool."""
    c0s = c0s.astype(np.float32)
    axes = axes.astype(np.float32)
    t = C @ axes.T                                              # (S, B)
    t -= (c0s * axes).sum(axis=1)[None, :]
    d2 = -2.0 * (C @ c0s.T)
    d2 += c_norm2[:, None]
    d2 += (c0s * c0s).sum(axis=1)[None, :]
    d2 -= t * t                                                 # = lat^2
    tanv = np.tan(np.minimum(alphas, 1.4)).astype(np.float32)
    reach = np.maximum(t, 0.0)
    reach *= tanv[None, :]
    reach += r0s.astype(np.float32)[None, :] + r[:, None] + np.float32(
        margin)
    ahead = t + (r[:, None] + np.float32(margin)) >= 0.0
    return (ahead & (d2 <= reach * reach)).T


def _cell_sphere(center, rot, radius: float, bounds,
                 rect_wh=None) -> tuple:
    """World bounding sphere of one equal-area source cell: a disk cell
    (bounds = [a0, a1, th0, th1], a the area fraction) or, with
    ``rect_wh = (w, h)``, a rect cell (bounds = fractional [u0, u1, v0,
    v1] of the w x h source rectangle; a rect spec's radius is 0)."""
    R = np.asarray(rot).reshape(3, 3)
    if rect_wh is not None:
        w, h = rect_wh
        u0, u1, v0, v1 = (float(v) for v in bounds)
        xs = w * (np.array([u0, u1]) - 0.5)
        ys = h * (np.array([v0, v1]) - 0.5)
        loc = np.array([[x, y, 0.0] for x in xs for y in ys])
    else:
        a0, a1, th0, th1 = (float(v) for v in bounds)
        r0 = radius * math.sqrt(a0)
        r1 = radius * math.sqrt(a1)
        th = th0 + (th1 - th0) * np.linspace(0.0, 1.0, 9)
        rr = np.concatenate([np.full_like(th, r0), np.full_like(th, r1)])
        tt = np.concatenate([th, th])
        loc = np.stack([rr * np.cos(tt), rr * np.sin(tt),
                        np.zeros_like(rr)], axis=1)
    pts = loc @ R.T + np.asarray(center)
    c = pts.mean(axis=0)
    return c, float(np.linalg.norm(pts - c, axis=1).max())


def _cone_sweep_clusters(CL: np.ndarray, RL: np.ndarray,
                         cl_norm2: np.ndarray,
                         c0s: np.ndarray, r0s: np.ndarray,
                         axes: np.ndarray, alphas: np.ndarray,
                         margin: float) -> np.ndarray:
    """Conservative cluster-level cone sweep: True whenever ANY sphere
    contained in the cluster bounding sphere could pass
    ``_cone_sweep_hits_batch``. For a member (c_m, r_m) inside cluster
    (c, R) (i.e. |c_m - c| + r_m <= R), a pass of the fine test implies
    the cluster passes with the radius inflated to R (1 + tan(alpha)):
    the lateral distance shifts by at most D = |c_m - c| while the reach
    loses at most D tan(alpha) of along-axis growth, and
    r_m + D (1 + tan a) <= R (1 + tan a). Returns (B, K) bool."""
    c0s = c0s.astype(np.float32)
    axes = axes.astype(np.float32)
    t = CL @ axes.T
    t -= (c0s * axes).sum(axis=1)[None, :]
    d2 = -2.0 * (CL @ c0s.T)
    d2 += cl_norm2[:, None]
    d2 += (c0s * c0s).sum(axis=1)[None, :]
    d2 -= t * t
    tanv = np.tan(np.minimum(alphas, 1.4)).astype(np.float32)
    reff = RL[:, None] * (1.0 + tanv[None, :]) + np.float32(1e-3)
    reach = np.maximum(t, 0.0)
    reach *= tanv[None, :]
    reach += r0s.astype(np.float32)[None, :] + reff + np.float32(margin)
    ahead = t + reff + np.float32(margin) >= 0.0
    return (ahead & (d2 <= reach * reach)).T


def _cluster_spheres(spheres: np.ndarray, leaf: int = 128) -> tuple:
    """Partition row bounding spheres into ~S/leaf spatial clusters by
    recursive median split along the widest axis. Returns
    (member_ids list of int arrays, cluster centers (K, 3) f32,
    cluster radii (K,) f32) with every member sphere CONTAINED in its
    cluster sphere (center distance + member radius <= cluster radius)."""
    C = spheres[:, :3]
    stack = [np.arange(len(spheres))]
    leaves = []
    while stack:
        idx = stack.pop()
        if len(idx) <= leaf:
            leaves.append(idx)
            continue
        P = C[idx]
        ax = int(np.argmax(P.max(axis=0) - P.min(axis=0)))
        m = len(idx) // 2
        part = np.argpartition(P[:, ax], m)
        stack.append(idx[part[:m]])
        stack.append(idx[part[m:]])
    centers = np.zeros((len(leaves), 3), dtype=np.float32)
    radii = np.zeros(len(leaves), dtype=np.float32)
    for k, idx in enumerate(leaves):
        lo = (C[idx] - spheres[idx, 3:4]).min(axis=0)
        hi = (C[idx] + spheres[idx, 3:4]).max(axis=0)
        c = 0.5 * (lo + hi)
        centers[k] = c
        radii[k] = float((np.linalg.norm(C[idx] - c, axis=1)
                          + spheres[idx, 3]).max())
    return leaves, centers, radii


class _ReachCache:
    """Memoized specular-closure sets: ``reach(s, cap)`` = rows reachable
    from a first-segment hit on row s under the source cone
    (d0, theta_src), expanded breadth-first up to ``cap`` bounces.

    The incident cone of every FIRST bounce is the source direction cone
    — identical for every cell — so the closure from a given first-hit
    row is CELL-INDEPENDENT and one BFS per (row, cap) serves the whole
    grid.

    The first ``reach`` call triggers ``precompute``: ONE multi-source
    level-synchronous BFS over every expandable row, with per-depth hit
    matrices so later calls at SMALLER caps (the corridor-degrade path)
    read the same store — hits found while expanding to depth d are a
    superset of any shallower BFS's (domination skips only drop cones
    whose hits an earlier-depth, wider cone already contributed). Sweeps
    go through a two-level sphere-cluster prune (_cone_sweep_clusters):
    at 10k rows the round-4 per-s0 BFS spent ~1050 s in flat (B, S)
    sweeps; the pruned global pass is ~20x cheaper."""

    def __init__(self, spheres, n_axis, widen, expandable_set, margin,
                 d0, theta_src):
        self.spheres = spheres
        self.C32 = np.ascontiguousarray(spheres[:, :3], dtype=np.float32)
        self.r32 = spheres[:, 3].astype(np.float32)
        self.c_norm2 = (self.C32 * self.C32).sum(axis=1)
        self.n_axis = n_axis
        self.widen = widen
        self.expandable = expandable_set
        self.margin = margin
        self.d0 = np.asarray(d0)
        self.theta_src = theta_src
        self.memo: dict = {}
        leaves, cl_c, cl_r = _cluster_spheres(spheres)
        self._leaves = leaves
        self._clC = cl_c
        self._clR = cl_r
        self._cl_norm2 = (cl_c * cl_c).sum(axis=1)
        self._pre = None        # list of per-depth (n_own, S) bool
        self._pre_cap = 0
        self._slot = None       # row -> owner slot (-1 = not expandable)

    def _sweep(self, origin_rows, axes, alphas) -> np.ndarray:
        """(B, S) bool cone sweep with cluster pruning: cones test the
        ~S/128 cluster bounding spheres first (conservatively inflated,
        see _cone_sweep_clusters) and refine only against hit clusters'
        members with the EXACT per-row test."""
        c0s = self.spheres[origin_rows, :3]
        r0s = self.spheres[origin_rows, 3]
        coarse = _cone_sweep_clusters(self._clC, self._clR, self._cl_norm2,
                                      c0s, r0s, axes, alphas, self.margin)
        out = np.zeros((len(origin_rows), len(self.spheres)), dtype=bool)
        for k, ids in enumerate(self._leaves):
            sel = np.nonzero(coarse[:, k])[0]
            if not sel.size:
                continue
            sub = _cone_sweep_hits_batch(
                self.C32[ids], self.r32[ids], self.c_norm2[ids],
                c0s[sel], r0s[sel], axes[sel], alphas[sel], self.margin)
            out[np.ix_(sel, ids)] = sub
        return out

    def precompute(self, cap: int) -> None:
        """Populate per-depth reach matrices for every expandable row."""
        if self._pre is not None and self._pre_cap >= cap:
            return
        S = len(self.spheres)
        owners = np.array(sorted(self.expandable), dtype=np.int32)
        slot = np.full(S, -1, dtype=np.int32)
        slot[owners] = np.arange(len(owners), dtype=np.int32)
        self._slot = slot
        self._pre = []
        self._pre_cap = cap
        if owners.size == 0 or cap <= 1:
            return
        exp_mask = np.zeros(S, dtype=bool)
        exp_mask[owners] = True
        n_own = len(owners)
        # cap > 3 needs the exact sequential domination bookkeeping of
        # the per-s0 BFS (cones expanded at depth >= 2 can dominate
        # depth >= 3 revisits); at the default cap 3 the only possible
        # seen entry at depth 2 is the source cone at (o, o), checked
        # vectorized below
        generic = cap > 3
        seen: dict = {}
        f_own = owners.copy()
        f_row = owners.copy()
        f_ax = np.broadcast_to(np.asarray(self.d0, dtype=np.float64),
                               (n_own, 3)).copy()
        f_al = np.full(n_own, float(self.theta_src))
        for depth in range(1, cap):
            if generic:
                keep_l = []
                for i in range(len(f_row)):
                    key = (int(f_own[i]), int(f_row[i]))
                    lst = seen.get(key)
                    ax, al = f_ax[i], float(f_al[i])
                    if lst is not None and any(
                            math.acos(float(np.clip(np.dot(a0, ax),
                                                    -1.0, 1.0))) + al
                            <= al0 + 1e-9 for a0, al0 in lst):
                        continue
                    seen.setdefault(key, []).append((ax.copy(), al))
                    keep_l.append(i)
                keep = np.asarray(keep_l, dtype=np.int64)
            elif depth == 2:
                # a depth-2 revisit of the own first-hit row checks
                # against the source cone recorded at depth 1
                self_mask = f_row == f_own
                dom = np.zeros(len(f_row), dtype=bool)
                if self_mask.any():
                    gap = np.arccos(np.clip(f_ax[self_mask]
                                            @ np.asarray(self.d0),
                                            -1.0, 1.0))
                    dom[self_mask] = (gap + f_al[self_mask]
                                      <= self.theta_src + 1e-9)
                keep = np.nonzero(~dom)[0]
            else:
                keep = np.arange(len(f_row))
            if keep.size == 0:
                break
            o = f_own[keep]
            s = f_row[keep]
            N = self.n_axis[s]
            refl = f_ax[keep] - 2.0 * (f_ax[keep] * N).sum(
                axis=1, keepdims=True) * N
            nrm = np.linalg.norm(refl, axis=1, keepdims=True)
            refl = refl / np.where(nrm > 0, nrm, 1.0)
            out_al = f_al[keep] + self.widen[s]
            order = np.argsort(o, kind="stable")
            o, s, refl, out_al = o[order], s[order], refl[order], \
                out_al[order]
            M = np.zeros((n_own, S), dtype=bool)
            nf = ([], [], [], [])
            # multi-k-row frontiers are millions of cones: the per-chunk
            # python overhead (leaf loop + owner folds) dominates below
            # ~8k cones/chunk, and a (chunk, S) bool hits matrix at this
            # size is ~150 MB — cheap against the (n_own, S) store
            chunk = max(1, (1 << 27) // max(S, 1))
            for i0 in range(0, len(s), chunk):
                sl = slice(i0, i0 + chunk)
                hits = self._sweep(s[sl], refl[sl], out_al[sl])
                ob = o[sl]
                starts = np.nonzero(np.r_[True, ob[1:] != ob[:-1]])[0]
                ends = np.r_[starts[1:], len(ob)]
                # owner-run OR folds: np.any reduces each run's rows
                # vectorized (ufunc.reduceat along axis 0 is a scalar
                # loop)
                for st, en in zip(starts.tolist(), ends.tolist()):
                    if en - st == 1:
                        M[slot[ob[st]]] |= hits[st]
                    else:
                        M[slot[ob[st]]] |= hits[st:en].any(axis=0)
                if depth + 1 < cap:
                    ci, cj = np.nonzero(hits & exp_mask[None, :])
                    nf[0].append(ob[ci])
                    nf[1].append(cj.astype(np.int32))
                    nf[2].append(refl[sl][ci])
                    nf[3].append(out_al[sl][ci])
            self._pre.append(M)
            if depth + 1 >= cap or not nf[0]:
                break
            f_own = np.concatenate(nf[0])
            f_row = np.concatenate(nf[1])
            f_ax = np.concatenate(nf[2])
            f_al = np.concatenate(nf[3])

    def reach(self, s0: int, cap: int) -> frozenset:
        key = (int(s0), int(cap))
        got = self.memo.get(key)
        if got is not None:
            return got
        # precompute early-returns when the store already covers cap and
        # rebuilds otherwise — gating on `_pre is None` instead would pin
        # the store at the FIRST call's cap and silently send every
        # larger-cap query down the per-s0 BFS
        self.precompute(cap)
        sl = self._slot[int(s0)] if self._slot is not None else -1
        if sl >= 0 and cap <= self._pre_cap:
            acc = np.zeros(len(self.spheres), dtype=bool)
            for M in self._pre[:max(cap - 1, 0)]:
                acc |= M[sl]
            out = frozenset(np.nonzero(acc)[0].tolist())
        else:
            out = self._reach_single(int(s0), int(cap))
        self.memo[key] = out
        return out

    def _reach_single(self, s0: int, cap: int) -> frozenset:
        """Per-source BFS fallback (non-expandable s0 or cap beyond the
        precomputed depth); the reference semantics the global pass
        mirrors."""
        cand = set()
        frontier = [(int(s0), self.d0, self.theta_src)]
        seen = {}   # row -> list of (axis, alpha) cones already expanded

        def dominated(s, axis, alpha):
            """True if an already-expanded cone at s contains this one
            (angle between axes + new half-angle <= old half-angle) —
            skipping is then sound because the old sweep was wider."""
            for old_axis, old_alpha in seen.get(s, ()):
                gap = math.acos(float(np.clip(np.dot(old_axis, axis),
                                              -1.0, 1.0)))
                if gap + alpha <= old_alpha + 1e-9:
                    return True
            return False

        for depth in range(1, cap):
            todo = []
            for s, in_axis, in_alpha in frontier:
                in_axis = np.asarray(in_axis)
                if dominated(s, in_axis, in_alpha):
                    continue
                seen.setdefault(s, []).append((in_axis, in_alpha))
                todo.append((s, _reflect(in_axis, self.n_axis[s]),
                             in_alpha + self.widen[s]))
            if not todo:
                break
            idx = np.array([s for s, _, _ in todo])
            axes = np.stack([a for _, a, _ in todo])
            alphas = np.array([al for _, _, al in todo])
            hits_mat = _cone_sweep_hits_batch(
                self.C32, self.r32, self.c_norm2, self.spheres[idx, :3],
                self.spheres[idx, 3], axes, alphas, self.margin)
            frontier = []
            for j in range(len(todo)):
                hits = np.nonzero(hits_mat[j])[0].tolist()
                cand.update(hits)
                if depth + 1 < cap:
                    out_axis, out_alpha = todo[j][1], todo[j][2]
                    for c in hits:
                        if c in self.expandable:
                            frontier.append((int(c), out_axis, out_alpha))
        return frozenset(cand)


def _one_cell_list(bounds, center, rot, radius, theta_src, spheres,
                   n_axis, widen, expandable_set, age_cap, margin, d0,
                   rect_wh=None, reach_cache=None):
    """Candidate row list for one source cell: first-segment cone sweep +
    breadth-first closure under specular reflection up to ``age_cap``
    bounces (see module doc). The closure from each first-hit row is
    cell-independent, so it is served by the shared ``reach_cache``
    (a fresh one is built here when not supplied)."""
    if reach_cache is None:
        reach_cache = _ReachCache(spheres, n_axis, widen, expandable_set,
                                  margin, d0, theta_src)
    c0, r0 = _cell_sphere(center, rot, radius, bounds, rect_wh=rect_wh)
    # the batched sweep (f32) everywhere — _cell_lists uses it for whole
    # grids, so the single-cell path (degrade rebuilds) must share its
    # numerics or a rebuilt cell could differ in boundary entries
    first = np.nonzero(_cone_sweep_hits_batch(
        reach_cache.C32, reach_cache.r32, reach_cache.c_norm2,
        np.asarray(c0)[None], np.asarray([r0]),
        np.asarray(d0)[None], np.asarray([theta_src]), margin)[0])[0]
    cand = set(first.tolist())
    for s in first.tolist():
        if s in expandable_set:
            cand |= reach_cache.reach(s, age_cap)
    return sorted(cand)


def _cell_lists(cell_bounds, center, rot, radius, theta_src, spheres,
                n_axis, widen, expandable_set, age_cap, margin, d0,
                rect_wh=None, reach_cache=None):
    """Candidate row lists for each source cell (see _one_cell_list).

    First-segment sweeps for the WHOLE grid run as one batched GEMM pass
    (chunked) instead of one scalar sweep per cell — mesh-targeted builds
    use grids of tens of thousands of cells where the per-call numpy
    dispatch dominated."""
    if reach_cache is None:
        reach_cache = _ReachCache(spheres, n_axis, widen, expandable_set,
                                  margin, d0, theta_src)
    nc = len(cell_bounds)
    S = len(spheres)
    c0s = np.zeros((nc, 3))
    r0s = np.zeros(nc)
    for i, bounds in enumerate(cell_bounds):
        c0s[i], r0s[i] = _cell_sphere(center, rot, radius, bounds,
                                      rect_wh=rect_wh)
    axes = np.broadcast_to(np.asarray(d0, dtype=np.float64), (nc, 3))
    alphas = np.full(nc, float(theta_src))
    # big grids (mesh builds: tens of thousands of cells x multi-k rows)
    # union the memoized reach sets as PACKED BITMASKS — the frozenset
    # unions cost ~1e9 set inserts at a 20k x 20k build. Same sets: the
    # bitmask of row s is exactly reach(s, age_cap)'s store lookup.
    bitset = nc * S > (1 << 25) and reach_cache.expandable
    pre_pack = None
    if bitset:
        reach_cache.precompute(age_cap)
        if reach_cache._pre is not None and len(reach_cache._pre):
            acc = reach_cache._pre[0].copy()
            for Mx in reach_cache._pre[1:max(age_cap - 1, 0)]:
                acc |= Mx
            pre_pack = np.packbits(acc, axis=1)
    out = []
    chunk = max(1, (1 << 25) // max(S, 1))
    for i0 in range(0, nc, chunk):
        sl = slice(i0, min(i0 + chunk, nc))
        hits = _cone_sweep_hits_batch(
            reach_cache.C32, reach_cache.r32, reach_cache.c_norm2,
            c0s[sl], r0s[sl], axes[sl], alphas[sl], margin)
        for j in range(hits.shape[0]):
            first = np.nonzero(hits[j])[0]
            if pre_pack is not None:
                slots = reach_cache._slot[first]
                slots = slots[slots >= 0]
                mask = np.zeros(S, dtype=bool)
                mask[first] = True
                if slots.size:
                    pk = np.bitwise_or.reduce(pre_pack[slots], axis=0)
                    mask |= np.unpackbits(pk, count=S).astype(bool)
                out.append(np.nonzero(mask)[0].tolist())
                continue
            cand = set(first.tolist())
            for s in first.tolist():
                if s in expandable_set:
                    cand |= reach_cache.reach(s, age_cap)
            out.append(sorted(cand))
    return out


def _row_fill(meta, spheres, resolution: int = 8) -> np.ndarray:
    """Per-row fill factor: surface area / bounding-sphere cross-section
    (pi r^2). Measures how much of a sphere hit is actually surface."""
    from .viz.render import mesh_of
    out = np.ones(len(spheres))
    for i, g in enumerate(_row_geometries(meta)):
        x, y, z = mesh_of(g, resolution)
        pts = np.stack([x, y, z], axis=-1)
        e1 = pts[1:, :-1] - pts[:-1, :-1]
        e2 = pts[:-1, 1:] - pts[:-1, :-1]
        area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum() * 2.0
        denom = np.pi * spheres[i, 3] ** 2
        out[i] = min(area / max(denom, 1e-30), 1.0)
    return out


def _pilot_survival(cell_bounds, center, rot, radius, theta_dni,
                    n_rays: int, spheres, n_axis, fill, absorb,
                    seed: int = 0, rect_wh=None,
                    rays_rot=None) -> np.ndarray:
    """Per-cell survival estimate: expected (1 - absorptivity) weight of a
    pilot ray's first interaction, from a pure-NumPy bounding-sphere
    intersect weighted by each row's fill factor x incidence cosine.
    Used ONLY for load balancing (block multiplicity) — never affects
    soundness — so the sphere approximation is fine, and it stays on the
    host. Pilot directions sample the solar disc only (98%+ of Buie
    energy). A rect source's cells (``rect_wh``) are fractional bounds of
    its w x h rectangle, and its directions leave about ``rays_rot``."""
    rng = np.random.default_rng(seed)
    nc = len(cell_bounds)
    b0, b1, b2, b3 = (np.repeat(cell_bounds[:, k], n_rays)
                      for k in range(4))
    u1 = rng.random(nc * n_rays)
    u2 = rng.random(nc * n_rays)
    if rect_wh is not None:
        w, hgt = rect_wh
        lx = w * (b0 + u1 * (b1 - b0) - 0.5)
        ly = hgt * (b2 + u2 * (b3 - b2) - 0.5)
        loc = np.stack([lx, ly, np.zeros_like(lx)], axis=1)
    else:
        rr = radius * np.sqrt(b0 + u1 * (b1 - b0))
        th = b2 + u2 * (b3 - b2)
        loc = np.stack([rr * np.cos(th), rr * np.sin(th),
                        np.zeros_like(rr)], axis=1)
    R = np.asarray(rot).reshape(3, 3)
    pos = (loc @ R.T + np.asarray(center)).astype(np.float32)
    t = theta_dni * np.sqrt(rng.random(nc * n_rays))
    p = 2.0 * np.pi * rng.random(nc * n_rays)
    ld = np.stack([np.sin(t) * np.cos(p), np.sin(t) * np.sin(p),
                   np.cos(t)], axis=1)
    Rd = R if rays_rot is None else np.asarray(rays_rot).reshape(3, 3)
    dirs = (ld @ Rd.T).astype(np.float32)

    c = spheres[:, :3].astype(np.float32)
    cT = np.ascontiguousarray(c.T)
    c_norm2 = (c * c).sum(axis=1)
    r2 = (spheres[:, 3] ** 2).astype(np.float32)
    na32 = n_axis.T.astype(np.float32)
    # first interaction weight = (1-a) * fill * |cos| of the nearest
    # sphere the ray pierces. GEMM formulation: with b = c - P,
    # b.D = D@c.T - (D.P) and |b|^2 = |c|^2 - 2 P@c.T + |P|^2, so the
    # two (N, S, 3) temporaries of the naive einsum become two BLAS
    # sgemms of (N, 3) x (3, S) — ~10x faster at multi-k-row scenes
    # (chunked: every N x S intermediate stays ~16 MB)
    surv = np.zeros(nc * n_rays, dtype=np.float32)
    w_row = ((1.0 - absorb) * fill).astype(np.float32)
    chunk = max(1, (1 << 22) // max(len(c), 1))
    for i0 in range(0, len(pos), chunk):
        P = pos[i0:i0 + chunk]
        D = dirs[i0:i0 + chunk]
        tt = D @ cT - (D * P).sum(axis=1, keepdims=True)
        b2 = (c_norm2[None, :] - 2.0 * (P @ cT)
              + (P * P).sum(axis=1)[:, None])
        miss = (tt < 0.0) | (b2 - tt * tt > r2[None, :])
        tt = np.where(miss, np.inf, tt)
        s = np.argmin(tt, axis=1)
        lane = np.arange(len(P))
        hit = np.isfinite(tt[lane, s])
        cosr = np.abs(np.einsum("nk,kn->n", D, na32[:, s]))
        surv[i0:i0 + chunk] = np.where(hit, w_row[s] * cosr, 0.0)
    return surv.reshape(nc, n_rays).mean(axis=1)


def _aggregate_survival(fine_cells, fine_h, coarse_cells) -> np.ndarray:
    """Area-weighted survival of a coarse equal-area partition from a
    fine partition's estimates: each fine cell's center lands in exactly
    one coarse cell, and all fine cells have equal area, so the coarse h
    is the plain mean of its member fine cells. Coarse cells with no
    member center SAMPLE the fine field at their own center instead (the
    mesh-scale builds run the pilot on a CAPPED grid, so the "coarse"
    query partition can be finer than the pilot; the survival field is
    smooth at that scale)."""
    a_mid = 0.5 * (fine_cells[:, 0] + fine_cells[:, 1])
    th_mid = 0.5 * (fine_cells[:, 2] + fine_cells[:, 3])
    out = np.full(len(coarse_cells), float(fine_h.mean()))
    counts = np.zeros(len(coarse_cells), dtype=np.int64)
    sums = np.zeros(len(coarse_cells))
    for c, (a0, a1, th0, th1) in enumerate(coarse_cells):
        m = (a_mid >= a0) & (a_mid < a1) & (th_mid >= th0) & (th_mid < th1)
        counts[c] = m.sum()
        sums[c] = fine_h[m].sum()
    empty = counts == 0
    if empty.any():
        qa = 0.5 * (coarse_cells[empty, 0] + coarse_cells[empty, 1])
        qt = 0.5 * (coarse_cells[empty, 2] + coarse_cells[empty, 3])
        inside = ((qa[:, None] >= fine_cells[None, :, 0])
                  & (qa[:, None] < fine_cells[None, :, 1])
                  & (qt[:, None] >= fine_cells[None, :, 2])
                  & (qt[:, None] < fine_cells[None, :, 3]))
        has = inside.any(axis=1)
        pick = np.argmax(inside, axis=1)
        out_e = np.full(int(empty.sum()), float(fine_h.mean()))
        out_e[has] = fine_h[pick[has]]
        out[empty] = out_e
    nz = counts > 0
    out[nz] = sums[nz] / counts[nz]
    return out


def build_block_culling(table, meta, source_spec, slab: int, *,
                        tile: Optional[int] = None, k_sigma: float = 5.0,
                        w_cap: float = 0.15, age_cap: int = 3,
                        margin: float = 0.25, resolution: int = 8,
                        balance: bool = True,
                        pilot_rays: int = 256,
                        max_smem_bytes: int = 1 << 20,
                        max_segments: int = 64,
                        min_segments: int = 1,
                        mesh_devices: int = 1,
                        park_aureole: Optional[bool] = None) -> BlockCulling:
    """Build per-block candidate lists for a disk source
    (``sources.buie_sunshape_pallas_spec``, ``disk_pillbox_pallas_spec``)
    or a rect one (``rect_buie_sunshape_pallas_spec``,
    ``oblique_rect_pillbox_pallas_spec``); the culled bounce kernel
    (kernels/bounce.py) consumes the same spec for in-kernel
    regeneration. The port of tracer_tpu/culling.py:906.

    slab must be a whole number of ray tiles; the nb = slab / TILE blocks
    serve equal-area cells of the source disk. With ``balance`` (default),
    a cheap pilot trace estimates each region's bounce-survival rate and
    cells over dense optics get MULTIPLE blocks (quota split between
    them): otherwise those cells' slow emission (refill only replaces dead
    lanes) sets the round count for the whole grid.

    The cell bounds are a disk cell's [a0, a1, th0, th1] (area fractions,
    angles) or a rect cell's [x0, x1, y0, y1] in local metres, as the
    kernels sample them. A one-device build raises NotImplementedError
    when its candidate lists exceed what K1 stages in shared memory
    (ROADMAP B5); a scene whose whole table exceeds K2's stage drains
    through the oracle instead.

    ``mesh_devices > 1`` builds for the sharded trace
    (parallel.trace_streaming_sharded) over that many ranks: ``slab`` is
    the GLOBAL slab, nb must divide by the rank count, and, as in
    tracer_tpu, the widest cells' corridors are degraded until every
    (rank, segment) chunk of ``mesh_segment_shards`` fits
    ``max_smem_bytes`` split into at most ``max_segments`` segments
    (tracer_tpu's budget, smem_need_bytes), so the arrays equal
    tracer_tpu's.

    ``park_aureole=True`` sizes the specular closure to the solar-disc
    cone (1.001 theta_dni) while the first-segment sweep keeps the full
    sunshape cone: shorter lists, and the culled trace parks the
    survivors of aureole-born lanes' first bounce for the exact drain.
    It is off for a source without an aureole. ``None`` (the default)
    means on for a mesh build of a Buie source whose aureole reaches past
    1.5 theta_dni, and off otherwise, as in tracer_tpu.

    On one device ``max_smem_bytes``, ``max_segments`` and
    ``min_segments`` (tracer_tpu's split of the block lists into
    sequential segments that each fit the TPU's 1 MB scalar memory) are
    accepted and ignored: the port's build is one segment, and its own
    checks against what K1 stages in shared memory still raise past the
    H100's budget."""
    del min_segments
    from .kernels.bounce import MAX_STAGE_FLOATS, TILE, row_width
    from .accel import UNBOUNDED_KINDS
    tile = tile or TILE
    if slab % tile != 0:
        raise ValueError(f"slab {slab} not a multiple of the ray tile {tile}")
    unbounded = [i for i, g in enumerate(_row_geometries(meta))
                 if g.kind in UNBOUNDED_KINDS]
    if unbounded:
        # the corridor analysis bounds every surface by a sphere from its
        # mesh; an infinite plane/quadric has no such bound, so any
        # candidate list would be unsound — refuse instead of silently
        # mis-culling (use the bounded variants: rect_plate, round_plate,
        # parabolic_dish, finite_cylinder, ...)
        raise ValueError(
            f"culling needs bounded surfaces; rows {unbounded} have "
            "unbounded kinds "
            f"({sorted({_row_geometries(meta)[i].kind for i in unbounded})})")
    nb = slab // tile
    if mesh_devices > 1 and nb % mesh_devices:
        raise ValueError(f"{nb} blocks not divisible by {mesh_devices} "
                         "mesh devices; pick a slab with a divisible "
                         "tile count")
    (cx, cy, cz, rot, radius, _e_ray, _coeffs, _disc_end, gamma, _kappa,
     _integ, theta_tot, theta_dni) = source_spec[:13]
    center = np.array([cx, cy, cz])
    R = np.asarray(rot).reshape(3, 3)
    # the rect-source marker: positions on a w x h rect in the rot frame,
    # directions about rays_rot's +z when the source is oblique
    rect = source_spec[15] if len(source_spec) > 15 else None
    rect_wh = (float(rect[0]), float(rect[1])) if rect is not None else None
    rays_rot = (rect[2] if rect is not None and rect[2] is not None
                else None)
    Rd = np.asarray(rays_rot).reshape(3, 3) if rays_rot is not None else R
    d0 = Rd[:, 2]  # ray-direction frame +z in world coords
    if rect is not None:
        cells_fn = lambda nc: rect_cells(nc, *rect_wh)   # noqa: E731
    else:
        cells_fn = disk_cells
    # Buie sunshapes carry a circumsolar aureole out to theta_tot, ~10x
    # the solar-disc cone theta_dni. The first-segment sweep always covers
    # the full cone; with park_aureole the specular closure covers only
    # the disc cone (the kernel flags aureole-born lanes' hits and the
    # engine parks their survivors). The 1.001 covers the inverse-CDF
    # polynomial's fit error. Mesh builds park by default: the disc-sized
    # closure is what lets multi-10k-row rank budgets fit at full depth.
    if park_aureole is None:
        park_aureole = (mesh_devices > 1 and gamma is not None
                        and float(theta_tot) > 1.5 * float(theta_dni))
    park_aureole = bool(park_aureole) and gamma is not None
    theta_first = float(theta_tot if gamma is not None else theta_dni)
    theta_reach = (1.001 * float(theta_dni) if park_aureole
                   else theta_first)

    with telemetry.span("build.geometry"):
        spheres = _row_spheres(meta, resolution)
        n_axis, n_beta = _row_normal_cones(table, meta, resolution)

    kinds = (meta.host_opt_kind if meta.host_opt_kind is not None
             else np.asarray(table.opt_kind))
    prm = (meta.host_opt_params if meta.host_opt_params is not None
           else np.asarray(table.opt_params))
    flg = (meta.host_opt_flags if meta.host_opt_flags is not None
           else np.asarray(table.opt_flags))
    S = len(spheres)
    # per-row slope-error sigma (same slot logic as the scene compiler)
    sigma = np.where(kinds == M.K_REFLECT, prm[:, 1],
                     np.where(np.isin(kinds, (M.K_REFLECT_SPECTRAL,
                                              M.K_LAMBERTIAN_SPECULAR,
                                              M.K_REFRACTIVE)),
                              prm[:, 2], 0.0))
    widen = 2.0 * (n_beta + k_sigma * math.sqrt(2.0) * sigma)
    # p0 is the absorptivity for constant-absorptance kinds; spectral rows
    # store a table index there and conductor rows store n1, so both are
    # conservatively non-terminal mirrors (R ~ 0.9 for metals)
    absorptivity = np.where(np.isin(kinds, (M.K_REFLECT_SPECTRAL,
                                            M.K_FRESNEL_CONDUCTOR,
                                            M.K_LAMBERTIAN_PIECEWISE)),
                            0.1, np.clip(prm[:, 0], 0.0, 1.0))
    # terminal rows absorb EVERYTHING they receive: spectral/conductor/
    # piecewise p0 is not an absorptivity (table index), and the IAM
    # modifier strictly reduces the nominal absorptivity (reflecting the
    # remainder), so none of those can be terminal even at p0 = 1
    terminal = (~np.isin(kinds, (M.K_REFLECT_SPECTRAL,
                                 M.K_FRESNEL_CONDUCTOR,
                                 M.K_LAMBERTIAN_PIECEWISE))
                & ((flg & M.F_IAM) == 0)
                & (prm[:, 0] >= 1.0 - 1e-6))   # no outgoing energy, ever
    # wide scatterers cannot keep the closure narrow -> demote (their
    # surviving rays leave the fast path and drain against the full
    # list); spectral and conductor mirrors reflect specularly, so they
    # expand
    specular = np.isin(kinds, (M.K_REFLECT, M.K_REFLECT_SPECTRAL,
                               M.K_FRESNEL_CONDUCTOR))
    demote = (~terminal) & ((widen > w_cap) | ~specular)
    expandable = np.nonzero(~terminal & ~demote)[0]
    expandable_set = set(expandable.tolist())

    # ---- load balancing: pick n_cells <= nb and block multiplicities so
    # every block finishes its quota in about the same number of rounds
    # (a block refills only its dead lanes, so a cell with survival h
    # emits ~ (1 - h) * TILE rays per round)
    # minimax over candidate partitions: the round count of the whole grid
    # is max_c quota/(m_c (1-h_c)) with quota = total/n_cells, so score
    # each candidate by max_c(w_c / m_c) / n_cells after greedy allocation
    n_cells = nb
    mult = np.ones(nb, dtype=np.int64)
    with telemetry.span("build.pilot_balance"):
        if balance and nb > 1:
            # ONE pilot; candidate partitions aggregate/sample it. The grid
            # is CAPPED: the pilot only feeds block multiplicities, and the
            # survival field is smooth at ~2k-cell resolution
            fine = cells_fn(min(nb, 2048))
            fill = _row_fill(meta, spheres, resolution)
            # the pilot is O(cells x rays x rows) and only feeds load
            # balancing — scale rays down as the scene grows (relative
            # survival needs ~1/sqrt(n) accuracy, not absolute precision)
            pilot_eff = max(48, int(pilot_rays
                                    * min(1.0, (1500.0 / S) ** 0.5)))
            fine_h = _pilot_survival(fine, center, rot, radius,
                                     float(theta_dni), pilot_eff,
                                     spheres, n_axis, fill, absorptivity,
                                     rect_wh=rect_wh, rays_rot=rays_rot)
            best = None
            tried = set()
            for div in (1.0, 1.1, 1.2, 1.35, 1.5, 1.7, 2.0):
                nc = int(np.clip(round(nb / div), 1, nb))
                if nc in tried:
                    continue
                tried.add(nc)
                cand = cells_fn(nc)
                h = (fine_h if nc == len(fine)
                     else _aggregate_survival(fine, fine_h, cand))
                w = 1.0 / np.maximum(1.0 - h, 0.1)
                m = np.ones(nc, dtype=np.int64)
                for _ in range(nb - nc):
                    m[np.argmax(w / m)] += 1
                # total cost ~ rounds x per-round cost. Rounds ~ max_c of
                # quota/(m_c (1-h_c)) ~ max(w/m)/nc. Per-round cost has a
                # fixed part and a candidate-loop part that grows with cell
                # area (estimated by the first-segment sweep count of a mid
                # ring cell; the closure roughly doubles it). The weights are
                # tracer_tpu's cost model, kept so the block layout (and the
                # lists) equal the JAX build's; re-tuning them for the H100
                # belongs with the tile re-tune (ROADMAP B5).
                mid = cand[len(cand) // 2]
                c0, r0 = _cell_sphere(center, rot, radius, mid,
                                      rect_wh=rect_wh)
                L1 = int(_cone_sweep_hits(spheres, c0, r0, d0, theta_first,
                                          margin).sum())
                score = (float((w / m).max()) / nc) * (1.0 + 0.09 * L1)
                if best is None or score < best[0]:
                    best = (score, nc, m)
            _, n_cells, mult = best
    cells = cells_fn(n_cells)

    reach_cache = _ReachCache(spheres, n_axis, widen, expandable_set,
                              margin, d0, theta_reach)
    with telemetry.span("build.reach_precompute"):
        reach_cache.precompute(age_cap)
    with telemetry.span("build.cell_lists"):
        cl = _cell_lists(cells, center, rot, radius, theta_first, spheres,
                         n_axis, widen, expandable_set, age_cap, margin, d0,
                         rect_wh=rect_wh, reach_cache=reach_cache)
    with telemetry.span("build.layout"):

        # ---- K1 stages a block's candidate rows in shared memory: a
        # one-device layout past its budget needs the row streaming of
        # ROADMAP B5. A mesh build degrades its widest corridors until every
        # (rank, segment) chunk fits tracer_tpu's budget, as tracer_tpu's.
        groups = table.groups
        G = len(groups)
        K = row_width(table)
        cell_depth = np.full(n_cells, age_cap, dtype=np.int64)
        cell_of_block = np.repeat(np.arange(n_cells), mult).astype(np.int32)
        assert len(cell_of_block) == nb
        mesh_n_seg = None
        if mesh_devices > 1:
            def rebuild(c: int) -> list:
                return _one_cell_list(cells[c], center, rot, radius,
                                      theta_first, spheres, n_axis, widen,
                                      expandable_set, int(cell_depth[c]),
                                      margin, d0, rect_wh=rect_wh,
                                      reach_cache=reach_cache)
            mesh_n_seg = _fit_mesh(table, cl, cell_of_block, cell_depth, nb,
                                   mesh_devices, max_smem_bytes, max_segments,
                                   rebuild)
        lists = [cl[c] for c in cell_of_block]
        cell_bounds = cells[cell_of_block]
        if rect is not None:
            # the kernels sample rect cells in local metres: the fractional
            # [u0, u1, v0, v1] become [x0, x1, y0, y1]
            w_src, h_src = rect_wh
            cell_bounds = np.stack([
                w_src * (cell_bounds[:, 0] - 0.5),
                w_src * (cell_bounds[:, 1] - 0.5),
                h_src * (cell_bounds[:, 2] - 0.5),
                h_src * (cell_bounds[:, 3] - 0.5)], axis=1).astype(np.float32)
        age_caps = cell_depth[cell_of_block].astype(np.int32)

        # ---- partition each block's list by APERTURE-SIGNATURE GROUP: the
        # kernel runs one specialized fori per group (its aperture predicates
        # and flat/quadric solver are compile-time), so a block's candidates
        # land in static per-group column segments [off_g, off_g + W_g),
        # padded with -1. counts is (nb, G).
        per_group = [[sorted(r for r in rows_b if start <= r < end)
                      for (start, end, _sig, _tag) in groups]
                     for rows_b in lists]
        counts = np.asarray([[len(gl) for gl in pg] for pg in per_group],
                            dtype=np.int32)

        w_g = tuple(max(1, int(counts[:, g].max())) for g in range(G))
        offsets = tuple(int(sum(w_g[:g])) for g in range(G))
        if mesh_devices == 1 and sum(w_g) * K > MAX_STAGE_FLOATS:
            raise NotImplementedError(
                f"candidate lists {sum(w_g)} rows wide exceed the culled "
                "kernel's shared-memory stage; row streaming is ROADMAP B5")
        arr = np.full((nb, sum(w_g)), -1, dtype=np.int32)
        for b in range(nb):
            for g, gl in enumerate(per_group[b]):
                arr[b, offsets[g]:offsets[g] + len(gl)] = gl
    n_cand = counts.sum(axis=1)
    stats = dict(nb=nb, n_cells=n_cells, mult_max=int(mult.max()),
                 L_max=int(n_cand.max()), n_groups=G,
                 L_mean=float(n_cand.mean()), n_rows=S,
                 n_demoted=int(demote.sum()), mesh_n_seg=mesh_n_seg,
                 reduction=float(S / max(n_cand.mean(), 1.0)))
    return BlockCulling(lists=arr, counts=counts, cell_bounds=cell_bounds,
                        cell_of_block=cell_of_block, n_cells=n_cells,
                        age_caps=age_caps, group_offsets=offsets,
                        demote_rows=tuple(int(r) for r in
                                          np.nonzero(demote)[0]),
                        stats=stats, park_aureole=park_aureole,
                        mesh_devices=mesh_devices)


def _fit_mesh(table, cl: list, cell_of_block, cell_depth, nb: int,
              n_dev: int, max_smem_bytes: int, max_segments: int,
              rebuild) -> int:
    """tracer_tpu's mesh fit (tracer_tpu/culling.py:1243-1350): the
    fewest uniform segments a rank, searched by doubling, such that every
    (rank, segment) chunk's layout and row shard fit ``max_smem_bytes``
    (smem_need_bytes; widths and row shards pad to the most over the
    ranks). While none fits, the cells binding the widest group (the
    next one down once it is at depth 1) lose a corridor level: their
    list is ``rebuild(c)`` at ``cell_depth[c]`` - 1 (``cl`` and
    ``cell_depth`` change in place). Returns the segment count."""
    groups = table.groups
    G = len(groups)
    n_cells = len(cl)
    nbl = nb // n_dev

    def group_counts():
        out = np.zeros((n_cells, G), dtype=np.int64)
        for c in range(n_cells):
            arr = np.asarray(cl[c], dtype=np.int64)
            for g, (start, end, _sig, _tag) in enumerate(groups):
                out[c, g] = (np.searchsorted(arr, end)
                             - np.searchsorted(arr, start))
        return out

    def chunk_rows(cells_in) -> int:
        if not len(cells_in):
            return 1
        return len(np.unique(np.concatenate(
            [np.asarray(cl[c], dtype=np.int64) for c in cells_in]
            + [np.zeros(1, dtype=np.int64)])))

    def fits(cgc, n_seg) -> bool:
        cuts = [round(i * nbl / n_seg) for i in range(n_seg + 1)]
        if any(b1 - b0 < 1 for b0, b1 in zip(cuts, cuts[1:])):
            return False
        for b0, b1 in zip(cuts, cuts[1:]):
            w_i = 0
            s_pad = 1
            for d in range(n_dev):
                cells_in = np.unique(cell_of_block[d * nbl + b0:
                                                   d * nbl + b1])
                w_d = int(sum(max(1, int(cgc[cells_in, g].max()))
                              for g in range(G)))
                w_i = max(w_i, w_d)
                s_pad = max(s_pad, chunk_rows(cells_in))
            if smem_need_bytes(table, b1 - b0, w_i,
                               n_rows=s_pad) > max_smem_bytes:
                return False
        return True

    def search(cgc, only_max: bool = False):
        n_max = min(max_segments, nbl)
        if only_max:
            return n_max if fits(cgc, n_max) else None
        n_seg = 1
        while n_seg <= n_max:
            if fits(cgc, n_seg):
                return n_seg
            n_seg *= 2
        return n_max if fits(cgc, n_max) else None

    cgc = group_counts()
    probing = False          # once a fit failed, probe the finest split
    while True:
        n_seg = search(cgc, only_max=probing)
        if n_seg is not None:
            return search(cgc) if probing else n_seg
        probing = True
        cands = np.array([], dtype=np.int64)
        for g_star in np.argsort(cgc.max(axis=0))[::-1]:
            cands = np.nonzero((cgc[:, g_star] == cgc[:, g_star].max())
                               & (cell_depth > 1))[0]
            if len(cands):
                break
        if len(cands) == 0:
            raise ValueError(
                f"first-segment candidate lists (group widths "
                f"{cgc.max(axis=0).tolist()}) exceed the per-rank budget "
                f"even split into {max_segments} sequential segments; "
                "increase the slab (smaller cells) or the rank count")
        for c in cands:
            cell_depth[c] -= 1
            cl[c] = rebuild(int(c))
        cgc = group_counts()


def _localize_rows(a: np.ndarray, n_rows: int, demote_rows):
    """Remap an array of global row ids (-1 padded) onto its own row
    shard (tracer_tpu/culling.py:1439). Returns (a_local, ids, local,
    dem_local): ids the sorted unique referenced rows (never empty),
    local the (n_rows,) global->local map, dem_local the demoted rows
    present in the shard in LOCAL ids."""
    ids = np.unique(a[a >= 0]).astype(np.int32)
    if len(ids) == 0:
        ids = np.array([0], dtype=np.int32)
    local = np.full(n_rows, -1, dtype=np.int32)
    local[ids] = np.arange(len(ids), dtype=np.int32)
    a_local = np.where(a >= 0, local[np.maximum(a, 0)],
                       -1).astype(np.int32)
    dem_local = tuple(int(local[r]) for r in demote_rows
                      if local[r] >= 0)
    return a_local, ids, local, dem_local


def mesh_segment_shards(culling: BlockCulling, table, n_dev: int,
                        max_smem_bytes: int = 1 << 20,
                        max_segments: int = 64,
                        force_n_seg: int = 0) -> list:
    """Uniform per-rank segments of the culled block grid for the sharded
    trace (tracer_tpu/culling.py:1461): rank d owns the contiguous block
    range [d*nb/D, (d+1)*nb/D), and every rank runs the same ``n_seg``
    sequential segments over even cuts of its range, each with only the
    candidate columns and the row SHARD that chunk references. Blocks
    never interact, so the decomposition is exact. ``n_seg`` is the
    build's (stats["mesh_n_seg"]) for a build of ``n_dev`` ranks, else the
    fewest, by doubling, whose chunks fit ``max_smem_bytes`` by
    tracer_tpu's budget (smem_need_bytes); ``force_n_seg`` sets it.

    Returns a list of ``n_seg`` dicts with keys:
      blocks        (D*chunk,) int32 global block ids, rank-major
      lists         (D*chunk, W) int32 candidate layout, entries LOCAL
                    to each rank's row shard, per-group columns
      counts        (D*chunk, G) int32
      group_offsets (G,) column offsets for this segment
      row_maps      (D, s_pad) int32 local->global row ids (edge-padded)
      demote_masks  (D, s_pad) bool rank-local demotion masks
    """
    nb = culling.nb
    if nb % n_dev:
        raise ValueError(f"{nb} blocks not divisible by {n_dev} devices")
    nbl = nb // n_dev
    counts = culling.counts
    G = counts.shape[1]
    goff = culling.group_offsets
    n_rows = int(table.ap_params.shape[0])

    def _plan(n_seg):
        """Cuts + per-seg (widths, row shards) if every chunk fits."""
        cuts = [round(i * nbl / n_seg) for i in range(n_seg + 1)]
        if any(b1 - b0 < 1 for b0, b1 in zip(cuts, cuts[1:])):
            return None
        plan = []
        for b0, b1 in zip(cuts, cuts[1:]):
            w_g = np.ones(G, dtype=np.int64)
            shards = []
            for d in range(n_dev):
                lo, hi = d * nbl + b0, d * nbl + b1
                w_g = np.maximum(w_g, counts[lo:hi].max(axis=0))
                a_local, ids, _, dem_local = _localize_rows(
                    culling.lists[lo:hi], n_rows, culling.demote_rows)
                shards.append((a_local, ids, dem_local))
            W = int(w_g.sum())
            s_pad = max(len(x[1]) for x in shards)
            if smem_need_bytes(table, b1 - b0, W,
                               n_rows=s_pad) > max_smem_bytes:
                return None
            plan.append((b0, b1, tuple(int(w) for w in w_g), shards,
                         s_pad))
        return plan

    if force_n_seg:
        plan = _plan(force_n_seg)
        if plan is None:
            raise ValueError(f"forced n_seg={force_n_seg} does not fit "
                             "the per-device SMEM budget")
    else:
        plan = None
        hint = culling.stats.get("mesh_n_seg")
        if hint and culling.mesh_devices == n_dev:
            plan = _plan(int(hint))
        n_seg = 1
        while plan is None and n_seg <= min(max_segments, nbl):
            plan = _plan(n_seg)
            n_seg *= 2
        if plan is None:
            raise ValueError(
                f"culled layout does not fit the per-device SMEM budget "
                f"even split into {min(max_segments, nbl)} sequential "
                f"segments per device; use more devices or a larger "
                "slab (smaller cells)")

    out = []
    for b0, b1, w_g, shards, s_pad in plan:
        off = tuple(int(sum(w_g[:g])) for g in range(G))
        chunk = b1 - b0
        lists_l = np.full((n_dev * chunk, sum(w_g)), -1, dtype=np.int32)
        blocks = np.zeros(n_dev * chunk, dtype=np.int32)
        row_maps = np.stack([np.pad(ids, (0, s_pad - len(ids)),
                                    mode="edge") for _, ids, _ in shards])
        demote_masks = np.zeros((n_dev, s_pad), dtype=bool)
        cnt = np.zeros((n_dev * chunk, G), dtype=np.int32)
        for d, (a_local, _, dem_local) in enumerate(shards):
            demote_masks[d, list(dem_local)] = True
            for j, blk in enumerate(range(d * nbl + b0, d * nbl + b1)):
                row = d * chunk + j
                blocks[row] = blk
                cnt[row] = counts[blk]
                for g in range(G):
                    k = int(counts[blk, g])
                    if k:
                        lists_l[row, off[g]:off[g] + k] = \
                            a_local[j, goff[g]:goff[g] + k]
        out.append(dict(blocks=blocks, lists=lists_l, counts=cnt,
                        group_offsets=off, row_maps=row_maps,
                        demote_masks=demote_masks))
    return out


def device_row_shards(culling: BlockCulling, n_rows: int, n_dev: int):
    """Per-rank row shards of the whole block range of each rank
    (tracer_tpu/culling.py:1579): rank d's blocks [d*nb/D, (d+1)*nb/D)
    reference a subset of the scene rows, so it can ship just that
    subset.

    Returns (lists_local, row_maps, demote_masks):
      lists_local (nb, W) int32 — the global candidate layout with every
          entry remapped to its rank's LOCAL row index;
      row_maps (n_dev, S_pad) int32 — rank d's sorted global row ids,
          edge-padded to the widest shard (padding rows are shipped but
          never referenced);
      demote_masks (n_dev, S_pad) bool — rank-local demotion masks.
    """
    nb = culling.nb
    if nb % n_dev:
        raise ValueError(f"{nb} blocks not divisible by {n_dev} devices")
    per = nb // n_dev
    lists_local = np.full_like(culling.lists, -1)
    outs = []
    for d in range(n_dev):
        sub = culling.lists[d * per:(d + 1) * per]
        a_local, ids, _, dem_local = _localize_rows(
            sub, n_rows, culling.demote_rows)
        lists_local[d * per:(d + 1) * per] = a_local
        outs.append((ids, dem_local))
    s_pad = max(len(ids) for ids, _ in outs)
    row_maps = np.stack([np.pad(ids, (0, s_pad - len(ids)), mode="edge")
                         for ids, _ in outs])
    demote_masks = np.zeros((n_dev, s_pad), dtype=bool)
    for d, (_, dem_local) in enumerate(outs):
        demote_masks[d, list(dem_local)] = True
    return lists_local, row_maps, demote_masks
