"""Kd-tree spatial acceleration over the scene rows: SAH build and
vectorized traversal (the PyTorch port's NumPy copy of
tracer_tpu/accel.py).

The tree is built and traversed on the host. TracerEngine.ray_tracer(
accel="lightweight") traverses it once a bounce for per-ray candidate
rows, which kernels.intersect.nearest_hit_candidates then tests alone;
culling.build_block_culling reads the row helpers. Traversal is
breadth-first over the node list, every node's slab test on all its
rays at once, returning the (n_rows, n_rays) relevancy mask. Per-row
AABBs come from each geometry's mesh points pushed through its frame.
Rows of UNBOUNDED_KINDS have no finite extent and are always relevant.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np


# geometry kinds with no finite extent: their "mesh" is a token patch for
# rendering, so NO bounding volume derived from it is sound — the Kd-tree
# treats their rows as always relevant (the reference does the same for
# objects without boundaries, accel_tree.py:59-73) and
# culling.build_block_culling refuses them
UNBOUNDED_KINDS = frozenset({"flat", "paraboloid", "flat_quadric",
                             "parabolic_cylinder", "cylinder", "cone"})


def row_aabbs(meta, resolution: int = 8, pad: float = 1e-9) -> np.ndarray:
    """(S, 2, 3) world AABBs of every scene-table row, from meshed surface
    points. Rows whose kind is in UNBOUNDED_KINDS get token boxes, which
    consumers must special-case (KdTree marks them always relevant)."""
    boxes = []
    for g, frame in zip(_row_geometries(meta), meta.frames):
        pts = _row_points(g, frame, resolution)
        lo = pts.min(axis=0) - pad
        hi = pts.max(axis=0) + pad
        boxes.append(np.stack([lo, hi]))
    return np.stack(boxes)


def _row_geometries(meta) -> list:
    """Per-row geometry handles in TABLE ORDER. compile_scene sorts rows by
    aperture signature, so iterating meta.surfaces does NOT give row order;
    use the recorded row_geoms (older pickled metas fall back to the
    iteration order, correct only for single-group scenes)."""
    if getattr(meta, "row_geoms", None) is not None:
        return meta.row_geoms
    return [g for surf in meta.surfaces for g in surf.geometries]


def _row_points(g, frame, resolution: int = 8) -> np.ndarray:
    """World-space sample points of one row's surface patch."""
    from .viz.render import mesh_of
    x, y, z = mesh_of(g, resolution)
    pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    return pts @ frame[:3, :3].T + frame[:3, 3]


class Node:
    __slots__ = ("bounds", "axis", "split", "left", "right", "rows", "leaf")

    def __init__(self, bounds):
        self.bounds = bounds
        self.leaf = True
        self.rows: List[int] = []
        self.axis = -1
        self.split = 0.0
        self.left: Optional[int] = None
        self.right: Optional[int] = None


class KdTree:
    """SAH Kd-tree over scene rows.

    Build parameters mirror the reference (accel_tree.py:20-41): traversal
    cost t_trav, intersection cost t_isec, empty bonus, max depth default
    8 + 1.3 ln(n). 'fast' caps candidate splits per axis at 12
    (accel_tree.py:83-86).
    """

    def __init__(self, meta, max_depth: Optional[int] = None,
                 t_trav: float = 1.0, t_isec: float = 4.0,
                 empty_bonus: float = 0.2, fast: bool = True,
                 min_leaf: int = 2):
        self.boxes = row_aabbs(meta)
        n = len(self.boxes)
        # rows with no finite extent cannot be bounded: they are ALWAYS
        # relevant (ref accel_tree.py:59-73 for boundary-less objects)
        # and stay out of the tree so their token boxes don't skew it
        self.always_relevant = [
            i for i, g in enumerate(_row_geometries(meta))
            if g.kind in UNBOUNDED_KINDS]
        bounded = [i for i in range(n) if i not in set(self.always_relevant)]
        self.max_depth = max_depth or int(8 + 1.3 * math.log(max(n, 2)))
        self.t_trav, self.t_isec = t_trav, t_isec
        self.empty_bonus = empty_bonus
        self.fast = fast
        self.min_leaf = min_leaf
        self.nodes: List[Node] = []
        if bounded:
            bb = self.boxes[bounded]
            root_bounds = np.stack([bb[:, 0].min(axis=0),
                                    bb[:, 1].max(axis=0)])
        else:
            root_bounds = np.stack([np.full(3, -1.0), np.full(3, 1.0)])
        self._build(root_bounds, bounded, 0)

    # -- SAH build ------------------------------------------------------------
    def _build(self, bounds, rows, depth) -> int:
        idx = len(self.nodes)
        node = Node(bounds)
        node.rows = rows
        self.nodes.append(node)
        if len(rows) <= self.min_leaf or depth >= self.max_depth:
            return idx
        best = self._determine_split(bounds, rows)
        if best is None:
            return idx
        axis, split, left_rows, right_rows = best
        node.leaf = False
        node.axis, node.split = axis, split
        lb = bounds.copy()
        lb[1, axis] = split
        rb = bounds.copy()
        rb[0, axis] = split
        node.left = self._build(lb, left_rows, depth + 1)
        node.right = self._build(rb, right_rows, depth + 1)
        return idx

    def _determine_split(self, bounds, rows):
        """PBRT-style SAH split selection (ref determine_split :149)."""
        rows_arr = np.asarray(rows)
        lo = self.boxes[rows_arr, 0]
        hi = self.boxes[rows_arr, 1]
        ext = bounds[1] - bounds[0]
        total_sa = 2 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
        if total_sa <= 0:
            return None
        leaf_cost = self.t_isec * len(rows)
        best = None
        best_cost = leaf_cost
        for axis in range(3):
            cands = np.unique(np.concatenate([lo[:, axis], hi[:, axis]]))
            cands = cands[(cands > bounds[0, axis])
                          & (cands < bounds[1, axis])]
            if self.fast and len(cands) > 12:
                cands = cands[np.linspace(0, len(cands) - 1, 12).astype(int)]
            for split in cands:
                nl = (lo[:, axis] < split).sum()
                nr = (hi[:, axis] > split).sum()
                e0, e1 = ext[(axis + 1) % 3], ext[(axis + 2) % 3]
                sa_l = 2 * (e0 * e1 + (split - bounds[0, axis]) * (e0 + e1))
                sa_r = 2 * (e0 * e1 + (bounds[1, axis] - split) * (e0 + e1))
                bonus = self.empty_bonus if (nl == 0 or nr == 0) else 0.0
                cost = (self.t_trav + (1.0 - bonus) * self.t_isec
                        * (sa_l / total_sa * nl + sa_r / total_sa * nr))
                if cost < best_cost:
                    left = rows_arr[lo[:, axis] < split].tolist()
                    right = rows_arr[hi[:, axis] > split].tolist()
                    best = (axis, float(split), left, right)
                    best_cost = cost
        return best

    # -- traversal --------------------------------------------------------------
    @staticmethod
    def intersect_bounds(bounds, pos, dirs) -> np.ndarray:
        """Vectorized slab test: which rays hit the AABB
        (ref intersect_bounds :314)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            inv = 1.0 / dirs
            t0 = (bounds[0] - pos) * inv
            t1 = (bounds[1] - pos) * inv
        # 0 * inf -> NaN when a ray origin sits EXACTLY on a slab plane
        # with the matching direction component 0; the limit is "inside
        # that slab, unconstrained" — a propagated NaN would compare
        # False and wrongly cull a ray that passes through the box
        t0 = np.nan_to_num(t0, nan=-np.inf)
        t1 = np.nan_to_num(t1, nan=np.inf)
        tmin = np.minimum(t0, t1).max(axis=1)
        tmax = np.maximum(t0, t1).min(axis=1)
        return (tmax >= np.maximum(tmin, 0.0))

    def traversal(self, pos, dirs) -> np.ndarray:
        """(n_rows, n_rays) bool relevancy mask: which surfaces each ray
        might hit (ref traversal :213, vectorized breadth-first instead of
        a per-ray Python stack walk)."""
        pos = np.asarray(pos, dtype=float)
        dirs = np.asarray(dirs, dtype=float)
        n_rays = len(pos)
        n_rows = len(self.boxes)
        mask = np.zeros((n_rows, n_rays), dtype=bool)
        for r in self.always_relevant:
            mask[r, :] = True
        stack: List[Tuple[int, np.ndarray]] = [
            (0, np.arange(n_rays))]
        while stack:
            node_idx, rays = stack.pop()
            node = self.nodes[node_idx]
            hit = self.intersect_bounds(node.bounds, pos[rays], dirs[rays])
            rays = rays[hit]
            if len(rays) == 0:
                continue
            if node.leaf:
                for r in node.rows:
                    mask[r, rays] = True
            else:
                stack.append((node.left, rays))
                stack.append((node.right, rays))
        return mask

    def surfaces_for_rays(self, pos, dirs) -> list:
        """Per-ray candidate row lists ('lightweight' mode analog,
        accel_tree.py traversal lightweight variant)."""
        mask = self.traversal(pos, dirs)
        return [np.nonzero(mask[:, i])[0] for i in range(mask.shape[1])]
