"""Vector helpers and the axis-aligned bounding box (the PyTorch port's
NumPy copy of tracer_tpu/vector_utils.py: get_angle(s),
rotate_z_to_normal, project_on_plane, aabb). Row-vector (n, 3)
conventions; :func:`rotate_z_to_normal_t` is the device twin that the
solar simulator's lamps use."""
from __future__ import annotations

import numpy as np
import torch

from .mathutils import apply_rot
from .spatial import rotation_to_z


def get_angle(v1, v2) -> float:
    """Angle between two vectors [rad]."""
    v1 = np.asarray(v1, dtype=float).reshape(-1)
    v2 = np.asarray(v2, dtype=float).reshape(-1)
    c = np.dot(v1, v2) / (np.linalg.norm(v1) * np.linalg.norm(v2))
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


def get_angles(v1s, v2s) -> np.ndarray:
    """Pairwise angles between rows of two (n,3) arrays."""
    v1s = np.asarray(v1s, dtype=float)
    v2s = np.asarray(v2s, dtype=float)
    c = np.sum(v1s * v2s, axis=-1) / (
        np.linalg.norm(v1s, axis=-1) * np.linalg.norm(v2s, axis=-1))
    return np.arccos(np.clip(c, -1.0, 1.0))


def rotate_z_to_normal(vecs, normals) -> np.ndarray:
    """Rotate vectors sampled about +Z into the frame(s) whose Z is
    ``normals``. vecs (n,3); normals (3,) or (n,3)."""
    vecs = np.atleast_2d(np.asarray(vecs, dtype=float))
    normals = np.asarray(normals, dtype=float)
    M = rotation_to_z(normals)
    if M.ndim == 2:
        return vecs @ M.T
    return np.einsum("nij,nj->ni", M, vecs)


def rotate_z_to_normal_t(vecs: torch.Tensor, normal) -> torch.Tensor:
    """:func:`rotate_z_to_normal` of (n, 3) tensors about one ``normal``
    (3,), on their device: the frame made on the host in float64, the
    rotation written out elementwise (mathutils.apply_rot)."""
    M = torch.as_tensor(rotation_to_z(np.asarray(normal, dtype=float)),
                        dtype=vecs.dtype, device=vecs.device)
    return apply_rot(M, vecs)


def project_on_plane(points, normal, plane_point=None) -> np.ndarray:
    """Orthogonal projection of (n,3) points onto the plane through
    ``plane_point`` with unit ``normal``."""
    points = np.atleast_2d(np.asarray(points, dtype=float))
    normal = np.asarray(normal, dtype=float).reshape(3)
    normal = normal / np.linalg.norm(normal)
    if plane_point is None:
        plane_point = np.zeros(3)
    d = (points - plane_point) @ normal
    return points - d[:, None] * normal


def aabb(points) -> np.ndarray:
    """Axis-aligned bounding box of (n,3) points: rows [min, max] (2,3)."""
    points = np.atleast_2d(np.asarray(points, dtype=float))
    return np.stack([points.min(axis=0), points.max(axis=0)])


AABB = aabb
