"""STL mesh IO and parametric mesh generators (the PyTorch port's NumPy
copy of tracer_tpu/stl_utils.py): cylinder, disc and rectangle vertex /
face generators, binary and ASCII STL read, binary STL write, and the
mesh -> scene helpers, whose triangles are the port's
geometry.triangle3d rows (one logical surface a mesh)."""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np


# --- parametric generators ---------------------------------------------------

def cylinder_verts_faces(radius: float, length: float, angbins: int = 24,
                         lbins: int = 10, capped: bool = False):
    """Cylinder wall (optionally capped) as (verts (n,3), faces (m,3))."""
    thetas = np.linspace(0.0, 2.0 * np.pi, angbins, endpoint=False)
    ls = np.linspace(-length / 2.0, length / 2.0, lbins + 1)
    verts = []
    faces = []
    if capped:
        # bottom cap winds clockwise seen from +z => outward (-z) normal,
        # consistent with the outward-facing wall quads below
        verts.append((0.0, 0.0, ls[0]))
        for th in thetas:
            verts.append((radius * np.cos(th), radius * np.sin(th), ls[0]))
        for i in range(angbins):
            faces.append((0, 1 + (i + 1) % angbins, 1 + i))
    base = len(verts)
    for z in ls:
        for th in thetas:
            verts.append((radius * np.cos(th), radius * np.sin(th), z))
    for i in range(lbins):
        for j in range(angbins):
            a = base + i * angbins + j
            b = base + i * angbins + (j + 1) % angbins
            c = base + (i + 1) * angbins + j
            d = base + (i + 1) * angbins + (j + 1) % angbins
            faces.append((a, b, c))
            faces.append((b, d, c))
    if capped:
        # top cap winds counterclockwise seen from +z => outward (+z)
        top0 = len(verts)
        verts.append((0.0, 0.0, ls[-1]))
        for th in thetas:
            verts.append((radius * np.cos(th), radius * np.sin(th), ls[-1]))
        for i in range(angbins):
            faces.append((top0, top0 + 1 + i, top0 + 1 + (i + 1) % angbins))
    return np.asarray(verts), np.asarray(faces, dtype=int)


def disc_verts_faces(radius: float, angbins: int = 24, rbins: int = 5,
                     r_int: float = 0.0):
    """Flat disc / annulus triangulation in the z=0 plane."""
    thetas = np.linspace(0.0, 2.0 * np.pi, angbins, endpoint=False)
    rs = np.linspace(r_int, radius, rbins + 1)
    verts = []
    faces = []
    if r_int == 0.0:
        verts.append((0.0, 0.0, 0.0))
        rs = rs[1:]
        for th in thetas:
            verts.append((rs[0] * np.cos(th), rs[0] * np.sin(th), 0.0))
        for i in range(angbins):
            faces.append((0, 1 + i, 1 + (i + 1) % angbins))
        base_rings = len(rs)
        start = 1
    else:
        base_rings = len(rs)
        start = 0
        for th in thetas:
            verts.append((rs[0] * np.cos(th), rs[0] * np.sin(th), 0.0))
    for k in range(1, base_rings):
        for th in thetas:
            verts.append((rs[k] * np.cos(th), rs[k] * np.sin(th), 0.0))
        for j in range(angbins):
            a = start + (k - 1) * angbins + j
            b = start + (k - 1) * angbins + (j + 1) % angbins
            c = start + k * angbins + j
            d = start + k * angbins + (j + 1) % angbins
            # counterclockwise seen from +z, matching the center fan
            faces.append((a, c, b))
            faces.append((b, c, d))
    return np.asarray(verts), np.asarray(faces, dtype=int)


def rectangle_verts_faces(lx: float, ly: float, nx: int = 4, ny: int = 4):
    """Rectangular plate triangulation in the z=0 plane."""
    xs = np.linspace(-lx / 2.0, lx / 2.0, nx + 1)
    ys = np.linspace(-ly / 2.0, ly / 2.0, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    verts = np.stack([X.ravel(), Y.ravel(), np.zeros(X.size)], axis=1)
    faces = []
    for i in range(nx):
        for j in range(ny):
            a = i * (ny + 1) + j
            b = a + 1
            c = a + (ny + 1)
            d = c + 1
            faces.append((a, c, b))
            faces.append((b, c, d))
    return verts, np.asarray(faces, dtype=int)


# --- STL IO ------------------------------------------------------------------

def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an STL file (binary or ASCII). Returns (verts (n,3),
    faces (m,3) int) with shared vertices merged."""
    with open(path, "rb") as f:
        head = f.read(80)
        rest = f.read()
    is_ascii = head[:5] == b"solid" and b"facet" in rest[:1000]
    tris = []
    if is_ascii:
        text = (head + rest).decode("ascii", errors="ignore")
        cur = []
        for line in text.splitlines():
            parts = line.split()
            if parts[:1] == ["vertex"]:
                cur.append([float(x) for x in parts[1:4]])
                if len(cur) == 3:
                    tris.append(cur)
                    cur = []
    else:
        (n_tri,) = struct.unpack("<I", rest[:4])
        data = np.frombuffer(rest[4:4 + n_tri * 50], dtype=np.uint8)
        data = data.reshape(n_tri, 50)
        floats = data[:, :48].copy().view("<f4").reshape(n_tri, 12)
        tris = floats[:, 3:12].reshape(n_tri, 3, 3)
    tris = np.asarray(tris, dtype=float)
    flat = tris.reshape(-1, 3)
    verts, inverse = np.unique(flat.round(9), axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3)
    return verts, faces


def make_stl(path: str, verts, faces) -> None:
    """Write a binary STL file from (verts, faces)."""
    verts = np.asarray(verts, dtype=np.float32)
    faces = np.asarray(faces, dtype=int)
    tris = verts[faces]  # (m,3,3)
    e1 = tris[:, 1] - tris[:, 0]
    e2 = tris[:, 2] - tris[:, 0]
    nrm = np.cross(e1, e2)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = np.where(ln > 0, nrm / np.maximum(ln, 1e-300), 0.0)
    with open(path, "wb") as f:
        f.write(b"tracer_tpu binary stl".ljust(80, b"\0"))
        f.write(struct.pack("<I", len(faces)))
        rec = np.zeros((len(faces), 50), dtype=np.uint8)
        block = np.concatenate(
            [nrm.astype("<f4"), tris.reshape(len(faces), 9).astype("<f4")],
            axis=1)
        rec[:, :48] = block.view(np.uint8).reshape(len(faces), 48)
        f.write(rec.tobytes())


# --- mesh -> scene -----------------------------------------------------------

def stl_to_geometries(verts, faces):
    """Triangle Geometries (with per-face frames) from a vertex/face mesh
    (ref stl_to_tracer_geom :178)."""
    from .geometry import triangle3d
    verts = np.asarray(verts, dtype=float)
    return [triangle3d(*verts[list(f)]) for f in np.asarray(faces, dtype=int)]


def make_stl_tracer_object(verts, faces, optics, name: str = "stl"):
    """AssembledObject with one logical surface holding all mesh faces
    (ref make_stl_tracer_object :213)."""
    from .scene import AssembledObject, Surface
    surf = Surface(stl_to_geometries(verts, faces), optics, name=name)
    return AssembledObject(surfs=[surf])


def load_stl_into_tracer(path: str, optics, name: Optional[str] = None):
    """Load an STL file straight into a traceable object
    (ref load_stl_into_tracer :229)."""
    verts, faces = load_stl(path)
    return make_stl_tracer_object(verts, faces, optics,
                                  name=name or path.rsplit("/", 1)[-1])
