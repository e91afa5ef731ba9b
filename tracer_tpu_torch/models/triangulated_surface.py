"""Triangulated-mesh object (the PyTorch port of
tracer_tpu/models/triangulated_surface.py): a vertex/face mesh becomes one
logical surface whose rows are triangle geometries with per-face frames
(geometry.triangle3d)."""
from __future__ import annotations

import numpy as np

from ..geometry import triangle3d
from ..scene import AssembledObject, Surface


class TriangulatedSurface(AssembledObject):
    def __init__(self, vertices, faces, optics, transform=None,
                 name: str = "triangulated"):
        """vertices - (n,3) array; faces - (m,3) int array of vertex
        indices; optics - OpticsSpec shared by all faces (pass a list of
        Surfaces yourself for per-face optics)."""
        vertices = np.asarray(vertices, dtype=float)
        faces = np.asarray(faces, dtype=int)
        geoms = [triangle3d(*vertices[list(f)]) for f in faces]
        surf = Surface(geoms, optics, name=name)
        AssembledObject.__init__(self, surfs=[surf], transform=transform)
        self.mesh = (vertices, faces)
