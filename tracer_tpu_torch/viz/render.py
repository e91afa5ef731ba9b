"""3D scene and ray-path rendering (the PyTorch port of
tracer_tpu/viz/render.py): surface meshes by geometry kind (``mesh_of``,
which the culling analysis needs too), meshes whose quads are a flux
map's cells (``mesh_from_edges``), the matplotlib ``Renderer`` and a text
``scene_tree``. matplotlib is imported inside ``Renderer`` only, so the
package imports without it."""
from __future__ import annotations

import numpy as np

from ..geometry import Geometry


def _np(x) -> np.ndarray:
    """A tensor (or array) as a host NumPy array."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else \
        np.asarray(x)


def mesh_of(geom: Geometry, resolution: int = 20):
    """Local-frame mesh (x, y, z 2D arrays) for a geometry, by kind —
    mirrors the reference GMs' mesh() methods (e.g. flat_surface.py:213,
    paraboloid.py:121, cylinder.py:113, sphere_surface.py:72)."""
    e = geom.extent
    k = geom.kind
    if k in ("rect", "extruded_rect", "perforated_rect", "rect_flat_quadric",
             "rect_parabolic_dish", "parabolic_trough"):
        w, h = e.get("w", 1.0), e.get("h", e.get("L", 1.0))
        xs = np.linspace(-w / 2, w / 2, resolution + 1)
        ys = np.linspace(-h / 2, h / 2, resolution + 1)
        x, y = np.meshgrid(xs, ys, indexing="ij")
        if k == "rect_parabolic_dish":
            z = e["qa"] * (x**2 + y**2)
        elif k == "parabolic_trough":
            z = e["qa"] * x**2
        elif k == "rect_flat_quadric":
            z = (e["a"] * x**2 + e["b"] * y**2 + e["c"] * x * y
                 + e["d"] * x + e["e"] * y + e["f"])
        else:
            z = np.zeros_like(x)
        return x, y, z
    if k in ("round", "cut_round", "parabolic_dish", "hex_parabolic_dish"):
        R = e.get("re", e.get("R", 1.0))
        ri = e.get("ri", 0.0) or 0.0
        rs = np.linspace(ri, R, resolution + 1)
        angs = np.linspace(0.0, 2 * np.pi, resolution + 1)
        x = np.outer(rs, np.cos(angs))
        y = np.outer(rs, np.sin(angs))
        if k in ("parabolic_dish", "hex_parabolic_dish"):
            qa = e.get("qa", 1.0 / (4.0 * e.get("focal", 1.0)))
            z = qa * (x**2 + y**2)
        else:
            z = np.zeros_like(x)
        return x, y, z
    if k in ("finite_cylinder", "rect_cut_cylinder", "cylinder"):
        R, h = e["R"], e.get("h", 1.0)
        a0, a1 = e.get("ang_range", (0.0, 2 * np.pi))
        hs = np.linspace(-h / 2, h / 2, resolution + 1)
        angs = np.linspace(a0, a1, resolution + 1)
        x = np.tile(R * np.cos(angs), (len(hs), 1))
        y = np.tile(R * np.sin(angs), (len(hs), 1))
        z = np.tile(hs[:, None], (1, len(angs)))
        return x, y, z
    if k in ("sphere", "hemisphere", "cut_sphere", "spherical_rect_facet"):
        R = e["R"]
        th0 = np.pi / 2 if k == "hemisphere" else 0.0
        th = np.linspace(th0, np.pi, resolution + 1)[:, None]
        ph = np.linspace(0.0, 2 * np.pi, resolution + 1)[None, :]
        return (R * np.sin(th) * np.cos(ph), R * np.sin(th) * np.sin(ph),
                np.broadcast_to(R * np.cos(th), (len(th), ph.shape[1])).copy())
    if k in ("conical_frustum", "finite_cone", "rect_cut_cone", "cone",
             "rect_cut_conical_frustum"):
        # rect_cut_cone's extent stores (r, h) instead of the gradient c
        c = e["c"] if "c" in e else e["r"] / e["h"]
        a = e.get("a", 0.0)
        if "z1" in e:
            z0, z1 = sorted((e["z1"], e["z2"]))
        else:
            z0, z1 = 0.0, e.get("h", 1.0)
        zs = np.linspace(z0, z1, resolution + 1)
        angs = np.linspace(0.0, 2 * np.pi, resolution + 1)
        r = np.abs(c * (zs - a))
        x = np.outer(r, np.cos(angs))
        y = np.outer(r, np.sin(angs))
        z = np.tile(zs[:, None], (1, len(angs)))
        return x, y, z
    if k == "ellipsoid":
        a, b, cc = e["a"], e["b"], e["c"]
        th = np.linspace(0.0, np.pi, resolution + 1)[:, None]
        ph = np.linspace(0.0, 2 * np.pi, resolution + 1)[None, :]
        return (a * np.sin(th) * np.cos(ph), b * np.sin(th) * np.sin(ph),
                np.broadcast_to(cc * np.cos(th), (len(th), ph.shape[1])).copy())
    if k == "triangle":
        v = e["verts"]
        x = np.array([[v[0, 0], v[1, 0]], [v[2, 0], v[2, 0]]])
        y = np.array([[v[0, 1], v[1, 1]], [v[2, 1], v[2, 1]]])
        return x, y, np.zeros_like(x)
    # fallback: small plate
    xs = np.linspace(-0.5, 0.5, 2)
    x, y = np.meshgrid(xs, xs, indexing="ij")
    return x, y, np.zeros_like(x)


def mesh_from_edges(kind: str, extent: dict, ue, ve):
    """Local-frame mesh whose quads are EXACTLY the flux-map cells of
    analysis/fluxmap.edges_of: (nu+1, nv+1) x/y/z grids, so a (nu, nv)
    flux map colormaps directly onto the geometry (the reference textures
    fluxmaps onto Coin3D quad meshes the same way, surface.py:146-252)."""
    from ..analysis.fluxmap import _AXIAL, _CARTESIAN, _POLAR, _SPHERICAL
    ue = np.asarray(ue, dtype=float)
    ve = np.asarray(ve, dtype=float)
    if kind in _CARTESIAN:
        x, y = np.meshgrid(ue, ve, indexing="ij")
        return x, y, np.zeros_like(x)
    if kind in _POLAR:
        r, th = np.meshgrid(ue, ve, indexing="ij")
        x, y = r * np.cos(th), r * np.sin(th)
        z = (extent["qa"] * (x**2 + y**2) if kind == "parabolic_dish"
             else np.zeros_like(x))
        return x, y, z
    if kind in _AXIAL:
        z, th = np.meshgrid(ue, ve, indexing="ij")
        if kind == "conical_frustum":
            r = np.abs(extent["c"] * (z - extent["a"]))
        else:
            r = np.full_like(z, extent["R"])
        return r * np.cos(th), r * np.sin(th), z
    if kind in _SPHERICAL:
        th, ph = np.meshgrid(ue, ve, indexing="ij")
        R = extent["R"]
        return (R * np.sin(th) * np.cos(ph), R * np.sin(th) * np.sin(ph),
                R * np.cos(th))
    raise NotImplementedError(f"no flux mesh for geometry kind {kind}")


class Renderer:
    """Render the scene's surfaces and (optionally) traced ray paths on
    matplotlib, which is imported here and nowhere else in the package.

    Usage:
        r = Renderer(engine)           # engine or (table, meta)
        r.show_geom()                  # surface meshes
        r.show_geom(fluxmap_from=result)   # + fluxmap-textured receivers
        r.show_rays(result, max_rays=100)
        r.save("scene.png")            # or r.show()
    """

    def __init__(self, engine):
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt  # noqa
        self._plt = plt
        # accept a TracerEngine or a (table, meta) pair (documented API)
        self.meta = engine[1] if isinstance(engine, tuple) else engine.meta
        self.fig = plt.figure(figsize=(9, 8))
        self.ax = self.fig.add_subplot(111, projection="3d")

    def show_geom(self, resolution: int = 20, alpha: float = 0.5,
                  fluxmap_from=None, fluxmaps=None,
                  flux_resolution: int = 40, cmap: str = "inferno",
                  colorbar: bool = True) -> None:
        """Draw all surface meshes; surfaces with a flux map are textured
        with it (the reference's fluxmap colormapping,
        tracer/surface.py:146-252 + CoIn_rendering/rendering.py:85-124).

        fluxmap_from - a TraceResult with records: every surface with
            recorded hits gets a flux texture (analysis.fluxmap).
        fluxmaps - dict {surface name: (flux, (ue, ve))} of precomputed
            maps, e.g. from device histograms via device_fluxmap.finalize;
            takes precedence over fluxmap_from for the named surfaces.
        """
        from matplotlib import cm, colors as mcolors

        maps = dict(fluxmaps or {})
        if fluxmap_from is not None:
            from ..analysis.fluxmap import surface_fluxmap
            for i, surf in enumerate(self.meta.surfaces):
                name = self.meta.names[i]
                if name in maps:
                    continue
                try:
                    flux, edges = surface_fluxmap(fluxmap_from, i,
                                                  flux_resolution)
                except NotImplementedError:
                    continue
                if np.any(flux > 0):
                    maps[name] = (flux, edges)

        vmax = max((float(np.max(f)) for f, _ in maps.values()),
                   default=0.0)
        norm = mcolors.Normalize(vmin=0.0, vmax=vmax or 1.0)
        import matplotlib
        cmap_f = matplotlib.colormaps[cmap]

        # iterate TABLE ROWS: compile_scene sorts rows by (aperture
        # signature, quadric class), so meta.surfaces iteration order is
        # NOT row order — pairing meshes with frames positionally through
        # the surface list would draw geometries at the wrong transforms
        frames = self.meta.frames
        for row in range(len(frames)):
            lid = int(self.meta.row_logical[row])
            surf = self.meta.surfaces[lid]
            color = surf.fixed_color
            fm = maps.get(self.meta.names[lid])
            for g in (self.meta.row_geoms[row],):
                frame = frames[row]
                use_fm = fm     # per-geometry: a kind unsupported by the
                # flux mesh must not disable the texture for later
                # geometries of the same surface
                if use_fm is not None:
                    flux, (ue, ve) = use_fm
                    try:
                        x, y, z = mesh_from_edges(g.kind, g.extent, ue, ve)
                    except NotImplementedError:
                        x, y, z = mesh_of(g, resolution)
                        use_fm = None
                else:
                    x, y, z = mesh_of(g, resolution)
                pts = np.stack([x, y, z], axis=-1) @ frame[:3, :3].T \
                    + frame[:3, 3]
                if use_fm is not None:
                    face = cmap_f(norm(np.asarray(use_fm[0], dtype=float)))
                    self.ax.plot_surface(
                        pts[..., 0], pts[..., 1], pts[..., 2],
                        facecolors=face, shade=False, linewidth=0,
                        antialiased=False)
                else:
                    self.ax.plot_surface(
                        pts[..., 0], pts[..., 1], pts[..., 2],
                        alpha=alpha, color=color,
                        linewidth=0, antialiased=False)
        if maps and colorbar:
            sm = cm.ScalarMappable(norm=norm, cmap=cmap_f)
            sm.set_array([])
            self.fig.colorbar(sm, ax=self.ax, shrink=0.6, pad=0.08,
                              label="flux [W/m$^2$]")

    def show_rays(self, result, max_rays: int = 100,
                  color: str = "orange") -> None:
        """Draw ray polylines from a TraceResult's per-bounce records
        (replacing the reference's RayTree parent walk, rendering.py:126)."""
        if not result.records:
            return
        if any(rec.slot is not None for rec in result.records):
            raise ValueError("show_rays draws full per-bounce records; "
                             "this trace recorded tagged hits only")
        n = result.records[0].sid.shape[0]
        sel = np.linspace(0, n - 1, min(max_rays, n)).astype(int)
        src_pos = _np(result.source.pos)[sel]
        pts = [src_pos]
        alive = [_np(result.records[0].alive_in)[sel]]
        for rec in result.records:
            pts.append(_np(rec.hit)[sel])
            alive.append(_np(rec.alive_in)[sel] & (_np(rec.sid)[sel] >= 0))
        for i in range(len(sel)):
            path = [pts[0][i]]
            for b in range(len(result.records)):
                if not alive[b + 1][i]:
                    break
                path.append(pts[b + 1][i])
            if len(path) > 1:
                path = np.asarray(path)
                self.ax.plot(path[:, 0], path[:, 1], path[:, 2],
                             color=color, linewidth=0.6, alpha=0.7)

    def show(self) -> None:
        self._plt.show()

    def save(self, path: str, dpi: int = 130) -> None:
        self.ax.set_box_aspect((1, 1, 1))
        self.fig.savefig(path, dpi=dpi, bbox_inches="tight")


def scene_tree(assembly, indent: int = 0) -> str:
    """Text rendering of the assembly tree."""
    pad = "  " * indent
    lines = [f"{pad}Assembly @ {assembly.get_location().round(3).tolist()}"]
    for obj in assembly.objects:
        lines.append(f"{pad}  Object @ "
                     f"{obj.get_location().round(3).tolist()}")
        for s in obj.surfaces:
            geoms = ", ".join(g.kind for g in s.geometries[:4])
            more = "..." if len(s.geometries) > 4 else ""
            lines.append(f"{pad}    Surface '{s.name or '?'}' "
                         f"[{geoms}{more}] optics kind={s.optics.kind}")
    for sub in assembly.assemblies:
        lines.append(scene_tree(sub, indent + 1))
    return "\n".join(lines)
