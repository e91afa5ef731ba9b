"""Flux maps per geometry kind (the PyTorch port's NumPy copy of
tracer_tpu/analysis/fluxmap.py): each kind projects local hit points to
(u, v) (``uv_project``), bins them on uniform edges (``edges_of``) and
divides by exact cell areas (``areas_of``). The device flux map
(device_fluxmap.py) takes the edges and areas; :func:`fluxmap` and
:func:`surface_fluxmap` bin a trace's records on the host.

The paraboloid's cell areas include the 1 / (12 a^2) factor of the exact
integral, as tracer_tpu's do (the reference omits it)."""
from __future__ import annotations

import numpy as np


def _polar_angles(x, y):
    a = np.arctan2(y, x)
    return np.where(a < 0.0, a + 2.0 * np.pi, a)


# kinds binned directly in local cartesian (x, y)
_CARTESIAN = ("rect", "extruded_rect", "perforated_rect")
# kinds binned in polar (r, theta) on the local XY plane
_POLAR = ("round", "cut_round", "parabolic_dish")
# kinds binned in (z, theta) — cylinders and frusta
_AXIAL = ("finite_cylinder", "rect_cut_cylinder", "conical_frustum")
# kinds binned in spherical (theta, phi); need R for the z -> theta map
_SPHERICAL = ("sphere", "hemisphere", "spherical_rect_facet")


def uv_project(kind: str, extent: dict, local):
    """The kind's 2-D binning coordinates of local hit points (n, 3)."""
    x, y, z = local[:, 0], local[:, 1], local[:, 2]
    if kind in _CARTESIAN:
        return x, y
    if kind in _POLAR:
        return np.hypot(x, y), _polar_angles(x, y)
    if kind in _AXIAL:
        return z, _polar_angles(x, y)
    if kind in _SPHERICAL:
        return (np.arccos(np.clip(z / extent["R"], -1.0, 1.0)),
                _polar_angles(x, y))
    raise NotImplementedError(f"no fluxmap for geometry kind {kind}")


def edges_of(kind: str, extent: dict, resolution: int):
    """Uniform (u_edges, v_edges) for the kind's natural mesh."""
    if kind in _CARTESIAN:
        w, h = extent["w"], extent["h"]
        return (np.linspace(-w / 2, w / 2, resolution + 1),
                np.linspace(-h / 2, h / 2, resolution + 1))
    if kind == "round":
        re_, ri = extent["re"], extent.get("ri", 0.0) or 0.0
        return (np.linspace(ri, re_, resolution + 1),
                np.linspace(0.0, 2.0 * np.pi, resolution + 1))
    if kind == "cut_round":
        return (np.linspace(0.0, extent["re"], resolution + 1),
                np.linspace(0.0, 2.0 * np.pi, resolution + 1))
    if kind == "parabolic_dish":
        return (np.linspace(0.0, extent["R"], resolution + 1),
                np.linspace(0.0, 2.0 * np.pi, resolution + 1))
    if kind in ("finite_cylinder", "rect_cut_cylinder"):
        h = extent["h"]
        a0, a1 = extent.get("ang_range", (0.0, 2.0 * np.pi))
        return (np.linspace(-h / 2, h / 2, resolution + 1),
                np.linspace(a0, a1, resolution + 1))
    if kind == "conical_frustum":
        z1, z2 = sorted((extent["z1"], extent["z2"]))
        return (np.linspace(z1, z2, resolution + 1),
                np.linspace(0.0, 2.0 * np.pi, resolution + 1))
    if kind in _SPHERICAL:
        return (np.linspace(0.0, np.pi, resolution + 1),
                np.linspace(0.0, 2.0 * np.pi, 2 * resolution + 1))
    raise NotImplementedError(f"no fluxmap for geometry kind {kind}")


def areas_of(kind: str, extent: dict, resolution: int) -> np.ndarray:
    """Exact cell areas on the (edges_of) mesh, shape (nu, nv)."""
    ue, ve = edges_of(kind, extent, resolution)
    if kind == "rect":
        return np.outer(np.diff(ue), np.diff(ve))
    if kind == "extruded_rect":
        # rectangle minus a rectangular hole (ref flat_surface.py:265-355
        # does an exact 4-piece map; equivalent here: exact rect-rect
        # overlap subtracted per cell)
        cx, cy = extent["cx"], extent["cy"]
        hw, hh = extent["ew"] / 2.0, extent["eh"] / 2.0
        full = np.outer(np.diff(ue), np.diff(ve))
        ox = (np.minimum(ue[1:], cx + hw) - np.maximum(ue[:-1], cx - hw))
        oy = (np.minimum(ve[1:], cy + hh) - np.maximum(ve[:-1], cy - hh))
        hole = np.outer(np.clip(ox, 0.0, None), np.clip(oy, 0.0, None))
        return full - hole
    if kind == "perforated_rect":
        # rectangle minus circular holes: per-cell circle overlap by
        # sub-sampling (exact to ~1e-3 of a cell, same approach as the
        # chord-clipped cut disc; ref flat_surface.py:357-455 bins the
        # full cells)
        full = np.outer(np.diff(ue), np.diff(ve))
        holes = np.asarray(extent.get("holes", ()), dtype=float)
        if len(holes) == 0:
            return full
        frac = _cell_fraction_outside(
            ue, ve,
            lambda X, Y: ~np.any(
                (X[..., None] - holes[None, None, :, 0]) ** 2
                + (Y[..., None] - holes[None, None, :, 1]) ** 2
                <= holes[None, None, :, 2] ** 2, axis=-1))
        return full * frac
    if kind == "round":
        drs = np.diff(ue)
        ravg = 0.5 * (ue[1:] + ue[:-1])
        return np.outer(drs * ravg, np.diff(ve))
    if kind == "cut_round":
        # polar cells clipped by the chord x = x_cut (ref
        # flat_surface.py:605-715 re-meshes the cut region; here the polar
        # mesh is kept and areas are chord-clipped by sub-sampling)
        x_cut = extent["x_cut"]
        full = np.outer(0.5 * (ue[1:] ** 2 - ue[:-1] ** 2), np.diff(ve))
        frac = _cell_fraction_outside(
            ue, ve, lambda R, A: (R * np.cos(A)) <= x_cut)
        return full * frac
    if kind == "parabolic_dish":
        qa = extent["qa"]
        # exact surface area of a polar cell on z = qa r^2: dtheta *
        # ((1+4 qa^2 r1^2)^(3/2) - (1+4 qa^2 r0^2)^(3/2)) / (12 qa^2)
        shell = ((1.0 + 4.0 * qa**2 * ue[1:] ** 2) ** 1.5
                 - (1.0 + 4.0 * qa**2 * ue[:-1] ** 2) ** 1.5) \
            / (12.0 * qa**2)
        return np.outer(shell, np.diff(ve))
    if kind in ("finite_cylinder", "rect_cut_cylinder"):
        full = np.outer(np.diff(ue), extent["R"] * np.diff(ve))
        if kind == "rect_cut_cylinder":
            # (z, theta) bands clipped by the |x|<=w/2, |y|<=h/2 box
            # trim (the cut is theta-only on a cylinder); sub-sampled
            # like the chord-clipped cut disc
            R = extent["R"]
            w2, h2 = extent["w"] / 2.0, extent["hf"] / 2.0
            frac = _cell_fraction_outside(
                ue, ve,
                lambda Z, A: (np.abs(R * np.cos(A)) <= w2 + 1e-12)
                & (np.abs(R * np.sin(A)) <= h2 + 1e-12))
            return full * frac
        return full
    if kind == "conical_frustum":
        c, a = extent["c"], extent["a"]
        slant = np.sqrt(1.0 + c**2)
        r_at = lambda z: np.abs(c * (z - a))
        band = 0.5 * slant * (r_at(ue[1:]) + r_at(ue[:-1])) * np.diff(ue)
        return np.outer(band, np.diff(ve))
    if kind in _SPHERICAL:
        R = extent["R"]
        band = R**2 * (np.cos(ue[:-1]) - np.cos(ue[1:]))
        full = np.outer(band, np.diff(ve))
        if kind == "spherical_rect_facet":
            # z<=0 half-sphere trimmed to |x|<=lx/2, |y|<=ly/2
            lx2, ly2 = extent["lx"] / 2.0, extent["ly"] / 2.0
            frac = _cell_fraction_outside(
                ue, ve,
                lambda TH, PH: (np.cos(TH) <= 1e-12)
                & (np.abs(R * np.sin(TH) * np.cos(PH)) <= lx2 + 1e-12)
                & (np.abs(R * np.sin(TH) * np.sin(PH)) <= ly2 + 1e-12))
            return full * frac
        return full
    raise NotImplementedError(f"no fluxmap for geometry kind {kind}")


def _cell_fraction_outside(ue, ve, keep_fn, nsub: int = 8) -> np.ndarray:
    """Fraction of each (u, v) cell satisfying keep_fn(u, v) — u/v may be
    cartesian x/y or polar r/theta — by nsub x nsub sub-sampling."""
    s = 0.5 * (np.linspace(0, 1, nsub + 1)[:-1]
               + np.linspace(0, 1, nsub + 1)[1:])
    uu = ue[:-1, None] + np.diff(ue)[:, None] * s[None, :]   # (nu, nsub)
    vv = ve[:-1, None] + np.diff(ve)[:, None] * s[None, :]   # (nv, nsub)
    U = uu[:, None, :, None]     # (nu, 1, nsub, 1)
    V = vv[None, :, None, :]     # (1, nv, 1, nsub)
    Ub = np.broadcast_to(U, (len(uu), len(vv), nsub, nsub))
    Vb = np.broadcast_to(V, (len(uu), len(vv), nsub, nsub))
    keep = keep_fn(Ub, Vb)
    return keep.mean(axis=(2, 3))


def supported_kinds() -> tuple:
    return _CARTESIAN + _POLAR + _AXIAL + _SPHERICAL


def fluxmap(geom, eners, local, resolution: int = 40):
    """Flux map on a surface's natural mesh: ``geom`` the surface's
    Geometry (its kind and extent), ``eners`` (n,) absorbed energy per
    hit, ``local`` (n, 3) local hit points. Returns (flux (nu, nv), (u
    edges, v edges))."""
    eners = np.asarray(eners, dtype=float)
    local = np.atleast_2d(np.asarray(local, dtype=float))
    if local.size == 0:
        local = np.zeros((0, 3))
    kind, extent = geom.kind, geom.extent
    u, v = uv_project(kind, extent, local)
    ue, ve = edges_of(kind, extent, resolution)
    hist = np.histogram2d(u, v, bins=[ue, ve], weights=eners)[0]
    areas = areas_of(kind, extent, resolution)
    with np.errstate(divide="ignore", invalid="ignore"):
        flux = np.where(areas > 0, hist / np.maximum(areas, 1e-300), 0.0)
    return flux, (ue, ve)


def surface_fluxmap(result, surface, resolution: int = 40):
    """Flux map of the energy absorbed on a logical surface (index or
    name) of an engine.TraceResult, from its records."""
    sidx = (result.meta.index_of(surface) if isinstance(surface, str)
            else surface)
    hits = result.hits_of(sidx, keys=("absorbed", "local"))
    return fluxmap(result.meta.surfaces[sidx].geometries[0],
                   hits["absorbed"], hits["local"], resolution)
