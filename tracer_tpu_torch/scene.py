"""Scene graph and its compiler to the flat device-side surface table
(PyTorch port of tracer_tpu/scene.py: the scene classes and the row order
are the same; the compiled table is a dataclass of torch tensors).

The user-facing API mirrors the reference's scene layer (Surface /
AssembledObject / Assembly with nested homogeneous transforms —
tracer/surface.py, object.py, assembly.py, has_frame.py), and
``compile_scene`` flattens the tree into a struct of tensors
(:class:`SceneTable`) that the trace kernels consume. Python objects never
appear on the hot path.

A Surface may carry several Geometry rows (e.g. a triangulated polygon);
they share one *logical* surface id so accounting aggregates correctly.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from .device import resolve
from .geometry import Geometry, N_AP_PARAMS
from .materials import OpticsSpec, N_OPT_PARAMS
from . import spatial


class HasFrame:
    """A node with a homogeneous transform relative to its parent
    (capability parity with ref tracer/has_frame.py)."""

    def __init__(self, location=None, rotation=None, transform=None):
        self._transform = np.eye(4)
        if transform is not None:
            self.set_transform(transform)
        if rotation is not None:
            self.set_rotation(rotation)
        if location is not None:
            self.set_location(location)

    def get_location(self) -> np.ndarray:
        return self._transform[:3, 3].copy()

    def get_rotation(self) -> np.ndarray:
        return self._transform[:3, :3].copy()

    def get_transform(self) -> np.ndarray:
        return self._transform.copy()

    def set_location(self, location) -> None:
        self._transform = self._transform.copy()
        self._transform[:3, 3] = np.asarray(location, dtype=float).reshape(3)

    def set_rotation(self, rotation) -> None:
        self._transform = self._transform.copy()
        self._transform[:3, :3] = np.asarray(rotation, dtype=float)

    def set_transform(self, transform) -> None:
        self._transform = np.asarray(transform, dtype=float).reshape(4, 4).copy()


class Surface(HasFrame):
    """Pairs shape (one or more Geometry rows) with an OpticsSpec
    (ref tracer/surface.py:12)."""

    def __init__(self, geometry: Union[Geometry, Sequence[Geometry]],
                 optics: OpticsSpec, location=None, rotation=None,
                 name: Optional[str] = None, fixed_color=None):
        HasFrame.__init__(self, location=location, rotation=rotation)
        if isinstance(geometry, Geometry):
            geometry = [geometry]
        self.geometries: List[Geometry] = list(geometry)
        self.optics = optics
        self.name = name
        self.fixed_color = fixed_color

    # Parity helpers -------------------------------------------------------
    def get_optics_manager(self) -> OpticsSpec:
        return self.optics

    def get_geometry_manager(self) -> Geometry:
        return self.geometries[0]


class AssembledObject(HasFrame):
    """A set of surfaces with a shared frame, optionally with a boundary
    used for acceleration (ref tracer/object.py:7)."""

    def __init__(self, surfs: Optional[Sequence[Surface]] = None,
                 bounds=None, location=None, rotation=None, transform=None):
        HasFrame.__init__(self, location=location, rotation=rotation,
                          transform=transform)
        self.surfaces: List[Surface] = list(surfs or [])
        self.bounds = bounds

    def add_surface(self, surface: Surface) -> None:
        self.surfaces.append(surface)

    def get_surfaces(self) -> List[Surface]:
        return list(self.surfaces)


class Assembly(HasFrame):
    """A tree of objects and sub-assemblies (ref tracer/assembly.py:9)."""

    def __init__(self, objects: Optional[Sequence[AssembledObject]] = None,
                 subassemblies: Optional[Sequence["Assembly"]] = None,
                 location=None, rotation=None, transform=None):
        HasFrame.__init__(self, location=location, rotation=rotation,
                          transform=transform)
        self.objects: List[AssembledObject] = list(objects or [])
        self.assemblies: List[Assembly] = list(subassemblies or [])

    def add_object(self, obj: AssembledObject, transform=None) -> None:
        if transform is not None:
            obj.set_transform(transform)
        self.objects.append(obj)

    def add_assembly(self, asm: "Assembly", transform=None) -> None:
        if transform is not None:
            asm.set_transform(transform)
        self.assemblies.append(asm)

    def get_assemblies(self) -> List["Assembly"]:
        out = list(self.assemblies)
        for a in self.assemblies:
            out.extend(a.get_assemblies())
        return out

    def get_objects(self) -> List[AssembledObject]:
        out = list(self.objects)
        for a in self.assemblies:
            out.extend(a.get_objects())
        return out

    def get_surfaces(self) -> List[Surface]:
        out: List[Surface] = []
        for o in self.get_objects():
            out.extend(o.surfaces)
        return out

    # -- flattening ----------------------------------------------------------
    def _walk(self, parent_frame: np.ndarray):
        """Yield (surface, global_frame) over the whole tree."""
        frame = parent_frame @ self._transform
        for obj in self.objects:
            obj_frame = frame @ obj._transform
            for s in obj.surfaces:
                yield s, obj_frame @ s._transform
        for a in self.assemblies:
            yield from a._walk(frame)


# ---------------------------------------------------------------------------
# Compiled scene
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SceneTable:
    """Flat struct-of-arrays scene on one device (the torch twin of
    tracer_tpu.scene.SceneTable, tracer_tpu/scene.py:158).

    frame      (S,4,4) local->global homogeneous transforms
    inv_frame  (S,4,4) exact inverses
    quadric    (S,10)  local-frame quadric coefficients
    ap_type    (S,C)   aperture constraint type ids (AP_NONE pads)
    ap_params  (S,C,6) constraint parameters
    opt_kind   (S,)    optics kind ids
    opt_flags  (S,)    optics flag words
    opt_params (S,P)   optics parameters
    spectral_wl/spectral_ab (L,) shared spectral absorptance table
    logical    (S,)    logical surface id (rows of one Surface share it)
    """

    frame: torch.Tensor
    inv_frame: torch.Tensor
    quadric: torch.Tensor
    ap_type: torch.Tensor
    ap_params: torch.Tensor
    opt_kind: torch.Tensor
    opt_flags: torch.Tensor
    opt_params: torch.Tensor
    spectral_wl: torch.Tensor
    spectral_ab: torch.Tensor
    logical: torch.Tensor
    # Static compile-time data, identical to the JAX table's. Rows are
    # SORTED so each aperture-signature group is a contiguous [start, end)
    # slice: (start, end, signature, quadric class).
    groups: tuple = ()
    # sorted tuple of optics kinds present
    kinds_present: tuple = ()
    # sorted tuple of flag words in use (F_ONE_SIDED etc.)
    flags_present: tuple = ()
    # flag words of rows that actually have slope error (sigma > 0)
    slope_flags_present: tuple = ()
    # static feature tags ("slope_error", "iam", "one_sided", "bivar", ...)
    features: tuple = ()
    # (att, scat, g) ambient participating medium declared by optics specs
    ambient_medium: tuple = ()
    # the scene's single static Martin-Ruiz IAM exponent c
    iam_c: float = 1.0

    @property
    def num_rows(self) -> int:
        return self.frame.shape[0]

    @property
    def device(self) -> torch.device:
        return self.frame.device

    @property
    def num_logical(self) -> int:
        return int(self.logical.max()) + 1


# the tensor fields of SceneTable and their host dtypes (None = the
# table's float dtype)
_INT_FIELDS = ("ap_type", "opt_kind", "opt_flags", "logical")
_FLOAT_FIELDS = ("frame", "inv_frame", "quadric", "ap_params", "opt_params",
                 "spectral_wl", "spectral_ab")
_STATIC_FIELDS = ("groups", "kinds_present", "flags_present",
                  "slope_flags_present", "features", "ambient_medium",
                  "iam_c")


def _table_from_numpy(arrays: dict, static: dict, dtype, device) -> SceneTable:
    device = resolve(device)
    fields = {k: torch.tensor(np.asarray(arrays[k]), dtype=dtype,
                              device=device) for k in _FLOAT_FIELDS}
    fields.update({k: torch.tensor(np.asarray(arrays[k]), dtype=torch.int32,
                                   device=device) for k in _INT_FIELDS})
    return SceneTable(**fields, **static)


def scene_from_jax(table_np: dict, device=None,
                   dtype=torch.float32) -> SceneTable:
    """Carry a tracer_tpu SceneTable across: ``table_np`` maps every field
    name to a numpy array (``np.asarray`` of the JAX field) and every
    static field name (groups, kinds_present, ...) to its tuple. ``device``
    None means the GPU (device.default_device)."""
    static = {k: table_np[k] for k in _STATIC_FIELDS if k in table_np}
    return _table_from_numpy(table_np, static, dtype, device)


@dataclasses.dataclass
class SceneMeta:
    """Host-side companion to SceneTable: names, per-logical-surface
    geometry/optics descriptors for flux-map binning and accounting."""

    surfaces: List[Surface]          # logical surfaces, index = logical id
    names: List[str]
    row_logical: np.ndarray          # (S,) logical id per table row
    frames: np.ndarray               # (S,4,4) global frames (host copy)
    # per-ROW geometry handles in table order (rows are sorted by aperture
    # signature at compile time, so meta.surfaces iteration order is NOT row
    # order in general — anything needing per-row geometry must use this)
    row_geoms: Optional[list] = None
    # host (numpy) copies of the table rows that build-time analyses need
    # (culling, accel), so they never read the device table
    host_quadric: Optional[np.ndarray] = None
    host_opt_kind: Optional[np.ndarray] = None
    host_opt_params: Optional[np.ndarray] = None
    host_opt_flags: Optional[np.ndarray] = None

    def index_of(self, name: str) -> int:
        return self.names.index(name)


def compile_scene(assembly: Assembly, dtype=torch.float32,
                  max_constraints: Optional[int] = None,
                  extra_features: Sequence[str] = (), device=None):
    """Flatten an Assembly into (SceneTable, SceneMeta) on ``device`` (None
    means the GPU, device.default_device).

    extra_features: additional static feature tags to compile in. The main
    use is ("volumetric",) for scenes traced in an ambient participating
    medium set on the ray bundle (att_coeff/scat_coeff) rather than entered
    through a refractive/absorbant interface — without the tag the engine
    prunes the volumetric code path."""
    device = resolve(device)
    pairs = list(assembly._walk(np.eye(4)))
    if not pairs:
        raise ValueError("empty scene")

    # group rows by logical surface; bifacial optics lower into two
    # coincident one-sided rows (back on a pi-flipped frame)
    flip = np.diag([1.0, -1.0, -1.0, 1.0])  # rotx(pi)
    logical_surfaces: List[Surface] = []
    rows = []  # (geometry, frame, logical_id, optics)
    seen = {}
    for surf, frame in pairs:
        if id(surf) not in seen:
            seen[id(surf)] = len(logical_surfaces)
            logical_surfaces.append(surf)
        lid = seen[id(surf)]
        for g in surf.geometries:
            rows.append((g, frame, lid, surf.optics))
            back = getattr(surf.optics, "back_spec", None)
            if back is not None:
                # the flip mirrors local y and z: flip_y_flat negates the
                # y-odd aperture parameters (and mesh extents) so ANY
                # flat geometry works — triangle, polygon, x-cut,
                # perforations (ref BiFacial works with any GM,
                # optics_callables.py:1877). Curved quadrics stay
                # rejected: their coefficient matrix and meshes would
                # need mirroring too.
                import dataclasses as _dc
                from .geometry import flip_y_flat
                gb = flip_y_flat(g)
                if g.frame is not None:
                    # per-face local frames (triangulated surfaces):
                    # the flip is the innermost local op
                    gb = _dc.replace(gb, frame=g.frame @ flip)
                    rows.append((gb, frame, lid, back))
                else:
                    rows.append((gb, frame @ flip, lid, back))

    # Sort rows so surfaces with the same aperture signature (and quadric
    # CLASS) are contiguous: the intersect kernel specializes per group.
    # Classes, cheapest first: "flat" (plane z=0 — no quadratic solve),
    # "parab" (axis-aligned paraboloid/parabolic cylinder: only axx, ayy,
    # bz, c0 nonzero — ~3x fewer coefficient products than the general
    # solve), "sphere" (axx=ayy=azz, no cross/linear terms), "quadric".
    def ap_sig(geom: Geometry):
        return tuple(t for t, _ in geom.apertures)

    _flat_quad = np.zeros(10)
    _flat_quad[8] = 0.5

    def _geom_class(geom: Geometry) -> str:
        q = geom.quadric
        if np.array_equal(q, _flat_quad):
            return "flat"
        if (q[2] == 0.0 and q[3] == q[4] == q[5] == 0.0
                and q[6] == q[7] == 0.0 and q[8] != 0.0):
            return "parab"
        if (q[0] == q[1] == q[2] != 0.0
                and q[3] == q[4] == q[5] == 0.0
                and q[6] == q[7] == q[8] == 0.0):
            return "sphere"
        return "quadric"

    _CLASS_RANK = {"flat": 0, "parab": 1, "sphere": 2, "quadric": 3}
    rows.sort(key=lambda r: (ap_sig(r[0]), _CLASS_RANK[_geom_class(r[0])]))

    S = len(rows)
    C = max_constraints or max(1, max(len(g.apertures) for g, *_ in rows))

    frames = np.zeros((S, 4, 4))
    invs = np.zeros((S, 4, 4))
    quad = np.zeros((S, 10))
    ap_type = np.zeros((S, C), dtype=np.int32)
    ap_params = np.zeros((S, C, N_AP_PARAMS))
    opt_kind = np.zeros((S,), dtype=np.int32)
    opt_flags = np.zeros((S,), dtype=np.int32)
    opt_params = np.zeros((S, N_OPT_PARAMS))
    logical = np.zeros((S,), dtype=np.int32)

    from . import materials as _M
    spectral_chunks = []
    spectral_len = 0

    for i, (g, frame, lid, opt) in enumerate(rows):
        if len(g.apertures) > C:
            raise ValueError(
                f"surface row {i} has {len(g.apertures)} constraints > C={C}")
        row_frame = frame if g.frame is None else frame @ g.frame
        frames[i] = row_frame
        invs[i] = spatial.invert_transform(row_frame)
        quad[i] = g.quadric
        for j, (t, p) in enumerate(g.apertures):
            ap_type[i, j] = t
            ap_params[i, j] = p
        opt_kind[i] = opt.kind
        opt_flags[i] = opt.flags
        opt_params[i] = opt.params
        if opt.spectral_table is not None:
            if opt.kind == _M.K_REFRACTIVE:
                # dispersive interface: both n(lambda) tables in one chunk,
                # start in slot 3 (lens already in slots 4/5)
                opt_params[i, 3] = spectral_len
            else:
                opt_params[i, 0] = spectral_len
                opt_params[i, 1] = len(opt.spectral_table)
            spectral_chunks.append(opt.spectral_table)
            spectral_len += len(opt.spectral_table)
        # generic multi-chunk packing: each (table, start_slot) chunk goes
        # into the shared table with its start offset written to the given
        # param slot (lengths are already in the factory's params)
        for tab, slot in getattr(opt, "pack_tables", ()):
            opt_params[i, slot] = spectral_len
            spectral_chunks.append(tab)
            spectral_len += len(tab)
        logical[i] = lid

    if spectral_chunks:
        spec = np.concatenate(spectral_chunks, axis=0)
    else:
        spec = np.zeros((1, 2))

    # contiguous aperture-signature groups (rows were sorted above), each
    # tagged with its quadric class so kernels compile the cheapest solve
    # ("flat": t = -v_z/d_z, no quadratic; "parab"/"sphere": specialized
    # few-coefficient ABC; "quadric": the general 10-coefficient solve)
    groups = []
    start = 0
    for i in range(1, S + 1):
        if i == S or ap_sig(rows[i][0]) != ap_sig(rows[start][0]) \
                or _geom_class(rows[i][0]) != _geom_class(rows[start][0]):
            groups.append((start, i, ap_sig(rows[start][0]),
                           _geom_class(rows[start][0])))
            start = i

    kinds_present = tuple(sorted({opt.kind for *_, opt in rows}))
    flags_present = tuple(sorted({opt.flags for *_, opt in rows}))

    from . import materials as M
    features = set()
    slope_flags = set()
    ambient_medium = ()
    iam_cs: set = set()
    for g, frame, lid, opt in rows:
        sigma_slot = 1 if opt.kind == M.K_REFLECT else 2
        if opt.kind in (M.K_REFLECT, M.K_REFLECT_SPECTRAL,
                        M.K_LAMBERTIAN_SPECULAR, M.K_REFRACTIVE) \
                and opt.params[sigma_slot] > 0:
            features.add("slope_error")
            slope_flags.add(opt.flags)
        if opt.flags & M.F_IAM:
            features.add("iam")
            iam_cs.add(round(float(opt.params[5]), 9))
            if opt.kind not in (M.K_REFLECT, M.K_LAMBERTIAN,
                                M.K_LAMBERTIAN_SPECULAR,
                                M.K_SEMI_LAMBERTIAN):
                # pack_rows mirrors a_r (p4) into a free row column only
                # for reflective / Lambertian / semi-Lambertian (p2) and
                # LambertianSpecular (p3) bases, so only those IAM rows
                # ride the fused megakernels; any other base stays on
                # the general path
                features.add("iam_nonmirror")
        if opt.flags & M.F_ONE_SIDED:
            features.add("one_sided")
        if opt.flags & M.F_BACKSIDE_MISS:
            features.add("bifacial")
        if opt.flags & M.F_BIVAR:
            features.add("bivar")
        if opt.flags & M.F_SPLIT:
            features.add("split")
        if opt.kind == M.K_REFLECT_SPECTRAL:
            features.add("spectral")
        if opt.kind == M.K_FRESNEL_CONDUCTOR:
            features.add("fresnel_conductor")
            if opt.params[2] > 1:
                # tabulated n(wl), k(wl): the megakernel needs the
                # per-lane wavelength thread (spectral mode) to
                # interpolate; constant-index conductors do not
                features.add("conductor_dispersive")
        if opt.kind == M.K_LAMBERTIAN_PIECEWISE:
            features.add("lambertian_piecewise")
            if opt.params[5] > 0:
                features.add("lambertian_piecewise_spectral")
            if opt.params[3] >= 0:
                features.add("lambertian_piecewise_dirspec")
        if opt.kind == M.K_REFRACTIVE and opt.spectral_table is not None:
            features.add("dispersive")
        if opt.kind == M.K_REFRACTIVE and opt.params[2] > 0:
            # frosted (slope-error) interface: the fused megakernels
            # carry its sigma through the q2 slot (refr_frost mode) and
            # perturb the Fresnel/Snell normal
            features.add("refractive_slope")
        if opt.kind == M.K_REFRACTIVE and np.any(opt.params[6:12] != 0.0):
            features.add("volumetric")
        if opt.ambient_medium is not None:
            # the periodic-medium composites carry the cell's ambient
            # medium on the optics spec (materials.OpticsSpec
            # ambient_medium); the engine folds it into the source's
            # ambient slots at trace time. Differing declarations are a
            # modeling error — there is one ambient.
            if ambient_medium and tuple(ambient_medium) != tuple(
                    opt.ambient_medium):
                raise ValueError(
                    f"conflicting ambient media declared by optics specs: "
                    f"{ambient_medium} vs {opt.ambient_medium}")
            ambient_medium = tuple(opt.ambient_medium)
    if ambient_medium:
        # the engine's volumetric machinery (free paths, Beer-Lambert,
        # HG draws) is compiled only for scenes with this feature
        features.add("volumetric")
    # one static Martin-Ruiz exponent per scene rides the fused kernels
    # as a compile-time constant (cos^c baked into the IAM epilogue);
    # MIXED exponents across rows would need a per-lane carry — those
    # scenes keep the general path
    if len(iam_cs) > 1:
        features.add("iam_nonmirror")
    iam_c = iam_cs.pop() if len(iam_cs) == 1 else 1.0
    features.update(extra_features)
    features = tuple(sorted(features))

    table = _table_from_numpy(
        dict(frame=frames, inv_frame=invs, quadric=quad, ap_type=ap_type,
             ap_params=ap_params, opt_kind=opt_kind, opt_flags=opt_flags,
             opt_params=opt_params, spectral_wl=spec[:, 0],
             spectral_ab=spec[:, 1], logical=logical),
        dict(groups=tuple(groups), kinds_present=kinds_present,
             flags_present=flags_present,
             slope_flags_present=tuple(sorted(slope_flags)),
             features=features, ambient_medium=ambient_medium,
             iam_c=iam_c), dtype, device)
    names = [s.name or f"surface_{k}" for k, s in enumerate(logical_surfaces)]
    meta = SceneMeta(surfaces=logical_surfaces, names=names,
                     row_logical=logical, frames=frames,
                     row_geoms=[g for g, *_ in rows],
                     host_quadric=np.asarray(quad, dtype=np.float64),
                     host_opt_kind=np.asarray(opt_kind),
                     host_opt_params=np.asarray(opt_params,
                                                dtype=np.float64),
                     host_opt_flags=np.asarray(opt_flags))
    return table, meta
