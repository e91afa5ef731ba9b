"""Monte-Carlo radiative view factors with adaptive precision (the
PyTorch port of tracer_tpu/analysis/view_factors.py).

The RTVF base runs the adaptive 3-sigma Welford loop that gates each
element's firing by the stdev, reciprocity and summation tests; the
solvers are the 2N-parameter axisymmetric cavity (and its 4-parameter
wrapper) and a binned axisymmetric receiver.

Every adaptive iteration fires all elements at once: one call samples
every element's emission bundle, finds each ray's nearest hit over the
cavity table (nearest_hit: K3 for float32 rays on the card, the float64
oracle on either device), bins the destination element on the device and
sums the (src, dst) exchange matrix with one index_add_. View factors are
direct-exchange fractions, so that one pass with black walls is the whole
trace. A call makes ``iters_per_call`` independent samples, stacks them
on the device and copies them to the host once; the host consumes them
one at a time through the same gates, so the statistics are those of
separate calls. The per-element engine loop (``batched=False``) is kept
as the oracle and as the fallback for walls that are not black.

Every random draw takes an explicit ``torch.Generator`` (None means one
on the scene's device seeded with 20260816); ``device`` None means the
GPU.
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from .. import geometry as G
from .. import materials as M
from .. import spatial as sp
from ..engine import TraceOptions, TracerEngine
from ..kernels.intersect import nearest_hit
from ..scene import Assembly, AssembledObject, Surface
from ..sources import disk_bundle, vf_cylinder_bundle, vf_frustum_bundle

log = logging.getLogger("tracer_tpu_torch")

_DEFAULT_SEED = 20260816


def build_two_n_cavity(aperture_radius: float, frusta_radii: Sequence[float],
                       frusta_depths: Sequence[float], cone_depth: float,
                       optics=None, aperture_optics=None) -> Assembly:
    """Axisymmetric cavity: aperture disc at z=0, a chain of frusta or
    cylinders, closed by a cone or a flat plate
    (tracer_tpu/analysis/view_factors.py:35).

    optics - per-surface OpticsSpec factory (default: absorptivity-1
        Lambertian, the view-factor configuration).
    aperture_optics - the aperture disc's factory (default: ``optics``,
        the black virtual element; the solar model passes a bifacial disc,
        transparent from outside, so sunlight can enter).
    """
    frusta_radii = list(frusta_radii)
    frusta_depths = list(frusta_depths)
    if optics is None:
        def optics():
            return M.lambertian(absorptivity=1.0)
    if aperture_optics is None:
        aperture_optics = optics

    objs = [AssembledObject(surfs=[Surface(
        G.round_plate(aperture_radius), aperture_optics(),
        name="aperture")])]
    radii = [aperture_radius] + frusta_radii
    z = 0.0
    for i in range(len(frusta_radii)):
        r_in, r_out, d = radii[i], radii[i + 1], frusta_depths[i]
        name = f"frustum_{i}"
        if r_in == r_out:  # cylinder section
            surf = Surface(G.finite_cylinder(2.0 * r_out, abs(d)), optics(),
                           name=name)
            obj = AssembledObject(surfs=[surf])
            obj.set_transform(sp.translate(z=z + d / 2.0))
        elif d == 0.0:  # flat annular step
            surf = Surface(G.round_plate(max(r_in, r_out), min(r_in, r_out)),
                           optics(), name=name)
            obj = AssembledObject(surfs=[surf])
            obj.set_transform(sp.translate(z=z))
        else:
            surf = Surface(G.conical_frustum(0.0, r_in, abs(d), r_out),
                           optics(), name=name)
            obj = AssembledObject(surfs=[surf])
            if d < 0.0:
                obj.set_transform(sp.translate(z=z) @ sp.rotx(np.pi))
            else:
                obj.set_transform(sp.translate(z=z))
        objs.append(obj)
        z += d

    r_last = radii[-1]
    if cone_depth > 0.0:  # outgoing cone
        obj = AssembledObject(surfs=[Surface(
            G.finite_cone(r_last, cone_depth), optics(), name="cone")])
        obj.set_transform(sp.rotx(np.pi) @ sp.translate(z=-(z + cone_depth)))
    elif cone_depth == 0.0:  # flat back plate
        obj = AssembledObject(surfs=[Surface(
            G.round_plate(r_last), optics(), name="cone")])
        obj.set_transform(sp.translate(z=z))
    else:  # inward cone
        obj = AssembledObject(surfs=[Surface(
            G.finite_cone(r_last, -cone_depth), optics(), name="cone")])
        obj.set_transform(sp.translate(z=z + cone_depth))
    objs.append(obj)
    return Assembly(objects=objs)


def frusta_bins(names, el_FRUs, frusta_depths):
    """Per frustum of a 2N cavity: (logical id, first element, slices,
    z start, depth); and the cone's first element."""
    out, idx, z = [], 1, 0.0
    for k, (el, d) in enumerate(zip(el_FRUs, frusta_depths)):
        out.append((names.index(f"frustum_{k}"), idx, el, z, d))
        idx += el
        z += d
    return out, idx


def bin_cavity_records(records, meta, el_FRUs, frusta_depths,
                       r_last: float, el_CON: int) -> np.ndarray:
    """Absorbed energy per 2N-cavity element summed over trace records:
    the aperture whole, depth-equal z slabs on each frustum (a zero-depth
    step is one element), radial rings on the cone."""
    frusta, cone_idx = frusta_bins(meta.names, el_FRUs, frusta_depths)
    ap_l, cone_l = meta.names.index("aperture"), meta.names.index("cone")
    out = np.zeros(cone_idx + el_CON)
    for rec in records:
        sid = rec.sid.cpu().numpy()
        valid = rec.alive_in.cpu().numpy() & (sid >= 0)
        if not valid.any():
            continue
        hit = rec.hit.double().cpu().numpy()
        absorbed = rec.absorbed.double().cpu().numpy()
        logical = meta.row_logical[np.maximum(sid, 0)]
        out[0] += absorbed[valid & (logical == ap_l)].sum()
        for f_l, i0, el, z, d in frusta:
            m = valid & (logical == f_l)
            if m.any():
                if d == 0.0:     # flat annular step: one element
                    b = np.zeros(int(m.sum()), dtype=int)
                else:
                    b = np.clip(((hit[m, 2] - z) / d * el).astype(int), 0,
                                el - 1)
                np.add.at(out, i0 + b, absorbed[m])
        m = valid & (logical == cone_l)
        if m.any():
            rr = np.hypot(hit[m, 0], hit[m, 1]) / r_last
            b = np.clip((el_CON * (1.0 - rr)).astype(int), 0, el_CON - 1)
            np.add.at(out, cone_idx + b, absorbed[m])
    return out


class RTVFBase:
    """Adaptive-precision Welford machinery shared by the view-factor
    solvers (tracer_tpu/analysis/view_factors.py:108)."""

    def _init_stats(self, n: int, num_rays: int):
        self.n_elements = n
        self.num_rays = int(num_rays)
        self.VF = np.zeros((n, n))
        self.VF_esperance = np.zeros((n, n))
        self.Qsum = np.zeros((n, n))
        self.stdev_VF = np.zeros((n, n))
        self.p = np.zeros(n)
        self.ray_counts = np.full(n, self.num_rays, dtype=float)
        self.progress = np.ones((n, n), dtype=bool)

    def _init_engine(self, assembly, generator, dtype, device):
        """The cavity's engine on ``device`` in ``dtype``, and the
        generator of every draw."""
        self.dtype = dtype
        self.engine = TracerEngine(assembly, dtype=dtype, device=device)
        self.device = self.engine.scene.device
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                _DEFAULT_SEED)
        return generator

    def _test_precision(self) -> None:
        r = self.ray_counts[:, None]
        p = np.maximum(self.p[:, None], 1.0)
        p_1 = np.maximum(p - r, 0.0)
        Ai = np.broadcast_to(self.areas[:, None], self.VF.shape)

        fired = r > 0
        self.Qsum = np.where(
            fired, self.Qsum + r * p_1 / p * (self.VF - self.VF_esperance) ** 2,
            self.Qsum)
        with np.errstate(divide="ignore", invalid="ignore"):
            self.stdev_VF = (3.0 * np.sqrt(self.Qsum / np.maximum(p - 1.0, 1.0))
                             / np.sqrt(p))
        self.VF_esperance = np.where(
            fired, (self.VF_esperance * p_1 + self.VF * r) / p,
            self.VF_esperance)

        AiFij = self.VF_esperance * Ai
        if self.precision_option == "absolute":
            stdev_test = self.stdev_VF <= self.precision / 2.0
            tas = self.stdev_VF * Ai
            reciprocity_test = (tas + tas.T) <= self.precision_rec
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                rel = np.nan_to_num(self.stdev_VF / self.VF_esperance)
                stdev_test = rel <= self.precision
                tas = Ai * self.stdev_VF
                rel_rec = np.nan_to_num((tas + tas.T) / AiFij,
                                        posinf=0.0, neginf=0.0)
            reciprocity_test = (rel_rec <= self.precision_rec) | (
                AiFij < self.precision_rec * np.max(AiFij, axis=1,
                                                    keepdims=True))
        summ_test = (np.abs(self.VF_esperance.sum(axis=1) - 1.0)
                     < self.precision)
        self.progress = ~(summ_test[:, None] & stdev_test & reciprocity_test)

    def _gate(self, it: int, min_iters: int, stable: int) -> int:
        """One sample consumed: the Welford update, the gates, the next
        iteration's ray counts; returns the count of stable iterations."""
        self.p += self.ray_counts
        self._test_precision()
        stable = stable + 1 if it >= min_iters and not self.progress.any() \
            else 0
        self.ray_counts = np.where(self.progress.any(axis=1),
                                   float(self.num_rays), 0.0)
        return stable

    def _adaptive_loop(self, generator, max_iters: int, min_iters: int,
                       fire_element) -> None:
        """Fire ``fire_element(generator, el) -> VF row`` per unconverged
        element until the precision gates pass."""
        stable = 0
        it = 0
        while (self.progress.any() or stable < 2) and it < max_iters:
            it += 1
            for el in range(self.n_elements):
                if self.ray_counts[el] == 0.0:
                    continue
                self.VF[el] = fire_element(generator, el)
            stable = self._gate(it, min_iters, stable)
        self.iterations = it

    def _adaptive_loop_batched(self, generator, max_iters: int,
                               min_iters: int, fire_all) -> None:
        """Batched adaptive loop: ``fire_all(generator) -> (k, n, n)``
        samples is one device call covering every element for k
        independent sub-iterations; rows of converged elements are
        ignored. The samples are consumed one at a time through the same
        gates, so the statistics are those of k separate calls."""
        stable = 0
        it = 0
        pending: list = []
        while (self.progress.any() or stable < 2) and it < max_iters:
            it += 1
            if not pending:
                pending = list(fire_all(generator))
            vf = pending.pop(0)
            active = self.ray_counts > 0
            self.VF[active] = vf[active]
            stable = self._gate(it, min_iters, stable)
        self.iterations = it

    def _wrap_fire(self, fire_rays):
        """A host callable ``fire(generator) -> (k, n, n)`` numpy array of
        ``iters_per_call`` samples of ``fire_rays(pos, dirs, e)`` over
        fresh sources, stacked on the device and copied to the host
        once."""
        k = max(1, int(getattr(self, "iters_per_call", 1)))

        def fire(generator):
            return torch.stack([fire_rays(*self._concat_sources(generator))
                                for _ in range(k)]).cpu().numpy()
        return fire

    def _alpha_rows(self):
        """(S,) absorbed fraction of every table row for one bounce, on the
        scene's device, or None when the batched one-bounce path would not
        be exact (any row that is not a black Lambertian, mirror or
        absorber: the engine loop's multi-bounce redistribution then
        matters), with a warning."""
        meta = self.engine.meta
        kinds = np.asarray(meta.host_opt_kind)
        ok = np.isin(kinds, [M.K_LAMBERTIAN, M.K_REFLECT, M.K_ABSORBER])
        if not ok.all():
            log.warning(
                "view factors: cavity has non-Lambertian/absorber optics "
                "(kinds %s) — falling back to the per-element engine loop "
                "(~2 orders slower than the batched device path; use "
                "absorptivity-1 Lambertian elements for geometric VFs)",
                sorted(set(kinds.tolist())))
            return None
        p0 = np.asarray(meta.host_opt_params)[:, 0]
        alpha = np.where(kinds == M.K_ABSORBER, 1.0, p0)
        if not (alpha >= 1.0 - 1e-9).all():
            log.warning(
                "view factors: %d cavity rows have absorptivity < 1 — "
                "falling back to the per-element engine loop (~2 orders "
                "slower). Geometric view factors presume BLACK elements; "
                "set absorptivity=1 to ride the batched device path",
                int((alpha < 1.0 - 1e-9).sum()))
            return None
        return torch.as_tensor(alpha, dtype=self.dtype, device=self.device)

    def _concat_sources(self, generator):
        """Every element's emission bundle, concatenated: (pos, dirs,
        energy) of n_elements * num_rays rays on the scene's device."""
        parts = [self._element_source(generator, el)
                 for el in range(self.n_elements)]
        return (torch.cat([b.pos for b in parts]),
                torch.cat([b.dir for b in parts]),
                torch.cat([b.energy for b in parts]))

    def _hits(self, pos, dirs, e, alpha):
        """The nearest hit of every ray: (sid, hit points (zero on a
        miss), absorbed energy)."""
        t, sid = nearest_hit(self.engine.scene, pos, dirs)
        hit = torch.where(torch.isfinite(t)[:, None],
                          pos + t[:, None] * dirs, 0.0)
        absorbed = torch.where(sid >= 0, e * alpha[sid.clamp(min=0).long()],
                               0.0)
        return sid, hit, absorbed

    def _fire_one(self, generator, el: int, min_energy: float):
        """The one-bounce engine trace of one element's bundle: (its first
        record, the energy it emitted)."""
        bund = self._element_source(generator, el)
        res = self.engine.ray_tracer(
            bund, reps=1, min_energy=min_energy, generator=generator,
            opts=TraceOptions(max_bounces=1, min_energy=min_energy))
        return res, float(bund.energy.sum())


class BinnedAxisymmetricRTVF(RTVFBase):
    """View factors of an axisymmetric receiver described by a binning
    scheme (tracer_tpu/analysis/view_factors.py:276, the reference's
    FONaR_RTVF): element i is the wall patch with angular span
    scheme[i,0], z span scheme[i,1] and radius span scheme[i,2] (equal z:
    an annular disc; equal r: a cylinder wall; otherwise a frustum).
    Emission bundles are chosen per patch type, and absorbed energy is
    binned back by the global hit coordinates.

    assembly - scene whose surfaces cover the patches (absorptivity-1
    optics recommended); rays_in - per-element emission orientation
    (True = toward the axis), scalar or (n,) array.
    """

    def __init__(self, assembly, binning_scheme, areas, num_rays=10000,
                 precision=0.01, precision_option="absolute",
                 precision_rec=None, rays_in=True, generator=None,
                 max_iters=200, min_iters=3, batched=True,
                 iters_per_call=8, dtype=torch.float32, device=None):
        self.iters_per_call = int(iters_per_call)
        self.binning_scheme = np.asarray(binning_scheme, dtype=float)
        self.areas = np.asarray(areas, dtype=float)
        self.precision = precision
        self.precision_rec = precision_rec or precision
        self.precision_option = precision_option
        n = len(self.binning_scheme)
        self.rays_in = np.broadcast_to(np.asarray(rays_in), (n,))
        self._init_stats(n, num_rays)
        generator = self._init_engine(assembly, generator, dtype, device)
        fire_all = self._build_fire_all() if batched else None
        if fire_all is not None:
            self._adaptive_loop_batched(generator, max_iters, min_iters,
                                        fire_all)
        else:
            self._adaptive_loop(generator, max_iters, min_iters, self._fire)

    def _windows(self) -> np.ndarray:
        """(n, 6) angle, z and radius windows of the elements, each
        widened by 1e-6."""
        sch, tol = self.binning_scheme, 1e-6
        zz = np.sort(sch[:, 1], axis=1)
        rr = np.sort(sch[:, 2], axis=1)
        return np.stack([sch[:, 0, 0] - tol, sch[:, 0, 1] + tol,
                         zz[:, 0] - tol, zz[:, 1] + tol,
                         rr[:, 0] - tol, rr[:, 1] + tol], axis=1)

    def _build_fire_all(self):
        """The batched iteration: sample all elements, one nearest hit,
        window-bin the destinations and reduce the exchange matrix. None
        when the walls are not black."""
        alpha = self._alpha_rows()
        if alpha is None:
            return None
        n, nrays = self.n_elements, self.num_rays
        wins = torch.as_tensor(self._windows(), dtype=self.dtype,
                               device=self.device)

        def fire_rays(pos, dirs, e):
            _, hit, absorbed = self._hits(pos, dirs, e, alpha)
            ang = torch.atan2(hit[:, 1], hit[:, 0])
            ang = torch.where(ang < 0.0, ang + 2.0 * np.pi, ang)
            z, r = hit[:, 2], torch.hypot(hit[:, 0], hit[:, 1])
            # (N, n) window mask: the host loop's semantics, the
            # tol-overlap double counting at the seams included
            m = ((ang[:, None] >= wins[None, :, 0])
                 & (ang[:, None] <= wins[None, :, 1])
                 & (z[:, None] >= wins[None, :, 2])
                 & (z[:, None] <= wins[None, :, 3])
                 & (r[:, None] >= wins[None, :, 4])
                 & (r[:, None] <= wins[None, :, 5]))
            contrib = torch.where(m, absorbed[:, None], 0.0).double()
            per_src = contrib.view(n, nrays, n).sum(1)
            emitted = e.double().view(n, nrays).sum(1)
            return per_src / emitted[:, None]

        self.fire_rays = fire_rays
        return self._wrap_fire(fire_rays)

    def _element_source(self, generator, el: int):
        ang, zz, rr = self.binning_scheme[el]
        nrays = self.num_rays
        rays_in = bool(self.rays_in[el])
        kw = dict(dtype=self.dtype, device=self.device)
        if zz[0] == zz[1]:      # annular disc
            return disk_bundle(generator, nrays, center=[0, 0, zz[0]],
                               direction=[0, 0, 1.0 if rays_in else -1.0],
                               radius=rr[1], radius_in=rr[0],
                               angular_span=tuple(ang),
                               ang_range=np.pi / 2,
                               flux=1.0 / (0.5 * (ang[1] - ang[0])
                                           * (rr[1] ** 2 - rr[0] ** 2)),
                               **kw)
        if rr[0] == rr[1]:      # cylinder wall
            return vf_cylinder_bundle(
                generator, nrays, rc=rr[0], lc=abs(zz[1] - zz[0]),
                center=[0, 0, 0.5 * (zz[0] + zz[1])],
                direction=[0, 0, np.sign(zz[1] - zz[0])],
                rays_in=rays_in, angular_span=tuple(ang), **kw)
        # frustum
        z0, z1 = (zz[0], zz[1]) if zz[1] > zz[0] else (zz[1], zz[0])
        r0, r1 = (rr[0], rr[1]) if zz[1] > zz[0] else (rr[1], rr[0])
        return vf_frustum_bundle(generator, nrays, r0=r0, r1=r1,
                                 depth=z1 - z0, center=[0, 0, z0],
                                 direction=[0, 0, 1.0], rays_in=rays_in,
                                 angular_span=tuple(ang), **kw)

    def _fire(self, generator, el: int) -> np.ndarray:
        res, emitted = self._fire_one(generator, el, 1e-12)
        rec = res.records[0]
        sid = rec.sid.numpy()
        ok = rec.alive_in.numpy() & (sid >= 0)
        hit = rec.hit.double().numpy()[ok]
        absorbed = rec.absorbed.double().numpy()[ok]
        ang = np.arctan2(hit[:, 1], hit[:, 0])
        ang = np.where(ang < 0.0, ang + 2.0 * np.pi, ang)
        z = hit[:, 2]
        r = np.hypot(hit[:, 0], hit[:, 1])
        out = np.zeros(self.n_elements)
        for j, w in enumerate(self._windows()):
            m = ((ang >= w[0]) & (ang <= w[1]) & (z >= w[2]) & (z <= w[3])
                 & (r >= w[4]) & (r <= w[5]))
            out[j] = absorbed[m].sum()
        return out / emitted


# the reference's class name
FONaR_RTVF = BinnedAxisymmetricRTVF


class TwoNParametersCavityRTVF(RTVFBase):
    """Adaptive MC view factors of a 2N-parameter cavity
    (tracer_tpu/analysis/view_factors.py:415).

    Elements, in order: the aperture, el_FRUs[i] depth-equal slices per
    frustum, el_CON slices of the cone. After construction,
    ``VF_esperance`` holds the converged VF matrix, ``areas`` the
    analytic element areas and ``iterations`` the adaptive iterations.
    """

    def __init__(self, apertureRadius: float, frustaRadii, frustaDepths,
                 coneDepth: float, el_FRUs, el_CON: int,
                 num_rays: int = 10000, precision: float = 0.01,
                 precision_option: str = "absolute",
                 precision_rec: Optional[float] = None,
                 generator: Optional[torch.Generator] = None,
                 max_iters: int = 200, min_iters: int = 3,
                 batched: bool = True, iters_per_call: int = 8,
                 dtype=torch.float32, device=None):
        self.iters_per_call = int(iters_per_call)
        self.aperture_radius = float(apertureRadius)
        self.frusta_radii = [float(r) for r in np.atleast_1d(frustaRadii)]
        self.frusta_depths = [float(d) for d in np.atleast_1d(frustaDepths)]
        self.cone_depth = float(coneDepth)
        self.el_FRUs = [int(e) for e in np.atleast_1d(el_FRUs)]
        self.el_CON = int(el_CON)
        for d, el in zip(self.frusta_depths, self.el_FRUs):
            if d == 0.0 and el != 1:
                # a flat annular step has no depth axis to slice along
                raise ValueError("zero-depth (flat annular step) sections "
                                 "support exactly one element")
        self.num_rays = int(num_rays)
        self.precision = precision
        self.precision_rec = precision_rec or precision
        self.precision_option = precision_option

        n = 1 + sum(self.el_FRUs) + self.el_CON
        self.areas = self._element_areas(n)
        self._init_stats(n, num_rays)
        asm = build_two_n_cavity(self.aperture_radius, self.frusta_radii,
                                 self.frusta_depths, self.cone_depth)
        generator = self._init_engine(asm, generator, dtype, device)
        fire_all = self._build_fire_all() if batched else None
        if fire_all is not None:
            self._adaptive_loop_batched(generator, max_iters, min_iters,
                                        fire_all)
        else:
            self._adaptive_loop(generator, max_iters, min_iters, self._fire)

    def _build_fire_all(self):
        """The batched iteration: sample every element's bundle, one
        nearest hit over the cavity table, bin the destination element on
        the device (z slab per frustum, radius ring on the cone: the
        device twin of bin_cavity_records) and sum the (src, dst) exchange
        matrix by index_add_ over src * (n + 1) + dst (dst = n: no
        element). None when the walls are not black."""
        alpha = self._alpha_rows()
        if alpha is None:
            return None
        n, nrays = self.n_elements, self.num_rays
        dev = self.device
        row_logical = torch.as_tensor(self.engine.meta.row_logical,
                                      device=dev)
        names = self.engine.meta.names
        ap_l, cone_l = names.index("aperture"), names.index("cone")
        frusta, cone_idx = frusta_bins(names, self.el_FRUs,
                                       self.frusta_depths)
        r_last = self.frusta_radii[-1]
        el_con = self.el_CON
        src = torch.arange(n, device=dev).repeat_interleave(nrays)

        def dst_of(sid, hit):
            logical = row_logical[sid.clamp(min=0).long()]
            valid = sid >= 0
            dst = torch.full(sid.shape, n, dtype=torch.int64, device=dev)
            dst = torch.where(valid & (logical == ap_l), 0, dst)
            for f_l, i0, el, z0, d in frusta:
                if d == 0.0:
                    # flat annular step: one element, no depth axis
                    dst = torch.where(valid & (logical == f_l), i0, dst)
                    continue
                b = ((hit[:, 2] - z0) / d * el).to(torch.int64).clamp(
                    0, el - 1)
                dst = torch.where(valid & (logical == f_l), i0 + b, dst)
            rr = torch.hypot(hit[:, 0], hit[:, 1]) / r_last
            b = (el_con * (1.0 - rr)).to(torch.int64).clamp(0, el_con - 1)
            return torch.where(valid & (logical == cone_l), cone_idx + b,
                               dst)

        def fire_rays(pos, dirs, e):
            sid, hit, absorbed = self._hits(pos, dirs, e, alpha)
            flat = src * (n + 1) + dst_of(sid, hit)
            mat = torch.zeros(n * (n + 1), dtype=torch.float64, device=dev)
            mat.index_add_(0, flat, absorbed.double())
            emitted = e.double().view(n, nrays).sum(1)
            return mat.view(n, n + 1)[:, :n] / emitted[:, None]

        self.fire_rays = fire_rays
        return self._wrap_fire(fire_rays)

    # --- geometry bookkeeping ----------------------------------------------
    def _element_areas(self, n: int) -> np.ndarray:
        """Analytic element areas."""
        areas = np.zeros(n)
        areas[0] = np.pi * self.aperture_radius ** 2
        radii_chain = [self.aperture_radius] + self.frusta_radii
        idx = 1
        for k, (el, d) in enumerate(zip(self.el_FRUs, self.frusta_depths)):
            r_in, r_out = radii_chain[k], radii_chain[k + 1]
            if r_in == r_out:
                areas[idx:idx + el] = 2.0 * np.pi * r_out * abs(d) / el
            else:
                L = np.sqrt(d ** 2 + (r_out - r_in) ** 2) / el
                radii = r_in + np.arange(el + 1) * (r_out - r_in) / el
                areas[idx:idx + el] = np.pi * (radii[:-1] + radii[1:]) * L
            idx += el
        r_last = self.frusta_radii[-1]
        radii = r_last + np.arange(self.el_CON + 1) * (-r_last) / self.el_CON
        areas[idx:] = (np.pi * (radii[:-1] + radii[1:])
                       * np.sqrt(self.cone_depth ** 2 + r_last ** 2)
                       / self.el_CON)
        return areas

    # --- element sources -----------------------------------------------------
    def _element_source(self, generator, element: int):
        """Emission bundle of one element."""
        nrays = self.num_rays
        ap_r = self.aperture_radius
        kw = dict(dtype=self.dtype, device=self.device)
        if element == 0:
            return disk_bundle(generator, nrays, center=[0, 0, 0],
                               direction=[0, 0, 1.0], radius=ap_r,
                               ang_range=np.pi / 2,
                               flux=1.0 / (np.pi * ap_r ** 2), **kw)
        idx = 1
        radii_chain = [self.aperture_radius] + self.frusta_radii
        z = 0.0
        for k, (el, d) in enumerate(zip(self.el_FRUs, self.frusta_depths)):
            for e in range(el):
                if element == idx:
                    r0 = radii_chain[k] + e * (radii_chain[k + 1]
                                               - radii_chain[k]) / el
                    r1 = radii_chain[k] + (e + 1) * (radii_chain[k + 1]
                                                     - radii_chain[k]) / el
                    if d == 0.0:
                        # flat annular step: a Lambertian annulus facing
                        # the wider side's section (one element)
                        r_lo, r_hi = sorted((r0, r1))
                        dirn = [0, 0, 1.0] if r1 > r0 else [0, 0, -1.0]
                        return disk_bundle(
                            generator, nrays, center=[0, 0, z],
                            direction=dirn, radius=r_hi, radius_in=r_lo,
                            ang_range=np.pi / 2,
                            flux=1.0 / (np.pi * (r_hi ** 2 - r_lo ** 2)),
                            **kw)
                    if r0 == r1:
                        return vf_cylinder_bundle(
                            generator, nrays, rc=r0, lc=abs(d / el),
                            center=[0, 0, z + (e + 0.5) * d / el],
                            direction=[0, 0, 1.0], rays_in=True, **kw)
                    return vf_frustum_bundle(
                        generator, nrays, r0=r0, r1=r1, depth=d / el,
                        center=[0, 0, z + e * d / el],
                        direction=[0, 0, 1.0], rays_in=(d >= 0.0), **kw)
                idx += 1
            z += d
        # cone elements: sub-frusta of the cone wall
        e = element - idx
        r_last = self.frusta_radii[-1]
        cd = self.cone_depth
        if cd == 0.0:  # flat back plate: annular disc emitters
            r_hi = r_last * (1.0 - e / self.el_CON)
            r_lo = r_last * (1.0 - (e + 1) / self.el_CON)
            return disk_bundle(generator, nrays, center=[0, 0, z],
                               direction=[0, 0, -1.0], radius=r_hi,
                               ang_range=np.pi / 2, radius_in=r_lo,
                               flux=1.0 / (np.pi * (r_hi ** 2 - r_lo ** 2)),
                               **kw)
        r0 = r_last * (1.0 - e / self.el_CON)
        r1 = r_last * (1.0 - (e + 1) / self.el_CON)
        # an outgoing cone (cd > 0): the cavity sees the cone's inside
        return vf_frustum_bundle(generator, nrays, r0=r0,
                                 r1=max(r1, 1e-9 * r_last),
                                 depth=cd / self.el_CON,
                                 center=[0, 0, z + cd * e / self.el_CON],
                                 direction=[0, 0, 1.0], rays_in=(cd > 0.0),
                                 **kw)

    def _fire(self, generator, el: int) -> np.ndarray:
        res, emitted = self._fire_one(generator, el, 1e-10)
        return bin_cavity_records(
            res.records[:1], self.engine.meta, self.el_FRUs,
            self.frusta_depths, self.frusta_radii[-1], self.el_CON) / emitted


class FourParametersCavityRTVF(TwoNParametersCavityRTVF):
    """4-parameter cavity (aperture radius and depth, cone radius and
    depth) over the 2N solver (tracer_tpu/analysis/view_factors.py:687)."""

    def __init__(self, apertureRadius, apertureDepth, coneRadius, coneDepth,
                 el_FRU, el_CON, num_rays=10000, precision=0.01, **kw):
        TwoNParametersCavityRTVF.__init__(
            self, apertureRadius, [coneRadius], [apertureDepth], coneDepth,
            el_FRU, el_CON, num_rays=num_rays, precision=precision, **kw)
