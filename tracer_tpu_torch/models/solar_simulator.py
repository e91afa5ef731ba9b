"""High-flux solar simulator: ellipsoidal reflector modules with plasma-arc
lamp models, flux-mapped targets, and a batched simulate loop with Welford
confidence intervals (the PyTorch port of
tracer_tpu/models/solar_simulator.py).

The lamps draw their rays on the device from an explicit
``torch.Generator`` with the port's samplers, and each lamp's frame and
its module's frame are applied there (vector_utils.rotate_z_to_normal_t),
so a batch reaches the trace without a host copy. Every batch traces on
``TracerEngine.ray_tracer`` with ``record="tags"``: only the targets'
hits are recorded and copied to the host, where the targets bin them.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch

from .. import geometry as G
from .. import materials as M
from ..analysis.estimator import Estimator
from ..bundle import RayBundle, concatenate_rays
from ..device import resolve
from ..engine import TraceOptions, TracerEngine
from ..sampling import (PWLinearDistribution, _uniform, cylinder_sampling,
                        lambertian_directions_sampling, sphere_sampling)
from ..scene import Assembly, AssembledObject, Surface
from ..spatial import rotation_to_z
from ..vector_utils import rotate_z_to_normal_t


class Target(AssembledObject):
    """Transparent flux-mapping plate: rays pass through unchanged while
    their incident energy is recorded; the fluxmap is a Welford estimator
    over batches (tracer_tpu's Target)."""

    def __init__(self, width, height, location, normal, binx, biny,
                 name="target"):
        geom = G.rect_plate(binx[-1] - binx[0], biny[-1] - biny[0])
        opt = M.with_accounting(M.transparent(), "reception", "location")
        rot = rotation_to_z(np.asarray(normal, dtype=float))
        AssembledObject.__init__(self, surfs=[Surface(geom, opt, name=name)],
                                 location=location, rotation=rot)
        self.name = name
        self.binx, self.biny = np.asarray(binx), np.asarray(biny)
        self.areas = (np.diff(self.binx)[:, None] * np.diff(self.biny)[None, :])
        self.fluxmap = Estimator()

    def evaluate_fluxmap(self, result):
        """Update the fluxmap estimator from a TraceResult's hits. Local
        hit coordinates are shifted by the bin arrays' centre, so that
        bins not centred on 0 still address the plate, which is
        bin-span-sized and centred on its own origin (tracer_tpu's
        documented deviation from the reference, which histograms raw
        local coordinates)."""
        hits = result.hits_of(self.name, keys=("local", "e_in"))
        power = self.power(hits["local"], hits["e_in"])
        self.fluxmap.update(power[None, ...] / self.areas)
        return self.fluxmap

    def power(self, local, energy):
        """(nx, ny) binned ``energy`` of hits at plate-local points
        ``local`` (n, 3), shifted by the bin arrays' centre."""
        if not len(energy):
            return np.zeros((len(self.binx) - 1, len(self.biny) - 1))
        cx = 0.5 * (self.binx[0] + self.binx[-1])
        cy = 0.5 * (self.biny[0] + self.biny[-1])
        return np.histogram2d(local[:, 0] + cx, local[:, 1] + cy,
                              bins=(self.binx, self.biny),
                              weights=energy)[0]


class SimulatorReflector(AssembledObject):
    """Truncated ellipsoidal mirror; the lamp sits at the first focus."""

    def __init__(self, a, b, c, zlim, location, rotation,
                 reflectivity=0.9, slope_error=2.5e-3, bi_var=False):
        eccentricity = np.sqrt(1.0 - a**2 / c**2)
        half_focal_dist = c * eccentricity
        geom = G.ellipsoid(a, b, c).with_aperture(G.zrange(zlim[0], zlim[1]))
        opt = M.reflective(1.0 - reflectivity, slope_error, bi_var)
        AssembledObject.__init__(
            self, surfs=[Surface(geom, opt,
                                 location=[0.0, 0.0, half_focal_dist],
                                 name="reflector")],
            location=location, rotation=rotation)
        self.eccentricity = eccentricity
        self.focal_dist = 2.0 * half_focal_dist


def _place(pos, dirs, direction, location):
    """Rays drawn about +Z turned onto ``direction`` and moved to
    ``location``, on their device."""
    loc = torch.as_tensor(np.asarray(location, dtype=float),
                          dtype=pos.dtype, device=pos.device)
    return (rotate_z_to_normal_t(pos, direction) + loc,
            rotate_z_to_normal_t(dirs, direction))


class SimulatorLampBader:
    """Plasma-arc lamp: cylindrical emission volume with a tabulated polar
    emission CDF (Bader et al. 2015, doi:10.1115/1.4028702). theta_CDF:
    (n,2) [theta, CDF] array or a path to such a whitespace table; None
    is the isotropic-in-theta CDF over [-pi/2, pi/2]."""

    def __init__(self, P_elec=2.5e3, eff_el=0.6, r_c=7.5e-4, l_c=4.5e-3,
                 theta_CDF=None, location=(0, 0, 0), direction=(0, 0, 1)):
        self.P = eff_el * P_elec
        self.r_c, self.l_c = r_c, l_c
        self.loc = np.asarray(location, dtype=float)
        self.dir = np.asarray(direction, dtype=float)
        if theta_CDF is None:
            ths = np.linspace(-np.pi / 2, np.pi / 2, 91)
            data = np.stack([ths, (ths + np.pi / 2) / np.pi], axis=1)
        elif isinstance(theta_CDF, str):
            data = np.loadtxt(theta_CDF)
        else:
            data = np.asarray(theta_CDF, dtype=float)
        integs = np.diff(data[:, 1])
        dths = np.diff(data[:, 0])
        pdf = integs / dths
        self._dist = PWLinearDistribution(data[:-1, 0] + dths / 2.0, pdf)

    def generate_rays(self, generator, n_rays, part_load=1.0,
                      dtype=torch.float32, device=None) -> RayBundle:
        """n_rays rays of P part_load in all, drawn from ``generator`` on
        ``device`` (None means the GPU)."""
        device = resolve(device)
        P = self.P * part_load
        phi = _uniform(generator, n_rays, dtype, device, 0.0, 2 * np.pi)
        r = self.r_c * torch.sqrt(_uniform(generator, n_rays, dtype, device))
        z = _uniform(generator, n_rays, dtype, device, -self.l_c / 2,
                     self.l_c / 2)
        verts = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], 1)
        thetas, _ = self._dist.sample(generator, n_rays, dtype, device)
        phis = _uniform(generator, n_rays, dtype, device, 0.0, 2 * np.pi)
        s = torch.sin(thetas)
        dirs = torch.stack([s * torch.cos(phis), s * torch.sin(phis),
                            torch.cos(thetas)], 1)
        verts, dirs = _place(verts, dirs, self.dir, self.loc)
        return RayBundle.create(pos=verts, dir=dirs, energy=P / n_rays,
                                device=device)


class SimulatorLampZhu:
    """Plasma-arc lamp as a sphere and two cylinder emitters (Zhu et al.
    2020, doi:10.1016/j.apenergy.2020.115165)."""

    def __init__(self, P_elec=7e3, eff_el=0.6, alpha_s=0.3, beta_c1=0.0412,
                 gamma_c2=0.6588, location=(0, 0, 0), direction=(0, 0, 1)):
        self.a_s, self.b_c1, self.g_c2 = alpha_s, beta_c1, gamma_c2
        self.r_s = 0.5e-3 / 2.0
        self.r_c2 = 2e-3 / 2.0
        self.l_c = 10e-3
        self.P = eff_el * (alpha_s + beta_c1 + gamma_c2) * P_elec
        self.loc = np.asarray(location, dtype=float)
        self.dir = np.asarray(direction, dtype=float)

    def counts(self, n_rays):
        """Rays of the sphere and of the two cylinders: int(n a_s),
        int(n b_c1) and the rest."""
        n_s = int(n_rays * self.a_s)
        n_c1 = int(n_rays * self.b_c1)
        return n_s, n_c1, n_rays - n_s - n_c1

    def generate_rays(self, generator, n_rays, part_load=1.0,
                      dtype=torch.float32, device=None) -> RayBundle:
        """The three emitters' rays, each component carrying its fraction
        of the power in units of P / (a_s + b_c1 + g_c2), so that the
        emitted power totals P part_load whatever the fractions sum to
        (tracer_tpu's documented deviation: the reference multiplies each
        component by its fraction on top of P)."""
        device = resolve(device)
        P_unit = part_load * self.P / (self.a_s + self.b_c1 + self.g_c2)
        n_s, n_c1, n_c2 = self.counts(n_rays)
        f = dict(dtype=dtype, device=device)
        vs, nms = sphere_sampling(generator, self.r_s, n_s, **f)
        vs[:, 2] -= self.l_c / 2 - self.r_s
        ds = lambertian_directions_sampling(generator, n_s, normals=nms, **f)
        parts = [RayBundle.create(pos=vs, dir=ds,
                                  energy=P_unit * self.a_s / n_s, **f)]
        for n_c, r, frac in ((n_c1, self.r_s, self.b_c1),
                             (n_c2, self.r_c2, self.g_c2)):
            vc, nc = cylinder_sampling(generator, r, self.l_c, n_c, **f)
            dc = lambertian_directions_sampling(generator, n_c, normals=nc,
                                                **f)
            parts.append(RayBundle.create(pos=vc, dir=dc,
                                          energy=P_unit * frac / n_c, **f))
        bund = concatenate_rays(parts)
        pos, dirs = _place(bund.pos, bund.dir, self.dir, self.loc)
        return bund.replace(pos=pos, dir=dirs)


_LAMPS = {"Bader": SimulatorLampBader, "Zhu": SimulatorLampZhu}


class SolarSimulatorModule(Assembly):
    """One reflector and its lamp at the reflector's first focus."""

    def __init__(self, a, b, c, zlim, reflectivity=0.9, slope_error=2.5e-3,
                 bi_var=False, lampdict=None,
                 first_focus_location=(0, 0, 0), aiming_vector=(0, 0, 1)):
        self.location = np.asarray(first_focus_location, dtype=float)
        self.aiming_vector = np.asarray(aiming_vector, dtype=float)
        self.rotation = rotation_to_z(self.aiming_vector)
        self.reflector = SimulatorReflector(a, b, c, zlim, self.location,
                                            self.rotation, reflectivity,
                                            slope_error, bi_var)
        Assembly.__init__(self, objects=[self.reflector])
        lampdict = dict(lampdict or {"model": "Bader"})
        model = lampdict.pop("model")
        self.lamp = _LAMPS[model](**lampdict)

    def fire_lamp(self, generator, nrays, part_load=1.0,
                  dtype=torch.float32, device=None) -> RayBundle:
        """The lamp's rays in the module's frame, on ``device``."""
        source = self.lamp.generate_rays(generator, nrays,
                                         part_load=part_load, dtype=dtype,
                                         device=device)
        pos, dirs = _place(source.pos, source.dir, self.aiming_vector,
                           self.location)
        return source.replace(pos=pos, dir=dirs)


class SolarSimulator(Assembly):
    """Multi-module simulator with flux-mapped targets."""

    def __init__(self, modules_positions, modules_directions, modules_dicts,
                 targets: Sequence[Target], homogenizer=None):
        self.modules = [
            SolarSimulatorModule(**modules_dicts[i],
                                 first_focus_location=modules_positions[i],
                                 aiming_vector=modules_directions[i])
            for i in range(len(modules_positions))]
        self.targets = list(targets)
        objects = list(targets)
        subasm = list(self.modules)
        if homogenizer is not None:
            subasm.append(homogenizer)
        Assembly.__init__(self, subassemblies=subasm, objects=objects)

    def fire(self, generator, ray_batch, part_load=1.0, dtype=torch.float32,
             device=None) -> RayBundle:
        """One batch: every module's ``ray_batch`` rays, in module order."""
        return concatenate_rays([
            m.fire_lamp(generator, ray_batch, part_load=part_load,
                        dtype=dtype, device=device) for m in self.modules])

    def simulate(self, nrays, part_load=1.0, ray_batch=10_000,
                 save_dir: Optional[str] = None,
                 generator: Optional[torch.Generator] = None, reps=20,
                 dtype=torch.float32, device=None, engine=None):
        """int(nrays / ray_batch) batches of ``ray_batch`` rays a module,
        each traced to ``reps`` bounces and binned by every target, whose
        estimator gives the Welford confidence intervals. ``generator``
        (on ``device``; None: one seeded with 0) draws the lamps' rays and
        the shading. Optionally saves fluxmap_%i.csv and
        confidence_intervals_%i.csv per target. ``engine`` reuses a
        TracerEngine compiled from this simulator (one is compiled in
        ``dtype`` on ``device`` otherwise). Returns the targets."""
        device = resolve(device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        if engine is None:
            engine = TracerEngine(self, dtype=dtype, device=device)
        dtype = engine.scene.frame.dtype
        opts = TraceOptions(max_bounces=reps, record="tags")
        ray_batch = int(min(ray_batch, nrays))
        for _ in range(int(nrays / ray_batch)):
            source = self.fire(generator, ray_batch, part_load, dtype,
                               device)
            res = engine.ray_tracer(source, generator=generator, opts=opts)
            for t in self.targets:
                t.evaluate_fluxmap(res)
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            for j, t in enumerate(self.targets):
                self._save_map(os.path.join(save_dir, f"fluxmap_{j}.csv"),
                               t, np.asarray(t.fluxmap.mean))
                self._save_map(
                    os.path.join(save_dir, f"confidence_intervals_{j}.csv"),
                    t, np.asarray(t.fluxmap.ci))
        return self.targets

    @staticmethod
    def _save_map(path, target, arr):
        with open(path, "w") as fo:
            fo.write("bins_x," + ",".join(str(e) for e in target.binx) + "\n")
            fo.write("bins_y," + ",".join(str(e) for e in target.biny) + "\n")
            for row in np.atleast_2d(arr):
                fo.write(",".join(str(v) for v in row) + "\n")


def high_flux_simulator(n_ring=6, ring_angle=np.pi / 6, a=0.4, b=0.4,
                        c=1.0, zlim=(-0.99, -0.6), lampdict=None,
                        target_size=0.2, target_bins=50) -> SolarSimulator:
    """A multi-lamp high-flux simulator: one module on the axis and
    ``n_ring`` on a ring at ``ring_angle`` from it (azimuths evenly
    spaced), every first focus one focal distance from the common second
    focus at the origin and every module aimed at it; a ``target_size``
    square Target of ``target_bins`` x ``target_bins`` bins there faces
    the modules (normal -z). The defaults: reflectors a = b = 0.4 m,
    c = 1.0 m, zlim (-0.99, -0.6) (focal distance 1.833 m, a 0.32 m rim
    0.317 m ahead of the lamp), Zhu lamps at their default 7 kW."""
    lampdict = lampdict or {"model": "Zhu"}
    ecc = np.sqrt(1.0 - a**2 / c**2)
    focal = 2.0 * c * ecc
    aims = [np.array([0.0, 0.0, 1.0])]
    for k in range(n_ring):
        phi = 2.0 * np.pi * k / n_ring
        aims.append(np.array([np.sin(ring_angle) * np.cos(phi),
                              np.sin(ring_angle) * np.sin(phi),
                              np.cos(ring_angle)]))
    bins = np.linspace(-target_size / 2, target_size / 2, target_bins + 1)
    target = Target(target_size, target_size, location=[0.0, 0.0, 0.0],
                    normal=[0.0, 0.0, -1.0], binx=bins, biny=bins)
    module = dict(a=a, b=b, c=c, zlim=zlim)
    return SolarSimulator([-focal * u for u in aims], aims,
                          [dict(module, lampdict=dict(lampdict))
                           for _ in aims], [target])
