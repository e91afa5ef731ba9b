"""2N-parameter axisymmetric cavity receiver: solar trace binning, MC view
factors, radiosity emission losses, and an iterative energy balance with a
pluggable wall-temperature model (the PyTorch port of
tracer_tpu/models/two_n_cavity.py).

The reference's temperature_guess depends on external tube-material and
steam-property packages that are absent from its own repository; here
the coolant and conduction coupling is a pluggable callable.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..analysis.radiosity import radiosity_rtvf
from ..analysis.view_factors import (TwoNParametersCavityRTVF,
                                     bin_cavity_records, build_two_n_cavity)
from .. import materials as M
from ..scene import Assembly


class TwoNParamCav(Assembly):
    """Aperture + frusta/cylinders + cone cavity with Lambertian absorbing
    walls of emissivity eps_wall."""

    def __init__(self, apertureRadius: float, frustaRadii: Sequence[float],
                 frustaDepths: Sequence[float], coneDepth: float,
                 eps_wall: float = 0.87, el_FRUs=1, el_CON=1):
        self.aperture_radius = float(apertureRadius)
        self.frusta_radii = [float(r) for r in np.atleast_1d(frustaRadii)]
        self.frusta_depths = [float(d) for d in np.atleast_1d(frustaDepths)]
        self.cone_depth = float(coneDepth)
        self.eps_wall = eps_wall
        self.el_FRUs = [int(e) for e in np.atleast_1d(el_FRUs)]
        self.el_CON = int(el_CON)

        # walls: absorbing Lambertian receivers. Aperture: the reference's
        # solar cavity has an OPEN aperture (rays enter freely,
        # Two_N_parameters_cavity.py builds no aperture disc); here a
        # BIFACIAL disc keeps the VF element-0 bookkeeping while letting
        # solar in — transparent seen from outside, black absorber seen
        # from inside, so bin_hits' "aperture" element measures exactly
        # the power escaping back out the opening.
        asm = build_two_n_cavity(
            self.aperture_radius, self.frusta_radii, self.frusta_depths,
            self.cone_depth,
            optics=lambda: M.receiver(M.lambertian(absorptivity=eps_wall)),
            aperture_optics=lambda: M.bifacial(
                M.receiver(M.lambertian(absorptivity=1.0)),
                M.transparent()))
        Assembly.__init__(self, objects=asm.objects,
                          subassemblies=asm.assemblies)
        self.VF = None
        self.areas = None

    # -- MC view factors ------------------------------------------------------
    def VF_sim(self, num_rays: int = 10000, precision: float = 0.01,
               generator=None, dtype=torch.float32, device=None):
        """The cavity's MC view factors and element areas
        (analysis.view_factors.TwoNParametersCavityRTVF on ``device``,
        None meaning the GPU)."""
        rt = TwoNParametersCavityRTVF(
            self.aperture_radius, self.frusta_radii, self.frusta_depths,
            self.cone_depth, self.el_FRUs, self.el_CON,
            num_rays=num_rays, precision=precision, generator=generator,
            dtype=dtype, device=device)
        self.VF = rt.VF_esperance
        self.areas = rt.areas
        return self.VF, self.areas

    # -- solar input binning ---------------------------------------------------
    def bin_hits(self, result) -> np.ndarray:
        """Absorbed solar power per radiosity element from a TraceResult of
        a solar trace onto this cavity."""
        return bin_cavity_records(result.records, result.meta, self.el_FRUs,
                                  self.frusta_depths, self.frusta_radii[-1],
                                  self.el_CON)

    # -- radiosity emission losses ----------------------------------------------
    def emi_sim(self, T_wall=None, inc_radiation=None, T_amb: float = 293.15):
        """Radiosity solve over the cavity elements. The aperture (element
        0) is a black surface at ambient; walls carry either temperature or
        flux boundary conditions. Returns (T, q, Q)."""
        if self.VF is None:
            raise RuntimeError("run VF_sim first")
        n = self.VF.shape[0]
        eps = np.concatenate([[1.0], np.full(n - 1, self.eps_wall)])
        T = np.full(n, np.nan)
        T[0] = T_amb
        inc = np.full(n, np.nan)
        if T_wall is not None:
            T[1:] = np.broadcast_to(np.asarray(T_wall, dtype=float), (n - 1,))
        if inc_radiation is not None:
            inc[1:] = np.broadcast_to(np.asarray(inc_radiation, dtype=float),
                                      (n - 1,))
            T[1:] = np.nan
        AA, bb, J, E, T_out, q, Q = radiosity_rtvf(
            self.VF, self.areas, eps, T=T, inc_radiation=inc)
        return T_out, q, Q

    # -- coupled balance --------------------------------------------------------
    def energy_balance(self, solar_result, temperature_model:
                       Optional[Callable[[np.ndarray], np.ndarray]] = None,
                       T_init: float = 800.0, tol: float = 0.5,
                       max_iters: int = 50, T_amb: float = 293.15):
        """Iterate wall temperatures against radiosity losses.

        temperature_model(Q_net_per_element) -> wall temperatures; this is
        the pluggable stand-in for the reference's tube-hydraulics
        temperature_guess (whose steam-property dependencies are not in its
        repository). Default: fixed-temperature walls at T_init.

        Returns dict(T, q, Q, solar_in, emissive_losses).
        """
        solar_in = self.bin_hits(solar_result)
        n = len(solar_in)
        T_wall = np.full(n - 1, T_init)
        for _ in range(max_iters):
            T, q, Q = self.emi_sim(T_wall=T_wall, T_amb=T_amb)
            if temperature_model is None:
                break
            net = solar_in[1:] - Q[1:]
            T_new = np.asarray(temperature_model(net), dtype=float)
            if np.max(np.abs(T_new - T_wall)) < tol:
                T_wall = T_new
                break
            T_wall = T_new
        losses = Q[1:].sum()
        return dict(T=T, q=q, Q=Q, solar_in=solar_in,
                    emissive_losses=losses)
