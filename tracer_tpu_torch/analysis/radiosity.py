"""Radiosity system solver for gray diffuse enclosures (the PyTorch
port of tracer_tpu/analysis/radiosity.py).

Given a view-factor matrix and per-element mixed boundary conditions
(temperature or incident flux), build [AA][J] = [bb], solve, and
back-compute emission, temperatures and net fluxes: radiosity_rtvf on the
host in NumPy, and its differentiable torch twin radiosity_rtvf_torch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve

SIGMA = 5.6677e-8  # Stefan-Boltzmann constant, same value as the reference


def radiosity_rtvf(VF, areas, eps, T=None, inc_radiation=None, q_net=None):
    """Solve the enclosure radiosity problem.

    VF - (n,n) view factor matrix.
    areas - (n,) element areas [m^2].
    eps - (n,) emissivities.
    T - (n,) wall temperatures [K], NaN where a flux BC applies.
    inc_radiation - (n,) incident radiation [W/m^2], NaN where a temperature
        BC applies. Exactly one of T/inc_radiation must be set per element.
    q_net - optional (n,) enforced net heat removal [W/m^2] (NaN = none).

    Returns (AA, bb, J, E, T, q, Q):
    J radiosities [W/m^2], E blackbody emissive power [W/m^2],
    T temperatures [K], q net radiative flux [W/m^2], Q net power [W].
    """
    VF = np.asarray(VF, dtype=float)
    areas = np.asarray(areas, dtype=float)
    eps = np.asarray(eps, dtype=float)
    n = VF.shape[0]
    if len(eps) != len(areas):
        raise ValueError("eps and areas lengths differ")

    T = (np.full(n, np.nan) if T is None
         else np.asarray(T, dtype=float).copy())
    inc = (np.full(n, np.nan) if inc_radiation is None
           else np.asarray(inc_radiation, dtype=float).copy())

    has_T = ~np.isnan(T)
    has_q = ~np.isnan(inc)
    if np.any(~has_T & ~has_q):
        raise ValueError("at least one element has no boundary condition")
    if np.any(has_T & has_q):
        raise ValueError("at least one element has two boundary conditions")

    AA = np.eye(n)
    bb = np.zeros(n)
    # flux-specified rows: J_i - sum_j F_ij J_j = G_i
    AA[has_q] -= VF[has_q]
    bb[has_q] += inc[has_q]
    # temperature-specified rows: J_i - (1-eps_i) sum_j F_ij J_j = eps sigma T^4
    AA[has_T] -= VF[has_T] * (1.0 - eps[has_T][:, None])
    bb[has_T] += eps[has_T] * SIGMA * T[has_T] ** 4

    if q_net is not None:
        q_net = np.asarray(q_net, dtype=float)
        m = ~np.isnan(q_net)
        bb[m] -= q_net[m]

    J = np.linalg.solve(AA, bb)

    q = np.zeros(n)
    for i in range(n):
        if has_T[i]:
            E_i = SIGMA * T[i] ** 4
            if eps[i] != 1.0:
                q[i] = eps[i] / (1.0 - eps[i]) * (E_i - J[i])
            else:
                q[i] = E_i - VF[i] @ J
        else:
            q[i] = bb[i]
            T[i] = (1.0 / SIGMA * (J[i] + (1.0 - eps[i]) / eps[i] * q[i])) ** 0.25

    E = SIGMA * T ** 4
    Q = areas * q
    return AA, bb, J, E, T, q, Q


def radiosity_rtvf_torch(VF, areas, eps, T, inc_radiation, has_T,
                         q_net=None, device=None):
    """Differentiable torch twin of :func:`radiosity_rtvf`
    (tracer_tpu/analysis/radiosity.py:82-138): autograd carries gradients
    through the linear solve into VF, eps, T and inc_radiation.

    The boundary conditions are explicit: ``has_T`` is a boolean array
    (True = temperature BC, False = incident-flux BC); the entries of
    ``T`` / ``inc_radiation`` it does not select are ignored (NaNs there
    are masked before use, so they poison neither values nor gradients).
    ``q_net`` is an optional (values, mask) pair. A tensor ``VF`` sets
    the dtype and device; an array-like one becomes float64 on
    ``device`` (None means the GPU), and so do the other array-likes.

    Returns (J, E, T, q, Q), radiosity_rtvf's outputs without the
    system matrices."""
    if not torch.is_tensor(VF):
        VF = torch.as_tensor(np.asarray(VF, dtype=float),
                             device=resolve(device))

    def t(x):
        return (x if torch.is_tensor(x) else torch.as_tensor(
            np.asarray(x, dtype=float), dtype=VF.dtype, device=VF.device))

    areas, eps = t(areas), t(eps)
    has_T = torch.as_tensor(np.asarray(has_T, dtype=bool), device=VF.device)
    n = VF.shape[0]
    T_in = torch.where(has_T, t(T), 0.0)
    inc = torch.where(has_T, 0.0, t(inc_radiation))
    # temperature rows: J - (1-eps) F J = eps sigma T^4
    # flux rows:        J -         F J = G
    w = torch.where(has_T, 1.0 - eps, 1.0)
    AA = torch.eye(n, dtype=VF.dtype, device=VF.device) - VF * w[:, None]
    bb = torch.where(has_T, eps * SIGMA * T_in ** 4, inc)
    if q_net is not None:
        q_vals, q_mask = q_net
        bb = bb - torch.where(torch.as_tensor(np.asarray(q_mask, dtype=bool),
                                              device=VF.device),
                              t(q_vals), 0.0)
    J = torch.linalg.solve(AA, bb)
    # net fluxes and temperatures per BC type, the reference's
    # per-element branches as one where-chain
    E_T = SIGMA * T_in ** 4
    eps_safe = torch.where(eps < 1.0, eps, 0.5)
    black = eps >= 1.0
    q_T = torch.where(black, E_T - VF @ J,
                      eps / torch.where(black, 1.0, 1.0 - eps_safe)
                      * (E_T - J))
    q = torch.where(has_T, q_T, bb)
    eps_pos = torch.where(eps > 0.0, eps, 1.0)
    arg = torch.where(has_T, 1.0, (J + (1.0 - eps) / eps_pos * q) / SIGMA)
    pos = arg > 0.0   # double where: x**0.25 has an infinite slope at 0
    T_q = torch.where(pos, torch.where(pos, arg, 1.0) ** 0.25, 0.0)
    T_out = torch.where(has_T, T_in, T_q)
    E = SIGMA * T_out ** 4
    Q = areas * q
    return J, E, T_out, q, Q
