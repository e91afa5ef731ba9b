"""Shading: apply each hit surface's optics to its rays (the PyTorch port
of tracer_tpu/kernels/shade.py).

Every optics kind of materials.K_*: specular rows with spectral
absorptance, the Martin-Ruiz incidence-angle modifier (its exponent per
row, so mixed exponents shade) and radial or bivariate slope error (sigma
p1 on K_REFLECT rows, p2 on the others); the Lambertian family
(Lambertian, Lambertian-specular, semi-Lambertian, the piecewise rows with
their spectral and direction-dependent tables); the refractive interface
with dispersive indices, the medium toggle of index-matched volumetric
interfaces and either the Fresnel roulette or, under ``split_mode``, the
energy split; Cook-Torrance, the Fresnel conductor, periodic and
transparent rows; the one-sided kill. The per-ray surface data comes
either from the winner's aux carried out of the nearest-hit kernel (K3),
with the parameter row gathered where a kind reads more than p0 and p1,
or from a gather of each ray's row (the float64 oracle path).

Each random draw is made only when the scene's kinds use it, from an
explicit ``torch.Generator``; the same seed gives other numbers than
jax.random, so random outputs compare with tracer_tpu statistically.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from .. import materials as M
from ..mathutils import (dot, normalize, rotate_to_normal, safe_arccos,
                         safe_sqrt)
from ..optics import (fresnel, fresnel_to_attenuating, reflections,
                      refractions)

# optics kinds whose parameters beyond p0 and p1 the shade reads: K3's aux
# carries only those two, so these scenes gather the parameter row
_EXTENDED_PARAM_KINDS = {M.K_LAMBERTIAN_SPECULAR, M.K_REFLECT_SPECTRAL,
                         M.K_REFRACTIVE, M.K_COOK_TORRANCE,
                         M.K_FRESNEL_CONDUCTOR, M.K_LAMBERTIAN_PIECEWISE}


class ShadeResult(NamedTuple):
    out_pos: torch.Tensor       # (N,3) next-segment origin (global)
    out_dir: torch.Tensor       # (N,3) next-segment direction
    out_energy: torch.Tensor    # (N,)
    out_ref_index: torch.Tensor  # (N,)
    out_medium: tuple           # (att, scat, g) each (N,): entered medium
    absorbed: torch.Tensor      # (N,) energy deposited on the hit surface
    local_pt: torch.Tensor      # (N,3) hit point in surface-local coords
    normal: torch.Tensor        # (N,3) shading normal (global, against ray)
    backside: torch.Tensor      # (N,) bool, hit arrived along local +Z
    split: Optional[tuple] = None  # energy-splitting interfaces only:
    #   (mask (N,) bool, secondary energy (N,), reflected dir (N,3))


def _segment_locate(x, start, length, tab_x):
    """Per ray, the count k of entries <= x in its [start, start + length)
    slice of ``tab_x``, with the slice's integer start and length (at
    least 1)."""
    start = start.long()
    length = length.long().clamp(min=1)
    idx = torch.arange(tab_x.shape[0], device=x.device)
    in_seg = ((idx[None, :] >= start[:, None])
              & (idx[None, :] < (start + length)[:, None]))
    xs = torch.where(in_seg, tab_x[None, :], math.inf)
    return (xs <= x[:, None]).sum(1), start, length


def _lerp_weight(x, x0, x1):
    same = x1 == x0
    w = torch.where(same, 0.0, (x - x0) / torch.where(same, 1.0, x1 - x0))
    return w.clamp(0.0, 1.0)


def _interp_segment(x, start, length, tab_x, tab_y):
    """Per-ray linear interpolation inside each ray's [start, start +
    length) slice of the shared table; outside it clamps to the slice's
    edge values."""
    k, start, length = _segment_locate(x, start, length, tab_x)
    last = start + length - 1
    lo = torch.minimum(torch.maximum(start + k - 1, start), last)
    hi = torch.minimum(torch.maximum(start + k, start), last)
    return tab_y[lo] + _lerp_weight(x, tab_x[lo], tab_x[hi]) * (
        tab_y[hi] - tab_y[lo])


def _interp2_segment(th, wl, th_start, T, wl_start, W, grid_start, tab_x,
                     tab_y):
    """Per-ray bilinear interpolation on a (T, W) grid packed into the
    shared table: the axis values lie in tab_x at [th_start, th_start + T)
    and [wl_start, wl_start + W), the grid values row-major in tab_y from
    grid_start. Every start and length is per ray."""
    def axis_locate(x, start, length):
        k, start, length = _segment_locate(x, start, length, tab_x)
        lo = torch.minimum(torch.maximum(start + k - 1, start),
                           start + length - 2)
        return lo - start, _lerp_weight(x, tab_x[lo], tab_x[lo + 1]), length

    i, wt, _ = axis_locate(th, th_start, T)
    j, ww, w_i = axis_locate(wl, wl_start, W)
    base = grid_start.long() + i * w_i + j
    g00, g01 = tab_y[base], tab_y[base + 1]
    g10, g11 = tab_y[base + w_i], tab_y[base + w_i + 1]
    return ((1 - wt) * ((1 - ww) * g00 + ww * g01)
            + wt * ((1 - ww) * g10 + ww * g11))


def _uniform(generator, n, like, scale: float = 1.0):
    u = torch.rand(n, generator=generator, dtype=like.dtype,
                   device=generator.device).to(like.device)
    return u * scale if scale != 1.0 else u


def _normals(n, generator, like):
    return torch.randn(n, generator=generator, dtype=like.dtype,
                       device=generator.device).to(like.device)


def _cosine_lobe(phi, sin_theta, ns):
    """Directions at polar sine ``sin_theta`` and azimuth ``phi`` about
    the normals ``ns``."""
    return rotate_to_normal(torch.stack([
        torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
        torch.sqrt((1.0 - sin_theta ** 2).clamp(min=0.0))], dim=1), ns)


def shade(scene, sid, t, pos, dirs, energy, wavelength, ref_index,
          generator: torch.Generator, medium=None, aux=None,
          split_mode: bool = False) -> ShadeResult:
    """Shade every ray against its hit row (sid >= 0; other lanes get
    finite outputs that the engine masks). ``aux``, the winner's shading
    data from K3 (kernels/nearest.py), replaces the per-ray geometry
    gather. ``medium`` is the rays' (att, scat, g), None for none.
    ``generator`` draws every random number. With ``split_mode`` the
    energy-splitting refractive rows (F_SPLIT) always cross at (1 - R) of
    the energy and ``split`` returns the reflected branch; without it
    they roulette like the others."""
    n = pos.shape[0]
    s = sid.clamp(min=0).long()
    kinds = set(scene.kinds_present) or {M.K_REFLECT}
    features = set(scene.features)
    n_prm = scene.opt_params.shape[1]
    t_safe = torch.where(torch.isfinite(t), t, 0.0)
    hit_g = pos + t_safe[:, None] * dirs

    needs_full_prm = bool(kinds & _EXTENDED_PARAM_KINDS) or "iam" in features
    if aux is not None:
        p_l = aux["local"]
        n_geom = normalize(aux["normal"], eps=1e-30)
        kind, flags = aux["kind"], aux["flags"]
        backside = aux["up_dot"] > 0.0
        if needs_full_prm:
            prm = scene.opt_params.index_select(0, s)
        else:
            prm = torch.nn.functional.pad(
                torch.stack([aux["p0"], aux["p1"]], dim=1), (0, n_prm - 2))
    else:
        # index_select, not t[s]: the backward of a differentiable trace
        # (diff.trace_diff) is then index_add_, where t[s]'s sorts the
        # indices and sums each row's duplicates serially
        fr = scene.frame.index_select(0, s)
        rot = fr[:, :3, :3]                            # (N,3,3)
        trn = fr[:, :3, 3]
        quad = scene.quadric.index_select(0, s)
        prm = scene.opt_params.index_select(0, s)
        kind, flags = scene.opt_kind[s], scene.opt_flags[s]
        # local coordinates p_l = R^T (p - t0)
        rel = hit_g - trn
        p_l = torch.stack([(rot[:, :, i] * rel).sum(1) for i in range(3)],
                          dim=1)
        x, y, z = p_l.unbind(1)
        # quadric gradient at the local hit point, (A p + b)
        grad = torch.stack([
            quad[:, 0] * x + quad[:, 3] * y + quad[:, 4] * z + quad[:, 6],
            quad[:, 3] * x + quad[:, 1] * y + quad[:, 5] * z + quad[:, 7],
            quad[:, 4] * x + quad[:, 5] * y + quad[:, 2] * z + quad[:, 8],
        ], dim=1)
        n_geom = torch.stack(
            [(rot[:, i, :] * normalize(grad, eps=1e-30)).sum(1)
             for i in range(3)], dim=1)
        backside = (dirs * rot[:, :, 2]).sum(1) > 0.0

    cos_geom = dot(dirs, n_geom)
    # the shading normal opposes the incoming ray
    ns = torch.where(cos_geom[:, None] > 0.0, -n_geom, n_geom)

    needs_diffuse = bool(kinds & {M.K_LAMBERTIAN, M.K_LAMBERTIAN_SPECULAR,
                                  M.K_SEMI_LAMBERTIAN,
                                  M.K_LAMBERTIAN_PIECEWISE})
    needs_choice = bool(kinds & {M.K_LAMBERTIAN_SPECULAR, M.K_REFRACTIVE,
                                 M.K_LAMBERTIAN_PIECEWISE})
    needs_slope = "slope_error" in features

    # ---- random draws, only those the scene's optics need
    phi = (_uniform(generator, n, pos, 2.0 * math.pi)
           if needs_diffuse or needs_slope else None)
    u1 = _uniform(generator, n, pos) if needs_diffuse else None
    u_choice = _uniform(generator, n, pos) if needs_choice else None

    # ---- effective absorptivity (spectral and IAM variants)
    absorptivity = prm[:, 0]
    if "spectral" in features:
        spec_abs = _interp_segment(wavelength, prm[:, 0], prm[:, 1],
                                   scene.spectral_wl, scene.spectral_ab)
        absorptivity = torch.where(kind == M.K_REFLECT_SPECTRAL, spec_abs,
                                   absorptivity)
    cos_aoi = dot(dirs, ns).abs()
    if "iam" in features:
        # Martin-Ruiz modifier, the row's exponent c in p5; cos is kept
        # away from 0 so that c < 1 makes no 0**c
        a_r = torch.where(prm[:, 4] > 0.0, prm[:, 4], 1.0)
        c_exp = torch.where(prm[:, 5] > 0.0, prm[:, 5], 1.0)
        cos_c = cos_aoi.clamp(1e-12, 1.0) ** c_exp
        iam_f = (1.0 - torch.exp(-cos_c / a_r)) / (1.0 - torch.exp(-1.0 / a_r))
        absorptivity = torch.where((flags & M.F_IAM) != 0,
                                   absorptivity * iam_f, absorptivity)

    # ---- perturbed normal for slope error
    n_eff = ns
    if needs_slope:
        nrm1 = _normals(n, generator, pos)
        sigma = torch.where(kind == M.K_REFLECT, prm[:, 1], prm[:, 2])
        th = nrm1 * sigma
        err = torch.stack([torch.sin(th) * torch.cos(phi),
                           torch.sin(th) * torch.sin(phi),
                           torch.cos(th)], dim=1)
        if "bivar" in features:
            nrm2 = _normals(n, generator, pos)
            tanx = torch.tan(nrm1 * sigma)
            tany = torch.tan(nrm2 * sigma)
            ez = 1.0 / torch.sqrt(1.0 + tanx ** 2 + tany ** 2)
            bivar_err = torch.stack([tanx * ez, tany * ez, ez], dim=1)
            err = torch.where(((flags & M.F_BIVAR) != 0)[:, None],
                              bivar_err, err)
        n_pert = normalize(rotate_to_normal(err, ns), eps=1e-30)
        n_eff = torch.where((sigma > 0.0)[:, None], n_pert, ns)

    # ---- candidate interactions, selected by kind
    d_reflect = reflections(dirs, n_eff)
    out_dir = d_reflect
    keep_energy = torch.zeros((n,), dtype=torch.bool, device=pos.device)

    def pick(mask, new, old):
        return torch.where(mask[:, None], new, old)

    if needs_diffuse:
        d_lambert = _cosine_lobe(phi, torch.sin(prm[:, 1]) * torch.sqrt(u1),
                                 ns)
        if kinds & {M.K_LAMBERTIAN_SPECULAR, M.K_LAMBERTIAN_PIECEWISE}:
            # the full-hemisphere lobe of the specular-diffuse kinds
            d_hemi = _cosine_lobe(phi, torch.sqrt(u1), ns)
        if M.K_LAMBERTIAN in kinds:
            out_dir = pick(kind == M.K_LAMBERTIAN, d_lambert, out_dir)
        if M.K_LAMBERTIAN_SPECULAR in kinds:
            out_dir = pick(kind == M.K_LAMBERTIAN_SPECULAR,
                           pick(u_choice < prm[:, 1], d_reflect, d_hemi),
                           out_dir)
        if M.K_SEMI_LAMBERTIAN in kinds:
            # diffuse below ang_range incidence, specular at glancing;
            # both absorb
            d_semi = pick(safe_arccos(cos_aoi) > prm[:, 1], d_reflect,
                          d_lambert)
            out_dir = pick(kind == M.K_SEMI_LAMBERTIAN, d_semi, out_dir)

    out_ref_index = ref_index
    split_rows = None
    if medium is None:
        zero = torch.zeros_like(ref_index)
        medium = (zero, zero, zero)
    att, scat, g_hg = medium
    out_att, out_scat, out_g = att, scat, g_hg
    if M.K_REFRACTIVE in kinds:
        # Fresnel interface, the roulette choosing reflection or
        # refraction; the media toggle against the ray's index, or for
        # index-matched volumetric interfaces (n1 == n2) against its
        # medium triple
        n1_s, n2_s = prm[:, 0], prm[:, 1]
        if "dispersive" in features:
            # per-ray indices from the row's two segments [st, st + L1)
            # and [st + L1, st + L1 + L2) of the shared table
            st, l1, l2 = prm[:, 3], prm[:, 4], prm[:, 5]
            n1_d = _interp_segment(wavelength, st, l1, scene.spectral_wl,
                                   scene.spectral_ab)
            n2_d = _interp_segment(wavelength, st + l1, l2,
                                   scene.spectral_wl, scene.spectral_ab)
            disp = l2 > 0.0
            n1_s = torch.where(disp, n1_d, n1_s)
            n2_s = torch.where(disp, n2_d, n2_s)
        att1, att2 = prm[:, 6], prm[:, 7]
        sc1, sc2 = prm[:, 8], prm[:, 9]
        g1, g2 = prm[:, 10], prm[:, 11]
        # the nearest index decides the side (robust to rounding)
        in_medium1 = torch.where(
            (n1_s - n2_s).abs() > 1e-9,
            (ref_index - n1_s).abs() <= (ref_index - n2_s).abs(),
            (att == att1) & (scat == sc1) & (g_hg == g1))
        n_next = torch.where(in_medium1, n2_s, n1_s)
        refr_ok, d_refract = refractions(ref_index, n_next, dirs, n_eff)
        R = torch.where(refr_ok, fresnel(dirs, n_eff, ref_index, n_next), 1.0)
        go_reflect = u_choice <= R
        is_refr = kind == M.K_REFRACTIVE
        if split_mode and "split" in features:
            # the primary lane takes the refracted branch at (1 - R) E;
            # the reflected one leaves through .split as a new ray
            split_rows = is_refr & ((flags & M.F_SPLIT) != 0)
            go_reflect = go_reflect & ~split_rows
        crossed = is_refr & ~go_reflect
        out_dir = pick(crossed, d_refract, out_dir)
        keep_energy = keep_energy | is_refr
        out_ref_index = torch.where(crossed, n_next, ref_index)
        out_att = torch.where(crossed, torch.where(in_medium1, att2, att1),
                              att)
        out_scat = torch.where(crossed, torch.where(in_medium1, sc2, sc1),
                               scat)
        out_g = torch.where(crossed, torch.where(in_medium1, g2, g1), g_hg)

    if M.K_COOK_TORRANCE in kinds:
        # Beckmann-sampled microfacet reflection (materials
        # .bdrf_cook_torrance), with its own uniforms
        u_ct = 1e-7 + (1.0 - 1e-7) * _uniform(generator, n, pos)
        phi_ct = _uniform(generator, n, pos, 2.0 * math.pi)
        tan2 = -prm[:, 0] ** 2 * torch.log(u_ct)
        cos_h = 1.0 / torch.sqrt(1.0 + tan2)
        sin_h = safe_sqrt(1.0 - cos_h ** 2)
        h_vec = normalize(rotate_to_normal(torch.stack(
            [sin_h * torch.cos(phi_ct), sin_h * torch.sin(phi_ct), cos_h],
            dim=1), ns), eps=1e-30)
        d_ct = reflections(dirs, h_vec)
        # throughput F(d.h) G |d.h| / (|n.d| |n.h|)
        v_dot_h = dot(dirs, h_vec).abs()
        n_dot_v = dot(dirs, ns).abs().clamp(min=1e-6)
        n_dot_h = dot(h_vec, ns).abs().clamp(min=1e-6)
        n_dot_l = dot(d_ct, ns)
        r_p, r_s, _ = fresnel_to_attenuating(
            1.0, (prm[:, 1], prm[:, 2]), safe_arccos(v_dot_h.clamp(min=0.0)))
        vh = v_dot_h.clamp(min=1e-6)
        geo = torch.minimum(torch.ones_like(vh), torch.minimum(
            2.0 * n_dot_h * n_dot_v / vh, 2.0 * n_dot_h * n_dot_l.abs() / vh))
        w_ct = prm[:, 3] * 0.5 * (r_p + r_s) * geo * v_dot_h / (
            n_dot_v * n_dot_h)
        # reflected below the surface: absorbed
        w_ct = torch.where(n_dot_l > 0.0, w_ct.clamp(0.0, 1.0), 0.0)
        is_ct = kind == M.K_COOK_TORRANCE
        out_dir = pick(is_ct, d_ct, out_dir)
        absorptivity = torch.where(is_ct, 1.0 - w_ct, absorptivity)

    if M.K_FRESNEL_CONDUCTOR in kinds:
        # specular reflection at the randomly polarized Fresnel
        # reflectance of the ray's wavelength; the transmitted share is
        # absorbed in the skin depth
        st_fc, l_fc = prm[:, 1], prm[:, 2]
        n2_fc = _interp_segment(wavelength, st_fc, l_fc, scene.spectral_wl,
                                scene.spectral_ab)
        k2_fc = _interp_segment(wavelength, st_fc + l_fc, l_fc,
                                scene.spectral_wl, scene.spectral_ab)
        n1_fc = torch.where(prm[:, 0] > 0.0, prm[:, 0], 1.0)
        r_p, r_s, _ = fresnel_to_attenuating(
            n1_fc, (n2_fc, k2_fc), safe_arccos(cos_aoi.clamp(min=0.0)))
        absorptivity = torch.where(kind == M.K_FRESNEL_CONDUCTOR,
                                   1.0 - (0.5 * (r_p + r_s)).clamp(0.0, 1.0),
                                   absorptivity)

    if M.K_LAMBERTIAN_PIECEWISE in kinds:
        # piecewise directional (optionally spectral) diffuse absorptance,
        # constant or direction-dependent specularity
        th_in = safe_arccos(cos_aoi.clamp(min=0.0))
        abs_pw = _interp_segment(th_in, prm[:, 0], prm[:, 1],
                                 scene.spectral_wl, scene.spectral_ab)
        if "lambertian_piecewise_spectral" in features:
            abs_2d = _interp2_segment(th_in, wavelength, prm[:, 0],
                                      prm[:, 1], prm[:, 4], prm[:, 5],
                                      prm[:, 6], scene.spectral_wl,
                                      scene.spectral_ab)
            abs_pw = torch.where(prm[:, 5] > 0.0, abs_2d, abs_pw)
        is_lpw = kind == M.K_LAMBERTIAN_PIECEWISE
        absorptivity = torch.where(is_lpw, abs_pw, absorptivity)
        # specular probability: p2, or interpolated over theta from its
        # own chunk (p3 >= 0)
        spec_p = prm[:, 2]
        if "lambertian_piecewise_dirspec" in features:
            spec_tab = _interp_segment(th_in, prm[:, 3], prm[:, 1],
                                       scene.spectral_wl, scene.spectral_ab)
            spec_p = torch.where(prm[:, 3] >= 0.0, spec_tab, spec_p)
        out_dir = pick(is_lpw, pick(u_choice < spec_p, d_reflect, d_hemi),
                       out_dir)

    out_pos = hit_g
    if M.K_PERIODIC in kinds:
        # teleport by the period along the (against-ray) normal
        is_periodic = kind == M.K_PERIODIC
        out_dir = pick(is_periodic, dirs, out_dir)
        out_pos = pick(is_periodic, hit_g + prm[:, 0][:, None] * ns, out_pos)
        keep_energy = keep_energy | is_periodic
    if M.K_TRANSPARENT in kinds:
        is_transp = kind == M.K_TRANSPARENT
        out_dir = pick(is_transp, dirs, out_dir)
        keep_energy = keep_energy | is_transp

    out_dir = normalize(out_dir, eps=1e-30)
    out_energy = torch.where(keep_energy, energy,
                             energy * (1.0 - absorptivity))
    if "one_sided" in features:
        out_energy = torch.where(((flags & M.F_ONE_SIDED) != 0) & backside,
                                 0.0, out_energy)
    absorbed = energy - out_energy

    split_info = None
    if split_rows is not None:
        # the reflected branch takes R of what is left, after the
        # absorbed share above: it deposits nothing here
        sec_e = torch.where(split_rows, out_energy * R, 0.0)
        out_energy = out_energy - sec_e
        split_info = (split_rows, sec_e, d_reflect)
    return ShadeResult(out_pos, out_dir, out_energy, out_ref_index,
                       (out_att, out_scat, out_g), absorbed, p_l, ns,
                       backside, split_info)
