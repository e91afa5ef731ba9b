"""Reference-API compatibility layer: the generated optics-manager names
(the PyTorch port of tracer_tpu/compat.py).

The reference synthesizes classes named <Optics><Accountants> at import
time, e.g. ``ReflectiveReceiver``, ``OneSidedRealReflectiveDetector``,
``LambertianReceiver``. This module resolves those names dynamically
(PEP 562) to OpticsSpec factories composed from the port's materials, the
same specs tracer_tpu's compat builds, and refuses the same parameters:

    from tracer_tpu_torch import compat as opt
    surf = Surface(geom, opt.ReflectiveReceiver(absorptivity=0.9))
"""
from __future__ import annotations

from . import materials as M

# base optics name -> factory(**kwargs) (longest names first when parsing)
def _reject_nonzero(spec, hint="", **params):
    """Refuse reference parameters this rebuild does not wire through,
    instead of silently dropping them (a ported script would otherwise
    trace with different physics and no warning)."""
    bad = {k: v for k, v in params.items() if v}
    if bad:
        raise NotImplementedError(
            f"compat: parameter(s) {sorted(bad)} are not supported by "
            f"this factory ({hint})")
    return spec


_BASES = {
    "OneSidedRealReflective": lambda absorptivity=0.0, sigma=0.0,
        bi_var=True: M.reflective(absorptivity, sigma, bi_var,
                                  one_sided=True),
    "OneSidedReflective": lambda absorptivity=0.0:
        M.reflective(absorptivity, one_sided=True),
    "RealReflective_IAM": lambda absorptivity, sigma, a_r, c=1.0,
        bi_var=True: M.iam(M.reflective(absorptivity, sigma, bi_var), a_r, c),
    "RealReflective": lambda absorptivity=0.0, sigma=0.0, bi_var=True:
        M.reflective(absorptivity, sigma, bi_var),
    "ReflectiveSpectral": lambda absorptances, wavelengths:
        M.reflective_spectral(absorptances, wavelengths),
    "Reflective_spectral": lambda absorptances, wavelengths:
        M.reflective_spectral(absorptances, wavelengths),
    "Reflective_IAM": lambda absorptivity, a_r, c=1.0:
        M.iam(M.reflective(absorptivity), a_r, c),
    "Reflective": lambda absorptivity=0.0: M.reflective(absorptivity),
    "BDRF_Cook_Torrance_isotropic": lambda alpha, m_n, m_k, R_Lam=1.0:
        M.bdrf_cook_torrance(alpha, m_n, m_k, R_Lam),
    "Lambertian_piecewise_Specular_directional_axisymmetric_piecewise":
        lambda thetas, absorptance_th, specularity_th:
        M.lambertian_directional_piecewise(thetas, absorptance_th,
                                           specularity_th),
    "LambertianSpecular_directional_axisymmetric_piecewise":
        lambda thetas, absorptance_th, specularity=0.0:
        M.lambertian_directional_piecewise(thetas, absorptance_th,
                                           specularity),
    "Lambertian_directional_axisymmetric_piecewise_spectral":
        lambda thetas, absorptance, wavelengths:
        M.lambertian_directional_spectral_piecewise(thetas, wavelengths,
                                                    absorptance),
    # ref :393: polychromatic (per-ray spectra) variant of the bilinear
    # (theta, wl) diffuse absorber — monochromatic traces use the same
    # bilinear grid; polychromatic bundles reject it loudly at trace
    # time (angle-dependent spectral filters need per-hit filtering)
    "Lambertian_directional_axisymmetric_piecewise_Polychromatic":
        lambda thetas, absorptance, wavelengths:
        M.lambertian_directional_spectral_piecewise(thetas, wavelengths,
                                                    absorptance),
    "Lambertian_directional_axisymmetric_piecewise":
        lambda thetas, absorptance_th, specularity=0.0:
        M.lambertian_directional_piecewise(thetas, absorptance_th),
    "LambertianSpecular": lambda absorptivity=0.0, specularity=0.5:
        M.lambertian_specular(absorptivity, specularity),
    # ref LambertianSpecular_IAM (optics_callables.py:588) — NOTE the
    # reference computes cos(aoi) from a zeroed directions array (its
    # `directs` where Reflective_IAM uses the incident `directions`), so
    # its modifier degenerates to the cos=0 constant; we apply the
    # Martin-Ruiz form at the true incidence angle, like its other IAM
    # classes (documented deviation)
    "LambertianSpecular_IAM": lambda absorptivity=0.0, specularity=0.5,
        a_r=0.16: M.iam(M.lambertian_specular(absorptivity, specularity),
                        a_r),
    "Lambertian_IAM": lambda absorptivity, a_r, c=1.0:
        M.iam(M.lambertian(absorptivity), a_r, c),
    "LambertianAbsorbant": lambda absorptivity=0.0,
        attenuation_coefficient=0.0, ang_range=1.5707963, scaling=1.0:
        _reject_nonzero(
            M.lambertian(absorptivity, ang_range),
            attenuation_coefficient=attenuation_coefficient,
            hint="give the enclosing medium its attenuation via the "
                 "bundle's att_coeff fields or an ambient_att source "
                 "spec instead (engine volumetrics)"),
    "SemiLambertian": lambda absorptivity=0.0, angular_range=None, **kw:
        M.semi_lambertian(absorptivity,
                          1.5707963 if angular_range is None
                          else angular_range),
    "Lambertian": lambda absorptivity=0.0, ang_range=1.5707963:
        M.lambertian(absorptivity, ang_range),
    "RefractiveTransmissiveHomogenous": lambda n1, n2,
        attenuation_coefficients, single_ray=True, sigma=None:
        M.refractive_transmissive_homogenous(n1, n2,
                                             attenuation_coefficients,
                                             single_ray, sigma or 0.0),
    "RefractiveAbsorbantHomogenous": lambda n1, n2, att1=0.0, att2=0.0,
        single_ray=True, sigma=None:
        M.refractive_absorbant_homogenous(n1, n2, att1, att2, single_ray,
                                          sigma or 0.0),
    "RefractiveScatteringHomogenous": lambda n1, n2, s_c1, s_c2, g_HG_1,
        g_HG_2, single_ray=True, sigma=None:
        M.refractive_homogenous(n1, n2, single_ray, sigma or 0.0,
                                scat1=s_c1, scat2=s_c2, g1=g_HG_1, g2=g_HG_2),
    "RefractiveHomogenous": lambda n1=1.0, n2=1.5, single_ray=True,
        sigma=0.0: M.refractive_homogenous(n1, n2, single_ray, sigma or 0.0),
    "FresnelConductorHomogenous": lambda n1, material:
        M.fresnel_conductor_homogenous(n1, material),
    "Absorbant": lambda attenuation_coefficients=0.0, scaling=1.0, n=1.0:
        _reject_nonzero(
            M.absorbant_interface(attenuation_coefficients, n),
            scaling=(scaling - 1.0),
            hint="free-path scaling is not supported; rescale the "
                 "attenuation coefficient instead"),
    "Scattering": lambda s_c=0.0, g_HG=0.0, n=1.0:
        M.scattering_interface(s_c, g_HG, n=n),
    # periodic x medium composites (ref optics_callables.py:1038-1106):
    # the boundary teleports; the medium rides OpticsSpec.ambient_medium
    # (the reference applies it to every path segment, which here is the
    # engine's ambient medium — folded into the source at trace time)
    "ScatteringAbsorbantPeriodicBoundary": lambda period, sc, g_HG,
        attenuation_coefficient=0.0, scaling=1.0: _reject_nonzero(
            M.scattering_periodic_boundary(period, sc, g_HG,
                                           attenuation_coefficient or 0.0),
            scaling=(scaling - 1.0),
            hint="free-path scaling is not supported; rescale the "
                 "coefficients instead"),
    "ScatteringPeriodicBoundary": lambda period, sc, g_HG, scaling=1.0:
        _reject_nonzero(
            M.scattering_periodic_boundary(period, sc, g_HG),
            scaling=(scaling - 1.0),
            hint="free-path scaling is not supported; rescale the "
                 "coefficients instead"),
    "AbsorbantPeriodicBoundary": lambda period,
        attenuation_coefficient=0.0, scaling=1.0: _reject_nonzero(
            M.absorbant_periodic_boundary(period,
                                          attenuation_coefficient or 0.0),
            scaling=(scaling - 1.0),
            hint="free-path scaling is not supported; rescale the "
                 "attenuation coefficient instead"),
    # material-based refractive x medium composites (ref :1108 :1172) —
    # the sides' media ride the K_REFRACTIVE medium tuple
    "RefractiveScatteringAbsorbant": lambda material_1, material_2, s_c1,
        s_c2, g_HG_1, g_HG_2, attenuation_coefficient_1=0.0,
        attenuation_coefficient_2=0.0, single_ray=True, sigma=None,
        scaling=1.0: _reject_nonzero(
            M.refractive_material(material_1, material_2, single_ray,
                                  sigma or 0.0,
                                  att1=attenuation_coefficient_1 or 0.0,
                                  att2=attenuation_coefficient_2 or 0.0,
                                  scat1=s_c1, scat2=s_c2, g1=g_HG_1,
                                  g2=g_HG_2),
            scaling=(scaling - 1.0),
            hint="free-path scaling is not supported; rescale the "
                 "coefficients instead"),
    "RefractiveScattering": lambda material_1, material_2, s_c1, s_c2,
        g_HG_1, g_HG_2, single_ray=True, sigma=None:
        M.refractive_material(material_1, material_2, single_ray,
                              sigma or 0.0, scat1=s_c1, scat2=s_c2,
                              g1=g_HG_1, g2=g_HG_2),
    "Refractive": lambda material_1, material_2, single_ray=True,
        sigma=None: M.refractive_material(material_1, material_2,
                                          single_ray, sigma or 0.0),
    "RefractiveAbsorbant": lambda material_1, material_2,
        attenuation_coefficient_1=0.0, attenuation_coefficient_2=0.0,
        single_ray=True, sigma=None:
        M.refractive_material(material_1, material_2, single_ray,
                              sigma or 0.0,
                              att1=attenuation_coefficient_1 or 0.0,
                              att2=attenuation_coefficient_2 or 0.0),
    "PeriodicBoundary": lambda period: M.periodic_boundary(period),
    "Transparent": lambda: M.transparent(),
    # ref BiFacial (optics_callables.py:1877): separate optics per face
    # side — takes two already-built specs, like the reference takes two
    # managers
    "BiFacial": lambda OpticsCallable_front, OpticsCallable_back:
        M.bifacial(OpticsCallable_front, OpticsCallable_back),
}

# accountant-name tokens -> record tags (ref Accountant subclasses
# :1597-1852 and aliases :2074)
_TOKENS = {
    "Receiver": ("location", "absorption"),
    "Detector": ("direction", "location", "absorption"),
    "Transmitter": ("location", "scattering"),
    "Location": ("location",),
    "Absorber": ("absorption",),
    "Attenuator": ("attenuation",),
    "Receptor": ("reception",),
    "Reception": ("reception",),
    "Directional": ("direction",),
    "Normal": ("normal",),
    "Spectral": ("spectral",),
    "Polychromatic": ("polychromatic",),
    "Scatterer": ("scattering",),
}


def _resolve(name: str):
    base_name = None
    for b in sorted(_BASES, key=len, reverse=True):
        if name.startswith(b):
            base_name = b
            break
    if base_name is None:
        raise AttributeError(name)
    rest = name[len(base_name):]
    records = []
    while rest:
        for tok in sorted(_TOKENS, key=len, reverse=True):
            if rest.startswith(tok):
                records.extend(_TOKENS[tok])
                rest = rest[len(tok):]
                break
        else:
            raise AttributeError(name)
    factory = _BASES[base_name]

    def make(*args, **kwargs):
        spec = factory(*args, **kwargs)
        if records:
            spec = M.with_accounting(spec, *records)
        return spec

    make.__name__ = name
    return make


def __getattr__(name: str):
    if name.startswith("_"):
        raise AttributeError(name)
    fn = _resolve(name)
    globals()[name] = fn  # cache
    return fn


# the reference's module constant (optics_callables.py:489)
perfect_mirror = M.perfect_mirror()
