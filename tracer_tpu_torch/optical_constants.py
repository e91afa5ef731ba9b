"""Optical-constant material models: complex refractive index vs wavelength
(the port's NumPy copy of tracer_tpu/optical_constants.py).

Capability parity with the reference's ray_trace_utils/optical_constants.py
(optical_material base with validity checking :35, Sopra-database loader :9,
file loader :116, hand-written models :99-269). The port bundles the JAX
package's whole n,k database, byte for byte: ``data/nk/NAME.txt``, ten
tables generated from the analytic models below (Lorentz-Drude metals,
Rakic et al., Appl. Opt. 37, 5271 (1998); Sellmeier SiO2 and BK7) by
``data/generate_nk.py``, and ``data/nk/sopra/``, the 267 measured tables
of the public SOPRA archive as ``data/convert_sopra.py`` normalises them.
``from_sopra`` looks in ``data/nk``, then in its ``sopra`` subfolder
(``measured=True`` flips the order); point database_dir at any external
Sopra-format archive for other materials. Built-in analytic models
(Sellmeier SiO2/BK7, Lorentz-Drude metals) are provided in corrected eV
units (see electromagnetics module docstring).
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .electromagnetics import dielectric_to_refractive, drude_lorentz_model


class OpticalMaterial:
    """Base material: complex index m(lambdas) valid on [l_min, l_max]
    (wavelengths in meters). Out-of-range queries return NaN with a
    warning-free mask, like the reference's check_valid decorator."""

    def __init__(self, l_min: float, l_max: float, m_func=None,
                 name: str = "material"):
        self.l_min, self.l_max = l_min, l_max
        self._m_func = m_func
        self.name = name

    def _m(self, lambdas):
        return self._m_func(lambdas)

    def m(self, lambdas):
        lambdas = np.atleast_1d(np.asarray(lambdas, dtype=float))
        valid = (lambdas >= self.l_min) & (lambdas <= self.l_max)
        out = np.full(lambdas.shape, np.nan, dtype=complex)
        if valid.any():
            out[valid] = self._m(lambdas[valid])
        return out

    def n(self, lambdas):
        return self.m(lambdas).real

    def k(self, lambdas):
        return self.m(lambdas).imag


class TabulatedMaterial(OpticalMaterial):
    """Material from (wavelength, n, k) samples, linearly interpolated."""

    def __init__(self, lambdas, n, k, name="tabulated"):
        lam = np.asarray(lambdas, dtype=float)
        order = np.argsort(lam)
        lam, n, k = lam[order], np.asarray(n)[order], np.asarray(k)[order]
        self._lam, self._n, self._k = lam, n, k
        super().__init__(lam.min(), lam.max(), name=name)

    def _m(self, lambdas):
        return (np.interp(lambdas, self._lam, self._n)
                + 1j * np.interp(lambdas, self._lam, self._k))


def from_file(filename: str, wavelength_col: int = 0, n_col: int = 1,
              k_col: int = 2, wavelength_unit: str = "nm",
              delimiter: str = ",", skiprows: int = 1) -> OpticalMaterial:
    """Material from a CSV of (wavelength, n, k)
    (ref OpticalMaterialFromFile :116)."""
    unit = {"nm": 1e-9, "um": 1e-6, "m": 1.0}.get(wavelength_unit)
    if unit is None:
        raise ValueError("Invalid wavelength unit. Use 'nm', 'um', or 'm'.")
    data = np.loadtxt(filename, skiprows=skiprows, delimiter=delimiter,
                      usecols=(wavelength_col, n_col, k_col))
    return TabulatedMaterial(data[:, 0] * unit, data[:, 1], data[:, 2],
                             name=os.path.basename(filename))


def builtin_nk_dir() -> str:
    """Directory of the bundled n,k database (Sopra NAME.txt format; see
    the module docstring for what it holds)."""
    return os.path.join(os.path.dirname(__file__), "data", "nk")


def from_sopra(material: str, database_dir: Optional[str] = None,
               measured: bool = False) -> OpticalMaterial:
    """Material from a Sopra-format database directory: file NAME.txt with
    'wavelength_nm, n, k' rows (ref get_from_Sopra :9). Without
    ``database_dir`` it looks in builtin_nk_dir(), then in its ``sopra``
    subfolder (``measured=True`` flips the order)."""
    name = material.upper() + ".txt"
    if database_dir is not None:
        path = os.path.join(database_dir, name)
    else:
        base = builtin_nk_dir()
        cands = [os.path.join(base, name),
                 os.path.join(base, "sopra", name)]
        if measured:
            cands.reverse()
        for path in cands:
            if os.path.exists(path):
                break
        else:
            raise FileNotFoundError(
                f"material {material!r} not in the bundled n,k database "
                f"({base}); pass database_dir= for an external archive")
    data = np.loadtxt(path, skiprows=1, delimiter=",")
    return TabulatedMaterial(data[:, 0] * 1e-9, data[:, 1], data[:, 2],
                             name=material)


get_from_sopra = from_sopra


class DrudeLorentzMaterial(OpticalMaterial):
    """Metal from Lorentz-Drude resonators (eV units; Rakic et al. 1998)."""

    def __init__(self, resonators, l_min, l_max, name="LD-metal"):
        self.resonators = np.asarray(resonators, dtype=float)
        super().__init__(l_min, l_max, name=name)

    def _m(self, lambdas):
        return dielectric_to_refractive(
            drude_lorentz_model(lambdas, self.resonators))


class Air(OpticalMaterial):
    """Vacuum/air placeholder, n = 1 (ref Air :143)."""

    def __init__(self):
        super().__init__(1e-9, 1.0, name="Air")

    def _m(self, lambdas):
        return np.ones(len(np.atleast_1d(lambdas)), dtype=complex)


class SiO2(OpticalMaterial):
    """Fused silica, Malitson 1965 Sellmeier (ref SiO2 :157)."""

    def __init__(self):
        super().__init__(210e-9, 6.7e-6, name="SiO2")

    def _m(self, lambdas):
        L2 = (np.asarray(lambdas) * 1e6) ** 2
        n = np.sqrt(1.0 + 0.6961663 * L2 / (L2 - 0.0684043**2)
                    + 0.4079426 * L2 / (L2 - 0.1162414**2)
                    + 0.8974794 * L2 / (L2 - 9.896161**2))
        return n + 0j


class BK7(OpticalMaterial):
    """Borosilicate crown glass, Schott N-BK7 Sellmeier coefficients."""

    def __init__(self):
        super().__init__(300e-9, 2.5e-6, name="BK7")

    def _m(self, lambdas):
        L2 = (np.asarray(lambdas) * 1e6) ** 2
        n = np.sqrt(1.0 + 1.03961212 * L2 / (L2 - 0.00600069867)
                    + 0.231792344 * L2 / (L2 - 0.0200179144)
                    + 1.01046945 * L2 / (L2 - 103.560653))
        return n + 0j


def _ld(omega_p, rows):
    """[f, w0, gamma] rows + plasma energy -> [sqrt(f)*wp, w0, gamma]
    resonator table (the natural form of Rakic Table 1)."""
    return [[omega_p * np.sqrt(f), w0, g] for (f, w0, g) in rows]


# Lorentz-Drude parameters [sqrt(f)*wp (eV), w0 (eV), gamma (eV)] from
# Rakic et al., "Optical properties of metallic films for vertical-cavity
# optoelectronic devices", Appl. Opt. 37 (1998). Rows: Drude term first.
_LD_CU = [[8.21225411, 0.0, 0.030], [2.67481269, 0.291, 0.378],
          [3.49257006, 2.957, 1.056], [9.20868474, 5.300, 3.213],
          [8.65045191, 11.18, 4.305]]
_LD_AL = [[10.83334709, 0.0, 0.047], [7.13714865, 0.162, 0.333],
          [3.34962983, 1.544, 0.312], [6.10331602, 1.808, 1.351],
          [2.59461211, 3.473, 3.382]]
_LD_TI = [[2.80451900, 0.0, 0.082], [6.91205801, 0.777, 2.276],
          [4.57008001, 1.545, 2.518], [3.15245090, 2.509, 1.663],
          [0.23053004, 19.43, 1.762]]
_LD_W = [[13.045 * np.sqrt(0.206), 0.0, 0.064],
         [13.045 * np.sqrt(0.054), 1.004, 0.530],
         [13.045 * np.sqrt(0.166), 1.917, 1.281],
         [13.045 * np.sqrt(0.706), 3.580, 3.332],
         [13.045 * np.sqrt(2.590), 7.498, 5.836]]


# Rakic 1998 Table 1, [f_j, omega_j (eV), Gamma_j (eV)] with plasma energy
_LD_AG = _ld(9.01, [[0.845, 0.0, 0.048], [0.065, 0.816, 3.886],
                    [0.124, 4.481, 0.452], [0.011, 8.185, 0.065],
                    [0.840, 9.083, 0.916], [5.646, 20.29, 2.419]])
_LD_AU = _ld(9.03, [[0.760, 0.0, 0.053], [0.024, 0.415, 0.241],
                    [0.010, 0.830, 0.345], [0.071, 2.969, 0.870],
                    [0.601, 4.304, 2.494], [4.384, 13.32, 2.214]])
_LD_NI = _ld(15.92, [[0.096, 0.0, 0.048], [0.100, 0.174, 4.511],
                     [0.135, 0.582, 1.334], [0.106, 1.597, 2.178],
                     [0.729, 6.089, 6.292]])
_LD_PT = _ld(9.59, [[0.333, 0.0, 0.080], [0.191, 0.780, 0.517],
                    [0.659, 1.314, 1.838], [0.547, 3.141, 3.668],
                    [3.576, 9.249, 8.517]])


def Ag():
    """Silver — the canonical CSP second-surface mirror coating."""
    return DrudeLorentzMaterial(_LD_AG, 207e-9, 12.4e-6, name="Ag")


def Au():
    return DrudeLorentzMaterial(_LD_AU, 248e-9, 6.2e-6, name="Au")


def Ni():
    return DrudeLorentzMaterial(_LD_NI, 248e-9, 6.2e-6, name="Ni")


def Pt():
    return DrudeLorentzMaterial(_LD_PT, 248e-9, 12.4e-6, name="Pt")


def Cu():
    return DrudeLorentzMaterial(_LD_CU, 207e-9, 12.4e-6, name="Cu")


def Al():
    return DrudeLorentzMaterial(_LD_AL, 62e-9, 248e-6, name="Al")


def Ti():
    return DrudeLorentzMaterial(_LD_TI, 248e-9, 31e-6, name="Ti")


def W():
    return DrudeLorentzMaterial(_LD_W, 150e-9, 24.9e-6, name="W")


def Rh(filename: Optional[str] = None):
    """Rhodium from a user-supplied (um, n, k) table (the reference read a
    hard-coded absolute path on the author's disk, :237)."""
    if filename is None:
        raise ValueError("Rh needs a data file: Rh(filename=...)")
    return from_file(filename, wavelength_unit="um", delimiter=None)


def Ta(filename: Optional[str] = None):
    """Tantalum from a user-supplied CSV (Werner 2009 + Ordal 1988 mix in
    the reference's other_material_data; :248)."""
    if filename is None:
        raise ValueError("Ta needs a data file: Ta(filename=...)")
    return from_file(filename)


def Al2O3(filename: Optional[str] = None):
    """Sapphire (ordinary ray) from a user-supplied Querry CSV (:99)."""
    if filename is None:
        raise ValueError("Al2O3 needs a data file: Al2O3(filename=...)")
    return from_file(filename, wavelength_unit="um")
