"""Generate the bundled n,k database (tracer_tpu_torch/data/nk/NAME.txt,
Sopra CSV format: header row + 'wavelength_nm, n, k' lines) from the
analytic dispersion models in tracer_tpu_torch.optical_constants (the
port's NumPy copy of tracer_tpu/data/generate_nk.py; its output equals the
JAX package's tables byte for byte):

  - metals Ag, Al, Au, Cu, Ni, Pt, Ti, W — Lorentz-Drude model with the
    published parameters of Rakic et al., Appl. Opt. 37, 5271 (1998)
  - dielectrics SiO2 (Malitson 1965 Sellmeier), BK7 (Schott N-BK7
    Sellmeier) — k = 0 in the transparency window

The reference ships the proprietary 268-file Sopra archive at
ray_trace_utils/Sopra_Data/ (loaded by its optical_constants.py:9); this
generated set covers the CSP-relevant materials with open provenance and
loads through the same ``from_sopra`` path. Regenerate with:

    python -m tracer_tpu_torch.data.generate_nk
"""
import os

import numpy as np


def write_table(path: str, lam_m: np.ndarray, m: np.ndarray,
                source: str) -> None:
    with open(path, "w") as f:
        f.write(f"wavelength_nm, n, k  # generated: {source}\n")
        for lam, mm in zip(lam_m, m):
            f.write(f"{lam * 1e9:.4f}, {mm.real:.6f}, {abs(mm.imag):.6f}\n")


def main(out_dir: str = None) -> list:
    from .. import optical_constants as oc
    if out_dir is None:
        out_dir = os.path.join(os.path.dirname(__file__), "nk")
    os.makedirs(out_dir, exist_ok=True)

    rakic = "Lorentz-Drude, Rakic et al. Appl. Opt. 37, 5271 (1998)"
    materials = [
        (oc.Ag(), rakic), (oc.Al(), rakic), (oc.Au(), rakic),
        (oc.Cu(), rakic), (oc.Ni(), rakic), (oc.Pt(), rakic),
        (oc.Ti(), rakic), (oc.W(), rakic),
        (oc.SiO2(), "Sellmeier, Malitson JOSA 55, 1205 (1965)"),
        (oc.BK7(), "Sellmeier, Schott N-BK7 catalog"),
    ]
    written = []
    for mat, source in materials:
        # log-spaced grid over each material's validity window: dense in
        # the solar band, thinning into the IR where dispersion is smooth
        lam = np.geomspace(mat.l_min, mat.l_max, 240)
        m = mat.m(lam)
        assert np.isfinite(m).all(), mat.name
        path = os.path.join(out_dir, mat.name.upper() + ".txt")
        write_table(path, lam, m, source)
        written.append(path)
    return written


if __name__ == "__main__":
    for p in main():
        print(p)
