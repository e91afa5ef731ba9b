"""Convert a SOPRA n,k archive into the bundled database format (the
port's NumPy copy of tracer_tpu/data/convert_sopra.py).

The SOPRA optical-constants database (268 materials of measured
``wavelength (nm), n, k`` tables, originally distributed free of charge by
SOPRA S.A. and mirrored by many optics packages — the reference bundles it
at ray_trace_utils/Sopra_Data/, loaded by optical_constants.py:9) is the
out-of-the-box material breadth for spectral traces. This script
normalizes an archive copy into
``tracer_tpu_torch/data/nk/sopra/NAME.txt`` (plain-decimal
``wavelength_nm, n, k`` rows, one header line), the format
``optical_constants.from_sopra`` reads; names already served by the
GENERATED analytic database (tracer_tpu_torch/data/nk/*.txt,
Rakic/Sellmeier models) keep both: the generated file wins by default and
the measured table stays reachable via ``from_sopra(name, measured=True)``.

Usage::

    python -m tracer_tpu_torch.data.convert_sopra /path/to/Sopra_Data
"""
from __future__ import annotations

import os
import sys

import numpy as np


def convert_archive(src_dir: str, dst_dir: str | None = None) -> int:
    """Convert every ``*.txt`` table in ``src_dir``; returns the count."""
    if dst_dir is None:
        dst_dir = os.path.join(os.path.dirname(__file__), "nk", "sopra")
    os.makedirs(dst_dir, exist_ok=True)
    n_done = 0
    for fname in sorted(os.listdir(src_dir)):
        if not fname.lower().endswith(".txt"):
            continue
        try:
            data = np.loadtxt(os.path.join(src_dir, fname), skiprows=1,
                              delimiter=",", ndmin=2)
        except ValueError:
            print(f"skip {fname}: not an n,k table", file=sys.stderr)
            continue
        if data.shape[1] != 3:
            print(f"skip {fname}: {data.shape[1]} columns", file=sys.stderr)
            continue
        name = os.path.splitext(fname)[0].upper()
        out = os.path.join(dst_dir, name + ".txt")
        with open(out, "w") as fh:
            fh.write("wavelength_nm, n, k  # converted from the public "
                     "SOPRA n,k archive (convert_sopra.py)\n")
            for wl, n, k in data:
                fh.write(f"{wl:.6g}, {n:.6g}, {k:.6g}\n")
        n_done += 1
    return n_done


if __name__ == "__main__":
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    print(f"converted {convert_archive(sys.argv[1])} materials")
