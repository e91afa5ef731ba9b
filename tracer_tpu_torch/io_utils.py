"""Results and ray-source IO (the PyTorch port's NumPy copy of
tracer_tpu/io_utils.py): CSV histograms with a metadata header, binary
ray-source files (replayable trace inputs; :func:`source_to_bundle` loads
one as a port RayBundle on a device), the SolTrace, Tonatiuh and Solstice
ray-dump importers, and VTK polygons to STL. The files are the same
bytes as tracer_tpu's, so either package reads the other's."""
from __future__ import annotations

import glob
import os
from typing import List, Sequence, Tuple

import numpy as np
import torch


# --- CSV histogram IO (ref simulation_data_io.py) ---------------------------

def save_hist_data_csv(hist, bins, hist_label, bins_label, info_header,
                       saveloc, separator=","):
    """Save a 1D or 2D histogram with bin edges and a metadata header."""
    hist = np.asarray(hist)
    with open(saveloc, "w") as fo:
        fo.write(info_header + "\n")
        if hist.ndim == 2:
            bx, by = bins
            lx, ly = bins_label
        else:
            bx, lx = bins, bins_label
        # trailing separator on value lines: the reference's loader
        # (simulation_data_io.py) slices split(separator)[:-1], so files
        # must end each line with the separator to round-trip through both
        # loaders (ours tolerates the resulting empty field)
        fo.write("bins_x:" + separator + lx + "\n")
        fo.write("".join(str(e) + separator for e in bx) + "\n")
        if hist.ndim == 2:
            fo.write("bins_y:" + separator + ly + "\n")
            fo.write("".join(str(e) + separator for e in by) + "\n")
        fo.write("data:" + separator + hist_label + "\n")
        if hist.ndim == 2:
            for row in hist:
                fo.write("".join(str(v) + separator for v in row) + "\n")
        else:
            fo.write("".join(str(v) + separator for v in hist) + "\n")


def load_hist_data_csv(path, separator=","):
    """Load a histogram saved by save_hist_data_csv.
    Returns (bins, data, bins_label, data_label, info_header)."""
    with open(path) as fo:
        lines = [ln.rstrip("\n") for ln in fo.readlines()]
    info = lines[0]
    bins, bins_label = [], []
    data, data_label = None, None
    i = 1
    while i < len(lines):
        ln = lines[i]
        if ln.startswith("bins_"):
            bins_label.append(ln.split(separator, 1)[1])
            bins.append(np.array([v for v in lines[i + 1].split(separator)
                                  if v != ""], dtype=float))
            i += 2
        elif ln.startswith("data:"):
            data_label = ln.split(separator, 1)[1]
            rows = []
            for row in lines[i + 1:]:
                vals = [v for v in row.split(separator) if v != ""]
                if vals:
                    rows.append(np.array(vals, dtype=float))
            data = np.stack(rows)
            break
        else:
            i += 1
    if len(bins) == 1:
        bins, bins_label = bins[0], bins_label[0]
        # 1-D histograms are stored as one row; 2-D histograms keep
        # their (1, k) shape even with a single row (two bins arrays)
        if data is not None and data.shape[0] == 1:
            data = data[0]
    return bins, data, bins_label, data_label, info


# --- binary ray sources (ref Source_formatter.py) ---------------------------

def binarize_source(path, vertices, directions, energy) -> None:
    """Write a binary ray-source file: raveled [vertices(3n), directions(3n),
    energy(n)] float64 (the reference's on-disk layout, :203).

    Arrays may be (3, n) — the canonical layout — or (n, 3), which is
    transposed automatically. A 3x3 array is AMBIGUOUS and is always
    interpreted as (3, n) = one coordinate per row; pass exactly-three-ray
    sets in the (3, n) layout."""
    vertices = np.asarray(vertices, dtype=float)
    directions = np.asarray(directions, dtype=float)
    energy = np.asarray(energy, dtype=float)
    if vertices.shape[0] != 3:
        vertices = vertices.T
        directions = directions.T
    X = np.hstack([vertices.ravel(), directions.ravel(), energy])
    X.tofile(path)


def load_source(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Read one binary source file -> (vertices (n,3), directions (n,3),
    energy (n,)) (ref load_source :166)."""
    X = np.fromfile(path)
    n = len(X) // 7
    v = X[:3 * n].reshape(3, n).T
    d = X[3 * n:6 * n].reshape(3, n).T
    e = X[6 * n:]
    return v, d, e


def load_sources(paths: Sequence[str]):
    """Concatenate several binary source files (ref load_sources :186)."""
    vs, ds, es = zip(*(load_source(p) for p in paths))
    return (np.concatenate(vs), np.concatenate(ds), np.concatenate(es))


def source_to_bundle(path, dtype=torch.float32, device=None):
    """Binary source file -> RayBundle in ``dtype`` on ``device`` (None
    means the GPU)."""
    from .bundle import RayBundle
    v, d, e = load_source(path)
    return RayBundle.create(pos=v, dir=d, energy=e, dtype=dtype,
                            device=device)


def rescale_source_energy(paths, total_power) -> None:
    """Re-normalize the energy of a set of binary sources to a total power
    (ref energy re-scale utility :203-220)."""
    current = sum(load_source(p)[2].sum() for p in paths)
    k = total_power / current
    for p in paths:
        v, d, e = load_source(p)
        binarize_source(p, v.T, d.T, e * k)


def push_back_rays(path, distance) -> None:
    """Move source ray origins backward along their directions (ref
    push-back utility :221-233) — useful to restart imported rays ahead of
    the geometry they were recorded on."""
    v, d, e = load_source(path)
    binarize_source(path, (v - distance * d).T, d.T, e)


def import_soltrace(files: Sequence[str], total_power: float,
                    rays_per_source: int, target_dir: str,
                    stage: int = 2, element: int = -1) -> List[str]:
    """Read SolTrace ray-dump CSVs (columns x,y,z,dx,dy,dz,element,stage)
    and write equal-energy binary source files (ref format_Soltrace_data
    :65)."""
    pos, dirs = [], []
    for s in files:
        data = np.loadtxt(s, delimiter=",", skiprows=1)
        sel = (data[:, 6] == element) & (data[:, 7] == stage)
        pos.append(data[sel, 0:3])
        dirs.append(data[sel, 3:6])
    pos = np.concatenate(pos)
    dirs = np.concatenate(dirs)
    return _write_chunks(pos, dirs, total_power, rays_per_source, target_dir)


def import_tonatiuh(files: Sequence[str], total_power: float,
                    rays_per_source: int, target_dir: str) -> List[str]:
    """Read Tonatiuh binary photon dumps (6 doubles per ray, Y-up) and
    write equal-energy binary sources (ref get_source_vecs/format_for_optim
    :4-63; note the axis swap from Tonatiuh's Y-up convention)."""
    pos, dirs = [], []
    for f in files:
        X = np.fromfile(f)
        d = np.stack([-X[0::6], X[2::6], -X[1::6]], axis=1)
        v = np.stack([X[3::6], -X[5::6], X[4::6]], axis=1)
        pos.append(v)
        dirs.append(d)
    return _write_chunks(np.concatenate(pos), np.concatenate(dirs),
                         total_power, rays_per_source, target_dir)


def import_solstice(results_dir: str, total_power: float,
                    rays_per_source: int, target_dir: str,
                    option: str = "S") -> List[str]:
    """Read a Solstice 'solpaths' VTK output and export the final ray of
    each path as a binary source (ref format_Solstice_data :96). option 'S'
    keeps the segment start, 'E' rewinds one unit from the segment end."""
    path_file = os.path.join(results_dir, "solpaths")
    matches = glob.glob(path_file + "*")
    if not matches:
        raise FileNotFoundError(f"no solpaths file under {results_dir}")
    pts, lines = _read_vtk_polydata(matches[0])
    pos, dirs = [], []
    for ln in lines:
        if len(ln) < 2:
            continue
        a, b = pts[ln[-2]], pts[ln[-1]]
        seg = b - a
        nrm = np.linalg.norm(seg)
        if nrm == 0:
            continue
        d = seg / nrm
        pos.append(a if option == "S" else b - d)
        dirs.append(d)
    return _write_chunks(np.asarray(pos), np.asarray(dirs), total_power,
                         rays_per_source, target_dir)


def _write_chunks(pos, dirs, total_power, rays_per_source, target_dir):
    """Split rays into replayable source files of ``rays_per_source`` each.
    Every file carries exactly ``total_power``: the final (possibly short)
    chunk keeps ALL its rays at proportionally higher per-ray energy —
    rounding the chunk count would silently drop up to half a chunk of
    samples and skew the last file's power."""
    os.makedirs(target_dir, exist_ok=True)
    n_src = max(1, -(-len(pos) // rays_per_source))   # ceil
    out = []
    for i in range(n_src):
        sl = slice(i * rays_per_source, (i + 1) * rays_per_source)
        v, d = pos[sl], dirs[sl]
        if len(v) == 0:
            break
        e = np.full(len(v), total_power / len(v))
        p = os.path.join(target_dir, str(i))
        binarize_source(p, v.T, d.T, e)
        out.append(p)
    return out


# --- minimal VTK polydata reading / STL conversion (ref vtk_to_stl.py) -----

def _read_vtk_polydata(path):
    """Tiny ASCII-VTK polydata reader: returns (points (n,3), cells)."""
    with open(path) as f:
        lines = f.read().split("\n")
    pts, cells = [], []
    i = 0
    while i < len(lines):
        parts = lines[i].split()
        if parts[:1] == ["POINTS"]:
            n = int(parts[1])
            vals = []
            i += 1
            while len(vals) < 3 * n:
                vals.extend(float(x) for x in lines[i].split())
                i += 1
            pts = np.array(vals).reshape(n, 3)
            continue
        if parts[:1] in (["LINES"], ["POLYGONS"]):
            n = int(parts[1])
            i += 1
            for _ in range(n):
                row = [int(x) for x in lines[i].split()]
                cells.append(row[1:1 + row[0]])
                i += 1
            continue
        i += 1
    return pts, cells


def vtk_to_stl(vtk_path: str, stl_path: str) -> None:
    """Convert an ASCII VTK polygon file to binary STL (ref
    ray_trace_utils/vtk_to_stl.py). Non-triangle polygons are fanned."""
    from .stl_utils import make_stl
    pts, polys = _read_vtk_polydata(vtk_path)
    faces = []
    for p in polys:
        for k in range(1, len(p) - 1):
            faces.append((p[0], p[k], p[k + 1]))
    make_stl(stl_path, pts, np.asarray(faces, dtype=int))
