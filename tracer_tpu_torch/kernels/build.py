"""Build the CUDA kernels of ``csrc/`` with nvcc and bind them with ctypes.

Every ``csrc/*.cu`` goes into one shared library: one nvcc per source,
all started together, then one link. The library has a plain C interface:
every pointer and the CUDA stream go in as ``c_void_p`` (a bare Python int
would be cut to 32 bits), and every entry point returns
``cudaGetLastError()``. It is built at first use into
``tracer_tpu_torch/_build/`` (listed in .gitignore), named by a hash of
all the sources and the flags, so a second process reuses it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# what the last load() did: seconds spent in nvcc, whether the library was
# already built, its path and ptxas' per-kernel resource report
info: dict = {}
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # rows S K lists W counts G gmeta max_c cells cell_bounds remaining
    # active order srcp seed pos dir e npos ndir ne sid absorbed wl nwl tab
    # n_tab nb t_eps disc_eps flat_rect modes (a host struct,
    # bounce._Modes) stream
    "tt_bounce_culled": [_P, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P, _P,
                         _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                         _P, _P, _P, _I, _I, _F, _F, _I, _P, _P],
    # W K n_tab flat_rect wl_lane modes out (5 ints)
    "tt_k1_geometry": [_I, _I, _I, _I, _I, _P, _P],
    # rows S K G gmeta max_c seed pos dir e npos ndir ne sid absorbed wl
    # nwl ri nri mid nmid s_e s_dir n t_eps disc_eps regen srcp pose tab
    # n_tab modes (a host struct, bounce._Modes) media_tab n_media
    # media_rows stream
    "tt_bounce": [_P, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                  _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _F, _F, _I, _P,
                  _P, _P, _I, _P, _P, _I, _P, _P],
    # S K n_tab n_media refr media modes n out (6 ints)
    "tt_k2_geometry": [_I, _I, _I, _I, _I, _I, _P, ctypes.c_longlong, _P],
    # rows S K G gmeta max_c pos dir t sid normal local up kind flags p0
    # p1 n t_eps disc_eps need_local backside_miss stream
    "tt_nearest": [_P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                   _P, _P, _P, _I, _F, _F, _I, _I, _P],
    # S K backside_miss n out (6 ints)
    "tt_k3_geometry": [_I, _I, _I, _I, _P],
    # rows S K t sid normal up pos dir e alive wl ri att scat g npos ndir
    # ne nalive nri natt nscat ng n seed min_energy tab n_tab modes
    # n_specs spec_i spec_f member W partial blocks stream
    "tt_epilogue": [_P, _I, _I, *[_P] * 21, ctypes.c_longlong, _I, _F, _P,
                    _I, _P, _I, _P, _P, _P, _I, _P, _I, _P],
    # n S W out (3 ints)
    "tt_epilogue_geometry": [ctypes.c_longlong, _I, _I, _P],
}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list:
    return sorted(_CSRC.glob("*.cu"))


def load():
    """Build (if needed) and load the kernel library; returns the CDLL."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs + sorted(_CSRC.glob("*.cuh")):
        h.update(p.name.encode() + p.read_bytes())
    so = BUILD_DIR / f"libtt_{h.hexdigest()[:16]}.so"
    info.update(path=str(so), cache_hit=so.exists(), nvcc_s=0.0, ptxas="")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tag = f"{so.stem}.{os.getpid()}"
        t0 = time.perf_counter()
        objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in srcs]
        procs = [subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-Xptxas", "-v",
                                   "-c", "-o", str(o), str(p)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for p, o in zip(srcs, objs)]
        errs = [p.communicate()[1] for p in procs]
        info["ptxas"] = "".join(errs)
        for p, src, err in zip(procs, srcs, errs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({p.returncode}):\n{err}")
        tmp = BUILD_DIR / f"{tag}.so"
        r = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-shared", "-o",
                            str(tmp), *map(str, objs)],
                           capture_output=True, text=True)
        info["nvcc_s"] = time.perf_counter() - t0
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(tmp, so)
        for o in objs:
            o.unlink()
    lib = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.tt_error_string.argtypes = [ctypes.c_int]
    lib.tt_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def ptxas_lines(report: str, what: str) -> list:
    """(entry, registers, stack, spill stores, spill loads) of each kernel
    whose mangled name holds ``what``, from nvcc -Xptxas -v (as
    info["ptxas"] holds it)."""
    out, entry, props = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, props = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            props = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and what in entry:
            out.append((entry, int(m.group(1)), *(props or (0, 0, 0))))
            entry = None
    return out


def k2_instance_name(entry: str) -> str:
    """<kRefr, kScat, kMedia, kExtra, kBmiss, kSplit> of a K2 instance's
    mangled name."""
    flags = re.findall(r"Lb([01])E", entry.split("bounce_kernel", 1)[1])
    return "<" + ", ".join("ft"[int(f)] for f in flags) + ">"


def k3_instance_name(entry: str) -> str:
    """<kC1, kBmiss> of a K3 instance's mangled name (the earlier,
    untemplated kernel: <>)."""
    flags = re.findall(r"Lb([01])E", entry.split("nearest_kernel", 1)[-1])
    return "<" + ", ".join("ft"[int(f)] for f in flags) + ">"


def check(lib, rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.tt_error_string(rc).decode()})")
