"""The K3 epilogue: wrapper of the CUDA kernel in csrc/epilogue.cu.

In each bounce of engine.trace_fused on CUDA float32 bundles, one launch
after K3 (kernels/nearest.py) shades every lane's winner with K1's and
K2's shade (csrc/shade.cuh), writes the next ray state, and adds the
bounce's per-row absorbed energy and hits, its escaped and culled energy
and its device flux histograms (analysis/device_fluxmap) to a partial
table, one row a block, which ``Epilogue.finish`` sums once a call. It
replaces no TPU kernel (tracer_tpu's shade after K3 is jnp code that XLA
fuses) and has no plain version of its own: on CPU tensors, and on every
trace it does not take (engine._epilogue_ok), the engine runs the plain
bounce (kernels/shade.py, engine._account, device_fluxmap.accumulate),
which the kernel is held against (tests/test_torch_epilogue.py).

``Epilogue`` is one call's launch state, made once a call: the packed
rows, the mode struct, the flux specs' tables, the partial table, the
call's own ray buffers and every argument that stays the same from
bounce to bounce. ``k3_epilogue`` launches it once a bounce and counts
its launches (``k3_epilogue.launches``).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..analysis.fluxmap import _AXIAL, _CARTESIAN, _POLAR, _SPHERICAL
from .rows import _check

# the (u, v) projection of each binned geometry kind (device_fluxmap._uv)
UV_KINDS = {**dict.fromkeys(_CARTESIAN, 0), **dict.fromkeys(_POLAR, 1),
            **dict.fromkeys(_AXIAL, 2), **dict.fromkeys(_SPHERICAL, 3)}
# csrc/epilogue.cu's block: threads (one lane each) and warps. The gate
# sizes a block's shared memory from them without the library; each
# Epilogue holds them to the library's own geometry (epi_geometry).
EPI_THREADS = 256
EPI_WARPS = EPI_THREADS // 32
# floats of a block's shared memory (its sums, each warp's row bins, a
# staging float a thread): 192 KB of the 227 a block may take
MAX_SHARED_FLOATS = 48 * 1024
# the ray fields the kernel reads; it writes the first four, and with
# refractive rows the last four
RAY_FIELDS = ("pos", "dir", "energy", "alive", "ref_index", "att_coeff",
              "scat_coeff", "scat_g")


def sums_width(n_rows: int, fluxspecs) -> int:
    """Floats of a block's sums: absorbed and hits per row, escaped,
    culled, then each spec's nu * nv bins."""
    return 2 * n_rows + 2 + sum(s.nu * s.nv for s in fluxspecs)


def shared_floats(n_rows: int, fluxspecs) -> int:
    """Floats of a block's shared memory: its sums, each warp's absorbed
    and hits a row, a staging float a thread."""
    return (sums_width(n_rows, fluxspecs) + EPI_WARPS * 2 * n_rows
            + EPI_THREADS)


def takes(n_rows: int, fluxspecs) -> bool:
    """Whether the kernel takes a scene of ``n_rows`` rows with these
    device flux specs: every spec of a binned kind, and a block's shared
    memory within MAX_SHARED_FLOATS floats."""
    return (all(s.kind in UV_KINDS for s in fluxspecs)
            and shared_floats(n_rows, fluxspecs) <= MAX_SHARED_FLOATS)


def _ptr(t):
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=16)
def _geometry(lib, n: int, S: int, W: int) -> tuple:
    """(blocks, threads, bytes of shared memory a block) of a launch."""
    from . import build
    out = (ctypes.c_int * 3)()
    build.check(lib, lib.tt_epilogue_geometry(n, S, W,
                                              ctypes.addressof(out)),
                "epilogue_geometry")
    return tuple(out)


def _spec_tables(fluxspecs, n_rows: int, device):
    """(spec_i (F, 4) int32: uv kind, nu, nv, first bin; spec_f (F, 5)
    float32: u0, nu / (u1 - u0), v0, nv / (v1 - v0), p0, each the float32
    that device_fluxmap.accumulate's arithmetic rounds its Python float
    to; member (F, S) int32: 1 where the row bins into the spec)."""
    spec_i, spec_f = [], []
    member = np.zeros((len(fluxspecs), n_rows), dtype=np.int32)
    first = 2 * n_rows + 2
    for k, s in enumerate(fluxspecs):
        spec_i.append([UV_KINDS[s.kind], s.nu, s.nv, first])
        spec_f.append([s.u0, s.nu / (s.u1 - s.u0), s.v0,
                       s.nv / (s.v1 - s.v0), s.p0])
        member[k, list(s.rows)] = 1
        first += s.nu * s.nv
    return (torch.tensor(np.asarray(spec_i, dtype=np.int32).reshape(-1, 4),
                         device=device),
            torch.tensor(np.asarray(spec_f, dtype=np.float32).reshape(-1, 5),
                         device=device),
            torch.tensor(member, device=device))


class Epilogue:
    """One trace_fused call's epilogue state (see the module).

    rows       (S, K) float32 packed table (pack_rows), K3's too
    ray        the call's input ray: a dict of RAY_FIELDS (N,) or (N, 3)
               tensors, which the kernel never writes
    fluxspecs  device_fluxmap.FluxSpec tuple (``takes`` must hold)
    modes      the mode struct (kernels.bounce._modes) of K2's shade
    refractive the scene has K_REFRACTIVE rows: the index and the medium
               triple are read and written
    wavelength (N,) float32 per-lane wavelengths where the rows read one
               (engine._k2_needs_wl), else None
    spectral_tab (L, 2) float32 table of the conductor and piecewise rows,
               else None
    min_energy lanes left with at most this die, their energy culled
    seed       the call's Philox seed (bounce b draws from a seed of its
               own made from it), 0 where the scene draws nothing
    lib        the kernel library (build.load(), or a stand-in)
    stream     the CUDA stream (its handle), None for the default
    """

    def __init__(self, rows, ray: dict, fluxspecs, modes, *,
                 refractive: bool, wavelength, spectral_tab,
                 min_energy: float, seed: int, lib, stream):
        dev = rows.device
        n = ray["pos"].shape[0]
        S, K = rows.shape
        _check("rows", rows, torch.float32, (S, K))
        for name in RAY_FIELDS[:3]:
            _check(name, ray[name], torch.float32,
                   (n, 3) if name in ("pos", "dir") else (n,))
        _check("alive", ray["alive"], torch.bool, (n,))
        if refractive:
            for name in RAY_FIELDS[4:]:
                _check(name, ray[name], torch.float32, (n,))
        if wavelength is not None:
            _check("wavelength", wavelength, torch.float32, (n,))
        if spectral_tab is not None:
            _check("spectral_tab", spectral_tab, torch.float32,
                   (spectral_tab.shape[0], 2))
        if not takes(S, fluxspecs):
            raise NotImplementedError(
                "the K3 epilogue takes flux specs of a binned kind within "
                f"{MAX_SHARED_FLOATS} floats of shared memory a block")
        self.lib, self.n, self.seed = lib, n, int(seed)
        self.rows, self.fluxspecs, self.modes = rows, tuple(fluxspecs), modes
        self.refractive = refractive
        self.W = sums_width(S, fluxspecs)
        self.blocks, threads, smem = _geometry(lib, n, S, self.W)
        if (threads, smem) != (EPI_THREADS, 4 * shared_floats(S, fluxspecs)):
            raise RuntimeError(
                f"csrc/epilogue.cu launches {threads} threads with {smem} B "
                f"of shared memory a block; the gate sizes {EPI_THREADS} "
                f"threads and {4 * shared_floats(S, fluxspecs)} B")
        self.partial = torch.zeros((self.blocks, self.W), dtype=torch.float32,
                                   device=dev)
        self.spec_i, self.spec_f, self.member = _spec_tables(fluxspecs, S,
                                                             dev)
        written = RAY_FIELDS if refractive else RAY_FIELDS[:4]
        self.out = {name: torch.empty_like(ray[name]) for name in written}
        # kept alive for the pointers below
        self.wavelength, self.spectral_tab = wavelength, spectral_tab
        # the arguments after the seed: the same every bounce
        self.tail = (float(min_energy), _ptr(spectral_tab),
                     0 if spectral_tab is None else spectral_tab.shape[0],
                     ctypes.addressof(modes), len(self.fluxspecs),
                     _ptr(self.spec_i), _ptr(self.spec_f), _ptr(self.member),
                     self.W, self.partial.data_ptr(), self.blocks, stream)

    def bounce_seed(self, bounce: int) -> int:
        """The Philox seed of bounce ``bounce``: the call's seed moved by
        a Weyl step, so that no two bounces draw the same uniforms."""
        return (self.seed + 0x61C88647 * bounce) % 2 ** 31

    def finish(self, accum) -> None:
        """Add the call's sums to ``accum`` (engine.TraceAccum), in place:
        the blocks' partial rows summed in float64."""
        tot = self.partial.sum(0, dtype=torch.float64).to(
            accum.absorbed.dtype)
        S = self.rows.shape[0]
        accum.absorbed += tot[:S]
        accum.hits += tot[S:2 * S]
        accum.escaped += tot[2 * S]
        accum.culled += tot[2 * S + 1]
        first = 2 * S + 2
        for spec, hist in zip(self.fluxspecs, accum.flux):
            hist += tot[first:first + spec.nu * spec.nv].view(spec.nu,
                                                              spec.nv)
            first += spec.nu * spec.nv


def launch_epilogue(plan: Epilogue, bounce: int, t, sid, aux, ray: dict):
    """Marshal one call of the library's ``tt_epilogue``: K3's results
    (t, sid, aux) and the ray ``ray`` (the call's input on its first
    bounce, ``plan.out`` after), written into ``plan.out``. Returns the
    C function's error code."""
    refr, out, rows = plan.refractive, plan.out, plan.rows
    return plan.lib.tt_epilogue(
        rows.data_ptr(), rows.shape[0], rows.shape[1], t.data_ptr(),
        sid.data_ptr(), aux["normal"].data_ptr(), aux["up_dot"].data_ptr(),
        *(ray[k].data_ptr() for k in RAY_FIELDS[:4]), _ptr(plan.wavelength),
        *(_ptr(ray[k]) if refr else None for k in RAY_FIELDS[4:]),
        *(out[k].data_ptr() for k in RAY_FIELDS[:4]),
        *(_ptr(out[k]) if refr else None for k in RAY_FIELDS[4:]),
        plan.n, plan.bounce_seed(bounce), *plan.tail)


def k3_epilogue(plan: Epilogue, bounce: int, t, sid, aux,
                ray: dict) -> dict:
    """One bounce's epilogue on the card (see the module): returns
    ``plan.out``, the next ray state. Each call adds one to
    ``k3_epilogue.launches``."""
    from . import build
    build.check(plan.lib, launch_epilogue(plan, bounce, t, sid, aux, ray),
                "k3_epilogue")
    k3_epilogue.launches += 1
    return plan.out


k3_epilogue.launches = 0
