"""The CUDA sources of K2 and K3 run on the CPU, against their plain
PyTorch versions.

The kernels cannot run here (no card, no nvcc), but their C++ can: this
module compiles csrc/bounce.cu and csrc/nearest.cu with g++ against a
stand-in for the CUDA runtime, in which every CUDA thread is a std::thread,
a block's threads meet at a std::barrier (__syncthreads), blocks run one
after another and dynamic shared memory is one host buffer. Built without
FMA contraction, the emulated kernels follow the plain versions' float32
arithmetic step for step, so the comparison is exact apart from the
libm calls. What the emulation cannot show: the device compiler's own
output, warp-level intrinsics (K1's ballot is stubbed, so K1 is not run)
and speed. tests/test_torch_gpu.py and chip_smoke.py hold the built
kernels against the same plain versions on the card. A second build of
K2 with a planted error in Snell's law shows that the comparison rejects
a refraction that is slightly wrong.
"""
import ctypes
import re
import shutil
import subprocess

import pytest
import torch

import tracer_tpu_torch as ptt
from tracer_tpu_torch.kernels import bounce as kb
from tracer_tpu_torch.kernels import build
from tracer_tpu_torch.kernels import nearest as kn
from test_torch_gpu import (K2_MODES, T_EPS, bench_lanes, bench_modes,
                            fuzz_assembly, fuzz_rays, k2_compare, k2_instance,
                            k2_near, k2_scene, k3_compare, medium_att,
                            traced_rays)

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

_RUNTIME = r"""
// CPU stand-in for the CUDA runtime the kernels include
#pragma once
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <barrier>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
struct dim3 { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* g_block = nullptr;
inline std::vector<float> g_dynamic_smem(1 << 16);
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
inline unsigned __ballot_sync(unsigned, bool) { return 0; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void sincosf(float x, float* s, float* c) { *s = sinf(x); *c = cosf(x); }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline int min(int a, int b) { return a < b ? a : b; }
template <class K, class A>
void emulated_launch(K kernel, int grid, int block, size_t smem,
                     cudaStream_t, A args) {
  if (smem / sizeof(float) > g_dynamic_smem.size())
    g_dynamic_smem.resize(smem / sizeof(float));
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    g_block = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([=] {
        blockIdx.x = b;
        threadIdx.x = t;
        kernel(args);
      });
    for (auto& th : threads) th.join();
  }
}
"""


def _emulable(source: str) -> str:
    """A kernel source with its launches and shared arrays rewritten for
    the stand-in runtime."""
    source = re.sub(r"(\w+)\s*<<<(.*?)>>>\((.*?)\);",
                    r"emulated_launch(\1, \2, \3);", source, flags=re.S)
    source = re.sub(r"extern __shared__ (\w+) (\w+)\[\];",
                    r"\1* \2 = (\1*)g_dynamic_smem.data();", source)
    # a block's static shared arrays: one copy for all its threads
    return source.replace("__shared__ ", "static ")


# a K2 with Snell's law 0.1% off (the ratio of indices that turns the
# direction; the index the lane takes is right): k2_compare must reject it
_PLANTED = ("const float inv_nr = 1.0f / nrat;",
            "const float inv_nr = 1.001f / nrat;")


def _compile(d, names, planted=None):
    """Start g++ on the emulable sources ``names`` (csrc/*.cu stems) in
    directory ``d``, with the ``planted`` (old, new) text swap. Returns
    (process, library path)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    (d / "cuda_runtime.h").write_text(_RUNTIME)
    srcs = []
    for p in sorted(build._CSRC.iterdir()):
        text = p.read_text()
        if p.suffix != ".cu":
            (d / p.name).write_text(text)
        elif p.stem in names:
            if planted is not None:
                assert planted[0] in text
                text = text.replace(*planted)
            srcs.append(str(d / (p.stem + ".cpp")))
            (d / (p.stem + ".cpp")).write_text(_emulable(text))
    so = d / "libemulated.so"
    proc = subprocess.Popen(
        [gxx, "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         "-ffp-contract=off", f"-I{d}", "-o", str(so), *srcs],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return proc, so


def _load(proc, so):
    err = proc.communicate(timeout=600)[1]
    assert proc.returncode == 0, err[-3000:]
    out = ctypes.CDLL(str(so))
    for name, args in build._SIGNATURES.items():
        if hasattr(out, name):
            getattr(out, name).argtypes = args
            getattr(out, name).restype = ctypes.c_int
    return out


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The emulated kernels, and K2 with _PLANTED, built side by side."""
    jobs = (_compile(tmp_path_factory.mktemp("emulated"),
                     ("bounce", "nearest")),
            _compile(tmp_path_factory.mktemp("planted"), ("bounce",),
                     _PLANTED))
    return tuple(_load(*job) for job in jobs)


@pytest.fixture
def lib(libs):
    return libs[0]


def _k2(lib, rows, seed, pos, dirs, energy, groups, **kw):
    """tt_bounce on CPU tensors, marshalled as kb.bounce_reflect does."""
    rc, out = kb.launch_k2(lib, rows, seed, pos, dirs, energy, groups,
                           T_EPS, None, **kw)
    assert rc == 0, rc
    return out


def _k2_mode(lib, mode):
    """K2 through ``lib`` against its plain version in K2_MODES[mode] on
    two tiles: (k2_compare's results, kw, got, want, live)."""
    scene, dead, regen = K2_MODES[mode]
    n = 2 * kb.TILE
    table, spec = k2_scene(scene, n, "cpu")
    pos, dirs, e, lanes = bench_lanes(table, spec, n, dead, 3, "cpu")
    rows = kb.pack_rows(table)
    kw = dict(regen=regen, **lanes, **bench_modes(table, spec))
    got = _k2(lib, rows, 17, pos, dirs, e, table.groups, **kw)
    want = kb.bounce_reflect_ref(rows, 17, pos, dirs, e, table.groups,
                                 T_EPS, **kw)
    tp, td = traced_rays(spec, 17, pos, dirs, e, regen)
    live = (e > 0.0) | ((e <= 0.0) & regen)
    res = k2_compare(got, want, k2_near(rows, tp, td, table.groups), tp,
                     td, live, att=medium_att(kw),
                     decisions=lanes["ref_index"] is not None)
    return res, kw, got, want, live


@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_source_matches_plain(lib, mode):
    """K2's CUDA source in each of its instances (regeneration over a
    half-dead slab, the MiniDish's rows, the Lambertian lobe with
    bivariate slope error, spectral rows in an attenuating medium, the
    lens's Fresnel roulette, the ambient HG medium, the media ids, the
    lens in that medium and absorbing media without scattering) on two
    tiles: no flips, every lane within k2_compare's tolerance, and no ties
    but on the lens's seam (its 2 cm centre is thinner than the sag of two
    0.3 m caps at r = 0.077 m, so lanes there meet both rows at one
    point)."""
    (_, flips, _), kw, got, want, live = _k2_mode(lib, mode)
    assert flips == 0
    assert (want[3][live] != -1).float().mean() > 0.5
    refr, scat, media = k2_instance(kw)
    if scat:
        assert (want[3][live] == -2).float().mean() > 0.05
    if refr:
        # lanes cross refractive rows: their index or their medium changes
        assert (got[5] != kw["ref_index"]).any() or (
            media and (got[6] != kw["medium_id"]).any())


def test_k2_compare_rejects_planted_snell(libs):
    """The lens through a K2 whose Snell's law is 0.1% off (_PLANTED)
    fails k2_compare: its refracted directions miss the plain version's by
    up to 8e-4, far outside the rounding that the cosines of incidence
    and refraction excuse."""
    with pytest.raises(AssertionError):
        _k2_mode(libs[1], "lens")


def test_k3_source_matches_plain(lib):
    """K3's CUDA source on the table with every quadric class and aperture
    kind: no flips, aux within k3_compare's tolerance."""
    table, meta = ptt.compile_scene(fuzz_assembly(ptt, 0), device="cpu")
    n = 4096
    pos, dirs = (torch.tensor(a) for a in fuzz_rays(meta, n, 5))
    rows = kb.pack_rows(table)
    S, K = rows.shape
    gmeta = kn._group_meta(tuple(table.groups), "cpu")
    f32 = [torch.empty(s) for s in ((n,), (n, 3), (n, 3), (n,), (n,), (n,))]
    t, normal, local, up, p0, p1 = f32
    sid, kind, flags = (torch.empty(n, dtype=torch.int32) for _ in range(3))
    rc = lib.tt_nearest(
        rows.data_ptr(), S, K, len(table.groups), gmeta.data_ptr(),
        kn.MAX_C, pos.data_ptr(), dirs.data_ptr(), t.data_ptr(),
        sid.data_ptr(), normal.data_ptr(), local.data_ptr(), up.data_ptr(),
        kind.data_ptr(), flags.data_ptr(), p0.data_ptr(), p1.data_ptr(), n,
        T_EPS, 1e-6, 1, 0, None)
    assert rc == 0
    got = (t, sid, dict(normal=normal, local=local, up_dot=up, kind=kind,
                        flags=flags, p0=p0, p1=p1))
    args = (rows, pos, dirs, table.groups, T_EPS)
    ties, flips = k3_compare(got, kn.nearest_hit_ref(*args),
                             kn.nearest_two_t(*args), pos, dirs)
    assert flips == 0 and ties <= 1e-4 * n
