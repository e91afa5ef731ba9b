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
kernels against the same plain versions on the card.
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
from tracer_tpu_torch.models.bench_configs import bench_scene
from test_torch_gpu import (T_EPS, bench_lanes, bench_modes, fuzz_assembly,
                            fuzz_rays, k2_compare, k3_compare, traced_rays)

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


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    d = tmp_path_factory.mktemp("emulated")
    (d / "cuda_runtime.h").write_text(_RUNTIME)
    srcs = []
    for p in sorted(build._CSRC.iterdir()):
        text = p.read_text()
        if p.suffix == ".cu":
            text = _emulable(text)
            srcs.append(str(d / (p.stem + ".cpp")))
            (d / (p.stem + ".cpp")).write_text(text)
        else:
            (d / p.name).write_text(text)
    so = d / "libemulated.so"
    r = subprocess.run([gxx, "-std=c++20", "-O1", "-fPIC", "-shared",
                        "-pthread", "-ffp-contract=off", f"-I{d}", "-o",
                        str(so), *srcs], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    out = ctypes.CDLL(str(so))
    for name, args in build._SIGNATURES.items():
        getattr(out, name).argtypes = args
        getattr(out, name).restype = ctypes.c_int
    return out


def _k2(lib, rows, seed, pos, dirs, energy, groups, *, disc_eps=1e-6,
        bivar=True, one_sided=True, slope=True, lambertian=False,
        source_spec=None, regen=False, wavelength=None, spectral_tab=None,
        ambient_att=0.0):
    """tt_bounce on CPU tensors, marshalled as kb.bounce_reflect does."""
    n = pos.shape[0]
    S, K = rows.shape
    gmeta = kn._group_meta(tuple(groups), pos.device)
    srcp = kb._source_tensor(source_spec, pos.device) if regen else None
    pose = torch.as_tensor(kb.source_pose(source_spec)) if regen else None
    outs = kb._ray_outputs(n, pos.device)
    nwl = torch.empty_like(wavelength) if wavelength is not None else None

    def ptr(t):
        return None if t is None else t.data_ptr()
    rc = lib.tt_bounce(
        rows.data_ptr(), S, K, len(groups), gmeta.data_ptr(), kn.MAX_C,
        int(seed), pos.data_ptr(), dirs.data_ptr(), energy.data_ptr(),
        ptr(wavelength), *(o.data_ptr() for o in outs[:3]), ptr(nwl),
        outs[3].data_ptr(), outs[4].data_ptr(), n, float(T_EPS),
        float(disc_eps), int(regen), ptr(srcp), ptr(pose),
        ptr(spectral_tab), spectral_tab.shape[0] if nwl is not None else 0,
        kb._BIVAR_MODE[bivar], int(one_sided), int(slope), int(lambertian),
        float(ambient_att), None)
    assert rc == 0, rc
    return outs if nwl is None else outs + (nwl,)


@pytest.mark.parametrize("cfg,dead,regen", [(1, 0.5, True), (1, 0.0, False),
                                            (2, 0.5, True), (3, 0.5, True)],
                         ids=["regen", "minidish", "lambertian", "spectral"])
def test_k2_source_matches_plain(lib, cfg, dead, regen):
    """K2's CUDA source in each mode of the plain megakernel (regeneration
    over a half-dead slab, the MiniDish's rows, the Lambertian lobe with
    bivariate slope error, spectral rows in an attenuating medium) on two
    tiles: no ties, no flips, every lane within k2_compare's tolerance."""
    n = 2 * kb.TILE
    table, _, source_fn = bench_scene(cfg, n, "cpu")
    spec = source_fn.pallas_spec
    pos, dirs, e, wl = bench_lanes(table, spec, n, dead, 3, "cpu")
    rows = kb.pack_rows(table)
    kw = dict(regen=regen, wavelength=wl, **bench_modes(table, spec))
    got = _k2(lib, rows, 17, pos, dirs, e, table.groups, **kw)
    want = kb.bounce_reflect_ref(rows, 17, pos, dirs, e, table.groups,
                                 T_EPS, **kw)
    tp, td = traced_rays(spec, 17, pos, dirs, e, regen)
    live = (e > 0.0) | ((e <= 0.0) & regen)
    ties, flips, _ = k2_compare(
        got, want, kn.nearest_two_t(rows, tp, td, table.groups, T_EPS), tp,
        td, live, att=kw["ambient_att"])
    assert (ties, flips) == (0, 0)
    assert (want[3][live] >= 0).float().mean() > 0.5


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
