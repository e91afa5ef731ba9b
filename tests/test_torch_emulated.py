"""The CUDA sources of K1, K2 and K3 run on the CPU, against their plain
PyTorch versions.

The kernels cannot run here (no card, no nvcc), but their C++ can: this
module compiles csrc/bounce.cu and csrc/nearest.cu with g++ against a
stand-in for the CUDA runtime, in which every CUDA thread is a std::thread,
a block's threads meet at a std::barrier (__syncthreads), blocks run one
after another and dynamic shared memory is one host buffer. Built without
FMA contraction, the emulated kernels follow the plain versions' float32
arithmetic step for step, so the comparison is exact apart from the
libm calls. A warp's ballot or sum is every lane's vote gathered through
the block's barrier, so K1 (whose dead-lane rank is a ballot and a scan)
runs too, and a warp's barrier is the block's; an asynchronous copy to
shared memory (cp.async) is queued and made when its thread waits for
it, so a kernel that reads staged data before its wait and barrier reads
stale memory here. What the emulation cannot show: the device compiler's
own output, the timing of real warps, and speed. tests/test_torch_gpu.py
and chip_smoke.py hold the built kernels against the same plain versions
on the card. More builds with planted errors show that the comparisons
reject a kernel that is slightly wrong: K2 with Snell's law 0.1% off, K2
with the split branch's energy taken before the medium's attenuation, K2
skipping the row scan of dead lanes, K1 (and the row code it shares)
with the sign of a paraboloid's axial gradient flipped, K1 with its
aureole flag set on lanes that were not reborn, K3 testing a streamed
part of the table before its copies land, and K3 keeping the later row
on ties.
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
from test_torch_gpu import (K1_MODES, K2_MODES, T_EPS, fuzz_assembly,
                            fuzz_rays, k1_call, k1_compare, k1_lanes,
                            k1_live, k1_scene, k1_straddling, k2_compare,
                            k2_dead, k2_instance, k2_mode, k2_near,
                            k2_scene, k3_compare, medium_att, traced_rays)

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
struct alignas(16) float4 { float x, y, z, w; };
inline thread_local dim3 threadIdx, blockIdx;
inline dim3 gridDim;
inline std::barrier<>* g_block = nullptr;
inline std::vector<float> g_dynamic_smem(1 << 16);
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaFuncAttributeMaxDynamicSharedMemorySize = 2 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
// three SMs: K2's persistent blocks each walk several chunks
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 3;
  return cudaSuccess;
}
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class K> cudaError_t cudaFuncSetAttribute(K, int, int) {
  return cudaSuccess;
}
template <class K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int,
                                                          size_t) {
  *n = 1;
  return cudaSuccess;
}
inline void __syncthreads() { g_block->arrive_and_wait(); }
// a warp's barrier: the block's, which every thread of a block reaches as
// often as a warp's in the kernels
inline void __syncwarp(unsigned = 0xffffffffu) { __syncthreads(); }
inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32);
}
// a warp's ballot: every thread of the block votes through one shared
// array between two barriers (all of a block's threads reach each ballot)
inline std::vector<int> g_ballot(1024);
inline unsigned __ballot_sync(unsigned, bool vote) {
  const unsigned t = threadIdx.x;
  g_ballot[t] = vote;
  __syncthreads();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i)
    m |= (unsigned)(g_ballot[(t & ~31u) + i] != 0) << i;
  __syncthreads();
  return m;
}
// a warp's sum, gathered the same way
inline int __reduce_add_sync(unsigned, int v) {
  const unsigned t = threadIdx.x;
  g_ballot[t] = v;
  __syncthreads();
  int sum = 0;
  for (unsigned i = 0; i < 32; ++i) sum += g_ballot[(t & ~31u) + i];
  __syncthreads();
  return sum;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void sincosf(float x, float* s, float* c) { *s = sinf(x); *c = cosf(x); }
inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
template <class K, class A>
void emulated_launch(K kernel, int grid, int block, size_t smem,
                     cudaStream_t, A args) {
  if (smem / sizeof(float) > g_dynamic_smem.size())
    g_dynamic_smem.resize(smem / sizeof(float));
  gridDim.x = grid;
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

_PIPELINE = r"""
// CPU stand-in for the asynchronous copies (cp.async): a thread's copies
// are queued, committed in groups and made when it waits for them
#pragma once
#include <string.h>
#include <vector>
struct PendingCopy { void* dst; const void* src; size_t n; };
inline thread_local std::vector<PendingCopy> g_open;
inline thread_local std::vector<std::vector<PendingCopy>> g_groups;
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n,
                                    size_t = 0) {
  g_open.push_back({dst, src, n});
}
inline void __pipeline_commit() {
  g_groups.push_back(g_open);
  g_open.clear();
}
inline void __pipeline_wait_prior(size_t prior) {
  while (g_groups.size() > prior) {
    for (const PendingCopy& c : g_groups.front()) memcpy(c.dst, c.src, c.n);
    g_groups.erase(g_groups.begin());
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
# a K2 whose split branch takes R of the energy before the medium's
# attenuation: k2_compare must reject it on TIR lanes in an absorbing
# ambient
_PLANTED_SPLIT = ("o.s_e = o.split ? e_out * r_split : 0.0f;",
                  "o.s_e = o.split ? in.e * r_split : 0.0f;")
# a K2 that skips the row scan for the lanes that enter dead and are not
# regenerated (their outputs left as their inputs): k2_compare must
# reject it on the drain's half-dead lanes
_PLANTED_DEAD = ("  const bool hit = b.sid >= 0;\n  const Modes& md",
                 "  const bool hit = b.sid >= 0 && in.e > 0.0f;\n"
                 "  const Modes& md")
# the paraboloid's axial gradient with its sign flipped (rows.cuh): the
# curved field's normals tilt the other way, which k1_compare must reject
_PLANTED_GRADIENT = ("      glz = qd[8];", "      glz = -qd[8];")
# K1's aureole flag raised on every lane while parking is on, reborn or
# not: k1_compare must reject the encoded sids of lanes that carried
# their ray in
_PLANTED_AUREOLE = ("a.e[l] <= 0.0f &&", "a.e[l] < 1e30f &&")
# a K3 that tests each streamed part of the table before its cp.async
# copies have landed (it waits after the part's rows): k3_compare must
# reject the rows it reads stale
_PLANTED_K3_WAIT = (
    ("        __pipeline_wait_prior(1);\n        __syncthreads();\n"
     "        scan_groups<kC1, true>(", "        scan_groups<kC1, true>("),
    ("        // every lane is done with the buffer before part p + 2 lands "
     "in it\n", "        __pipeline_wait_prior(1);\n"
     "        __syncthreads();\n"))
# a K3 that keeps the later row on ties (<= for <): a lane that misses
# every row keeps the last one, which k3_compare must reject
_PLANTED_K3_TIES = ("    if (th < t) {", "    if (th <= t) {")


def _compile(d, names, planted=None):
    """Start g++ on the emulable sources ``names`` (csrc/*.cu stems) in
    directory ``d``, with the ``planted`` (old, new) text swap, or each of
    a tuple of them, in whichever source or header holds it. Returns
    (process, library path)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the CUDA sources for the CPU")
    (d / "cuda_runtime.h").write_text(_RUNTIME)
    (d / "cuda_pipeline_primitives.h").write_text(_PIPELINE)
    srcs = []
    swaps = (() if planted is None else
             (planted,) if isinstance(planted[0], str) else planted)
    found = [False] * len(swaps)
    for p in sorted(build._CSRC.iterdir()):
        text = p.read_text()
        for i, swap in enumerate(swaps):
            if swap[0] in text:
                text = text.replace(*swap)
                found[i] = True
        if p.suffix != ".cu":
            (d / p.name).write_text(text)
        elif p.stem in names:
            srcs.append(str(d / (p.stem + ".cpp")))
            (d / (p.stem + ".cpp")).write_text(_emulable(text))
    assert all(found), planted
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
    """The emulated kernels, K2 with _PLANTED, K1 with _PLANTED_GRADIENT,
    K2 with _PLANTED_SPLIT, K1 with _PLANTED_AUREOLE, K2 with
    _PLANTED_DEAD, K3 with _PLANTED_K3_WAIT and K3 with _PLANTED_K3_TIES,
    built side by side."""
    jobs = (_compile(tmp_path_factory.mktemp("emulated"),
                     ("bounce", "nearest")),
            _compile(tmp_path_factory.mktemp("planted"), ("bounce",),
                     _PLANTED),
            _compile(tmp_path_factory.mktemp("planted_gradient"),
                     ("bounce",), _PLANTED_GRADIENT),
            _compile(tmp_path_factory.mktemp("planted_split"), ("bounce",),
                     _PLANTED_SPLIT),
            _compile(tmp_path_factory.mktemp("planted_aureole"),
                     ("bounce",), _PLANTED_AUREOLE),
            _compile(tmp_path_factory.mktemp("planted_dead"), ("bounce",),
                     _PLANTED_DEAD),
            _compile(tmp_path_factory.mktemp("planted_k3_wait"),
                     ("nearest",), _PLANTED_K3_WAIT),
            _compile(tmp_path_factory.mktemp("planted_k3_ties"),
                     ("nearest",), _PLANTED_K3_TIES))
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


def _k2_mode(lib, mode, n=2 * kb.TILE):
    """K2 through ``lib`` against its plain version in K2_MODES[mode] on
    ``n`` lanes (two tiles), the lanes that enter dead and are not
    regenerated included: (k2_compare's results, kw, got, want, live)."""
    table, spec, rows, pos, dirs, e, kw, regen = k2_mode(mode, n, 3, "cpu")
    got = _k2(lib, rows, 17, pos, dirs, e, table.groups, **kw)
    want = kb.bounce_reflect_ref(rows, 17, pos, dirs, e, table.groups,
                                 T_EPS, **kw)
    tp, td = traced_rays(spec, 17, pos, dirs, e, regen)
    live = (e > 0.0) | ((e <= 0.0) & regen)
    res = k2_compare(got, want, k2_near(rows, tp, td, table.groups,
                                        backside_miss=kw["backside_miss"]),
                     tp, td, live, att=medium_att(kw),
                     decisions=kw["ref_index"] is not None,
                     split=kw["refr_split"],
                     dead=k2_dead(rows, 17, pos, dirs, e, table.groups, kw))
    return res, kw, got, want, live


@pytest.mark.parametrize("mode", K2_MODES)
def test_k2_source_matches_plain(lib, mode):
    """K2's CUDA source in each of its instances (regeneration over a
    half-dead slab, the MiniDish's rows, the Lambertian lobe with
    bivariate slope error, spectral rows in an attenuating medium, the
    lens's Fresnel roulette, the ambient HG medium, the media ids, the
    lens in that medium, absorbing media without scattering, and the stage
    (d)/(e) kinds: config 7's Cook-Torrance target, the transparent,
    Lambertian-specular and semi-Lambertian scene, a dispersive conductor,
    IAM with c = 2, a bilinear piecewise grid, a periodic cell in its HG
    medium; energy splitting on the split lens and on TIR lanes in an
    absorbing ambient; the stage (d)/(e) kinds beside refraction and
    media ids: the glazed config 7, the lens in an HG medium over a
    Cook-Torrance floor, an absorbing slab beside a transparent sheet,
    config 8b's box with a Lambertian-specular floor; and the
    backside_miss twin of every instance) on two tiles: no flips, every
    lane within k2_compare's tolerance, and no ties but on the lens's
    seam (its 2 cm centre is thinner than the sag of two 0.3 m caps at r
    = 0.077 m, so lanes there meet both rows at one point)."""
    (_, flips, _), kw, got, want, live = _k2_mode(lib, mode)
    assert flips == 0
    # the rect source covers the whole field, whose mirrors take a sixth
    # of its rays; the HG medium scatters most of the lens's beam in the
    # air before the floor
    share = {"rect_regen": 0.1}.get(mode, 0.5)
    assert (want[3][live] != -1).float().mean() > share
    refr, scat, media = k2_instance(kw)[:3]
    if scat:
        assert (want[3][live] == -2).float().mean() > 0.05
    if refr:
        # lanes cross refractive rows: their index or their medium changes
        assert (got[5] != kw["ref_index"]).any() or (
            media and (got[6] != kw["medium_id"]).any())
    if kw["refr_split"]:
        # lanes split, and on the TIR lanes all of the energy leaves on
        # the reflected branch
        s_e = want[-2]
        assert (s_e[live] > 0.0).float().mean() > 0.3
        if mode == "split_tir":
            assert ((want[2] == 0.0) & (s_e > 0.0)).sum() > 500


def test_k2_compare_rejects_planted_dead_lanes(libs):
    """The drain's half-dead lanes through a K2 that skips the row scan
    for the lanes that enter dead (_PLANTED_DEAD: their outputs left as
    their inputs) fail k2_compare: their points and directions are not
    the plain version's hits, though their sid (-1) and energy (0) agree;
    the same build passes the live lanes of a regenerating mode."""
    with pytest.raises(AssertionError):
        _k2_mode(libs[5], "drain")
    (_, flips, _), *_ = _k2_mode(libs[5], "regen")
    assert flips == 0


@pytest.mark.parametrize("mode", ("drain", "regen", "split_lens"))
def test_k2_ragged_chunks(lib, mode):
    """K2's CUDA source over a lane count that ends inside a chunk (two
    tiles less five lanes), its persistent blocks each walking several
    chunks: every lane, dead ones included, within k2_compare's tolerance
    of the plain version and no flips."""
    (_, flips, _), kw, got, want, live = _k2_mode(lib, mode,
                                                  2 * kb.TILE - 5)
    assert flips == 0 and got[0].shape[0] == 2 * kb.TILE - 5
    assert (want[3][live] != -1).float().mean() > 0.3


def test_k2_source_every_aperture_kind(lib):
    """K2's CUDA source on the table with every quadric class and every
    aperture kind, two aperture slots a row (so its scan reads the slot
    count at run time), a third of the lanes dead: no flips, every lane
    within k2_compare's tolerance of the plain version, dead ones
    included."""
    table, meta = ptt.compile_scene(fuzz_assembly(ptt, 0), device="cpu")
    n = 4096
    pos, dirs = (torch.tensor(a) for a in fuzz_rays(meta, n, 5))
    g = torch.Generator().manual_seed(1)
    e = torch.where(torch.rand(n, generator=g) < 0.3, 0.0, 1.0)
    rows = kb.pack_rows(table)
    assert (rows.shape[1] - kb.ROW_AP) // 6 == 2
    kw = dict(bivar=True, one_sided=False, slope=False)
    got = _k2(lib, rows, 17, pos, dirs, e, table.groups, **kw)
    want = kb.bounce_reflect_ref(rows, 17, pos, dirs, e, table.groups,
                                 T_EPS, **kw)
    _, flips, _ = k2_compare(
        got, want, k2_near(rows, pos, dirs, table.groups), pos, dirs,
        e > 0.0, dead=k2_dead(rows, 17, pos, dirs, e, table.groups,
                              dict(kw, regen=False)))
    assert flips == 0
    assert (want[3][e > 0.0] >= 0).float().mean() > 0.3


def test_k2_geometry_matches_wrapper(lib):
    """K2's launch geometry is the wrapper's: chunks of whole warps, one
    lane a thread, the stage kb.k2_stage_floats (the rows padded to
    16-byte words), and as many persistent blocks as the card keeps
    resident, never more than there are chunks."""
    table, *_ = k2_scene(1, kb.TILE, "cpu")
    rows = kb.pack_rows(table)
    S, K = rows.shape
    modes = kb._modes(True, True, True, False, 0.0, False, False, False,
                      0.0, 0.0, False, (False,) * len(kb.EXTRA_MODES))
    for chunks in (11, 1):
        out = (ctypes.c_int * 6)()
        rc = lib.tt_k2_geometry(S, K, 0, 0, 0, 0, ctypes.addressof(modes),
                                256 * (chunks - 1) + 3,
                                ctypes.addressof(out))
        assert rc == 0
        blocks, threads, chunk, smem, resident, sms = out
        assert chunk == threads and threads % 32 == 0
        n = 256 * (chunks - 1) + 3
        assert blocks == min(-(-n // chunk), sms * resident)
        assert (smem, resident, sms) == (4 * kb.k2_stage_floats(S, K), 1, 3)


def test_k2_compare_rejects_planted_split_energy(libs):
    """TIR lanes in an absorbing ambient through a K2 whose split branch
    takes R of the energy before the medium's attenuation
    (_PLANTED_SPLIT) fail k2_compare: the branch carries e where the plain
    version's carries e exp(-att t)."""
    with pytest.raises(AssertionError):
        _k2_mode(libs[3], "split_tir")


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


def _k3_case(case):
    """(table, pos, dirs, keywords) of K3 case ``case`` (K3_CASES)."""
    import math
    import numpy as np
    from tracer_tpu_torch.models.tau_minidish import MiniDish
    from tracer_tpu_torch.sources import solar_disk_bundle
    from test_torch_gpu import bifacial_assembly
    if case in ("minidish", "minidish_local_off"):
        asm = MiniDish(5.0, 6.25, 0.9, 6.95, 0.4, 0.7, 0.9)
        asm.set_transform(ptt.spatial.rotx(-np.pi / 4))
        table, _ = ptt.compile_scene(asm, device="cpu")
        x = -1.0 / math.sqrt(2.0)
        sun = solar_disk_bundle(torch.Generator().manual_seed(42), 4096,
                                [0.0, 7.0, 7.0], [0.0, x, x], 3.0, 0.005,
                                flux=1000.0, device="cpu")
        return (table, sun.pos.contiguous(), sun.dir.contiguous(),
                dict(need_local=case == "minidish"))
    asm, n, seed = {
        "ragged": (fuzz_assembly(ptt, 0), 4091, 7),
        "bifacial": (bifacial_assembly(ptt), 4096, 8),
        "streamed": (fuzz_assembly(ptt, 1, extra=300), 4093, 9),
        "many_rows": (fuzz_assembly(ptt, 2, extra=100, every_kind=False),
                      4095, 10),
        "streamed_one_slot": (fuzz_assembly(ptt, 3, extra=400,
                                            every_kind=False), 4093, 11),
    }[case]
    table, meta = ptt.compile_scene(asm, device="cpu")
    pos, dirs = (torch.tensor(a) for a in fuzz_rays(meta, n, seed))
    return table, pos, dirs, dict(backside_miss="bifacial" in
                                  table.features)


# K3's cases through its CUDA source: the MiniDish's rows under its sun,
# with and without the local hit point, a lane count that ends inside a
# chunk and a 16-byte word, the bifacial plates with backside_miss, a
# table of two aperture slots that streams through the stage in three
# parts, groups spanning them, and tables of one slot and 100 or 400 rows,
# staged whole or streamed (the winner's aux made from the stage or from
# device memory); every count but the MiniDish's ragged
K3_CASES = ("minidish", "minidish_local_off", "ragged", "bifacial",
            "streamed", "many_rows", "streamed_one_slot")


def _k3_mode(lib, case):
    """K3 through ``lib`` against its plain version in K3 case ``case``:
    (k3_compare's ties, got, want, table, rows)."""
    table, pos, dirs, kw = _k3_case(case)
    rows = kb.pack_rows(table)
    args = (rows, pos, dirs, table.groups, T_EPS)
    rc, got = kn.launch_k3(lib, *args, None, **kw)
    assert rc == 0, rc
    want = kn.nearest_hit_ref(*args, **kw)
    ties, flips = k3_compare(got, want, kn.nearest_two_t(
        *args, backside_miss=kw.get("backside_miss", False)), pos, dirs)
    assert flips == 0 and ties <= 1e-4 * pos.shape[0] + 1
    return ties, got, want, table, rows


@pytest.mark.parametrize("case", K3_CASES)
def test_k3_source_cases(lib, case):
    """K3's CUDA source against its plain version in each K3 case: no
    flips, ties within 1e-4 of the lanes, aux within k3_compare's
    tolerance; hits on at least a quarter of the lanes; the local point
    zeros without need_local (every other output as with it); the
    bifacial rows rejecting back-side arrivals (the winner moves to the
    plate's other face on over 100 lanes); the streamed table longer
    than two of its parts (csrc/nearest.cu: rows beyond K3_TABLE_FLOATS),
    with a group that crosses a part's end."""
    _, got, want, table, rows = _k3_mode(lib, case)
    assert (want[1] >= 0).float().mean() > 0.25
    if case == "minidish_local_off":
        assert torch.equal(got[2]["local"],
                           torch.zeros_like(got[2]["local"]))
        _, with_local, *_ = _k3_mode(lib, "minidish")
        assert torch.equal(got[0], with_local[0])
        assert torch.equal(got[1], with_local[1])
        for k in ("normal", "up_dot", "kind", "flags", "p0", "p1"):
            assert torch.equal(got[2][k], with_local[2][k]), k
    if case == "bifacial":
        no_bmiss = kn.nearest_hit_ref(rows, *_k3_case(case)[1:3],
                                      table.groups, T_EPS)
        assert (no_bmiss[1] != want[1]).sum() > 100
    if case.startswith("streamed"):
        geo = _k3_geometry(lib, rows, 4096)
        part = geo["part"]
        assert 2 * part < rows.shape[0] < 3 * part
        assert any(g[0] // part != (g[1] - 1) // part for g in table.groups)


def _k3_geometry(lib, rows, n, backside_miss=False):
    out = (ctypes.c_int * 6)()
    rc = lib.tt_k3_geometry(*rows.shape, int(backside_miss), n,
                            ctypes.addressof(out))
    assert rc == 0
    return dict(zip(("blocks", "threads", "smem", "resident", "sms",
                     "part"), out))


def test_k3_geometry_matches_wrapper(lib):
    """K3's launch geometry: chunks of whole warps, one lane a thread; on
    a table staged whole as many persistent blocks as the card keeps
    resident and never more than there are chunks, on a streamed one a
    block a chunk; and a stage of each warp's two ray buffers and the
    table (whole at its padded stride, or two streamed parts)."""
    for extra, every, n in ((0, True, 4091), (300, True, 4093),
                            (0, True, 100), (100, False, 9000),
                            (400, False, 4093), (60, False, 999)):
        table, _ = ptt.compile_scene(fuzz_assembly(ptt, 1, extra=extra,
                                                   every_kind=every),
                                     device="cpu")
        rows = kb.pack_rows(table)
        S, K = rows.shape
        geo = _k3_geometry(lib, rows, n)
        Kp = -(-K // 4) * 4
        assert geo["threads"] % 32 == 0
        chunks = -(-n // geo["threads"])
        whole = geo["part"] == S
        assert geo["blocks"] == (min(chunks, geo["sms"] * geo["resident"])
                                 if whole else chunks)
        table_floats = S * Kp if whole else 2 * geo["part"] * Kp
        assert geo["smem"] == 4 * (12 * geo["threads"] + table_floats)


def test_k3_compare_rejects_planted_wait(libs):
    """The streamed table through a K3 that tests each part before its
    cp.async copies have landed (_PLANTED_K3_WAIT) fails k3_compare: the
    stage still holds another part's rows."""
    with pytest.raises(AssertionError):
        _k3_mode(libs[6], "streamed")


@pytest.mark.parametrize("case", ("ragged", "many_rows"))
def test_k3_compare_rejects_planted_ties(libs, case):
    """The every-class table and a table of one slot and 100 rows through
    a K3 that keeps the later row on ties (_PLANTED_K3_TIES) fail
    k3_compare: lanes that miss every row come back with the last row's
    id."""
    with pytest.raises(AssertionError):
        _k3_mode(libs[7], case)


# K1 on three tiles of a 16-tile culling over 40 pads: two traced (a third
# and a half of their dead lanes within quota), one idle
K1_TILES = (3, 4, 5)


def _k1_fn(lib):
    """tt_bounce_culled through ``lib`` on CPU tensors, with the
    wrapper's arguments (kb.launch_k1 marshals them)."""
    def fn(rows, lists, counts, cells, cb, seed, rem, act, pos, dirs, e,
           groups, offsets, t_eps, **kw):
        rc, out = kb.launch_k1(lib, rows, lists, counts, cells, cb, seed,
                               rem, act, pos, dirs, e, groups, offsets,
                               t_eps, None, **kw)
        assert rc == 0, rc
        return out
    return fn


def _k1_mode(lib, mode):
    """K1 through ``lib`` against its plain version in K1 mode ``mode``
    (regeneration, slope error and every switch the field's kinds set):
    (k1_compare's results, got, want, live)."""
    slab = 16 * kb.TILE
    table, meta, culling, spec = k1_scene(mode, 40, slab, "cpu")
    lanes = k1_lanes(meta, culling, K1_TILES, 3, 0.4, "cpu", spec[13])
    rem = torch.tensor([kb.TILE, 400, kb.TILE], dtype=torch.int32)
    act = torch.tensor([1, 1, 0], dtype=torch.int32)
    args = (table, culling, spec, K1_TILES, 13, lanes, rem, act)
    got = k1_call(_k1_fn(lib), *args)
    want = k1_call(kb.bounce_reflect_culled_ref, *args)
    live = k1_live(lanes[2], rem, act)
    return k1_compare(got, want, live, max_flips=0), got, want, live


@pytest.mark.parametrize("mode", K1_MODES)
def test_k1_source_matches_plain(lib, mode):
    """K1's CUDA source in each mode beyond the NSTTF's (the curved
    field's two classes, rect cells, the Lambertian receiver, spectral
    mirrors on a wavelength lane in an attenuating ambient, conductor
    mirrors over an IAM receiver with c = 2, bifacial mirrors, aureole
    parking under a Buie disk and on rect cells) on two traced tiles and
    an idle one, with regeneration and slope error: no flips (encoded
    sids included), every lane within k1_compare's tolerance, the
    wavelength lane where the field has one; hits on at least a quarter
    of the live lanes, at least 10 encoded sids where lanes park, and the
    idle tile passed through."""
    _, got, want, live = _k1_mode(lib, mode)
    assert (want[3][live] >= 0).float().mean() > 0.25
    assert (int((want[3] <= -16).sum()) >= 10) == mode.startswith("aureole")
    idle = slice(2 * kb.TILE, 3 * kb.TILE)
    assert (got[3][idle] == -1).all() and (got[4][idle] == 0).all()
    assert (len(got) == 6) == (mode == "spectral")


def test_k1_compare_rejects_planted_gradient(libs):
    """The curved field through a K1 whose paraboloid gradient has its
    axial sign flipped (_PLANTED_GRADIENT) fails k1_compare: its normals
    tilt by up to twice the facets' slope at their rims."""
    with pytest.raises(AssertionError):
        _k1_mode(libs[2], "curved")


def test_k1_compare_rejects_planted_aureole(libs):
    """The parked rect-cell field through a K1 that raises its aureole
    flag on lanes that were not reborn (_PLANTED_AUREOLE) fails
    k1_compare: their hits come back encoded."""
    with pytest.raises(AssertionError):
        _k1_mode(libs[4], "aureole_rect")


@pytest.mark.parametrize("mode", ("rect", "curved"))
def test_k1_ranks_across_sub_tiles(lib, mode):
    """K1's CUDA source (the NSTTF instance on rect cells, the general one
    on the curved field) over four tiles whose dead lanes straddle the
    boundaries of its sub-tiles (k1_straddling), with quotas of 0, one
    ending inside the third sub-tile, one past the tile's dead count and
    TILE: no
    flips, every live lane within k1_compare's tolerance, and lanes
    leaving with energy exactly where the plain version's do, so each
    sub-tile's ranks continue its tile's flat order as the engine's cumsum
    does."""
    table, meta, culling, spec = k1_scene(mode, 40, 16 * kb.TILE, "cpu")
    tiles = (3, 4, 5, 6)
    lanes, rem = k1_straddling(meta, culling, tiles, 5, "cpu", spec[13])
    act = torch.ones(4, dtype=torch.int32)
    args = (table, culling, spec, tiles, 29, lanes, rem, act)
    got = k1_call(_k1_fn(lib), *args)
    want = k1_call(kb.bounce_reflect_culled_ref, *args)
    k1_compare(got, want, k1_live(lanes[2], rem, act), max_flips=0)
    assert torch.equal(got[2] > 0.0, want[2] > 0.0)
    # the quotas reach past the tiles' first sub-tiles
    reborn = (lanes[2] <= 0.0) & k1_live(lanes[2], rem, act)
    sub = kb.TILE // kb.K1_SPLIT
    assert reborn.view(4, kb.K1_SPLIT, sub).any(2).sum(1).tolist() == [
        0, 3, kb.K1_SPLIT, kb.K1_SPLIT]


def test_k1_tile_order_moves_nothing(lib):
    """K1's CUDA source dispatching its tiles in other orders (the
    derived heaviest-first, the identity, a rotation) gives every output
    bit for bit the same: a block reads and writes only its own tile."""
    table, meta, culling, spec = k1_scene("curved", 40, 16 * kb.TILE, "cpu")
    lanes = k1_lanes(meta, culling, K1_TILES, 3, 0.4, "cpu", spec[13])
    rem = torch.tensor([kb.TILE, 400, kb.TILE], dtype=torch.int32)
    act = torch.tensor([1, 1, 0], dtype=torch.int32)
    args = (table, culling, spec, K1_TILES, 13, lanes, rem, act)
    outs = [k1_call(_k1_fn(lib), *args, **({} if o is None else dict(
        order=torch.tensor(o, dtype=torch.int32))))
        for o in (None, (0, 1, 2), (2, 0, 1))]
    for other in outs[1:]:
        for g, t in zip(outs[0], other):
            assert torch.equal(g, t)


def _offset(t):
    """A contiguous view of a copy of ``t`` whose data starts 4 bytes past
    a 16-byte boundary."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype)
    view = flat[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 == 4
    return view


def test_k1_unaligned_rays_are_copied(lib):
    """Rays and energies that start 4 bytes past a 16-byte boundary go to
    K1's CUDA source as its wrapper hands them on (kb._aligned16: a fresh
    aligned copy, where the kernel's 16-byte stages need one) and give
    every output bit for bit the aligned tensors' results."""
    table, meta, culling, spec = k1_scene("rect", 40, 16 * kb.TILE, "cpu")
    lanes = k1_lanes(meta, culling, K1_TILES, 3, 0.4, "cpu", spec[13])
    rem = torch.tensor([kb.TILE, 400, kb.TILE], dtype=torch.int32)
    act = torch.tensor([1, 1, 0], dtype=torch.int32)
    args = (table, culling, spec, K1_TILES, 13)
    views = tuple(_offset(t) for t in lanes[:3])
    handed = tuple(kb._aligned16(v) for v in views)
    assert all(h.data_ptr() % 16 == 0 and torch.equal(h, v)
               for h, v in zip(handed, views))
    assert kb._aligned16(lanes[0]) is lanes[0]
    want = k1_call(_k1_fn(lib), *args, lanes, rem, act)
    got = k1_call(_k1_fn(lib), *args, handed + lanes[3:], rem, act)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_k1_geometry_matches_wrapper(lib):
    """The source's cut of a tile is the one the wrapper and the tests
    assume (kb.K1_SPLIT blocks of TILE / K1_SPLIT lanes), and a block
    stages its sub-tile's rays beside the candidate rows."""
    out = (ctypes.c_int * 5)()
    modes = kb._culled_modes(True, True, True, False, 0.0, False, False,
                             False, False)
    rc = lib.tt_k1_geometry(31, 36, 0, 1, 0, ctypes.addressof(modes),
                            ctypes.addressof(out))
    assert rc == 0
    split, threads, sub, smem, _ = out
    assert (split, sub) == (kb.K1_SPLIT, kb.TILE // kb.K1_SPLIT)
    assert sub % threads == 0
    assert smem == 4 * (kb.K1_RAY_FLOATS + 31 * 36 + 31)
