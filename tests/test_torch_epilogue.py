"""The K3 epilogue (kernels/epilogue.py, csrc/epilogue.cu) against the
plain bounce it replaces in trace_fused (kernels/shade.py,
engine._account, analysis/device_fluxmap.accumulate).

On the CPU: the gate (engine._epilogue_ok) for the model library's scenes
and for float64, volumetric, dispersive, splitting and polychromatic
inputs, and trace_fused on CPU tensors bit for bit the plain loop; then
the kernel's C++ itself, built with g++ against tests/test_torch_emulated's
stand-in for the CUDA runtime (here with shared-memory atomics and a
warp's match, gathered through the block's barrier as its ballots are),
driven through trace_fused on CPU tensors. Built without FMA contraction,
the emulated kernel's positions, energies and bins are the plain path's
to the last bit on the MiniDish's flat receiver.

On the card (marked cuda; the GPU machine has no jax, which
tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_epilogue.py

the same comparisons on the built kernel at 4,194,304 lanes, and its
launch counter against K3's.

Every comparison of sums takes the plain path's per-lane results summed
in float64: its own float32 flux bins take one serial add a lane
(index_add_), whose rounding would swamp the tolerance.
"""
import contextlib
import ctypes
import dataclasses
import math
from functools import partial
import unittest.mock

import numpy as np
import pytest
import torch

import tracer_tpu_torch as ptt
from tracer_tpu_torch import engine
from tracer_tpu_torch import materials as M
from tracer_tpu_torch.analysis import device_fluxmap as dfm
from tracer_tpu_torch.bundle import RayBundle
from tracer_tpu_torch.engine import TraceAccum, trace_fused
from tracer_tpu_torch.kernels import build
from tracer_tpu_torch.kernels import epilogue as ke
from tracer_tpu_torch.kernels import nearest as kn
from tracer_tpu_torch.models.bench_configs import bench_scene
from tracer_tpu_torch.models.tau_minidish import MiniDish
from tracer_tpu_torch.scene import Assembly, AssembledObject, Surface
from tracer_tpu_torch.sources import solar_disk_bundle

# the suite runs several test processes at once: one torch thread each
# keeps them from oversubscribing the cores
torch.set_num_threads(1)

MIN_E = 1e-6
CARD_LANES = 4 * 1024 * 1024
EMU_LANES = 6144
# what the epilogue needs of the stand-in runtime beyond K1's, K2's and
# K3's: float atomics on shared memory, a warp's match (every thread of
# the block reaches each match, as each ballot), IEEE operations
_EMU_RUNTIME = r"""
#include <mutex>
inline std::mutex g_atomic;
inline float atomicAdd(float* p, float v) {
  std::lock_guard<std::mutex> lock(g_atomic);
  const float old = *p;
  *p = old + v;
  return old;
}
inline unsigned __match_any_sync(unsigned, int key) {
  const unsigned t = threadIdx.x;
  g_ballot[t] = key;
  __syncthreads();
  unsigned m = 0;
  for (unsigned i = 0; i < 32; ++i)
    m |= (unsigned)(g_ballot[(t & ~31u) + i] == key) << i;
  __syncthreads();
  return m;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
"""


# ---------------------------------------------------------------------------
# scenes and rays
# ---------------------------------------------------------------------------

def minidish(device, dtype=torch.float32):
    """The MiniDish of portbench/configs/minidish.json: (table, meta)."""
    asm = MiniDish(5.0, 6.25, 0.9, 6.95, 0.4, 0.7, 0.9)
    asm.set_transform(ptt.spatial.rotx(-np.pi / 4))
    return ptt.compile_scene(asm, dtype=dtype, device=device)


def sun(n: int, seed: int, device) -> RayBundle:
    """The MiniDish's 5 mrad pillbox sun, n rays."""
    x = -1.0 / math.sqrt(2.0)
    gen = torch.Generator(device=device).manual_seed(seed)
    return solar_disk_bundle(gen, n, [0, 7, 7], [0, x, x], 3.0, 0.005,
                             flux=1000.0, device=device)


def plates(device, *surfaces, dtype=torch.float32):
    """(table, meta) of named surfaces, each (geometry fn, optics, frame)."""
    objs = []
    for geom_fn, optics, frame, name in surfaces:
        g = geom_fn(ptt.geometry)
        g.frame = frame
        objs.append(AssembledObject([Surface([g], optics, name=name)]))
    return ptt.compile_scene(Assembly(objs), dtype=dtype, device=device)


def at(x, y, z):
    return ptt.spatial.translate(x, y, z)


def receiver_scene(kind, device):
    """One receiver of the binned kind ``kind`` (device_fluxmap's _uv)
    named "rec", with rays that reach its front: (table, meta, bundle of
    n rays given n)."""
    geoms = {"rect": lambda G: G.rect_plate(2.0, 2.0),
             "round": lambda G: G.round_plate(1.5),
             "parabolic_dish": lambda G: G.parabolic_dish(3.0, 1.2),
             "finite_cylinder": lambda G: G.finite_cylinder(2.0, 1.5),
             "conical_frustum": lambda G: G.conical_frustum(-0.6, 1.2, 0.8,
                                                           0.7),
             "sphere": lambda G: G.sphere(1.1),
             "hemisphere": lambda G: G.hemisphere(1.1)}
    optics = M.receiver(M.reflective(0.7, one_sided=False))
    table, meta = plates(device, (geoms[kind], optics, np.eye(4), "rec"))

    def rays(n, seed):
        rng = np.random.default_rng(seed)
        if kind in ("rect", "round", "parabolic_dish"):
            r = 1.45 * np.sqrt(rng.uniform(size=n))
            a = rng.uniform(0, 2 * np.pi, n)
            pos = np.stack([r * np.cos(a) + 0.05, r * np.sin(a) - 0.03,
                            np.full(n, 3.0)], 1)
            d = np.tile([0.0, 0.0, -1.0], (n, 1)) + rng.normal(
                size=(n, 3)) * 1e-3
        else:
            pos = rng.normal(size=(n, 3)) * 0.05
            d = rng.normal(size=(n, 3))
            if kind in ("finite_cylinder", "conical_frustum"):
                d[:, 2] *= 0.3
            if kind == "hemisphere":
                d[:, 2] = -np.abs(d[:, 2])
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return RayBundle.create(pos=pos, dir=d,
                                energy=rng.uniform(0.5, 1.5, n),
                                dtype=torch.float32, device=device)
    return table, meta, rays


def panel_scene(device):
    """A surface of 24 tilted panels on a ring (24 rows, each with its own
    frame), lit from inside: (table, meta, rays(n, seed))."""
    frames = []
    for i in range(24):
        a = 2 * np.pi * i / 24
        frames.append(ptt.spatial.generate_transform([0, 0, 1.0], a,
                                                     [0, 0, 0])
                      @ ptt.spatial.translate(2.0, 0.0, 0.3 * math.sin(3 * a))
                      @ ptt.spatial.roty(-np.pi / 2))
    geoms = []
    for f in frames:
        g = ptt.geometry.rect_plate(0.5, 0.6)
        g.frame = f
        geoms.append(g)
    optics = M.receiver(M.absorber(one_sided=False))
    asm = Assembly([AssembledObject([Surface(geoms, optics, name="rec")])])
    table, meta = ptt.compile_scene(asm, dtype=torch.float32, device=device)

    def rays(n, seed):
        rng = np.random.default_rng(seed)
        d = rng.normal(size=(n, 3))
        d[:, 2] *= 0.15
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return RayBundle.create(pos=np.zeros((n, 3)), dir=d,
                                dtype=torch.float32, device=device)
    return table, meta, rays


def one_sided_scene(device):
    """A one-sided reflective plate (absorptivity 0.3) lit from both
    sides, half the rays a side: (table, meta, rays(n, seed))."""
    table, meta = plates(device, (lambda G: G.rect_plate(2.0, 2.0),
                                  M.receiver(M.reflective(0.3,
                                                          one_sided=True)),
                                  np.eye(4), "rec"))

    def rays(n, seed):
        rng = np.random.default_rng(seed)
        xy = rng.uniform(-0.9, 0.9, (n, 2))
        zs = np.where(np.arange(n) % 2 == 0, 1.0, -1.0)
        pos = np.concatenate([xy, zs[:, None]], axis=1)
        d = np.stack([np.zeros(n), np.zeros(n), -zs], axis=1)
        return RayBundle.create(pos=pos, dir=d, dtype=torch.float32,
                                device=device)
    return table, meta, rays


def dispersive_scene(device):
    """A dispersive refractive interface (n 1.6 to 1.4 over 400-700 nm)
    over an absorbing floor."""
    return plates(device,
                  (lambda G: G.rect_plate(4.0, 4.0),
                   M.refractive_material(1.0, ([400e-9, 700e-9],
                                               [1.6, 1.4])),
                   np.eye(4), "iface"),
                  (lambda G: G.rect_plate(4.0, 4.0),
                   M.absorber(one_sided=False), at(0.0, 0.0, -2.0),
                   "floor"))


def bench_bundle(cfg, n, seed, device):
    """Bench config ``cfg``'s scene and a bundle of n rays of its source."""
    table, meta, src = bench_scene(cfg, n, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return table, meta, src(gen, device=device)


# ---------------------------------------------------------------------------
# the two paths, one bounce or one call
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Backend:
    """Where the epilogue runs: the built kernel on the card, or its C++
    under the stand-in runtime on CPU tensors (``lib``)."""
    device: torch.device
    lanes: int
    lib: object = None

    @contextlib.contextmanager
    def active(self):
        """trace_fused takes the kernel inside: on CPU tensors, the
        emulated library stands in for the built one."""
        if self.lib is None:
            yield
            return
        with unittest.mock.patch.object(engine, "_epilogue_ok",
                                        engine._epilogue_takes), \
                unittest.mock.patch.object(build, "load", lambda: self.lib):
            yield


@pytest.fixture(scope="module")
def emulated_lib(tmp_path_factory):
    import test_torch_emulated as te
    saved = te._RUNTIME
    te._RUNTIME = saved + _EMU_RUNTIME
    try:
        job = te._compile(tmp_path_factory.mktemp("epilogue"), ("epilogue",))
    finally:
        te._RUNTIME = saved
    return te._load(*job)


@pytest.fixture(params=["emulated",
                        pytest.param("card", marks=pytest.mark.cuda)])
def backend(request):
    if request.param == "card":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU "
                        "mode (python3 chip_smoke.py runs them on the card)")
        return Backend(torch.device("cuda", 0), CARD_LANES)
    return Backend(torch.device("cpu"), EMU_LANES,
                   request.getfixturevalue("emulated_lib"))


def plain_bounce(table, bundle, specs, min_energy=MIN_E, seed=0):
    """The plain bounce: (next bundle, float64 sums: per-row absorbed and
    hits, escaped, culled, each spec's map)."""
    gen = torch.Generator(device=bundle.pos.device).manual_seed(seed)
    acc = TraceAccum.zeros(table.num_rows, device=bundle.pos.device)
    nb, _, rec = engine._bounce_step(table, bundle, acc, gen,
                                     min_energy=min_energy, t_eps=None,
                                     disc_eps=1e-6, block=64)
    flux = tuple(torch.zeros((s.nu, s.nv), dtype=torch.float64,
                             device=bundle.pos.device) for s in specs)
    dfm.accumulate(flux, specs, table, rec.sid, rec.hit, rec.absorbed)
    hit = rec.sid >= 0
    S = table.num_rows
    sid = rec.sid.long().clamp(min=0)
    d64 = dict(dtype=torch.float64, device=bundle.pos.device)
    absorbed = torch.zeros(S, **d64).index_add_(
        0, sid, torch.where(hit, rec.absorbed.double(), 0.0))
    hits = torch.zeros(S, **d64).index_add_(0, sid, hit.double())
    escaped = torch.where(rec.alive_in & ~hit, bundle.energy.double(),
                          0.0).sum()
    culled = torch.where(hit & (rec.e_out <= min_energy),
                         rec.e_out.double(), 0.0).sum()
    return nb, dict(absorbed=absorbed, hits=hits, escaped=escaped,
                    culled=culled, flux=flux)


def kernel_bounce(backend, table, bundle, specs, min_energy=MIN_E,
                  seed=0, bounce=0):
    """The epilogue's bounce (K3 and the kernel): (next bundle, the
    call's accumulators)."""
    gen = torch.Generator(device=bundle.pos.device).manual_seed(seed)
    with backend.active():
        plan = engine._epilogue_plan(table, bundle, gen, min_energy, specs)
        nb = engine._bounce_step_epilogue(table, bundle, plan, bounce, 3e-4,
                                          1e-6)
        acc = TraceAccum.zeros(table.num_rows, device=bundle.pos.device,
                               fluxspecs=specs)
        plan.finish(acc)
    return nb, acc


def assert_sums_close(acc, want, rtol=1e-5, flux_rtol=1e-5):
    """The kernel's float32 sums against the plain path's float64 ones;
    hits exactly."""
    np.testing.assert_array_equal(acc.hits.double().cpu().numpy(),
                                  want["hits"].cpu().numpy())
    for k in ("absorbed", "escaped", "culled"):
        np.testing.assert_allclose(getattr(acc, k).double().cpu().numpy(),
                                   want[k].cpu().numpy(), rtol=rtol,
                                   atol=1e-30, err_msg=k)
    for got, ref in zip(acc.flux, want["flux"]):
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(got.double().cpu().numpy(), ref,
                                   rtol=flux_rtol,
                                   atol=flux_rtol * ref.max())


def assert_rays_close(got: RayBundle, want: RayBundle):
    """alive identical; pos and energy within float32 rounding of the
    scene's metres and the ray's energy, dir within 1e-6 (unit vectors)."""
    assert torch.equal(got.alive, want.alive)
    live = want.alive
    scale = 1.0 + want.pos[live].abs()
    assert ((got.pos[live] - want.pos[live]).abs() <= 1e-6 * scale).all()
    assert ((got.dir[live] - want.dir[live]).abs() <= 1e-6).all()
    torch.testing.assert_close(got.energy, want.energy, rtol=1e-6, atol=0.0)


# ---------------------------------------------------------------------------
# the gate (CPU)
# ---------------------------------------------------------------------------

GATE_CONFIGS = {1: True, 2: True, 6: True, 7: True, "7g": True,
                3: False, 8: False, "8b": False, "6s": False}


@pytest.mark.parametrize("cfg", list(GATE_CONFIGS), ids=str)
def test_gate_bench_configs(cfg):
    """The epilogue takes the fused kinds (MiniDish rows, slope error and
    Lambertian rows, the lens, Cook-Torrance, glazing) and leaves the
    volumetric (3, 8, 8b) and splitting (6s) scenes to the plain bounce;
    never on CPU tensors."""
    table, meta, b = bench_bundle(cfg, 64, 0, "cpu")
    assert engine._epilogue_takes(table, b) is GATE_CONFIGS[cfg]
    assert engine._epilogue_takes(table, b) is engine._fused_ok(table)
    assert not engine._epilogue_ok(table, b)


def test_gate_model_library():
    """The model library's MiniDish, SG4 (slope error), the config 5
    cavity (Lambertian walls, a transparent bifacial aperture), a binned
    receiver of every kind, the panel ring, the one-sided plate: taken; a
    dispersive interface: not."""
    from tracer_tpu_torch.models.sg4 import SG4
    for t, _ in (cavity("cpu"), ptt.compile_scene(SG4(
            dishDiameter=25.0, dishFocus=13.4, absMirrors=0.1, sigma=2e-3),
            device="cpu")):
        assert engine._epilogue_takes(t, sun(8, 0, "cpu"))
    table, meta = minidish("cpu")
    b = sun(64, 0, "cpu")
    spec = dfm.flux_plan(meta, "receiver", resolution=50)
    assert engine._epilogue_takes(table, b, (spec,))
    for kind in ("rect", "round", "parabolic_dish", "finite_cylinder",
                 "conical_frustum", "sphere", "hemisphere"):
        t, m, rays = receiver_scene(kind, "cpu")
        s = dfm.flux_plan(m, "rec", resolution=8)
        assert engine._epilogue_takes(t, rays(8, 0), (s,)), kind
    for scene in (panel_scene, one_sided_scene):
        t, m, rays = scene("cpu")
        assert engine._epilogue_takes(t, rays(8, 0),
                                      (dfm.flux_plan(m, "rec"),))
    t, m = dispersive_scene("cpu")
    assert "dispersive" in t.features
    assert not engine._epilogue_takes(t, sun(8, 0, "cpu"))


def test_gate_refuses_float64_polychromatic_grad_and_wide_maps():
    """float64 bundles, polychromatic bundles, bundles that track a
    gradient and maps past the shared memory keep the plain bounce."""
    table, meta = minidish("cpu")
    b = sun(64, 0, "cpu")
    assert engine._epilogue_takes(table, b)
    t64, _ = minidish("cpu", torch.float64)
    b64 = RayBundle.create(pos=b.pos.double(), dir=b.dir.double(),
                           energy=b.energy.double(), dtype=torch.float64,
                           device="cpu")
    assert not engine._epilogue_takes(t64, b64)
    grid = torch.linspace(400e-9, 700e-9, 4)
    poly = b.with_spectra(grid, torch.ones(64, 4))
    assert not engine._epilogue_takes(table, poly)
    grad = b.replace(pos=b.pos.clone().requires_grad_(True))
    assert not engine._epilogue_takes(table, grad)
    with torch.no_grad():
        assert engine._epilogue_takes(table, grad)
    wide = dfm.flux_plan(meta, "receiver", resolution=250)
    assert ke.shared_floats(table.num_rows, (wide,)) > ke.MAX_SHARED_FLOATS
    assert not engine._epilogue_takes(table, b, (wide,))


def test_maps_agree_catches_a_shift():
    """test_torch_gpu.maps_agree: two maps of independent draws of the
    same rays agree; a map whose energy moved by two fifths of a bin's
    width, or a map with 10% more energy, does not. Rays deposit 5-30%
    of their energy, so the records' squared deposits (the third
    argument) and not the Bernoulli bound set the bins' sigma."""
    from test_torch_gpu import maps_agree
    rng = np.random.default_rng(0)
    n = 200_000

    def draw(shift=0.0, gain=1.0):
        x = np.clip(rng.normal(0.5 + shift, 0.15, n), 0.0, 1.0 - 1e-9)
        y = np.clip(rng.normal(0.5, 0.15, n), 0.0, 1.0 - 1e-9)
        w = np.where(rng.uniform(size=n) < 0.6,
                     rng.uniform(0.05, 0.3, n) * gain / n, 0.0)
        return [np.histogram2d(x, y, bins=20, range=[[0, 1], [0, 1]],
                               weights=wt)[0] for wt in (w, w * w)]
    (a, sq), (b, _) = draw(), draw()
    assert maps_agree(a, b, sq, 1.0, n)
    for shifted, _ in (draw(0.02), draw(gain=1.1)):
        assert not maps_agree(shifted, b, sq, 1.0, n)


def test_trace_fused_on_cpu_is_the_plain_loop():
    """On CPU tensors trace_fused launches no epilogue and is bit for bit
    the plain loop: _bounce_step and device_fluxmap.accumulate a bounce."""
    table, meta = minidish("cpu")
    spec = dfm.flux_plan(meta, "receiver", resolution=20)
    b = sun(4096, 3, "cpu")
    before = ke.k3_epilogue.launches
    final, acc = trace_fused(table, b, torch.Generator().manual_seed(5),
                             max_bounces=20, fluxspecs=(spec,))
    assert ke.k3_epilogue.launches == before
    gen = torch.Generator().manual_seed(5)
    want = TraceAccum.zeros(table.num_rows, device="cpu", fluxspecs=(spec,))
    bundle = b
    for _ in range(20):
        if not bool(bundle.alive.any()):
            break
        bundle, want, rec = engine._bounce_step(
            table, bundle, want, gen, min_energy=MIN_E, t_eps=None,
            disc_eps=1e-6, block=64)
        dfm.accumulate(want.flux, (spec,), table, rec.sid, rec.hit,
                       rec.absorbed)
    for f in dataclasses.fields(want):
        a, w = getattr(acc, f.name), getattr(want, f.name)
        for x, y in (zip(a, w) if f.name == "flux" else ((a, w),)):
            assert torch.equal(x, y), f.name
    for f in ("pos", "dir", "energy", "alive", "ref_index"):
        assert torch.equal(getattr(final, f), getattr(bundle, f)), f


# ---------------------------------------------------------------------------
# the kernel against the plain bounce (emulated on the CPU, and on the card)
# ---------------------------------------------------------------------------

def test_minidish_bounce_matches_plain(backend):
    """The MiniDish's second bounce (the receiver's and the homogenizer's
    hits) from the plain path's first: alive identical, pos, dir and
    energy within float32 rounding, per-row absorbed and hits, escaped
    and the receiver's 50 x 50 bins within 1e-5 of the plain path's
    per-lane results summed in float64; the first bounce too."""
    table, meta = minidish(backend.device)
    spec = dfm.flux_plan(meta, "receiver", resolution=50)
    b0 = sun(backend.lanes, 11, backend.device)
    b1, want0 = plain_bounce(table, b0, (spec,))
    got1, acc0 = kernel_bounce(backend, table, b0, (spec,))
    assert_rays_close(got1, b1)
    assert_sums_close(acc0, want0)
    b2, want = plain_bounce(table, b1, (spec,))
    got2, acc = kernel_bounce(backend, table, b1, (spec,))
    assert_rays_close(got2, b2)
    assert float(want["flux"][0].sum()) > 0.3 * float(b0.energy.sum())
    assert_sums_close(acc, want)


@pytest.mark.parametrize("kind", ["rect", "round", "parabolic_dish",
                                  "finite_cylinder", "conical_frustum",
                                  "sphere", "hemisphere"])
def test_flux_kinds_match_plain(backend, kind):
    """Each binned kind (cartesian, polar, axial, spherical) binned as
    device_fluxmap bins it: the map within 1e-5 of the plain path's. The
    emulated kernel's atan2, hypot and acos are the C library's, the
    plain path's torch's, which may round a lane's angle the other way
    at a bin edge: there the maps agree within 1e-3 of their total."""
    table, meta, rays = receiver_scene(kind, backend.device)
    spec = dfm.flux_plan(meta, "rec", resolution=12)
    b = rays(backend.lanes, 7)
    want_b, want = plain_bounce(table, b, (spec,))
    got_b, acc = kernel_bounce(backend, table, b, (spec,))
    assert_rays_close(got_b, want_b)
    ref = want["flux"][0]
    assert float(ref.sum()) > 0.3 * float(b.energy.sum())
    if backend.lib is not None and kind != "rect":
        assert_sums_close(acc, {**want, "flux": ()})
        diff = (acc.flux[0].double() - ref).abs().sum()
        assert float(diff) <= 1e-3 * float(ref.sum())
    else:
        assert_sums_close(acc, want)


def test_multi_row_flux_matches_plain(backend):
    """The 24-panel ring: each hit binned in its own row's frame."""
    table, meta, rays = panel_scene(backend.device)
    spec = dfm.flux_plan(meta, "rec", resolution=6)
    assert len(spec.rows) == 24
    b = rays(backend.lanes, 5)
    want_b, want = plain_bounce(table, b, (spec,))
    got_b, acc = kernel_bounce(backend, table, b, (spec,))
    assert_rays_close(got_b, want_b)
    assert float(want["flux"][0].sum()) > 0.3 * float(b.energy.sum())
    assert_sums_close(acc, want)


def test_one_sided_kill_and_min_energy_cull(backend):
    """Back-face hits on a one-sided plate die with all their energy
    absorbed; lanes left at or below min_energy die with it culled."""
    table, meta, rays = one_sided_scene(backend.device)
    spec = dfm.flux_plan(meta, "rec", resolution=4)
    b = rays(backend.lanes, 1)
    for min_e in (MIN_E, 0.8):
        want_b, want = plain_bounce(table, b, (spec,), min_energy=min_e)
        got_b, acc = kernel_bounce(backend, table, b, (spec,),
                                   min_energy=min_e)
        assert_rays_close(got_b, want_b)
        assert_sums_close(acc, want)
        back = torch.arange(b.num_rays, device=b.pos.device) % 2 == 1
        assert not bool(got_b.alive[back].any())
        if min_e == 0.8:
            assert float(acc.culled) > 0.2 * float(b.energy.sum())
            assert not bool(got_b.alive.any())
        else:
            assert float(acc.culled) == 0.0
            assert bool(got_b.alive[~back].all())


def test_trace_fused_leaves_the_bundle_and_closes(backend):
    """A whole trace_fused call on the MiniDish: the caller's bundle is
    not written, the energy closes (absorbed, escaped, culled and the
    final bundle's energy sum to the source's), and the kernel launches
    once a K3 launch."""
    table, meta = minidish(backend.device)
    spec = dfm.flux_plan(meta, "receiver", resolution=50)
    b = sun(backend.lanes, 2, backend.device)
    saved = {k: getattr(b, k).clone() for k in ke.RAY_FIELDS}
    k3, epi = kn.nearest_hit.launches, ke.k3_epilogue.launches
    with backend.active():
        final, acc = trace_fused(table, b, max_bounces=20, fluxspecs=(spec,))
    for k, v in saved.items():
        assert torch.equal(getattr(b, k), v), k
    launches = ke.k3_epilogue.launches - epi
    assert launches >= 3
    if backend.lib is None:
        assert kn.nearest_hit.launches - k3 == launches
    total = (acc.absorbed.double().sum() + acc.escaped.double()
             + acc.culled.double() + final.energy.double().sum())
    src = b.energy.double().sum()
    assert abs(float(total / src) - 1.0) < 1e-5
    _, want = plain_trace(table, b, specs=(spec,))
    # whole traces part by float32 rounding after their first bounce (the
    # shades normalise otherwise), so a rare lane takes another row
    np.testing.assert_allclose(acc.hits.cpu().numpy(),
                               want.hits.cpu().numpy(), rtol=1e-4)
    np.testing.assert_allclose(acc.absorbed.cpu().numpy(),
                               want.absorbed.cpu().numpy(), rtol=1e-4)


def test_sums_repeat_bit_for_bit(backend):
    """Two calls on the same rays give the same per-row sums, escaped and
    culled energy to the bit (the warps' own row bins, fixed trees), as
    trace_sharded's one-rank check asks of trace_fused."""
    table, meta = minidish(backend.device)
    b = sun(backend.lanes, 8, backend.device)
    with backend.active():
        runs = [trace_fused(table, b, max_bounces=20)[1] for _ in range(2)]
    for k in ("absorbed", "hits", "escaped", "culled"):
        assert torch.equal(getattr(runs[0], k), getattr(runs[1], k)), k


def plain_trace(table, b, gen=None, specs=()):
    """trace_fused with the gate shut: the plain loop, on either device."""
    with unittest.mock.patch.object(engine, "_epilogue_ok",
                                    lambda *a, **k: False):
        return trace_fused(table, b, gen, max_bounces=20, fluxspecs=specs)


DRAW_CASES = {2: "slope error and Lambertian rows", 6: "the lens's Fresnel "
              "roulette", "7g": "Cook-Torrance under a refractive cover",
              "cavity": "Lambertian walls behind a transparent bifacial "
              "aperture"}


def cavity(device):
    """The config 5 cavity (models/two_n_cavity.py): (table, meta)."""
    from tracer_tpu_torch.models.two_n_cavity import TwoNParamCav
    return ptt.compile_scene(TwoNParamCav(
        apertureRadius=0.3, frustaRadii=[0.5, 0.5], frustaDepths=[0.4, 0.4],
        coneDepth=0.3, el_FRUs=[2, 2], el_CON=2), device=device)


def cavity_bundle(n, seed, device):
    """The cavity lit through its aperture (test_torch_gpu's beam)."""
    table, meta = cavity(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return table, meta, solar_disk_bundle(
        gen, n, center=[0, 0, 0.01], direction=[0, 0, 1.0], radius=0.29,
        ang_range=0.05, flux=5e5, device=device)


@pytest.mark.parametrize("cfg", list(DRAW_CASES), ids=str)
def test_draws_agree_statistically(backend, cfg):
    """Scenes whose kinds draw (the kernel from K2's Philox stream, the
    plain path from the generator): every row's absorbed share of the
    source, and the escaped share, within 3 sigma of the plain path's
    (sigma of two independent runs of a share p: sqrt(2 p (1 - p) / n),
    rays counted as Bernoulli trials of their whole energy)."""
    make = cavity_bundle if cfg == "cavity" else partial(bench_bundle, cfg)
    table, meta, b = make(backend.lanes, 4, backend.device)
    gen = torch.Generator(device=backend.device).manual_seed(9)
    with backend.active():
        _, acc = trace_fused(table, b, gen, max_bounces=20)
    _, want = plain_trace(table, b, torch.Generator(
        device=backend.device).manual_seed(9))
    src = float(b.energy.double().sum())
    n = b.num_rays
    got = np.append(acc.absorbed.double().cpu().numpy(),
                    float(acc.escaped)) / src
    ref = np.append(want.absorbed.double().cpu().numpy(),
                    float(want.escaped)) / src
    sig = np.sqrt(2.0 * np.clip(ref * (1 - ref), 1e-12, None) / n)
    assert (np.abs(got - ref) <= 3.0 * sig + 1e-7).all(), (got, ref, sig)
    assert ref.max() > 0.05


def test_refraction_carries_index_and_medium(backend):
    """The lens (config 6) one bounce on rays that carry a medium triple:
    a lane that crosses takes the other side's index and the row's media
    (none: the scene has no volumetric rows), one that reflects keeps its
    index and triple; the crossed share within 3 sigma of the plain
    path's."""
    table, meta, b = bench_bundle(6, backend.lanes, 3, backend.device)
    b = b.replace(att_coeff=torch.full_like(b.energy, 0.5),
                  scat_coeff=torch.full_like(b.energy, 0.25),
                  scat_g=torch.full_like(b.energy, 0.125))
    got, _ = kernel_bounce(backend, table, b, ())
    want, _ = plain_bounce(table, b, ())
    hit = (want.pos != b.pos).any(1)
    shares = []
    for nb in (got, want):
        crossed = nb.ref_index != b.ref_index
        for k, v in (("att_coeff", 0.5), ("scat_coeff", 0.25),
                     ("scat_g", 0.125)):
            x = getattr(nb, k)
            assert bool((x[crossed] == 0.0).all()), k
            assert bool((x[~crossed] == v).all()), k
        shares.append(float(crossed[hit].double().mean()))
    assert 0.5 < shares[1] < 1.0
    n = int(hit.sum())
    sig = math.sqrt(2.0 * shares[1] * (1.0 - shares[1]) / n)
    assert abs(shares[0] - shares[1]) <= 3.0 * sig, (shares, sig)


def test_curved_maps_agree_statistically(backend):
    """The config 5 cavity's frustum and cylinder binned axially through
    the epilogue, whose draws come from K2's Philox stream, against the
    plain path's, whose draws come from the generator
    (test_torch_gpu.curved_map_compare, the gate shut): each row's
    absorbed energy within 3 sigma (share_z), each map's total and bins
    within 3 sigma (maps_agree, the bins' sigma from ray_tracer's records
    of the plain path's draws), each map summing to the energy absorbed on
    its rows, the epilogue launched once a K3 launch on the card."""
    from test_torch_gpu import curved_map_compare, maps_agree, share_z
    table, meta, b = cavity_bundle(backend.lanes, 6, backend.device)
    names = ("frustum_0", "frustum_1")
    res = 12 if backend.lib is not None else 50
    maps, want, _, _ = curved_map_compare(table, meta, names, b, 16, 20,
                                          resolution=res)
    specs = tuple(dfm.flux_plan(meta, nm, resolution=res) for nm in names)
    k3, epi = kn.nearest_hit.launches, ke.k3_epilogue.launches
    with backend.active():
        assert engine._epilogue_ok(table, b, specs)
        _, acc = trace_fused(table, b, torch.Generator(
            device=backend.device).manual_seed(17), max_bounces=20,
            fluxspecs=specs)
    launches = ke.k3_epilogue.launches - epi
    assert launches > 0
    if backend.lib is None:
        assert kn.nearest_hit.launches - k3 == launches
    src, n = float(b.energy.double().sum()), b.num_rays
    got_rows = acc.absorbed.double().cpu().numpy()
    want_rows = want.absorbed.double().cpu().numpy()
    z = [share_z(x, y, src, n) for x, y in zip(got_rows, want_rows)]
    assert max(z) <= 3.0, z
    for nm, spec, got in zip(names, specs, acc.flux):
        got = got.double().cpu().numpy()
        absorbed = got_rows[list(spec.rows)].sum()
        assert absorbed > 0.01 * src
        assert abs(got.sum() - absorbed) <= 1e-5 * absorbed
        assert maps_agree(got, maps[nm]["hist"], maps[nm]["sq"], src, n)


class _Skewed:
    """The library with its shared memory a block reported 4 B larger."""

    def __init__(self, lib):
        self.lib = lib

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def tt_epilogue_geometry(self, n, S, W, addr):
        rc = self.lib.tt_epilogue_geometry(n, S, W, addr)
        (ctypes.c_int * 3).from_address(addr)[2] += 4
        return rc


@pytest.mark.parametrize("res", [8, 50, 120])
def test_geometry_is_the_librarys(emulated_lib, res):
    """The gate's threads and shared memory a block (kernels/epilogue
    .shared_floats) are csrc/epilogue.cu's own (tt_epilogue_geometry),
    and a library that reports others is refused when a call's plan is
    made."""
    table, meta = minidish("cpu")
    spec = dfm.flux_plan(meta, "receiver", resolution=res)
    W = ke.sums_width(table.num_rows, (spec,))
    for n in (1, EMU_LANES, CARD_LANES):
        blocks, threads, smem = ke._geometry(emulated_lib, n,
                                             table.num_rows, W)
        assert threads == ke.EPI_THREADS
        assert smem == 4 * ke.shared_floats(table.num_rows, (spec,))
        assert 1 <= blocks <= -(-n // threads)
    b = sun(64, 0, "cpu")
    with unittest.mock.patch.object(build, "load",
                                    lambda: _Skewed(emulated_lib)):
        with pytest.raises(RuntimeError, match="shared memory"):
            engine._epilogue_plan(table, b, None, MIN_E, (spec,))


@pytest.mark.cuda
def test_launches_follow_k3_and_gate_on_card():
    """On the card the epilogue launches once for each K3 launch of a
    MiniDish trace_fused call, and never for a float64 bundle, a
    volumetric scene (config 8) or a dispersive one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    table, meta = minidish(dev)
    k3, epi = kn.nearest_hit.launches, ke.k3_epilogue.launches
    trace_fused(table, sun(1 << 20, 0, dev), max_bounces=20)
    assert ke.k3_epilogue.launches - epi == kn.nearest_hit.launches - k3 > 0
    epi = ke.k3_epilogue.launches
    t64, _ = minidish(dev, torch.float64)
    b = sun(1 << 16, 1, dev)
    trace_fused(t64, RayBundle.create(pos=b.pos.double(), dir=b.dir.double(),
                                      energy=b.energy.double(),
                                      dtype=torch.float64, device=dev),
                max_bounces=5)
    t8, _, b8 = bench_bundle(8, 1 << 16, 0, dev)
    trace_fused(t8, b8, max_bounces=5)
    td, _ = dispersive_scene(dev)
    bd = RayBundle.create(pos=np.tile([0.0, 0.0, 1.0], (4096, 1)),
                          dir=np.tile([0.0, 0.0, -1.0], (4096, 1)),
                          wavelength=550e-9, dtype=torch.float32, device=dev)
    trace_fused(td, bd, max_bounces=5)
    assert ke.k3_epilogue.launches == epi
