#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (tracer_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py             # every phase, a few minutes
    python3 chip_smoke.py --profile   # plus a torch.profiler breakdown
                                      # of one NSTTF bench-size trace

Phases, each printing its lines:

1. the card (nvidia-smi name and power limit) and the torch / CUDA
   versions;
2. the build of the CUDA kernels (every kernels/csrc/*.cu, one nvcc each,
   all started together);
3. K1 and K2 against their plain PyTorch versions on the card, on the same
   inputs and random streams: K1 (bounce_reflect_culled) over 64 NSTTF
   tiles with regeneration and slope error, K2 (bounce_reflect) over the
   same lanes; then each one's time at the benchmark slab (2,101,248
   lanes) beside its plain version's;
4. K3 (nearest_hit) against its plain version: on the MiniDish at
   4,194,304 lanes (the sun's rays, then their second bounce), on the
   NSTTF table, on a table with every quadric class and aperture kind and
   on the same with 2,000 more rows (groups longer than one staged chunk)
   at 2,101,248 lanes; each one's time beside the plain version's;
5. the NSTTF main path at benchmark size: NSTTF scene -> culling ->
   trace_streaming of 537,919,488 rays (slab 2,101,248, max_path 8,
   min_energy 1e-6) with the 50x50 receiver flux map, under bench.py's
   three guards. The NSTTF drain (K2) only runs for parked rays, and with
   the default corridor depth of 3 no ray survives three front-side
   mirror hits; so the same trace also runs once with depth-1 corridors
   (every heliostat survivor parks and takes its next bounce in the
   drain), at 32 slabs. One untimed short trace of each kind runs first;
   then the bench trace runs three times (median and every wall time
   printed) and the depth-1 trace once;
6. the MiniDish main paths at the published size (TAU MiniDish rotated by
   -pi/4, pillbox disk sun of radius 3 m, flux 1000): TracerEngine
   .ray_tracer on 1,048,576 rays with full records and histogram_hits,
   then trace_fused on 4,194,304 rays (20 bounces, 50x50 receiver flux
   map; one warm-up, three timed runs), one of them profiled for K3's
   share of device time. Guards: energy closure below 1e-4 of the source,
   K3 launched once per bounce, and against the port's float64 CPU
   ray_tracer on the first 65,536 rays (same float32 self-hit guard):
   receiver fraction within 3 binomial sigma, every surface's absorbed
   energy on those rays within 1e-4 of their source energy;
7. bench configs 1-3 (benchmarks/suite.py: the MiniDish under a pillbox
   sun; a slope-error dish over a Lambertian absorber; a spectral silver
   mirror under a Buie sun with a wavelength band, in an attenuating
   medium) on the plain streaming megakernel: K2 (bounce_reflect) against
   its plain version at the suite's slab of 700,416 lanes in each mode the
   path runs (regeneration over a half-dead slab, the MiniDish's
   paraboloid and rect rows, the Lambertian lobe with bivariate slope
   error, spectral absorptance with ambient attenuation), with ties and
   edge flips at most 1e-5 of the lanes (tests/test_torch_gpu.k2_compare),
   each timed beside its plain version; then each configuration through
   trace_streaming(culling=None) at the suite's size (128 emission rounds,
   89,653,248 rays, max_path 20, 20 and 8): one untimed short trace, three
   timed (median and every wall time, rounds and K2 launches printed) and
   one profiled for K2's share of device time. Guards: full emission,
   closure below 1e-4, config 1's receiver fraction within 3 binomial
   sigma of phase 6's float64 reference, configs 2 and 3's per-surface
   fractions (and config 3's medium share) within 3 combined sigma of a
   196,608-ray CPU trace through the plain version, and a medium loss in
   config 3. The TPU's recorded physics values are printed beside the
   port's for the reader;
8. bench configs 6, 8 and 8b (benchmarks/suite.py:267, :432, :517: a
   spherical glass lens over a focal-plane receiver; a closed box of
   Lambertian walls in an ambient Henyey-Greenstein medium; the same box
   with the medium bounded by two index-matched scattering sheets) in the
   same way: K2 against its plain version at 700,416 lanes in each new
   mode (the lens's Fresnel roulette, the ambient HG medium, the media
   ids, and the instances these configurations leave out: the lens in
   config 8's HG medium, absorbing media without scattering; a uniform
   within rounding of R may flip the roulette, counted with the edge
   flips; ties only on the lens's seam), then each configuration at
   89,653,248 rays
   (max_path 20, 24, 24). Guards: full emission, closure below 1e-4,
   config 6's receiver fraction in (0.75, 0.98), the medium's share above
   0.1 (8) and 0.05 (8b), and every fraction within 3 combined sigma of
   the plain version's 196,608-ray CPU trace.

Every kernel's launch count is set to 0 just before a main path runs and
read just after. The line before the last is the kernels' JSON record;
the last line is ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero without that line; so does a
machine without CUDA or a directory without the package.
"""
import argparse
import json
import os
import subprocess
import sys
import time


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, msg: str) -> None:
    """A failed check ends the run (a plain assert would vanish under -O)."""
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_cuda(fn, reps: int) -> float:
    """Mean device milliseconds per call over ``reps`` calls, after one
    warm-up, between CUDA events. A spin kernel queued first holds the
    stream while the host issues the calls, so the events time the calls'
    device work rather than the host's rate of issuing them (a wrapper's
    checks and ctypes call can take longer than a kernel); the spin grows
    until it outlasts the issuing."""
    import torch
    fn()
    torch.cuda.synchronize()
    spin = 2_000_000                # ~1 ms of a 2 GHz clock per call
    while True:
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin * reps)
        t0.record()
        for _ in range(reps):
            fn()
        ahead = not t0.query()      # the spin still held the stream
        t1.record()
        torch.cuda.synchronize()
        if ahead or spin > 100_000_000:
            return t0.elapsed_time(t1) / reps
        spin *= 8


# one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 bytes per second and
# float32 operations per second outside the tensor cores
H100_BYTES_S = 3.35e12
H100_F32_S = 67e12

# float32 operations each kernel spends, counted from its source: per
# candidate row by quadric class (transform 33, then the class's solve and
# self-hit guard), per aperture test by kind, per shaded lane (reflect,
# bivariate slope error, one-sided kill) and per regenerated lane (Buie
# cell sample). Comparisons and selects count as operations; Philox's
# integer rounds do not.
ROW_OPS = {"flat": 48, "parab": 93, "sphere": 90, "quadric": 133}
AP_OPS = {0: 0, 1: 4, 2: 5, 3: 2, 4: 20, 5: 1, 6: 6, 7: 15, 8: 6, 9: 5,
          10: 5, 11: 8, 12: 4, 13: 15}
SHADE_OPS = 130
REGEN_OPS = 100


def row_ops(tag, sig) -> int:
    """Operations of one lane against one row (curved classes test their
    apertures at both roots)."""
    return ROW_OPS[tag] + (1 if tag == "flat" else 2) * sum(
        AP_OPS[k] for k in sig)


def bound(nbytes, nops):
    """(ms, what sets it): the larger of the bytes over the card's memory
    rate and the float32 operations over its peak rate."""
    t_b = nbytes / H100_BYTES_S * 1e3
    t_o = nops / H100_F32_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                 bnd):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None}


def reset_launches(*wrappers) -> None:
    for w in wrappers:
        w.launches = 0


def compare(name, got, want, live, pos_tol=1e-4, dir_tol=1e-5,
            e_rtol=1e-5):
    """Kernel vs plain outputs (pos, dir, energy, sid, absorbed) on the
    live lanes: sid equal on >= 99.99% of them (aperture-edge ties are the
    only allowed difference), and on the lanes whose sid matches pos
    within pos_tol*(1+|x|), dir within dir_tol, energy and absorbed within
    e_rtol relative. Returns (max abs error, sid mismatches)."""
    gp, gd, ge, gs, ga = got
    wp, wd, we, ws, wa = want
    n_live = int(live.sum())
    same = live & (gs == ws)
    ties = n_live - int(same.sum())
    if n_live == 0 or ties > 1e-4 * n_live:
        raise AssertionError(f"{name}: sid differs on {ties} of {n_live} "
                             "live lanes")
    m = same

    def mx(t):
        return float(t.max()) if t.numel() else 0.0

    def rel(a, b):
        nz = b[m] != 0
        return mx(((a - b).abs()[m] / b.abs()[m].clamp(min=1e-30))[nz])

    errs = {"pos": mx((gp - wp).abs()[m] / (1.0 + wp.abs()[m])),
            "dir": mx((gd - wd).abs()[m]), "energy": rel(ge, we),
            "absorbed": rel(ga, wa)}
    tol = {"pos": pos_tol, "dir": dir_tol, "energy": e_rtol,
           "absorbed": e_rtol}
    for k, v in errs.items():
        if not v <= tol[k]:
            raise AssertionError(f"{name}: {k} error {v:.3e} > {tol[k]:.0e}")
    max_abs = max(mx((gp - wp).abs()[m]), mx((gd - wd).abs()[m]),
                  mx((ge - we).abs()[m]), mx((ga - wa).abs()[m]))
    log(f"{name} vs plain: {n_live} live lanes, sid ties {ties}, "
        + ", ".join(f"{k} err {v:.2e}" for k, v in errs.items()))
    return max_abs, ties


def main(argv) -> None:
    parser = argparse.ArgumentParser(
        description="GPU smoke run of the PyTorch / CUDA port")
    parser.add_argument("--profile", action="store_true",
                        help="add a torch.profiler breakdown of one "
                        "bench-size trace")
    profiling = parser.parse_args(argv).profile
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    # the K2 and K3 checks share the GPU test's fuzzed table, lanes and
    # comparisons
    sys.path.insert(1, os.path.join(root, "tests"))
    try:
        import tracer_tpu_torch  # noqa: F401
    except ImportError as exc:
        raise SystemExit(f"chip_smoke: the tracer_tpu_torch package is not "
                         f"beside this script ({exc})")
    from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.engine import energy_closure, trace_streaming
    from tracer_tpu_torch.kernels import bounce as kb
    from tracer_tpu_torch.kernels import build
    from tracer_tpu_torch.kernels import nearest as kn
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: the card
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- phase 2: the build
    t0 = time.perf_counter()
    build.load()
    log(f"build: nvcc {build.info['nvcc_s']:.1f} s, cache hit "
        f"{build.info['cache_hit']}, load {time.perf_counter() - t0:.1f} s, "
        f"{build.info['path']}")
    for line in build.info.get("ptxas", "").splitlines():
        if "registers" in line or "Compiling entry" in line \
                or "spill" in line:
            log("  ptxas: " + line.strip())

    # ---- phase 3: kernels vs their plain versions
    slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)     # bench.py's
    table, meta, info = build_scene(device=dev)
    source_fn = make_source_fn(info, slab)
    spec = source_fn.pallas_spec
    t0 = time.perf_counter()
    culling = build_block_culling(table, meta, spec, slab)
    log(f"culling: {culling.nb} tiles, L_mean {culling.stats['L_mean']:.1f}"
        f", L_max {culling.stats['L_max']}, {time.perf_counter() - t0:.1f} s")
    rows = kb.pack_rows(table)
    te = 3e-4
    kw = dict(bivar=True, one_sided=True, slope=True)

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    def culled_args(nb):
        return (rows, i32(culling.lists[:nb]), i32(culling.counts[:nb]),
                torch.arange(nb, dtype=torch.int32, device=dev),
                torch.as_tensor(culling.cell_bounds[:nb], device=dev))

    def k1_inputs(nb, gen):
        """Round-1 then round-2 inputs of nb tiles: all lanes dead with
        random quotas (regeneration), then the survivors of a round
        (reflected rays in flight) among fresh dead lanes."""
        n = nb * kb.TILE
        pos = torch.zeros((n, 3), device=dev)
        dirs = torch.zeros((n, 3), device=dev)
        dirs[:, 2] = 1.0
        e = torch.zeros((n,), device=dev)
        rem = torch.randint(0, kb.TILE + 1, (nb,), generator=gen,
                            dtype=torch.int32).to(dev)
        rem[: nb // 2] = kb.TILE
        act = torch.ones((nb,), dtype=torch.int32, device=dev)
        act[nb - 1] = 0                     # one idle tile
        return pos, dirs, e, rem, act

    gen = torch.Generator().manual_seed(1234)
    nb = 64
    args = culled_args(nb)
    pos, dirs, e, rem, act = k1_inputs(nb, gen)
    k1_err, k1_ties = 0.0, 0
    for rnd, seed in enumerate((11, 12)):
        dead = (e <= 0.0).view(nb, kb.TILE)
        rank = torch.cumsum(dead.to(torch.int32), 1) - 1
        live = ((e > 0.0).view(nb, kb.TILE)
                | (dead & (rank < rem[:, None]))).view(-1)
        got = kb.bounce_reflect_culled(*args, seed, rem, act, pos, dirs, e,
                                       table.groups, culling.group_offsets,
                                       te, source_spec=spec, **kw)
        want = kb.bounce_reflect_culled_ref(
            *args, seed, rem, act, pos, dirs, e, table.groups,
            culling.group_offsets, te, source_spec=spec, **kw)
        torch.cuda.synchronize()
        err, ties = compare(f"K1 round {rnd + 1}", got, want,
                            live & (act != 0).repeat_interleave(kb.TILE))
        k1_err, k1_ties = max(k1_err, err), k1_ties + ties
        pos, dirs, e = want[0], want[1], torch.where(want[3] >= 0,
                                                     want[2], 0.0)
        rem = torch.full_like(rem, kb.TILE // 4)
    # K2 on the round-2 survivors (reflected rays heading for the tower)
    got = kb.bounce_reflect(rows, 21, pos, dirs, e, table.groups, te, **kw)
    want = kb.bounce_reflect_ref(rows, 21, pos, dirs, e, table.groups, te,
                                 **kw)
    torch.cuda.synchronize()
    k2_err, k2_ties = compare("K2", got, want, e > 0.0)

    # per-call times at the benchmark slab: round-2 state of every tile
    nbb = culling.nb
    args = culled_args(nbb)
    pos, dirs, e, rem, act = k1_inputs(nbb, gen)
    act[:] = 1
    rem[:] = kb.TILE
    o = kb.bounce_reflect_culled(*args, 5, rem, act, pos, dirs, e,
                                 table.groups, culling.group_offsets, te,
                                 source_spec=spec, **kw)
    pos, dirs, e = o[0], o[1], torch.where(o[3] >= 0, o[2], 0.0)
    rem[:] = kb.TILE // 4
    call_k1 = (lambda: kb.bounce_reflect_culled(
        *args, 6, rem, act, pos, dirs, e, table.groups,
        culling.group_offsets, te, source_spec=spec, **kw))
    call_k1_ref = (lambda: kb.bounce_reflect_culled_ref(
        *args, 6, rem, act, pos, dirs, e, table.groups,
        culling.group_offsets, te, source_spec=spec, **kw))
    call_k2 = (lambda: kb.bounce_reflect(rows, 7, pos, dirs, e,
                                         table.groups, te, **kw))
    call_k2_ref = (lambda: kb.bounce_reflect_ref(rows, 7, pos, dirs, e,
                                                 table.groups, te, **kw))
    # plain, kernel, kernel, plain: report the better of each pair
    p1 = time_cuda(call_k1_ref, 3)
    k1a = time_cuda(call_k1, 20)
    k2a = time_cuda(call_k2, 20)
    p2 = time_cuda(call_k2_ref, 3)
    k1b = time_cuda(call_k1, 20)
    k2b = time_cuda(call_k2, 20)
    p1b = time_cuda(call_k1_ref, 3)
    p2b = time_cuda(call_k2_ref, 3)
    times = {"K1": (min(k1a, k1b), min(p1, p1b)),
             "K2": (min(k2a, k2b), min(p2, p2b))}
    for k, (t_k, t_p) in times.items():
        log(f"{k} at {nbb * kb.TILE} lanes: kernel {t_k:.3f} ms, plain "
            f"{t_p:.3f} ms ({card})")
    # the bounds of the timed calls: every lane's results written once
    # (36 B); a lane that carries its ray in reads it once (28 B), a lane
    # that K1 regenerates reads only its energy (4 B); each input table is
    # read once. K1 tests its tile's candidates, shades its live lanes and
    # samples its regenerated ones; K2 (regeneration off) tests every row
    # (only lanes with energy need the work)
    n_lanes = nbb * kb.TILE
    live_b = (e > 0.0).view(nbb, kb.TILE).sum(1).cpu()
    regen_b = torch.minimum(kb.TILE - live_b, rem.cpu().to(live_b.dtype))
    n_live, n_regen = int(live_b.sum()), int(regen_b.sum())
    cand = int(((live_b + regen_b)
                * torch.as_tensor(culling.counts.sum(1))).sum())
    tables = 4 * (rows.numel() + sum(a.numel() for a in args[1:]) + 2 * nbb)
    k1_bound = bound(36 * n_lanes + 28 * (n_lanes - n_regen) + 4 * n_regen
                     + tables, cand * row_ops("flat", (1,))
                     + (n_live + n_regen) * SHADE_OPS + n_regen * REGEN_OPS)
    k2_bound = bound(64 * n_lanes + 4 * rows.numel(), n_live * (sum(
        (g[1] - g[0]) * row_ops(g[3], g[2]) for g in table.groups)
        + SHADE_OPS))
    for k, bnd in (("K1", k1_bound), ("K2", k2_bound)):
        log(f"{k} bound at {n_lanes} lanes ({n_live} live, {n_regen} "
            f"regenerated by K1): {bnd[0]:.4f} ms, set by {bnd[1]}")
    record = {"kernels": [
        kernel_entry("bounce_reflect_culled",
                     "tracer_tpu_torch/kernels/csrc/bounce.cu",
                     "tracer_tpu/kernels/pallas_intersect.py:2049", 0,
                     k1_err, times["K1"][0], times["K1"][1], k1_bound),
        kernel_entry("bounce_reflect",
                     "tracer_tpu_torch/kernels/csrc/bounce.cu",
                     "tracer_tpu/kernels/pallas_intersect.py:1693", 0,
                     k2_err, times["K2"][0], times["K2"][1], k2_bound)]}
    del pos, dirs, e, o

    # ---- phase 4: K3 against its plain version
    record["kernels"].append(k3_phase(dev, card, table, source_fn, kn))

    fspec = flux_plan(meta, "receiver", resolution=50)
    if profiling:
        profile(table, source_fn, culling, 256 * slab, fspec,
                trace_streaming)

    # ---- phase 5: the NSTTF main path at benchmark size
    culling_d1 = build_block_culling(table, meta, spec, slab, age_cap=1)
    # (label, culling, rays, max_rounds, timed runs)
    runs = (("default corridors", culling, 256 * slab, 600, 3),
            ("depth-1 corridors", culling_d1, 32 * slab, 20_000, 1))
    # one untimed trace of each kind first, so the timed ones pay no
    # first-use costs (the allocator's slab buffers, cuBLAS's handle)
    for _, cul, _, max_rounds, _ in runs:
        trace_streaming(table, source_fn, torch.Generator().manual_seed(1),
                        total_rays=4 * slab, max_rounds=max_rounds,
                        max_path=8, min_energy=1e-6, culling=cul,
                        fluxspecs=(fspec,))
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    for label, cul, total, max_rounds, reps in runs:
        l1, l2 = kb.bounce_reflect_culled.launches, kb.bounce_reflect.launches
        walls = []
        for rep in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accum, emitted, source_e = trace_streaming(
                table, source_fn, torch.Generator().manual_seed(rep),
                total_rays=total, max_rounds=max_rounds, max_path=8,
                min_energy=1e-6, culling=cul, fluxspecs=(fspec,))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rec_frac, closure, flux_rec = check_trace(
                label, accum, emitted, source_e, total, energy_closure)
        wall = sorted(walls)[len(walls) // 2]
        log(f"slice ({label}): {int(emitted)} rays emitted, receiver "
            f"fraction {rec_frac:.5f}, closure {closure:.2e}, flux/receiver "
            f"{flux_rec:.6f}, K1 launches "
            f"{kb.bounce_reflect_culled.launches - l1}, K2 launches "
            f"{kb.bounce_reflect.launches - l2} in {reps} run(s); wall "
            f"median {wall:.3f} s of {', '.join(f'{w:.3f}' for w in walls)}"
            f", {int(emitted) / wall / 1e6:.1f} Mrays/s ({card})")
    record["kernels"][0]["launches"] = kb.bounce_reflect_culled.launches
    record["kernels"][1]["launches"] = kb.bounce_reflect.launches
    check(kn.nearest_hit.launches == 0, "K3 launched on the NSTTF path")

    # ---- phase 6: the MiniDish main paths
    record["kernels"][2]["launches"], p_ref = minidish_phase(dev, card, kn,
                                                             kb)

    # ---- phases 7 and 8: bench configs 1-3, then 6, 8 and 8b, on the
    # plain megakernel
    entry = record["kernels"][1]
    for modes, cfgs in ((BENCH_MODES, (1, 2, 3)),
                        (STAGE_C_MODES, (6, 8, "8b"))):
        k2 = bench_phase(dev, card, kb, kn, p_ref, modes, cfgs)
        entry["launches"] += k2["launches"]
        entry["max_abs_err"] = max(entry["max_abs_err"], k2["max_abs_err"])
        if cfgs[0] == 1:
            # the record keeps config 1's regeneration mode
            entry.update({k: k2[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")})
    for k in record["kernels"]:
        check(k["launches"] > 0, f"{k['name']} never launched on the path")
    print(json.dumps(record))
    return finish()


MD_LANES = 4_194_304          # trace_fused and K3 at the MiniDish
MD_RECORDED = 1_048_576       # ray_tracer with full records
MD_CPU = 65_536               # the float64 CPU reference
F32_T_EPS = 3e-4              # kernels.intersect.default_t_eps(float32)


def minidish_scene(device, dtype=None):
    """(assembly, table, meta) of the TAU MiniDish as the examples build
    it: 5 m dish, f = 6.25 m, 0.4 m homogenizer 0.7 m deep in front of the
    receiver, efficiencies 0.9, rotated by -pi/4 about x."""
    import numpy as np
    import torch
    from tracer_tpu_torch import spatial
    from tracer_tpu_torch.models.tau_minidish import MiniDish
    from tracer_tpu_torch.scene import compile_scene
    asm = MiniDish(5.0, 6.25, 0.9, 6.95, 0.4, 0.7, 0.9)
    asm.set_transform(spatial.rotx(-np.pi / 4))
    table, meta = compile_scene(asm, dtype=dtype or torch.float32,
                                device=device)
    return asm, table, meta


def minidish_sun(n, device, seed=42):
    """The examples' pillbox disk sun (radius 3 m, 5 mrad, 1000 W/m^2)
    shining down the dish axis, drawn on ``device``."""
    import math
    import torch
    from tracer_tpu_torch.sources import solar_disk_bundle
    x = -1.0 / math.sqrt(2.0)
    return solar_disk_bundle(
        torch.Generator(device=device).manual_seed(seed), n,
        center=[0.0, 7.0, 7.0], direction=[0.0, x, x], radius=3.0,
        ang_range=0.005, flux=1000.0, device=device)


def head(bundle, n, device=None, dtype=None):
    """The first n rays of a bundle, optionally moved / cast."""
    from tracer_tpu_torch.bundle import RayBundle
    out = {}
    for k, v in bundle.__dict__.items():
        v = v[:n]
        if device is not None:
            v = v.to(device)
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        out[k] = v.contiguous()
    return RayBundle(**out)


def k3_phase(dev, card, nsttf_table, nsttf_source, kn):
    """K3 against its plain version on the card (sid equal off ties, t
    and aux within 1e-5 of their scale: tests/test_torch_gpu.k3_compare),
    then its time beside the plain version's. Returns its JSON entry with
    the MiniDish's numbers (the main path's shape); launches are filled in
    by the MiniDish phase; its max_abs_err is the largest difference in
    t, normal, local hit and up_dot over the MiniDish's lanes (the other
    tables' are printed)."""
    import torch
    import tracer_tpu_torch as ptt
    from tracer_tpu_torch.engine import TraceAccum, _bounce_step
    from tracer_tpu_torch.kernels.bounce import pack_rows
    from test_torch_gpu import fuzz_assembly, fuzz_rays, k3_compare
    _, md_table, _ = minidish_scene(dev)
    sun = minidish_sun(MD_LANES, dev)
    second, _, _ = _bounce_step(
        md_table, sun, TraceAccum.zeros(md_table.num_rows, device=dev),
        torch.Generator(device=dev).manual_seed(0), 1e-6, None, 1e-6, 64)
    slab = nsttf_source.num_rays
    helio = nsttf_source(torch.Generator(device=dev).manual_seed(7),
                         device=dev)
    fz_table, fz_meta = ptt.compile_scene(fuzz_assembly(ptt, 0), device=dev)
    fz = [torch.as_tensor(a, device=dev) for a in fuzz_rays(fz_meta, slab, 5)]
    # groups of ~500 rows: each spans two of the kernel's staged chunks
    big_table, big_meta = ptt.compile_scene(
        fuzz_assembly(ptt, 1, extra=2000), device=dev)
    big = [torch.as_tensor(a, device=dev)
           for a in fuzz_rays(big_meta, slab, 6)]
    cases = (("MiniDish sun rays", md_table, sun.pos, sun.dir),
             ("MiniDish second bounce", md_table, second.pos, second.dir),
             ("NSTTF Buie rays", nsttf_table, helio.pos, helio.dir),
             ("every class and aperture", fz_table, fz[0], fz[1]),
             ("every class, 2,017 rows", big_table, big[0], big[1]))
    out = None
    for label, tab, pos, dirs in cases:
        n = pos.shape[0]
        rows = pack_rows(tab)
        args = (rows, pos, dirs, tab.groups, F32_T_EPS)
        kw = dict(need_local=True,
                  backside_miss="bifacial" in tab.features)
        got = kn.nearest_hit(*args, **kw)
        want = kn.nearest_hit_ref(*args, **kw)
        torch.cuda.synchronize()
        ties, flips = k3_compare(got, want, kn.nearest_two_t(*args), pos,
                                 dirs, rtol=1e-5,
                                 max_flips=int(1e-5 * n) + 1)
        hit = (want[1] >= 0) & (got[1] == want[1])
        errs = {"t": float((got[0] - want[0]).abs()[hit].max())}
        errs.update({k: float((got[2][k] - want[2][k]).abs()[hit].max())
                     for k in ("normal", "local", "up_dot")})
        err = max(errs.values())
        del got, want
        call_k = (lambda: kn.nearest_hit(*args, **kw))
        call_p = (lambda: kn.nearest_hit_ref(*args, **kw))
        p1 = time_cuda(call_p, 3)
        k1 = time_cuda(call_k, 20)
        k2 = time_cuda(call_k, 20)
        p2 = time_cuda(call_p, 3)
        ops = n * sum((g[1] - g[0]) * row_ops(g[3], g[2])
                      for g in tab.groups)
        bnd = bound(n * (24 + 52), ops)
        log(f"K3 {label}: {n} lanes, {tab.num_rows} rows, hits "
            f"{float((hit).float().mean()):.3f}, sid ties {ties}, edge "
            f"flips {flips}, max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; kernel "
            f"{min(k1, k2):.4f} ms, plain {min(p1, p2):.3f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}) ({card})")
        if out is None:
            out = kernel_entry(
                "nearest_hit", "tracer_tpu_torch/kernels/csrc/nearest.cu",
                "tracer_tpu/kernels/pallas_intersect.py:583", 0, err,
                min(k1, k2), min(p1, p2), bnd)
        elif tab is md_table:
            out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def minidish_phase(dev, card, kn, kb):
    """ray_tracer and trace_fused on the MiniDish at the published size,
    under the guards of the module docstring. Returns K3's launches on the
    timed trace_fused runs."""
    import math
    import statistics
    import torch
    from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
    from tracer_tpu_torch.engine import (TraceOptions, TracerEngine,
                                         trace_fused)
    asm, table, meta = minidish_scene(dev)
    names = meta.names
    rec_i = names.index("receiver")
    sun = minidish_sun(MD_LANES, dev)

    # the float64 CPU reference on the first rays, with float32's
    # self-hit guard so that only rounding differs
    asm64, _, _ = minidish_scene("cpu", torch.float64)
    t0 = time.perf_counter()
    ref = TracerEngine(asm64, dtype=torch.float64, device="cpu").ray_tracer(
        head(sun, MD_CPU, "cpu", torch.float64),
        opts=TraceOptions(t_eps=F32_T_EPS, record=False))
    ref_abs = ref.absorbed_by_logical()
    ref_src = ref.energy_balance()["source"]
    p_ref = ref_abs[rec_i] / ref_src
    gpu_sub = TracerEngine(table, meta).ray_tracer(
        head(sun, MD_CPU), opts=TraceOptions(record=False))
    diff = abs(gpu_sub.absorbed_by_logical() - ref_abs).max() / ref_src
    log(f"MiniDish CPU float64 reference: {MD_CPU} rays in "
        f"{time.perf_counter() - t0:.1f} s, receiver fraction {p_ref:.5f};"
        f" the card's float32 run on the same rays: largest per-surface "
        f"difference {diff:.2e} of the source")
    check(diff < 1e-4, f"MiniDish per-surface absorbed differs by {diff}")

    def guards(label, src, absorbed, escaped, culled, residual, n):
        closure = (src - absorbed.sum() - escaped - culled - residual) / src
        p = absorbed[rec_i] / src
        sig = math.sqrt(p_ref * (1 - p_ref) * (1.0 / MD_CPU + 1.0 / n))
        check(abs(closure) < 1e-4, f"{label}: closure {closure}")
        check(abs(p - p_ref) < 3 * sig,
              f"{label}: receiver fraction {p} vs {p_ref} +- {sig}")
        return p, closure

    # ray_tracer with full records
    bundle = head(sun, MD_RECORDED)
    engine = TracerEngine(table, meta)
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = engine.ray_tracer(bundle, reps=100)
    wall = time.perf_counter() - t0
    launches = kn.nearest_hit.launches
    check(launches == len(res.records) > 0,
          f"ray_tracer: {launches} K3 launches for {len(res.records)} "
          "bounces")
    check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
          == 0, "K1/K2 launched on the MiniDish path")
    bal = res.energy_balance()
    absorbed = res.absorbed_by_logical()
    check(all(math.isfinite(v) for v in bal.values()), f"balance {bal}")
    p, closure = guards("ray_tracer", bal["source"], absorbed,
                        bal["escaped"], bal["culled"], bal["residual"],
                        MD_RECORDED)
    H, xb, yb = asm.histogram_hits(res, bins=50)
    check(H.shape == (50, 50) and abs(H.sum() - absorbed[rec_i])
          < 1e-3 * absorbed[rec_i], f"histogram {H.sum()} vs receiver "
          f"{absorbed[rec_i]}")
    conc = H / ((xb[1] - xb[0]) * (yb[1] - yb[0])) / 1000.0
    log(f"MiniDish ray_tracer: {MD_RECORDED} rays, {len(res.records)} "
        f"bounces, K3 launches {launches}, receiver fraction {p:.5f}, "
        f"closure {closure:.2e}, receiver histogram {H.sum():.1f} W (peak "
        f"{conc.max():.1f} suns), wall {wall:.3f} s ({card})")
    log("  absorbed W: " + ", ".join(f"{nm} {a:.2f}"
                                     for nm, a in zip(names, absorbed)))
    del res, bundle

    # trace_fused: one warm-up, three timed runs
    spec = flux_plan(meta, "receiver", resolution=50)

    def fused(max_bounces=20):
        return trace_fused(table, sun, max_bounces=max_bounces,
                           fluxspecs=(spec,))
    fused()
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        final, acc = fused()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = kn.nearest_hit.launches
    check(launches % 3 == 0, f"trace_fused: {launches} K3 launches")
    bounces = launches // 3
    check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
          == 0, "K1/K2 launched on the MiniDish path")
    # K3 ran once per bounce: one bounce fewer leaves rays alive
    check(not bool(final.alive.any())
          and bool(fused(bounces - 1)[0].alive.any()),
          f"trace_fused: {bounces} bounces do not end the trace")
    src = float(sun.total_energy())
    ab = acc.absorbed.double().cpu().numpy()
    p, closure = guards("trace_fused", src, ab, float(acc.escaped),
                        float(acc.culled), float(final.total_energy()),
                        MD_LANES)
    fsum = float(acc.flux[0].double().sum())
    check(acc.flux[0].shape == (50, 50)
          and bool(torch.isfinite(acc.flux[0]).all())
          and abs(fsum - ab[rec_i]) < 1e-3 * ab[rec_i],
          f"flux map {fsum} vs receiver {ab[rec_i]}")
    wall = statistics.median(walls)
    log(f"MiniDish trace_fused: {MD_LANES} rays, {bounces} bounces, K3 "
        f"launches {launches} in 3 runs, receiver fraction {p:.5f}, "
        f"closure {closure:.2e}, flux/receiver {fsum / ab[rec_i]:.6f}; "
        f"wall median {wall:.3f} s of "
        f"{', '.join(f'{w:.3f}' for w in walls)}, "
        f"{MD_LANES / wall / 1e6:.1f} Mrays/s ({card})")
    profile_path("MiniDish trace_fused", fused, "K3", "nearest_kernel",
                 card)
    return launches, p_ref


def profile_path(label, run, name, kernel_key, card, top=8):
    """One profiled run: device busy time (summed over device events
    only) and the share of kernel ``name`` (events whose key holds
    ``kernel_key``), then the largest device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    k_us = sum(e.self_device_time_total for e in dev if kernel_key in e.key)
    check(dev_us > 0 and k_us > 0, f"profile: no device time for {name}")
    log(f"{label} profile: wall {wall * 1e3:.1f} ms under the profiler, "
        f"device busy {dev_us / 1e3:.1f} ms in {sum(e.count for e in dev)}"
        f" device events, {name} {k_us / 1e3:.2f} ms = "
        f"{100 * k_us / dev_us:.1f}% of device time ({card})")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms "
            f"({100 * e.self_device_time_total / dev_us:4.1f}%) "
            f"{e.count:6d}x {e.key[:80]}")


BENCH_SLAB = 228 * 3072       # the suite's slab: 228 tiles of 3072 lanes
BENCH_ROUNDS = 128            # emission rounds of one bench call
BENCH_SMALL = 4 * 3072        # the plain version's small CPU trace
# the recorded TPU physics of bench configs 1, 3, 6 and 8
# (BENCHMARKS.md, benchmarks/suite.py), printed beside the port's for the
# reader only
TPU_PHYSICS = {1: ("receiver fraction", 0.6008),
               3: ("medium / source", 0.5101),
               6: ("receiver fraction", 0.9213),
               8: ("medium / source", 0.555),
               "8b": ("medium / source", 0.363)}
# K2's modes: (label, scene (test_torch_gpu.k2_scene), dead share,
# regeneration)
BENCH_MODES = (("regeneration over a half-dead slab", 1, 0.5, True),
               ("MiniDish rows", 1, 0.0, False),
               ("Lambertian + bivariate slope (config 2)", 2, 0.5, True),
               ("spectral + ambient (config 3)", 3, 0.5, True))
STAGE_C_MODES = (("lens, Fresnel roulette (config 6)", 6, 0.5, True),
                 ("ambient HG medium (config 8)", 8, 0.5, True),
                 ("media ids (config 8b)", "8b", 0.5, True),
                 ("lens in the HG medium", "lens_hg", 0.5, True),
                 ("absorbing media, no scattering", "slab_media", 0.5, True))
# float32 operations of K2's epilogue branches, counted from its source
SLOPE_OPS = 90                # of SHADE_OPS: the slope error
LAMBERT_OPS = 45              # the Lambertian lobe
ATT_OPS = 25                  # Beer-Lambert attenuation
SEG_OPS = 6                   # per spectral-table segment scanned
BAND_OPS = 5                  # a wavelength drawn in the band
REFR_OPS = 60                 # Snell and Fresnel on a refractive hit
FREE_OPS = 10                 # a free path drawn in a scattering medium
HG_OPS = 45                   # an HG direction on a scattered lane
MEDIA_OPS = 6                 # a lane's medium and the winner's side ids


def k2_bound(table, rows, kw, pos, dirs, energy, want, regen):
    """(ms, what sets it) of one K2 call on these inputs. Bytes: every
    lane's results written once (36 B, 4 B more for each of the
    wavelength, index and medium id lanes it threads); a lane that carries
    its ray in reads it once (28 B, 4 B more for each of those lanes), a
    regenerated lane only its energy (4 B, and its wavelength when the
    source has no band to draw one); the rows, the spectral table and the
    media tables read once. Operations, as its data needs them: every row
    for each lane that carries a ray after regeneration, the epilogue's
    branches for those lanes (the free path in a scattering medium, the
    medium lookup), Snell and Fresnel on each refractive hit and the HG
    direction on each scattered lane, the sample for each regenerated lane,
    and the table segments each spectral hit scans."""
    import torch
    from tracer_tpu_torch.kernels.bounce import media_flags
    n = pos.shape[0]
    spectral = kw.get("wavelength") is not None
    media = kw.get("media")
    n_lanes = sum(kw.get(k) is not None
                  for k in ("wavelength", "ref_index", "medium_id"))
    dead = energy <= 0.0
    n_regen = int(dead.sum()) if regen else 0
    n_traced = n - int(dead.sum()) + n_regen
    band = bool(kw["source_spec"][13]) if regen else False
    nbytes = (n * (36 + 4 * n_lanes)
              + (n - n_regen) * (28 + 4 * n_lanes)
              + n_regen * (4 + (4 if spectral and not band else 0))
              + 4 * rows.numel()
              + (4 * kw["spectral_tab"].numel() if spectral else 0)
              + (4 * (3 * len(media[0]) + 2 * rows.shape[0]) if media
                 else 0))
    att_on, scat_on = (media_flags(media) if media is not None
                       else (kw["ambient_att"] > 0.0,
                             kw.get("ambient_scat", 0.0) > 0.0))
    per_lane = (sum((g[1] - g[0]) * row_ops(g[3], g[2])
                    for g in table.groups)
                + SHADE_OPS - (0 if kw["slope"] else SLOPE_OPS)
                + (LAMBERT_OPS if kw["lambertian"] else 0)
                + (ATT_OPS if att_on else 0)
                + (FREE_OPS if scat_on else 0)
                + (MEDIA_OPS if media is not None else 0))
    nops = n_traced * per_lane + n_regen * (
        REGEN_OPS + (BAND_OPS if spectral else 0))
    kinds = table.opt_kind[want[3].clamp(min=0).long()]
    if kw.get("ref_index") is not None:
        nops += int(((want[3] >= 0) & (kinds == 6)).sum()) * REFR_OPS
    nops += int((want[3] == -2).sum()) * HG_OPS
    if spectral:
        on = (want[3] >= 0) & (kinds == 5)
        x = kw["spectral_tab"][:, 0].contiguous()
        seg = torch.searchsorted(x, want[5][on].contiguous())
        nops += int((seg + 1).sum()) * SEG_OPS
    return bound(nbytes, nops)


def bench_phase(dev, card, kb, kn, p_ref, modes, cfgs):
    """Bench configurations ``cfgs`` (benchmarks/suite.py) on the plain
    megakernel: K2 against its plain version in each of ``modes`` at the
    suite's slab, then each configuration's trace_streaming(culling=None)
    at full size under its guards. Returns K2's numbers for the record:
    its launches on these paths and, from the first mode, its time, its
    plain version's and its bound."""
    import math
    import statistics
    import torch
    from test_torch_gpu import (bench_lanes, bench_modes, k2_compare,
                                k2_near, k2_scene, medium_att, traced_rays)
    from tracer_tpu_torch.models.bench_configs import (BENCH, bench_scene,
                                                       max_rounds)
    from tracer_tpu_torch.engine import energy_closure, trace_streaming
    n = BENCH_SLAB
    out = {"max_abs_err": 0.0}
    for label, scene, dead, regen in modes:
        table, spec = k2_scene(scene, n, dev)
        pos, dirs, e, lanes = bench_lanes(table, spec, n, dead, 23, dev)
        rows = kb.pack_rows(table)
        kw = dict(regen=regen, **lanes, **bench_modes(table, spec))
        args = (rows, 29, pos, dirs, e, table.groups, F32_T_EPS)
        got = kb.bounce_reflect(*args, **kw)
        want = kb.bounce_reflect_ref(*args, **kw)
        torch.cuda.synchronize()
        tp, td = traced_rays(spec, 29, pos, dirs, e, regen)
        live = (e > 0.0) | ((e <= 0.0) & regen)
        max_flips = int(1e-5 * n) + 1
        ties, flips, err = k2_compare(
            got, want, k2_near(rows, tp, td, table.groups, F32_T_EPS), tp,
            td, live, att=medium_att(kw), max_flips=max_flips,
            decisions=lanes["ref_index"] is not None)
        hits = float((want[3][live] >= 0).float().mean())
        scat = float((want[3][live] == -2).float().mean())
        bnd = k2_bound(table, rows, kw, pos, dirs, e, want, regen)
        del got
        call_k = (lambda: kb.bounce_reflect(*args, **kw))
        call_p = (lambda: kb.bounce_reflect_ref(*args, **kw))
        p1 = time_cuda(call_p, 3)
        k1 = time_cuda(call_k, 20)
        k2 = time_cuda(call_k, 20)
        p2 = time_cuda(call_p, 3)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        log(f"K2 {label}: {n} lanes ({int(live.sum())} traced, hit share "
            f"{hits:.3f}, scattered {scat:.3f}), rows {table.num_rows} in "
            f"groups {[(g[3], g[2]) for g in table.groups]}, sid ties "
            f"{ties}, flips {flips}, max abs err {err:.2e}; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bnd[0]:.4f} ms "
            f"({bnd[1]}) ({card})")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        if "ms" not in out:
            out.update(ms=ms, plain_ms=plain_ms, bound_ms=bnd[0],
                       bound_by=bnd[1])
        del want, pos, dirs, e, lanes, tp, td

    # each configuration through the plain megakernel at the suite's size
    total = BENCH_ROUNDS * n
    out["launches"] = 0
    for cfg in cfgs:
        table, meta, source_fn = bench_scene(cfg, n, dev)
        max_path = BENCH[cfg]["max_path"]
        seed0 = {"8b": 9}.get(cfg, cfg)

        def run(seed, total=total):
            return trace_streaming(
                table, source_fn, torch.Generator().manual_seed(seed),
                total, max_rounds=max_rounds(cfg, BENCH_ROUNDS),
                max_path=max_path)
        run(100 + seed0, 4 * n)         # untimed: first-use costs
        reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                       kn.nearest_hit)
        walls, results = [], []
        for rep in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            results.append(run(10 * seed0 + rep))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        launches = kb.bounce_reflect.launches
        check(kb.bounce_reflect_culled.launches == kn.nearest_hit.launches
              == 0, f"config {cfg}: K1 or K3 launched on the path")
        check(launches > 3 * BENCH_ROUNDS, f"config {cfg}: {launches} K2 "
              f"launches in 3 calls of {BENCH_ROUNDS}+ rounds")
        out["launches"] += launches
        # the plain version's small trace of the same configuration
        if cfg != 1:
            s_table, _, s_source = bench_scene(cfg, BENCH_SMALL, "cpu")
            acc_s, em_s, se_s = trace_streaming(
                s_table, s_source, torch.Generator().manual_seed(7),
                16 * BENCH_SMALL, max_rounds=max_rounds(cfg, 16),
                max_path=max_path)
            q = (list(acc_s.absorbed.double().numpy() / float(se_s))
                 + [float(acc_s.medium) / float(se_s)])
        for rep, (accum, emitted, source_e) in enumerate(results):
            em, se = int(emitted), float(source_e)
            check(total <= em <= total + n,
                  f"config {cfg}: emitted {em} of {total}")
            closure = energy_closure(accum, source_e)
            check(abs(closure) < 1e-4, f"config {cfg}: closure {closure}")
            for name in ("absorbed", "escaped", "culled", "medium",
                         "residual"):
                check(bool(torch.isfinite(getattr(accum, name)).all()),
                      f"config {cfg}: {name} not finite")
            p = (list(accum.absorbed.double().cpu().numpy() / se)
                 + [float(accum.medium) / se])
            physics = max(p[:-1])
            if cfg == 1:
                rec = p[int((meta.row_logical
                             == meta.index_of("receiver")).nonzero()[0][0])]
                sig = math.sqrt(p_ref * (1 - p_ref) * (1 / MD_CPU + 1 / em))
                check(abs(rec - p_ref) < 3 * sig, f"config 1: receiver "
                      f"fraction {rec} vs {p_ref} +- {sig}")
                physics = rec
            else:
                n_s = int(em_s)
                for i, (a, b) in enumerate(zip(p, q)):
                    sig = math.sqrt(max(b * (1 - b), 1e-12)
                                    * (1 / n_s + 1 / em))
                    check(abs(a - b) < 3 * sig, f"config {cfg}: fraction "
                          f"{i} {a} vs the plain version's {b} +- {sig}")
            if cfg == 6:
                physics = sum(p[int(r)] for r in (
                    meta.row_logical == meta.index_of("rec")).nonzero()[0])
                check(0.75 < physics < 0.98,
                      f"config 6: receiver fraction {physics}")
            if cfg in (3, 8, "8b"):
                physics = p[-1]
                check(physics > {3: 0.0, 8: 0.1, "8b": 0.05}[cfg],
                      f"config {cfg}: medium share {physics}")
        shown = ", ".join(f"{nm} {x:.5f}" for nm, x in zip(
            [meta.names[int(r)] for r in meta.row_logical] + ["medium"], p))
        wall = statistics.median(walls)
        what, tpu = TPU_PHYSICS.get(cfg, ("largest surface fraction", None))
        log(f"config {cfg}: {em} rays emitted per call, {launches / 3:.0f} "
            f"rounds (K2 launches) per call, closure {closure:.2e}, {what} "
            f"{physics:.5f}" + (f" (TPU recorded {tpu})" if tpu else "")
            + f"; wall median {wall:.3f} s of "
            f"{', '.join(f'{w:.3f}' for w in walls)}, "
            f"{em / wall / 1e6:.1f} Mrays/s ({card})")
        log(f"  fractions of the source (the last call): {shown}")
        if cfg != 1:
            log(f"  the plain version's {int(em_s)}-ray CPU trace: "
                + ", ".join(f"{x:.5f}" for x in q))
        profile_path(f"config {cfg} trace", lambda: run(200 + seed0),
                     "K2", "bounce_kernel", card)
    return out


def check_trace(label, accum, emitted, source_e, total, energy_closure):
    """bench.py's three guards on one trace, plus finite outputs of the
    expected shape. Returns (receiver fraction, closure, flux/receiver)."""
    import torch
    ab = accum.absorbed.double().cpu()
    closure = energy_closure(accum, source_e)
    rec = float(ab.max())
    rec_frac = rec / float(source_e)
    fsum = float(accum.flux[0].double().sum())
    check(accum.flux[0].shape == (50, 50), f"flux map shape "
          f"{tuple(accum.flux[0].shape)}")
    for name in ("absorbed", "escaped", "culled", "residual"):
        check(bool(torch.isfinite(getattr(accum, name)).all()),
              f"{label}: {name} not finite")
    check(bool(torch.isfinite(accum.flux[0]).all()),
          f"{label}: flux map not finite")
    check(int(emitted) >= total, f"{label}: emitted {int(emitted)}")
    check(abs(closure) < 5e-3, f"{label}: energy closure {closure}")
    check(0.035 < rec_frac < 0.08, f"{label}: receiver {rec_frac}")
    check(abs(fsum - rec) / rec < 5e-3,
          f"{label}: flux map {fsum} vs receiver {rec}")
    return rec_frac, closure, fsum / rec


def profile(table, source_fn, culling, total, fspec, trace_streaming):
    """Where a trace's time goes: torch.profiler over one warm trace of
    ``total`` rays. Device time is summed over the device-side events
    (kernels, copies, fills) only: an operator's own row repeats the time
    of the kernels it launched, so summing every row counts most of the
    device time twice."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    def run():
        trace_streaming(table, source_fn, torch.Generator().manual_seed(3),
                        total_rays=total, max_rounds=600, max_path=8,
                        min_energy=1e-6, culling=culling, fluxspecs=(fspec,))
        torch.cuda.synchronize()

    run()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    check(dev_us > 0, "profile: the profiler recorded no device events")
    log(f"profile: {total} rays, wall {wall * 1e3:.1f} ms under the "
        f"profiler, device busy {dev_us / 1e3:.1f} ms "
        f"({100 * dev_us / 1e6 / wall:.1f}%) in {sum(e.count for e in dev)}"
        f" device events")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms "
            f"({100 * e.self_device_time_total / dev_us:4.1f}%) "
            f"{e.count:6d}x {e.key[:80]}")
    host = [e for e in events if e.device_type == DeviceType.CPU]
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
        log(f"  host {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:6d}x "
            f"{e.key[:80]}")
    return dev_us / 1e3


def finish():
    import torch
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main(sys.argv[1:])
