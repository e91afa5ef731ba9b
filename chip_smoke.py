#!/usr/bin/env python3
"""GPU smoke run of the PyTorch / CUDA port (tracer_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py             # every phase, 10-18 minutes
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
   same lanes, and on the dead lanes it traces and shades beside the live
   ones (tests/test_torch_gpu.k2_compare with k2_dead), with each K2
   instance's registers and spill from ptxas (none may spill); then each
   one's time at the benchmark slab (2,101,248 lanes) beside its plain
   version's, K1 dispatching the tiles in the culling's order as the
   trace does, K1's launch geometry there (blocks, threads, lanes a
   block, blocks resident a SM, waves) with the spread of the tiles'
   candidate rows, and K2's (persistent blocks, threads, lanes a chunk,
   shared bytes, blocks resident a SM);
4. K3 (nearest_hit) against its plain version: on the MiniDish at
   4,194,304 lanes (the sun's rays with and without the local hit point,
   whose zeros it checks, then their second bounce), on the NSTTF table,
   on a table with every quadric class and aperture kind and on the same
   with 2,000 more rows (groups that stream through several staged
   parts) at 2,101,248 lanes; each one's time beside the plain version's
   and its launch geometry (blocks, threads, chunks a block, the table
   staged whole or streamed, shared bytes, blocks resident a SM), with
   each K3 instance's registers and spill from ptxas (none may spill);
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
   K3 launched once per bounce and the K3 epilogue once after each K3
   launch of trace_fused (never on ray_tracer), and against the port's
   float64 CPU ray_tracer on the first 65,536 rays (same float32 self-hit
   guard): receiver fraction within 3 binomial sigma, every surface's
   absorbed energy on those rays within 1e-4 of their source energy.
   Then the K3 epilogue against its plain version (engine._bounce_step's
   shade and accounting, device_fluxmap.accumulate) on the same 4,194,304
   lanes, first and second bounce: alive equal, pos, dir and energy
   within 1e-6, per-row sums, escaped, culled and the 50 x 50 bins within
   1e-5 relative, hits equal (tests/test_torch_epilogue's comparisons);
   its time beside the plain version's and its bound;
7. bench configs 1-3 (benchmarks/suite.py: the MiniDish under a pillbox
   sun; a slope-error dish over a Lambertian absorber; a spectral silver
   mirror under a Buie sun with a wavelength band, in an attenuating
   medium) on the plain streaming megakernel: K2 (bounce_reflect) against
   its plain version at the suite's slab of 700,416 lanes in each mode the
   path runs (regeneration over a half-dead slab, the MiniDish's
   paraboloid and rect rows, the drain's half-dead lanes without
   regeneration, the Lambertian lobe with bivariate slope error, spectral
   absorptance with ambient attenuation), with ties and edge flips at
   most 1e-5 of the lanes, dead ones included
   (tests/test_torch_gpu.k2_compare),
   each timed beside its plain version; then each configuration through
   trace_streaming(culling=None) at the suite's size (128 emission rounds,
   89,653,248 rays, max_path 20, 20 and 8): one untimed short trace, three
   timed (median and every wall time, rounds and K2 launches printed) and
   one profiled for K2's share of device time (a quarter call: the
   profiler takes minutes to sort a whole call's events). Guards: full
   emission, closure below 1e-4, config 1's receiver fraction within 3 binomial
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
   the plain version's 196,608-ray CPU trace;
9. bench config 7 (benchmarks/suite.py:360: a Cook-Torrance target
   scattering into an absorbing collection dome) and K2's stage (d) and
   (e) kinds: K2 against its plain version at 700,416 lanes in each new
   mode (config 7's Cook-Torrance rows with regeneration; a transparent
   cover over a Lambertian-specular target in a semi-Lambertian dome; a
   dispersive conductor under a wavelength band; IAM with c = 2; a
   bilinear (theta, wl) piecewise plate; a periodic cell in the HG medium
   its boundary declares), then config 7 at 89,653,248 rays through the
   plain megakernel as in phase 7, then through the general streaming
   path (the same source without its spec: one untimed short trace, three
   timed, K2 launches per call). Guards: full emission, closure below
   1e-4, the dome's share above 0.4 (suite.py:419) and within 3 sigma of
   the plain version's 196,608-ray CPU trace, the general path's within
   2% of the megakernel's (suite.py:425);
10. K1's modes beyond the NSTTF's and the two new fields: K2 against its
   plain version at 700,416 lanes with rect regeneration (the NSTTF's
   oblique rect source) and backside_miss (two bifacial plates); K1
   against its plain version on 64 tiles of each full field
   (tests/test_torch_gpu.K1_MODES: the curved field's two classes, rect
   cells with regeneration, a Lambertian receiver, spectral mirrors with
   a band in an attenuating ambient, conductor mirrors over an IAM
   receiver with c = 2, bifacial mirrors; flips at most 1e-5 of the
   lanes), each timed at the benchmark slab beside its plain version and
   its bound; then the curved field (benchmarks/curved.py: slab
   3,151,872, 134,479,872 rays, max_rounds 400) and the rect-source NSTTF
   (phase 5's scene, 537,919,488 rays, max_rounds 600), max_path 8, the
   50x50 receiver flux map: one untimed short trace, three timed culled
   ones, one culling=None. Guards: closure below 1e-4, the receiver's
   fraction (0.04-0.09, curved.py:79; above 0.02 for the rect source),
   culled within 2% (receiver) and 0.5% (escaped) of unculled for the
   curved field, 1.5%, 3% (mirrors) and 0.5% for the rect source
   (tests/test_pallas_tpu.py:215-255);
11. energy splitting and the stage (d)/(e) kinds beside refraction and
   media ids: K2 against its plain version at 700,416 lanes in refr_split
   mode (the split lens, config 6's lens with single_ray=False; TIR lanes
   in a glass block in an absorbing ambient; a splitting cover over a
   Cook-Torrance target) and in the four mixed scenes (the glazed config
   7, a glass cover over its Cook-Torrance target; the lens in config 8's
   HG medium over a Cook-Torrance floor; an absorbing slab beside a
   transparent sheet; config 8b's box with a Lambertian-specular floor),
   the branch's energy held like the energies and its direction on the
   lanes that split (tests/test_torch_gpu.k2_compare), each timed beside
   its plain version and its bound; then the glazed config 7 at
   89,653,248 rays on the plain megakernel as in phase 7 (guards: full
   emission, closure below 1e-4, the dome above 0.4 and every fraction
   within 3 sigma of the plain version's 196,608-ray CPU trace), and the
   split stream (benchmarks/suite.py:338-351: the split lens, its source
   without the spec, on the general path with one overflow slot per
   lane) at 89,653,248 rays: one untimed short trace, three timed (median,
   every wall time, rounds and K2 launches per call). Guards: exact
   emission, closure below 1e-4, a residual below 1e-6 of the source, the
   receiver's share in (0.75, 0.98) and within 2% of phase 8's lens
   (suite.py:351) and within 3 combined sigma of it, less at most the
   share of the source culled as branches below min_energy (which the
   roulette lens does not make), K1 and K3 never launched;
12. aureole parking (culling park_aureole: the specular closure sized to
   the solar disc, the hits of aureole-born lanes flagged by K1 and their
   survivors parked for the drain): K1 with parking against its plain
   version on every tile of the benchmark slab, 40% dead lanes and a
   quarter tile's quota each, in the NSTTF instance under a CSR 0.2 Buie
   disk and on CSR 0.2 rect cells and in the general instance on the
   curved field (flips at most 1e-5 of the lanes, encoded sids
   included), and against the kernel without parking (equal but for the
   encoded sids), each timed with and without parking beside its plain
   version and its bound; then phase 5's NSTTF trace at 537,919,488
   rays: one counted trace with phase 5's culling and one with a parked
   culling (rounds, drains, aureole-parked lanes, walls), three timed
   parked ones, under bench.py's guards and within 3 combined binomial
   sigma of phase 5's receiver; and the rect-source NSTTF with a parked
   culling once, under phase 10's guards against its unculled trace;
13. the unfused bounce (K3, the volumetric media and the shade of every
   optics kind) at the suite's 700,416 rays: config 2's flux map
   (benchmarks/suite.py:174-181: ray_tracer with record="tags", reps 20,
   then surface_fluxmap at resolution 20; its peak in suns printed beside
   the TPU's recorded 6201, which came from 30M rays), each bounce's full
   record copied to the host on the same scene (bytes and ms);
   trace_fused on configs 3, 7, 8, 8b and 7g, on phase 9's conductor,
   IAM c = 2, piecewise and periodic scenes and on three scenes of its
   own (mixed IAM exponents, a splitting face over a scattering sheet, a
   dispersive splitting face), config 8b's profiled; ray_tracer on the
   split lens (its bundle grows by the reflected branches); the general
   streaming path on its three scenes (16 slabs of rays, K3 and the
   shade every round). Guards: closure below 1e-4; K3 launched once a
   bounce, K1 and K2 never on the bundle traces, the K3 epilogue after
   each K3 launch of a trace_fused call its gate takes and never
   elsewhere, and K2 never on the general path's unfused rounds; every
   share within 3 combined binomial sigma of the plain megakernel's on
   the card (phases 7-9 and 11, or an 8-round megakernel trace here for
   phase 9's scenes), of phase 11's split stream for the split lens
   (less the culled shares), of trace_fused for the general path, and of
   a float64 CPU ray_tracer on the first 65,536 rays for the mixed
   exponents; the flux map's cells times their areas summing to the
   receiver's absorbed energy;
14. cavities, the Kd accelerator and polychromatic rays: config 5
   (benchmarks/suite.py:686-740: TwoNParametersCavityRTVF at 100,000
   rays an element and precision 0.005, every sample's nearest hit on
   K3, then radiosity_rtvf with the suite's emissivities and
   temperatures, and radiosity_rtvf_torch on the card against it; the
   reciprocity error, iterations, escaped share and one fire call's
   throughput printed, the aperture loss beside the TPU run's 10.21 kW);
   the Holman cavity (tests/test_thermal.py) at 100,000 rays an element;
   ray_tracer with and without accel="lightweight" on phase 5's NSTTF
   scene (262,144 rays of its Buie disk, 8 bounces: the tree's build,
   candidates a ray, the host traversal and both walls printed); a
   polychromatic ray_tracer on config 3's scene (its Buie disk as a host
   bundle of 700,416 rays, a flat spectrum on the silver table's 32
   wavelengths, record="tags" on its tagged receiver). Guards: row sums
   within 0.01, the enclosure balance below 3 x precision and the
   aperture loss within 3% of 10.21 kW (suite.py:719, :732), the Holman
   view factors within 0.03 of the analytic ones, closures below 1e-4;
   K3 once a sample and once a bounce, never on the accelerated trace;
   at most 1e-5 of the NSTTF lanes (plus one) with a flipped sid and each
   surface within 1e-5 of the source (plus the flipped lanes' energy);
   the polychromatic shares within 3 combined sigma of phase 7's
   monochromatic megakernel trace of config 3;
15. differentiable tracing and the field analyses: config 9
   (benchmarks/suite.py:569-644: the dish's focal-length gradient step,
   1,048,576 rays, 3 bounces, checkpointed; 2 rows, so the oracle's
   brute force and no kernel) and config 9b (:647-683: the NSTTF beam-tilt
   step, 1,048,576 rays, 2 bounces, checkpointed; every bounce's winner
   from K3 under no_grad, its distance recomputed differentiably), each a
   warm-up and three timed steps (median wall, Mrays/s, peak memory, K3's
   launches), one profiled step (K3's share, the gather backward, the
   host's idle share) and one profiled forward (what the checkpoint
   recomputes); 9b's step at 65,536 rays with K3 and with its plain
   version (tests/test_torch_gpu.fast_winner_compare: loss and gradient
   within its derived tolerance, the flipped sids printed); config 9 in
   float32 on the card against float64 on the CPU at 65,536 rays (rtol
   1e-4 on the loss, 1e-3 on the gradient); field_losses on phase 14's
   NSTTF ray_tracer (262,144 rays; both audits below 1e-5 of the
   source); an annual efficiency_sweep of the NSTTF field at three noon
   positions, culled (K1), 4,194,304 rays a position (|closure| < 5e-3,
   efficiency and cosine efficiency in (0, 1), each position's host build
   and trace walls);
16. the model library on K3: (a) a seven-module high-flux solar
   simulator (models/solar_simulator.high_flux_simulator: Zhu lamps at
   their default 7 kW, 29.4 kW of light, ellipsoidal reflectors in the
   general-quadric class, a 0.2 m target of 50 x 50 bins at the common
   second focus) through SolarSimulator.simulate at 4 batches of
   7,340,032 rays (closure, emitted power, the map against its records,
   the wall's shares; one batch again with K3's plain version, flipped
   and diverged lanes counted, the maps bin by bin); (b) curved device
   flux maps through trace_fused at 4,194,304 rays (config 5's cavity,
   its frustum and cylinder binned axially; SG4's outer dish binned
   polar), each against the energy absorbed on its rows and against the
   host histogram of a ray_tracer run of the same rays and draws (the K3
   epilogue's gate shut: it draws from its own stream), then through the
   K3 epilogue (the default trace_fused), each map and the rows'
   absorbed energy within 3 sigma of the gate-shut trace's; (c) a
   CAD receiver written and loaded as STL (1,920 triangle rows, streamed
   through K3's shared memory) under 1,048,576 rays through ray_tracer:
   closure, the hit share against the mesh's projected width, K3 against
   its plain version with its time and bound;
17. float64 traces and multi-device tracing (parallel.py): (a) the
   MiniDish through trace_fused in float64 on the card at 4,194,304 rays
   (the oracle's nearest hits and the unfused shade; closure below 1e-9,
   receiver within 3 sigma of phase 6's reference) and its first 65,536
   rays against the same float64 trace on the CPU (per-row sums within
   1e-9 relative: the MiniDish draws nothing), and config 1 on the
   float64 general streaming path at 5,603,328 rays (cut from 128 slabs
   to 8), closure below 1e-9, no kernel launched; (b) one rank over NCCL
   (init_process_group("nccl", world_size=1)): trace_sharded of the
   MiniDish at 4,194,304 rays equal bit for bit to trace_fused with the
   rank's generator, trace_streaming_sharded of config 1 at 89,653,248
   rays and of the culled NSTTF at bench size (phase 5's culling,
   mesh_devices=1) under bench.py's guards and within 3 sigma of phase
   5's receiver; (c) two ranks on the one card over gloo, spawned by
   torch.multiprocessing after the build: the culled NSTTF at bench size
   built with mesh_devices=2 (342 tiles a rank, aureole parking on, each
   rank's row shard through K1), a forced two-segment row-shard run of
   phase 5's culling at 67,239,936 rays and trace_sharded of the
   MiniDish, each under its guards and within 3 sigma of its one-rank
   counterpart. Each workload's walls are the min, median and max of
   three after a warm-up, the spawn and set-up printed apart; the ranks
   report their launches to the parent and print nothing; (d) the culled
   trace of a table past K2's stage, whose drain runs through the oracle
   and the unfused shade: a 4,097-row mirror grid (tracer_tpu's 20,001-row
   mesh-scale field cut to 64 x 64 mirrors) at 12,582,912 rays with an
   aureole-parked culling and with an unparked one, full emission,
   closure below 1e-4, no K2 or K3 launch, oracle drain bounces in the
   parked trace, its receiver within 3 sigma of the unparked trace's.

Every kernel's launch count, the K3 epilogue's included, is set to 0
just before a main path runs and read just after. The line before the
last is the kernels' JSON record; the last line is ``{"ok": true,
"device": {...}}``. Any failed check raises, and the script exits
non-zero without that line; so does a machine without CUDA or a
directory without the package.
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
    """Set each wrapper's launch count to 0, and the K3 epilogue's: it
    launches after K3 on trace_fused's float32 paths, and every main path
    reads it."""
    for w in wrappers:
        w.launches = 0
    epilogue().launches = 0


def epilogue():
    """The K3 epilogue's wrapper (kernels/epilogue.k3_epilogue), whose
    ``launches`` the main paths read beside K1's, K2's and K3's."""
    from tracer_tpu_torch.kernels.epilogue import k3_epilogue
    return k3_epilogue


def compare(name, got, want, live):
    """Kernel vs plain outputs (pos, dir, energy, sid, absorbed) on the
    live lanes (tests/test_torch_gpu.k1_compare): sid equal on >= 99.99%
    of them (aperture-edge ties are the only allowed difference), and on
    the lanes whose sid matches pos within 1e-4 (1 + |x|), dir within
    1e-5, energy and absorbed within 1e-5 relative. Returns (max abs
    error, sid mismatches)."""
    from test_torch_gpu import k1_compare
    n_live = int(live.sum())
    max_abs, ties, errs = k1_compare(got, want, live,
                                     max_flips=int(1e-4 * n_live))
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

    def lap(t_prev, label):
        """Log ``label``'s wall since ``t_prev`` (phases 3-10 print none of
        their own) and return the time now."""
        now = time.perf_counter()
        log(f"{label}: {now - t_prev:.1f} s")
        return now
    t_mark = time.perf_counter()

    # ---- phase 3: kernels vs their plain versions
    slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)     # bench.py's
    table, meta, info = build_scene(device=dev)
    source_fn = make_source_fn(info, slab)
    spec = source_fn.pallas_spec
    t0 = time.perf_counter()
    culling = build_block_culling(table, meta, spec, slab)
    t_culling = time.perf_counter() - t0
    log(f"culling: {culling.nb} tiles, L_mean {culling.stats['L_mean']:.1f}"
        f", L_max {culling.stats['L_max']}, {t_culling:.1f} s")
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
    # and on the dead lanes beside them, which it traces and shades too
    from test_torch_gpu import k2_compare, k2_dead, k2_near
    got = kb.bounce_reflect(rows, 21, pos, dirs, e, table.groups, te, **kw)
    want = kb.bounce_reflect_ref(rows, 21, pos, dirs, e, table.groups, te,
                                 **kw)
    torch.cuda.synchronize()
    k2_err, k2_ties = compare("K2", got, want, e > 0.0)
    n_dead = int((e <= 0.0).sum())
    d_ties, d_flips, d_err = k2_compare(
        got, want, k2_near(rows, pos, dirs, table.groups, te), pos, dirs,
        torch.zeros_like(e, dtype=torch.bool),
        max_flips=int(1e-5 * n_dead) + 1,
        dead=k2_dead(rows, 21, pos, dirs, e, table.groups,
                     dict(kw, regen=False), te))
    k2_err = max(k2_err, d_err)
    log(f"K2 vs plain on its {n_dead} dead lanes (traced and shaded too): "
        f"ties {d_ties}, flips {d_flips}, max abs err {d_err:.2e}")
    # K2's instances: registers and spill (ptxas), none may spill
    k2_ptxas = build.ptxas_lines(build.info.get("ptxas", ""),
                                 "bounce_kernel")
    for entry, regs, stack, st, ld in k2_ptxas:
        log(f"  K2 {build.k2_instance_name(entry)}: {regs} registers, "
            f"{stack} B stack, spill {st} / {ld} B")
    if build.info.get("ptxas"):
        check(len(k2_ptxas) == 28, f"{len(k2_ptxas)} K2 instances in ptxas")
        check(not any(st or ld for _, _, _, st, ld in k2_ptxas),
              "a K2 instance spills")

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
    # the trace's call: the culling's tile order, K1's launch geometry
    order = i32(culling.order)
    call_k1 = (lambda: kb.bounce_reflect_culled(
        *args, 6, rem, act, pos, dirs, e, table.groups,
        culling.group_offsets, te, source_spec=spec, order=order, **kw))
    geo = kb.k1_geometry(args[1], rows, table.groups, culling.group_offsets,
                         **kw)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_cand = torch.as_tensor(culling.counts.sum(1), dtype=torch.float64)
    log(f"K1 launch geometry at {nbb} tiles: {geo['blocks']} blocks of "
        f"{geo['threads']} threads, {geo['split']} a tile of {geo['sub']} "
        f"lanes each, {geo['smem']} B of shared memory a block, "
        f"{geo['resident']} resident a SM on {sms} SMs: "
        f"{geo['blocks'] / (geo['resident'] * sms):.2f} waves; candidate "
        f"rows a tile: median {float(n_cand.median()):.0f}, 90th "
        f"percentile {float(n_cand.quantile(0.9)):.1f}, max "
        f"{int(n_cand.max())}, {int((n_cand == 0).sum())} tiles with none, "
        f"dispatched most first ({card})")
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
    geo2 = kb.k2_geometry(rows, nbb * kb.TILE, **kw)
    n_chunks = -(-nbb * kb.TILE // geo2["chunk"])
    log(f"K2 launch geometry at {nbb * kb.TILE} lanes: {geo2['blocks']} "
        f"persistent blocks of {geo2['threads']} threads, chunks of "
        f"{geo2['chunk']} lanes ({n_chunks}, {n_chunks / geo2['blocks']:.2f}"
        f" a block), {geo2['smem']} B of shared memory a block, "
        f"{geo2['resident']} resident a SM on {geo2['sms']} SMs ({card})")
    # the bounds of the timed calls: every lane's results written once
    # (36 B); a lane that carries its ray in reads it once (28 B), a lane
    # that K1 regenerates reads only its energy (4 B); each input table is
    # read once. K1 tests its tile's candidates, shades its live lanes and
    # samples its regenerated ones; K2 (regeneration off) tests every row
    # for every lane and shades every lane, dead ones too, as its contract
    # (bounce_reflect_pallas) does
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
    k2_bound = bound(64 * n_lanes + 4 * rows.numel(), n_lanes * (sum(
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

    t_mark = lap(t_mark, "phase 3")
    # ---- phase 4: K3 against its plain version
    record["kernels"].append(k3_phase(dev, card, table, source_fn, kn,
                                       build))

    fspec = flux_plan(meta, "receiver", resolution=50)
    if profiling:
        profile(table, source_fn, culling, 256 * slab, fspec,
                trace_streaming)

    t_mark = lap(t_mark, "phase 4")
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
    phase5 = {}
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
        phase5[label] = (rec_frac, int(emitted), wall)
        log(f"slice ({label}): {int(emitted)} rays emitted, receiver "
            f"fraction {rec_frac:.5f}, closure {closure:.2e}, flux/receiver "
            f"{flux_rec:.6f}, K1 launches "
            f"{kb.bounce_reflect_culled.launches - l1}, K2 launches "
            f"{kb.bounce_reflect.launches - l2} in {reps} run(s); wall "
            f"median {wall:.3f} s of {', '.join(f'{w:.3f}' for w in walls)}"
            f", {int(emitted) / wall / 1e6:.1f} Mrays/s ({card})")
    record["kernels"][0]["launches"] = kb.bounce_reflect_culled.launches
    record["kernels"][1]["launches"] = kb.bounce_reflect.launches
    check(kn.nearest_hit.launches == epilogue().launches == 0,
          "K3 or its epilogue launched on the NSTTF path")

    t_mark = lap(t_mark, "phase 5")
    # ---- phase 6: the MiniDish main paths
    record["kernels"][2]["launches"], p_ref, epi = minidish_phase(
        dev, card, kn, kb)
    record["kernels"].append(epi)

    t_mark = lap(t_mark, "phase 6")
    # ---- phases 7-9: bench configs 1-3, then 6, 8 and 8b, then 7, on the
    # plain megakernel; then config 7 on the general path
    entry = record["kernels"][1]
    physics = {}
    for modes, cfgs in ((BENCH_MODES, (1, 2, 3)),
                        (STAGE_C_MODES, (6, 8, "8b")),
                        (STAGE_DE_MODES, (7,))):
        k2 = bench_phase(dev, card, kb, kn, p_ref, modes, cfgs)
        entry["launches"] += k2["launches"]
        entry["max_abs_err"] = max(entry["max_abs_err"], k2["max_abs_err"])
        physics.update(k2["physics"])
        if cfgs[0] == 1:
            # the record keeps config 1's regeneration mode
            entry.update({k: k2[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "bound_by")})
    entry["launches"] += general_phase(dev, card, kb, kn, 7, physics[7])[0]

    t_mark = lap(t_mark, "phases 7-9")
    # ---- phase 10: K1's other modes, K2's rect regeneration and
    # backside_miss, then the curved and the rect-source fields
    k2 = bench_phase(dev, card, kb, kn, p_ref, PHASE10_K2_MODES, ())
    entry["max_abs_err"] = max(entry["max_abs_err"], k2["max_abs_err"])
    k1 = record["kernels"][0]
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_modes_phase(dev, card, kb))
    unculled = {}
    for field in ("curved", "rect"):
        l1, l2, unculled[field] = field_phase(dev, card, kb, kn, field)
        k1["launches"] += l1
        entry["launches"] += l2

    t_mark = lap(t_mark, "phase 10")
    # ---- phase 11: energy splitting, and the stage (d)/(e) kinds beside
    # refraction and media ids: K2's new modes, the glazed config 7 on the
    # megakernel, then the split stream on the general path
    t11 = time.perf_counter()
    k2 = bench_phase(dev, card, kb, kn, p_ref, PHASE11_K2_MODES, ("7g",))
    entry["launches"] += k2["launches"]
    entry["max_abs_err"] = max(entry["max_abs_err"], k2["max_abs_err"])
    physics.update(k2["physics"])
    l2, split_stream = general_phase(dev, card, kb, kn, "6s", physics[6])
    entry["launches"] += l2
    log(f"phase 11: {time.perf_counter() - t11:.1f} s")

    # ---- phase 12: aureole parking: K1 with parking against its plain
    # version and itself without, then the parked NSTTF and rect-source
    # traces
    t12 = time.perf_counter()
    k1["max_abs_err"] = max(k1["max_abs_err"], aureole_k1_phase(dev, card,
                                                                kb))
    l1, l2 = aureole_trace_phase(dev, card, kb, kn, culling, t_culling,
                                 phase5["default corridors"],
                                 unculled["rect"])
    k1["launches"] += l1
    entry["launches"] += l2
    log(f"phase 12: {time.perf_counter() - t12:.1f} s")

    # ---- phase 13: the unfused bounce (K3, the media and the shade of
    # every optics kind) on the record path, trace_fused and the general
    # streaming path
    l2, l3, le = unfused_phase(dev, card, kb, kn, physics, split_stream)
    entry["launches"] += l2
    record["kernels"][2]["launches"] += l3
    epi["launches"] += le

    # ---- phase 14: config 5 (the cavity view factors and the radiosity
    # solve), the Holman cavity, the Kd accelerator on the NSTTF and a
    # polychromatic bundle on config 3
    record["kernels"][2]["launches"] += cavity_phase(
        dev, card, kb, kn, physics, (table, meta, info))

    # ---- phase 15: configs 9 and 9b (differentiable tracing, 9b's winners
    # on K3 under no_grad), field_losses and an annual sweep of the NSTTF
    # field
    for k, n in zip(record["kernels"], diff_phase(dev, card, kb, kn,
                                                   (table, meta, info))):
        k["launches"] += n

    # ---- phase 16: the model library on K3: the seven-module solar
    # simulator, curved device flux maps, an STL receiver
    l3, le = model_phase(dev, card, kb, kn)
    record["kernels"][2]["launches"] += l3
    epi["launches"] += le

    # ---- phase 17: float64 on the card, one rank over NCCL, two ranks on
    # the card over gloo
    for k, n in zip(record["kernels"], phase17(
            dev, card, kb, kn, p_ref, slab, culling, fspec,
            phase5["default corridors"])):
        k["launches"] += n
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
    """The first n rays of a bundle, optionally moved / cast (a
    polychromatic bundle's grid whole)."""
    from tracer_tpu_torch.bundle import RayBundle
    out = {}
    for k, v in bundle.__dict__.items():
        if v is None:
            out[k] = v
            continue
        if k != "spectral_grid":
            v = v[:n]
        if device is not None:
            v = v.to(device)
        if dtype is not None and v.is_floating_point():
            v = v.to(dtype)
        out[k] = v.contiguous()
    return RayBundle(**out)


def k3_cases(dev, nsttf_table, nsttf_source):
    """(label, table, pos, dirs, keywords) of phase 4's K3 calls: the
    MiniDish's sun rays (with and without the local hit point) and their
    second bounce at 4,194,304 lanes, and at the NSTTF slab (2,101,248
    lanes) the NSTTF table under its Buie sun, the table with every
    quadric class and aperture kind, and the same with 2,000 more rows
    (groups that stream through several staged parts)."""
    import torch
    import tracer_tpu_torch as ptt
    from tracer_tpu_torch.engine import TraceAccum, _bounce_step
    from test_torch_gpu import fuzz_assembly, fuzz_rays
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
    big_table, big_meta = ptt.compile_scene(
        fuzz_assembly(ptt, 1, extra=2000), device=dev)
    big = [torch.as_tensor(a, device=dev)
           for a in fuzz_rays(big_meta, slab, 6)]

    def kw(table, need_local=True):
        return dict(need_local=need_local,
                    backside_miss="bifacial" in table.features)
    return (("MiniDish sun rays", md_table, sun.pos, sun.dir, kw(md_table)),
            ("MiniDish sun rays, need_local off", md_table, sun.pos,
             sun.dir, kw(md_table, False)),
            ("MiniDish second bounce", md_table, second.pos, second.dir,
             kw(md_table)),
            ("NSTTF Buie rays", nsttf_table, helio.pos, helio.dir,
             kw(nsttf_table)),
            ("every class and aperture", fz_table, fz[0], fz[1],
             kw(fz_table)),
            ("every class, 2,017 rows", big_table, big[0], big[1],
             kw(big_table)))


def k3_bound(table, n):
    """(ms, what sets it) of one K3 call of n lanes on ``table``: each
    lane's 24 bytes of ray read once and 52 bytes of results written once,
    and its test of every row."""
    return bound(n * (24 + 52), n * sum((g[1] - g[0]) * row_ops(g[3], g[2])
                                        for g in table.groups))


def k3_geometry_line(kn, rows, n, kw) -> str:
    geo = kn.k3_geometry(rows, n, kw["backside_miss"])
    chunks = -(-n // geo["threads"])
    staged = ("the table staged whole" if geo["part"] >= rows.shape[0]
              else f"the table streamed in parts of {geo['part']} rows")
    return (f"{geo['blocks']} blocks of {geo['threads']} threads, one lane "
            f"a thread ({chunks / geo['blocks']:.2f} chunks a block), "
            f"{staged}, {geo['smem']} B of shared memory a block, "
            f"{geo['resident']} resident a SM on {geo['sms']} SMs")


def k3_phase(dev, card, nsttf_table, nsttf_source, kn, build):
    """K3 against its plain version on the card (sid equal off ties, t
    and aux within 1e-5 of their scale: tests/test_torch_gpu.k3_compare;
    without need_local the local points zeros), then its time beside the
    plain version's, with its launch geometry and each K3 instance's
    registers and spill from ptxas (none may spill). Returns its JSON
    entry with the MiniDish's numbers (the main path's shape); launches
    are filled in by the MiniDish phase; its max_abs_err is the largest
    difference in t, normal, local hit and up_dot over the MiniDish's
    lanes (the other tables' are printed)."""
    import torch
    from tracer_tpu_torch.kernels.bounce import pack_rows
    from test_torch_gpu import k3_compare
    k3_ptxas = build.ptxas_lines(build.info.get("ptxas", ""),
                                 "nearest_kernel")
    for entry, regs, stack, st, ld in k3_ptxas:
        log(f"  K3 {build.k3_instance_name(entry)}: {regs} registers, "
            f"{stack} B stack, spill {st} / {ld} B")
    if build.info.get("ptxas"):
        check(len(k3_ptxas) == 4, f"{len(k3_ptxas)} K3 instances in ptxas")
        check(not any(st or ld for _, _, _, st, ld in k3_ptxas),
              "a K3 instance spills")
    out = None
    md_rows = None
    for label, tab, pos, dirs, kw in k3_cases(dev, nsttf_table,
                                              nsttf_source):
        n = pos.shape[0]
        rows = pack_rows(tab)
        args = (rows, pos, dirs, tab.groups, F32_T_EPS)
        got = kn.nearest_hit(*args, **kw)
        want = kn.nearest_hit_ref(*args, **kw)
        torch.cuda.synchronize()
        ties, flips = k3_compare(got, want, kn.nearest_two_t(
            *args, backside_miss=kw["backside_miss"]), pos, dirs, rtol=1e-5,
            max_flips=int(1e-5 * n) + 1)
        if not kw["need_local"]:
            check(not bool(got[2]["local"].any()),
                  f"K3 {label}: local points not zeros")
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
        bnd = k3_bound(tab, n)
        log(f"K3 {label}: {n} lanes, {tab.num_rows} rows, hits "
            f"{float((hit).float().mean()):.3f}, sid ties {ties}, edge "
            f"flips {flips}, max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f"; kernel "
            f"{min(k1, k2):.4f} ms, plain {min(p1, p2):.3f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); "
            f"{k3_geometry_line(kn, rows, n, kw)} ({card})")
        if out is None:
            md_rows = rows
            out = kernel_entry(
                "nearest_hit", "tracer_tpu_torch/kernels/csrc/nearest.cu",
                "tracer_tpu/kernels/pallas_intersect.py:583", 0, err,
                min(k1, k2), min(p1, p2), bnd)
        elif torch.equal(rows, md_rows):
            out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def minidish_phase(dev, card, kn, kb):
    """ray_tracer and trace_fused on the MiniDish at the published size,
    under the guards of the module docstring, then the K3 epilogue against
    its plain version (epilogue_check). Returns K3's launches on the timed
    trace_fused runs, phase 6's reference receiver fraction and the
    epilogue's JSON entry, its launches those of the timed runs."""
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
          == epilogue().launches == 0,
          "K1/K2 or the K3 epilogue launched on the MiniDish record path")
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
    epi_launches = epilogue().launches
    check(launches % 3 == 0, f"trace_fused: {launches} K3 launches")
    check(epi_launches == launches, f"trace_fused: {epi_launches} K3 "
          f"epilogue launches for {launches} K3 launches")
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
        f"launches {launches} and K3 epilogue launches {epi_launches} in 3 "
        f"runs, receiver fraction {p:.5f}, "
        f"closure {closure:.2e}, flux/receiver {fsum / ab[rec_i]:.6f}; "
        f"wall median {wall:.3f} s of "
        f"{', '.join(f'{w:.3f}' for w in walls)}, "
        f"{MD_LANES / wall / 1e6:.1f} Mrays/s ({card})")
    profile_path("MiniDish trace_fused", fused, "K3", "nearest_kernel",
                 card)
    entry = epilogue_check(dev, card, kn, table, spec, sun)
    entry["launches"] = epi_launches
    return launches, p_ref, entry


# bytes a lane of the K3 epilogue moves: a live lane reads K3's t, sid,
# normal and up_dot (24) and its ray's pos, dir, energy and alive (29),
# and writes the next pos, dir, energy and alive (29); a dead lane reads
# its alive flag alone
EPI_LIVE_READ, EPI_LIVE_WRITE, EPI_DEAD_READ = 53, 29, 1


def epilogue_check(dev, card, kn, table, spec, sun):
    """The K3 epilogue (kernels/epilogue.k3_epilogue) against its plain
    version (engine._bounce_step's shade and accounting, then
    device_fluxmap.accumulate) on phase 6's 4,194,304 MiniDish lanes, on
    the first bounce (every lane live) and on the plain version's second,
    at tests/test_torch_epilogue's tolerances: alive equal, pos, dir and
    energy within 1e-6, the per-row absorbed energy, escaped, culled and
    the receiver's 50 x 50 bins within 1e-5 relative of the plain
    version's per-lane results summed in float64, hits equal. Then its
    time on the first bounce beside the plain version's (the plain bounce
    less its K3 call, need_local on as it runs it) and its bound (bytes a
    lane: EPI_LIVE_READ, EPI_LIVE_WRITE, EPI_DEAD_READ; the blocks'
    partial rows left out, as the work needs one row). Returns its JSON
    entry; max_abs_err is the largest difference in pos, dir and energy
    on the live lanes."""
    import torch
    from tracer_tpu_torch import engine
    from tracer_tpu_torch.analysis import device_fluxmap as dfm
    from tracer_tpu_torch.engine import TraceAccum
    from tracer_tpu_torch.kernels import epilogue as ke
    from tracer_tpu_torch.kernels.intersect import nearest_hit_aux
    threads = torch.get_num_threads()
    # the test module keeps the suite's processes to one torch thread
    # each; the later phases' CPU references want them all
    from test_torch_epilogue import (Backend, assert_rays_close,
                                     assert_sums_close, kernel_bounce,
                                     plain_bounce)
    torch.set_num_threads(threads)
    n = sun.num_rays
    backend = Backend(dev, n)
    b, err = sun, 0.0
    for bounce in (1, 2):
        want_b, want = plain_bounce(table, b, (spec,))
        got_b, acc = kernel_bounce(backend, table, b, (spec,))
        assert_rays_close(got_b, want_b)
        assert_sums_close(acc, want)
        live = want_b.alive
        errs = {k: float((getattr(got_b, k) - getattr(want_b, k))[live]
                         .abs().max()) for k in ("pos", "dir", "energy")}
        rel = {k: float(((getattr(acc, k).double() - want[k]).abs()
                         / want[k].abs().clamp(min=1e-30)).max())
               for k in ("absorbed", "escaped")}
        ref = want["flux"][0]
        rel["bins"] = float((acc.flux[0].double() - ref).abs().max()
                            / ref.max())
        err = max(err, *errs.values())
        log(f"K3 epilogue vs plain, MiniDish bounce {bounce}: {n} lanes, "
            f"{int(b.alive.sum())} live in, {int(live.sum())} live out "
            f"(alive equal); max abs err "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + "; relative err " + ", ".join(f"{k} {v:.2e}"
                                            for k, v in rel.items())
            + f"; hits equal ({card})")
        b = want_b
    del got_b, want_b, acc, want, b
    # the time of one launch on the first bounce, beside the plain
    # version's shade, accounting and binning
    gen = torch.Generator(device=dev).manual_seed(0)
    plan = engine._epilogue_plan(table, sun, gen, 1e-6, (spec,))
    t, sid, aux = kn.nearest_hit(plan.rows, sun.pos, sun.dir, table.groups,
                                 F32_T_EPS, 1e-6, need_local=False,
                                 backside_miss="bifacial" in table.features)
    ray = {k: getattr(sun, k) for k in ke.RAY_FIELDS}
    flux = (torch.zeros((spec.nu, spec.nv), dtype=torch.float32,
                        device=dev),)
    acc = TraceAccum.zeros(table.num_rows, device=dev)

    def call_e():
        ke.k3_epilogue(plan, 0, t, sid, aux, ray)

    def call_k3():
        nearest_hit_aux(table, sun.pos, sun.dir, t_eps=None, disc_eps=1e-6,
                        block=64, need_local=True)

    def call_p():
        _, _, rec = engine._bounce_step(table, sun, acc, gen, 1e-6, None,
                                        1e-6, 64)
        dfm.accumulate(flux, (spec,), table, rec.sid, rec.hit, rec.absorbed)
    p1, k3a = time_cuda(call_p, 3), time_cuda(call_k3, 10)
    e1 = time_cuda(call_e, 20)
    e2, k3b = time_cuda(call_e, 20), time_cuda(call_k3, 10)
    p2 = time_cuda(call_p, 3)
    ms, k3_ms = min(e1, e2), min(k3a, k3b)
    plain_ms = min(p1, p2) - k3_ms
    n_live = int((sun.alive & (sun.energy > 0)).sum())
    bnd = bound((EPI_LIVE_READ + EPI_LIVE_WRITE) * n_live
                + EPI_DEAD_READ * (n - n_live), n_live * SHADE_OPS)
    log(f"K3 epilogue, MiniDish first bounce: {n} lanes ({n_live} live), "
        f"{plan.blocks} blocks of {ke.EPI_THREADS} threads, "
        f"{4 * ke.shared_floats(table.num_rows, (spec,))} B of shared "
        f"memory a block; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms (the "
        f"plain bounce {min(p1, p2):.3f} ms less its K3 {k3_ms:.4f} ms), "
        f"bound {bnd[0]:.4f} ms ({bnd[1]}), {100 * bnd[0] / ms:.1f}% of it "
        f"({card})")
    return kernel_entry("k3_epilogue",
                        "tracer_tpu_torch/kernels/csrc/epilogue.cu",
                        "tracer_tpu/engine.py:933", 0, err, ms, plain_ms,
                        bnd)


def profile_path(label, run, name, kernel_key, card, top=8):
    """One profiled run (profile_run): device busy time and the share of
    kernel ``name`` (events whose key holds ``kernel_key``), then the
    largest device events."""
    p = profile_run(run, kernel_key, top)
    check(p["kernel"] > 0, f"profile: no device time for {name}")
    log(f"{label} profile: wall {p['wall']:.1f} ms under the profiler, "
        f"device busy {p['busy']:.1f} ms in {p['events']} device events, "
        f"{name} {p['kernel']:.2f} ms = {100 * p['kernel'] / p['busy']:.1f}%"
        f" of device time ({card})")


def profile_run(run, kernel_key="nearest_kernel", top=8):
    """torch.profiler over one call of ``run``: its wall (ms), the device
    busy time (summed over device events only: an operator's own row
    repeats its kernels' time), the kernel's device time (events whose key
    holds ``kernel_key``), the gather backward's (the IndexSelect and
    Index autograd nodes' device time: index_add_ and index_put_ with
    accumulate into the gathered tables) and the device's idle share of
    the wall. Logs the ``top`` largest device events."""
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
    ev = prof.key_averages()
    dev = [e for e in ev if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in dev)
    check(dev_us > 0, "profile: the profiler recorded no device events")
    host = {e.key: e.device_time_total for e in ev
            if e.device_type == DeviceType.CPU}
    gather = sum(max(host.get(n, 0.0), host.get(
        "autograd::engine::evaluate_function: " + n, 0.0))
        for n in ("IndexSelectBackward0", "IndexBackward0"))
    out = dict(wall=wall * 1e3, busy=dev_us / 1e3,
               events=sum(e.count for e in dev),
               kernel=sum(e.self_device_time_total for e in dev
                          if kernel_key in e.key) / 1e3,
               gather=gather / 1e3)
    out["idle"] = 1.0 - out["busy"] / out["wall"]
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:top]:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms "
            f"({100 * e.self_device_time_total / dev_us:4.1f}%) "
            f"{e.count:6d}x {e.key[:80]}")
    return out


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
               7: ("dome fraction", 0.5228),
               "8b": ("medium / source", 0.363)}
# K2's modes: (label, scene (test_torch_gpu.k2_scene), dead share,
# regeneration)
BENCH_MODES = (("regeneration over a half-dead slab", 1, 0.5, True),
               ("MiniDish rows", 1, 0.0, False),
               ("the drain's shape: half dead, no regeneration", 1, 0.5,
                False),
               ("Lambertian + bivariate slope (config 2)", 2, 0.5, True),
               ("spectral + ambient (config 3)", 3, 0.5, True))
STAGE_C_MODES = (("lens, Fresnel roulette (config 6)", 6, 0.5, True),
                 ("ambient HG medium (config 8)", 8, 0.5, True),
                 ("media ids (config 8b)", "8b", 0.5, True),
                 ("lens in the HG medium", "lens_hg", 0.5, True),
                 ("absorbing media, no scattering", "slab_media", 0.5, True))
# K2's modes of phase 11: energy splitting (on the general path's lanes:
# no regeneration) and the stage (d)/(e) kinds beside refraction and media
# ids (tests/test_torch_gpu.MIXED)
PHASE11_K2_MODES = (
    ("split lens, refr_split (split stream)", "6s", 0.0, False),
    ("TIR lanes, refr_split, absorbing ambient", "split_tir", 0.0, False),
    ("splitting cover over Cook-Torrance", "split_glazed_ct", 0.0, False),
    ("glazed config 7: glass cover, Cook-Torrance", "7g", 0.5, True),
    ("lens in the HG medium, Cook-Torrance floor", "lens_hg_ct", 0.5,
     True),
    ("absorbing slab beside a transparent sheet", "slab_transparent", 0.5,
     True),
    ("config 8b's box, Lambertian-specular floor", "box_ls", 0.5, True))
STAGE_DE_MODES = (("Cook-Torrance (config 7)", 7, 0.5, True),
                  ("transparent, Lambertian-specular, semi-Lambertian",
                   "scatterers", 0.5, True),
                  ("dispersive conductor, wavelength band", "conductor",
                   0.5, True),
                  ("IAM with c = 2", "iam_c2", 0.5, True),
                  ("bilinear piecewise Lambertian", "piecewise_2d", 0.5,
                   True),
                  ("periodic cell in its HG medium", "periodic_hg", 0.5,
                   True))
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
CT_OPS = 120                  # a Cook-Torrance hit: half-vector, F, G
COND_OPS = 45                 # a conductor hit's Fresnel reflectance
IAM_OPS = 25                  # an IAM hit's modifier (with cos^c)
PIECE_OPS = 25                # a piecewise hit's incidence angle
CHOICE_OPS = 5                # a specular-or-diffuse choice


def k2_bound(table, rows, kw, pos, dirs, energy, want, regen):
    """(ms, what sets it) of one K2 call on these inputs. Bytes: every
    lane's results written once (36 B, 4 B more for each of the
    wavelength, index and medium id lanes it threads, 16 B more for the
    reflected branch with refr_split); a lane that carries its ray in
    reads it once (28 B, 4 B more for each of those lanes), a
    regenerated lane only its energy (4 B, and its wavelength when the
    source has no band to draw one); the rows, the spectral table and the
    media tables read once. Operations, as its data needs them: every row
    for every lane, and the epilogue's branches for every lane (the free
    path in a scattering medium, the medium lookup): K2 traces and shades
    the lanes that enter dead and are not regenerated too, as
    bounce_reflect_pallas does; Snell and Fresnel on each refractive hit
    and the HG direction on each scattered lane (as the plain version
    reports them: a dead lane's sid is -1), the sample for each
    regenerated lane, and the table segments each spectral hit scans."""
    import torch
    from tracer_tpu_torch.kernels.bounce import media_flags
    n = pos.shape[0]
    spectral = kw.get("wavelength") is not None
    media = kw.get("media")
    n_lanes = sum(kw.get(k) is not None
                  for k in ("wavelength", "ref_index", "medium_id"))
    dead = energy <= 0.0
    n_regen = int(dead.sum()) if regen else 0
    band = bool(kw["source_spec"][13]) if regen else False
    nbytes = (n * (36 + 4 * n_lanes + (16 if kw.get("refr_split") else 0))
              + (n - n_regen) * (28 + 4 * n_lanes)
              + n_regen * (4 + (4 if spectral and not band else 0))
              + 4 * rows.numel()
              + (4 * kw["spectral_tab"].numel()
                 if kw.get("spectral_tab") is not None else 0)
              + (4 * (3 * len(media[0]) + 2 * rows.shape[0]) if media
                 else 0))
    att_on, scat_on = (media_flags(media) if media is not None
                       else (kw.get("ambient_att", 0.0) > 0.0,
                             kw.get("ambient_scat", 0.0) > 0.0))
    per_lane = (sum((g[1] - g[0]) * row_ops(g[3], g[2])
                    for g in table.groups)
                + SHADE_OPS - (0 if kw.get("slope", True) else SLOPE_OPS)
                + (LAMBERT_OPS if kw.get("lambertian") else 0)
                + (ATT_OPS if att_on else 0)
                + (FREE_OPS if scat_on else 0)
                + (MEDIA_OPS if media is not None else 0))
    nops = n * per_lane + n_regen * (
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
    # the stage (d)/(e) branches on the hits of their kinds (a conductor
    # or piecewise hit as the two table segments it interpolates; the
    # diffuse lobes of the Lambertian-specular, semi-Lambertian and
    # piecewise kinds left out: which lanes take them is random)
    hit = want[3] >= 0
    flags = table.opt_flags[want[3].clamp(min=0).long()]

    def n_of(kind):
        return int((hit & (kinds == kind)).sum())
    nops += (n_of(9) * CT_OPS + n_of(10) * (COND_OPS + 2 * SEG_OPS)
             + n_of(11) * (PIECE_OPS + 2 * SEG_OPS)
             + (n_of(3) + n_of(4) + n_of(11)) * CHOICE_OPS
             + int((hit & ((flags & 4) != 0)).sum()) * IAM_OPS)
    return bound(nbytes, nops)


def bench_phase(dev, card, kb, kn, p_ref, modes, cfgs):
    """Bench configurations ``cfgs`` (benchmarks/suite.py) on the plain
    megakernel: K2 against its plain version in each of ``modes`` at the
    suite's slab, then each configuration's trace_streaming(culling=None)
    at full size under its guards. Returns K2's numbers for the record:
    its launches on these paths and, from the first mode, its time, its
    plain version's and its bound; and under "physics" each
    configuration's (meta, fractions of the source, rays emitted) of its
    last timed call."""
    import math
    import statistics
    import torch
    from test_torch_gpu import (bench_lanes, bench_modes, k2_compare,
                                k2_dead, k2_near, k2_scene, medium_att,
                                traced_rays)
    from tracer_tpu_torch.models.bench_configs import (BENCH, bench_scene,
                                                       max_rounds)
    from tracer_tpu_torch.engine import energy_closure, trace_streaming
    n = BENCH_SLAB
    out = {"max_abs_err": 0.0, "physics": {}}
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
            got, want, k2_near(rows, tp, td, table.groups, F32_T_EPS,
                               kw["backside_miss"]), tp,
            td, live, att=medium_att(kw), max_flips=max_flips,
            decisions=lanes["ref_index"] is not None,
            split=kw["refr_split"],
            dead=k2_dead(rows, 29, pos, dirs, e, table.groups, kw,
                         F32_T_EPS))
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
        log(f"K2 {label}: {n} lanes ({int(live.sum())} live, "
            f"{n - int(live.sum())} dead, hit share "
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
        seed0 = {"8b": 9, "7g": 17}.get(cfg, cfg)

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
              == epilogue().launches == 0,
              f"config {cfg}: K1, K3 or its epilogue launched on the path")
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
            if cfg in (7, "7g"):
                physics = surface_fraction(meta, p, "dome")
                check(physics > 0.4, f"config {cfg}: dome fraction "
                      f"{physics}")
        out["physics"][cfg] = (meta, p, em)
        shown = ", ".join(f"{nm} {x:.5f}" for nm, x in zip(
            [meta.names[int(r)] for r in meta.row_logical] + ["medium"], p))
        wall = statistics.median(walls)
        what, tpu = TPU_PHYSICS.get(cfg, (
            "dome fraction" if cfg == "7g" else "largest surface fraction",
            None))
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
        # a quarter call: sorting a whole call's events (150,000 for 8b)
        # took the profiler most of these phases' wall
        profile_path(f"config {cfg} trace, a quarter call",
                     lambda: run(200 + seed0, total // 4), "K2",
                     "bounce_kernel", card)
    return out


def surface_fraction(meta, p, name) -> float:
    """A logical surface's share of the source from per-row fractions
    ``p``."""
    return sum(p[int(r)] for r in (
        meta.row_logical == meta.index_of(name)).nonzero()[0])


# the general path's runs: the surface its guard reads (against the
# megakernel's share of the same scene, or for the split stream of the
# roulette lens's), the seeds of its untimed, timed and profiled runs,
# and the emission rounds of the profiled run, a quarter call (the split
# stream's full call makes 150,000 device events, which the profiler
# takes over a minute to sort)
GENERAL_RUNS = {7: ("dome", 170, 71, 270, BENCH_ROUNDS // 4),
                "6s": ("rec", 160, 61, 260, BENCH_ROUNDS // 4)}


def general_phase(dev, card, kb, kn, cfg, mega):
    """Bench config ``cfg``'s source without its spec through
    trace_streaming's general path at the suite's size: config 7 (the
    suite's general-path cell) or "6s" (the split stream: the split lens,
    one overflow slot per lane). One untimed short trace, three timed
    (median, every wall time, rounds and K2 launches per call), one
    profiled (a quarter call). Guards: exact
    emission, closure below 1e-4, K1 and K3 never
    launched, the surface's share within 2% and 3 combined sigma of the
    megakernel's (``mega``: that phase's (meta, fractions, emitted) of
    config 7, or of config 6's roulette lens); for the split stream also
    a residual below 1e-6 of the source and the receiver's share in
    (0.75, 0.98). A split stream culls the branches that carry less than
    min_energy (second reflections, R^2 of a ray's 4.5e-5 W), which the
    roulette lens never does: the receiver may read lower than the
    megakernel's by up to the culled share of the source besides the 3
    sigma (tests/test_torch_split.py::
    test_split_stream_culls_second_reflections shows it on the CPU).
    Returns K2's launches and (meta, the last call's fractions of the
    source by row, rays emitted, culled share of the source)."""
    import math
    import statistics
    import torch
    from tracer_tpu_torch.engine import energy_closure, trace_streaming
    from tracer_tpu_torch.models.bench_configs import (BENCH, bench_scene,
                                                       max_rounds,
                                                       without_spec)
    name, seed_warm, seed_timed, seed_prof, prof_rounds = GENERAL_RUNS[cfg]
    label = ("split stream (config 6s)" if cfg == "6s"
             else f"config {cfg} general path")
    n = BENCH_SLAB
    total = BENCH_ROUNDS * n
    table, meta, source_fn = bench_scene(cfg, n, dev)
    general = without_spec(source_fn)

    def run(seed, total=total):
        return trace_streaming(table, general,
                               torch.Generator().manual_seed(seed), total,
                               max_rounds=max_rounds(cfg, BENCH_ROUNDS),
                               max_path=BENCH[cfg]["max_path"])
    run(seed_warm, 4 * n)               # untimed: first-use costs
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    walls, results = [], []
    for rep in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(run(seed_timed + rep))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = kb.bounce_reflect.launches
    check(kb.bounce_reflect_culled.launches == kn.nearest_hit.launches
          == epilogue().launches == 0,
          f"{label}: K1, K3 or its epilogue launched")
    check(launches > 3 * BENCH_ROUNDS, f"{label}: {launches} K2 launches in "
          "3 calls")
    meta_mega, p_mega, em_mega = mega
    d_mega = surface_fraction(meta_mega, p_mega, name)
    for accum, emitted, source_e in results:
        em, se = int(emitted), float(source_e)
        check(em == total, f"{label}: emitted {em}")
        closure = energy_closure(accum, source_e)
        check(abs(closure) < 1e-4, f"{label}: closure {closure}")
        p = list(accum.absorbed.double().cpu().numpy() / se)
        d = surface_fraction(meta, p, name)
        sig = math.sqrt(d_mega * (1 - d_mega) * (1 / em + 1 / em_mega))
        culled = float(accum.culled) / se if cfg == "6s" else 0.0
        check(abs(d - d_mega) < 0.02 * d_mega
              and d_mega - 3 * sig - culled < d < d_mega + 3 * sig,
              f"{label}: {name} fraction {d} vs the megakernel's {d_mega} "
              f"+- {sig} (culled {culled})")
        if cfg == "6s":
            residual = float(accum.residual) / se
            check(residual < 1e-6, f"{label}: residual {residual}")
            check(0.75 < d < 0.98, f"{label}: receiver fraction {d}")
    wall = statistics.median(walls)
    log(f"{label}: {total} rays emitted per call, {launches / 3:.0f} "
        f"rounds, {launches / 3:.0f} K2 launches per call ({launches} in 3)"
        f", closure {closure:.2e}, residual {float(accum.residual) / se:.2e}"
        f", culled {float(accum.culled) / se:.5f}, {name} fraction {d:.5f} "
        f"(megakernel {d_mega:.5f} +- {sig:.5f}); wall median "
        f"{wall:.3f} s of {', '.join(f'{w:.3f}' for w in walls)}, "
        f"{1e3 * wall / (launches / 3):.2f} ms a round, "
        f"{total / wall / 1e6:.1f} Mrays/s ({card})")
    profile_path(f"{label}, {prof_rounds * n} rays,",
                 lambda: run(seed_prof, prof_rounds * n), "K2",
                 "bounce_kernel", card)
    return launches, (meta, p, em, float(accum.culled) / se)


# K2's modes of phase 10: (label, scene (test_torch_gpu.k2_scene), dead
# share, regeneration)
PHASE10_K2_MODES = (("rect regeneration (NSTTF rect source)", "rect_nsttf",
                     0.5, True),
                    ("bifacial rows (backside_miss)", "bifacial", 0.5, True))
# K1's modes of phase 10 (test_torch_gpu.K1_MODES): label, mode
PHASE10_K1_MODES = (("curved groups", "curved"),
                    ("rect cells with regeneration", "rect"),
                    ("Lambertian receiver", "lambertian"),
                    ("spectral, band and attenuation", "spectral"),
                    ("conductor and IAM (c = 2)", "conductor_iam"),
                    ("bifacial rows", "bifacial"))


def k1_bound(table, culling, spec, lanes, remaining, want):
    """(ms, what sets it) of one K1 call over every tile. Bytes: every
    lane's results written once (36 B, 4 B more with a wavelength lane); a
    lane that carries its ray in reads it once (28 B, +4), a regenerated
    lane only its energy; the rows, the tiles' lists, counts, cells,
    bounds, quotas and flags and the spectral table read once. Operations:
    each traced lane against its tile's candidates (row_ops of each
    group's class and apertures), the epilogue (the slope error where the
    scene has it, the Lambertian lobe, attenuation, a conductor's or an
    IAM's factor on hits of those rows) and the sample of each
    regenerated lane (and its wavelength)."""
    import torch
    from tracer_tpu_torch import materials as M
    from tracer_tpu_torch.kernels.rows import row_width
    from test_torch_gpu import k1_modes
    nb = culling.nb
    pos, dirs, e, wl = lanes
    dead_b = (e <= 0.0).view(nb, -1).sum(1).cpu()
    regen_b = torch.minimum(dead_b, remaining.cpu().to(dead_b.dtype))
    traced_b = (e > 0.0).view(nb, -1).sum(1).cpu() + regen_b
    n, n_regen = e.shape[0], int(regen_b.sum())
    modes = k1_modes(table, spec)
    extra_lane = 4 if wl is not None else 0
    tab = modes["spectral_tab"]
    nbytes = (n * (36 + extra_lane) + (n - n_regen) * (28 + extra_lane)
              + 4 * n_regen + 4 * table.num_rows * row_width(table)
              + 4 * (culling.lists.size + culling.counts.size + 7 * nb)
              + (8 * tab.shape[0] if tab is not None else 0))
    per_group = torch.tensor([row_ops(g[3], g[2]) for g in table.groups],
                             dtype=torch.float64)
    cand = (torch.as_tensor(culling.counts, dtype=torch.float64)
            * per_group).sum(1)
    epi = (SHADE_OPS - (0 if modes["slope"] else SLOPE_OPS)
           + (LAMBERT_OPS if modes["lambertian"] else 0)
           + (ATT_OPS if modes["ambient_att"] > 0 else 0))
    nops = float((traced_b.double() * (cand + epi)).sum()) + n_regen * (
        REGEN_OPS + (BAND_OPS if wl is not None else 0))
    hit = want[3] >= 0
    kinds = table.opt_kind[want[3].clamp(min=0).long()]
    flags = table.opt_flags[want[3].clamp(min=0).long()]
    nops += (int((hit & (kinds == M.K_FRESNEL_CONDUCTOR)).sum())
             * (COND_OPS + 2 * SEG_OPS)
             + int((hit & ((flags & M.F_IAM) != 0)).sum()) * IAM_OPS)
    if wl is not None:
        on = hit & (kinds == M.K_REFLECT_SPECTRAL)
        x = tab[:, 0].contiguous().to(wl.device)
        seg = torch.searchsorted(x, want[5][on].contiguous())
        nops += int((seg + 1).sum()) * SEG_OPS
    return bound(nbytes, nops)


def k1_modes_phase(dev, card, kb) -> float:
    """K1 against its plain version in each of PHASE10_K1_MODES: the full
    field (218 pads), the benchmark slab's culling, 64 tiles (the last
    idle) of lanes aimed at the tiles' candidates with a 40% dead share
    and random quotas (regeneration), slope error on: sid equal on all
    but 1e-5 of the live lanes, the rest within
    tests/test_torch_gpu.k1_compare's tolerance (widened as the incidence
    grazes, as k2_compare's); then its time at the
    benchmark slab (every tile active, a quarter tile's quota each) beside
    its plain version's and its bound. Returns the largest abs error."""
    import torch
    from test_torch_gpu import (k1_args, k1_call, k1_compare, k1_lanes,
                                k1_live, k1_scene, k1_traced)
    slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)
    worst = 0.0
    for label, mode in PHASE10_K1_MODES:
        t0 = time.perf_counter()
        table, meta, culling, spec = k1_scene(mode, 218, slab, dev)
        t_build = time.perf_counter() - t0
        tiles = tuple(range(300, 364))
        lanes = k1_lanes(meta, culling, tiles, 7, 0.4, dev, spec[13])
        gen = torch.Generator().manual_seed(7)
        rem = torch.randint(0, kb.TILE + 1, (len(tiles),), generator=gen,
                            dtype=torch.int32).to(dev)
        act = torch.ones(len(tiles), dtype=torch.int32, device=dev)
        act[-1] = 0
        args = (table, culling, spec, tiles, 19, lanes, rem, act)
        got = k1_call(kb.bounce_reflect_culled, *args)
        want = k1_call(kb.bounce_reflect_culled_ref, *args)
        torch.cuda.synchronize()
        live = k1_live(lanes[2], rem, act)
        n_live = int(live.sum())
        err, flips, errs = k1_compare(
            got, want, live, max_flips=int(1e-5 * n_live) + 1,
            traced=k1_traced(*args))
        worst = max(worst, err)
        hits = float((want[3][live] >= 0).float().mean())
        del got, want
        # every tile of the benchmark slab, a quarter tile's quota each
        tiles = tuple(range(culling.nb))
        lanes = k1_lanes(meta, culling, tiles, 8, 0.4, dev, spec[13])
        rem = torch.full((culling.nb,), kb.TILE // 4, dtype=torch.int32,
                         device=dev)
        act = torch.ones(culling.nb, dtype=torch.int32, device=dev)
        pos_args, kw_args = k1_args(table, culling, spec, tiles, 23, lanes,
                                    rem, act)
        want = kb.bounce_reflect_culled_ref(*pos_args, **kw_args)
        bnd = k1_bound(table, culling, spec, lanes, rem, want)
        del want
        order = torch.as_tensor(culling.order, device=dev)
        call_k = (lambda: kb.bounce_reflect_culled(*pos_args, order=order,
                                                   **kw_args))
        geo = kb.k1_geometry(pos_args[1], pos_args[0], *pos_args[11:13],
                             **kw_args)
        call_p = (lambda: kb.bounce_reflect_culled_ref(*pos_args,
                                                       **kw_args))
        p1 = time_cuda(call_p, 3)
        k1a = time_cuda(call_k, 20)
        k1b = time_cuda(call_k, 20)
        p2 = time_cuda(call_p, 3)
        log(f"K1 {label}: culling {culling.nb} tiles (L_mean "
            f"{culling.stats['L_mean']:.1f}, lists {culling.lists.shape[1]}"
            f" wide, groups {[(g[3], g[2]) for g in table.groups]}, built "
            f"in {t_build:.1f} s); 64 tiles: {n_live} live lanes, hit share "
            f"{hits:.3f}, flips {flips}, max abs err {err:.2e} ("
            + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
            + f"); at {slab} lanes kernel {min(k1a, k1b):.4f} ms, plain "
            f"{min(p1, p2):.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
            f"{geo['resident']} blocks resident a SM ({card})")
        del lanes, pos_args, kw_args
    return worst


def field_phase(dev, card, kb, kn, field):
    """A field's culled trace at full size, then the same without its
    culling: "curved" (benchmarks/curved.py: slab 3,151,872, 134,479,872
    rays, max_rounds 400) or "rect" (phase 5's scene under the NSTTF's
    oblique rect source: slab 2,101,248, 537,919,488 rays, max_rounds
    600), max_path 8, min_energy 1e-6, the 50x50 receiver flux map. One
    untimed short trace, three timed (median and every wall time, K1 and
    K2 launches), one culling=None trace. Guards: closure < 1e-4 on every
    trace, the receiver's fraction (curved.py:79's (0.04, 0.09); above
    0.02 for the rect source), culled against unculled within
    test_pallas_tpu.py's margins (receiver 2%, escaped 0.5% for the curved
    field; receiver 1.5%, mirrors 3%, escaped 0.5% for the rect source),
    the difference also printed in combined binomial sigma. Returns (K1,
    K2) launches of the timed and unculled traces and the unculled trace's
    fractions."""
    import math
    import statistics
    import torch
    from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.engine import energy_closure, trace_streaming
    from tracer_tpu_torch.kernels.bounce import MAX_STAGE_FLOATS
    from tracer_tpu_torch.kernels.rows import row_width
    from tracer_tpu_torch.models import nsttf
    base = (1 << 20) // kb.TILE * kb.TILE + kb.TILE
    if field == "curved":
        table, meta, info = nsttf.build_curved_scene(device=dev)
        slab, total, max_rounds = 3 * base, 128 * base, 400
        source_fn = nsttf.make_source_fn(info, slab)
    else:
        table, meta, info = nsttf.build_scene(device=dev)
        slab, total, max_rounds = 2 * base, 512 * base, 600
        source_fn = nsttf.make_rect_source_fn(info, slab)
    t0 = time.perf_counter()
    culling = build_block_culling(table, meta, source_fn.pallas_spec, slab)
    t_build = time.perf_counter() - t0
    width = culling.lists.shape[1]
    stage = width * row_width(table) + width
    check(stage <= MAX_STAGE_FLOATS, f"{field}: K1 stage {stage} floats")
    log(f"{field} field: {table.num_rows} rows in groups "
        f"{[(g[3], g[2]) for g in table.groups]}, culling {culling.nb} "
        f"tiles in {t_build:.1f} s (L_mean {culling.stats['L_mean']:.1f}, "
        f"L_max {culling.stats['L_max']}, lists {width} wide, K1 stage "
        f"{stage} of {MAX_STAGE_FLOATS} floats, {len(culling.demote_rows)}"
        f" demoted rows) ({card})")
    fspec = flux_plan(meta, "receiver", resolution=50)
    rec_row = int((meta.row_logical == meta.index_of("receiver"))
                  .nonzero()[0][0])

    def run(seed, cul, total=total):
        return trace_streaming(table, source_fn,
                               torch.Generator().manual_seed(seed), total,
                               max_rounds=max_rounds, max_path=8,
                               min_energy=1e-6, culling=cul,
                               fluxspecs=(fspec,))
    run(100, culling, 4 * slab)          # untimed: first-use costs
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    walls, results = [], []
    for rep in (1, 2, 3, None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(run(rep or 4, culling if rep else None))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    l1, l2 = kb.bounce_reflect_culled.launches, kb.bounce_reflect.launches
    check(kn.nearest_hit.launches == epilogue().launches == 0,
          f"{field}: K3 or its epilogue launched")
    fr = []
    for accum, emitted, source_e in results:
        em, se = int(emitted), float(source_e)
        check(em >= total, f"{field}: emitted {em} of {total}")
        closure = energy_closure(accum, source_e)
        check(abs(closure) < 1e-4, f"{field}: closure {closure}")
        ab = accum.absorbed.double().cpu()
        for name in ("absorbed", "escaped", "culled", "residual"):
            check(bool(torch.isfinite(getattr(accum, name)).all()),
                  f"{field}: {name} not finite")
        rec = float(ab[rec_row]) / se
        fsum = float(accum.flux[0].double().sum())
        check(accum.flux[0].shape == (50, 50)
              and abs(fsum - float(ab[rec_row])) < 5e-3 * float(ab[rec_row]),
              f"{field}: flux map {fsum} vs receiver {float(ab[rec_row])}")
        fr.append(dict(rec=rec, mir=float(ab.sum()) / se - rec,
                       esc=float(accum.escaped) / se, n=em,
                       closure=closure))
    lo, hi = (0.04, 0.09) if field == "curved" else (0.02, 1.0)
    for f in fr:
        check(lo < f["rec"] < hi, f"{field}: receiver fraction {f['rec']}")
    off = fr[-1]
    margins = ({"rec": 0.02, "esc": 0.005} if field == "curved"
               else {"rec": 0.015, "mir": 0.03, "esc": 0.005})
    sigmas = {}
    for f in fr[:-1]:
        for k, m in margins.items():
            d = abs(f[k] - off[k])
            check(d < m * off[k], f"{field}: culled {k} {f[k]} vs unculled "
                  f"{off[k]}")
            sig = math.sqrt(max(off[k] * (1 - off[k]), 1e-12)
                            * (1 / f["n"] + 1 / off["n"]))
            sigmas[k] = max(sigmas.get(k, 0.0), d / sig)
    wall = statistics.median(walls[:3])
    recs = ", ".join(f"{f['rec']:.5f}" for f in fr[:3])
    log(f"{field} field: {fr[0]['n']} rays emitted per call, receiver "
        f"{recs} (unculled {off['rec']:.5f}), mirrors {fr[0]['mir']:.5f} (unculled "
        f"{off['mir']:.5f}), escaped {fr[0]['esc']:.5f} (unculled "
        f"{off['esc']:.5f}), largest culled-unculled difference "
        + ", ".join(f"{k} {v:.2f} sigma" for k, v in sigmas.items())
        + f", closures {max(abs(f['closure']) for f in fr):.1e}; K1 "
        f"launches {l1}, K2 launches {l2} in 3 culled runs and 1 unculled; "
        f"wall median {wall:.3f} s of {', '.join(f'{w:.3f}' for w in walls[:3])}"
        f" ({total / wall / 1e6:.1f} Mrays/s), unculled {walls[3]:.3f} s "
        f"({card})")
    check(l1 > 0 and l2 > 0, f"{field}: K1 {l1}, K2 {l2} launches")
    return l1, l2, off


# phase 12's K1 modes with parking (test_torch_gpu.K1_MODES, all but the
# curved field's CSR 0.2): label, mode
AUREOLE_K1_MODES = (("NSTTF instance, Buie disk CSR 0.2", "aureole"),
                    ("NSTTF instance, rect cells CSR 0.2", "aureole_rect"),
                    ("general instance, curved field CSR 0.02", "curved"))


def aureole_k1_phase(dev, card, kb) -> float:
    """K1 with park_aureole in each of AUREOLE_K1_MODES on 218 pads, every
    tile of the benchmark slab's parked culling: lanes aimed at the
    tiles' candidates with a 40% dead share and a quarter tile's quota
    each (regeneration), slope error on. Against its plain version: sid
    equal on all but 1e-5 of the live lanes (encoded sids included), the
    rest within tests/test_torch_gpu.k1_compare's tolerance; against the
    kernel without parking: every output equal once the encoded sids are
    decoded, and encoded sids only on regenerated lanes. Then the kernel
    with and without parking timed in turns (off, on, on, off) beside the
    plain version and the bound. Returns the largest abs error."""
    import torch
    from test_torch_gpu import (k1_args, k1_compare, k1_lanes, k1_live,
                                k1_scene, k1_traced)
    slab = 2 * ((1 << 20) // kb.TILE * kb.TILE + kb.TILE)
    worst = 0.0
    for label, mode in AUREOLE_K1_MODES:
        t0 = time.perf_counter()
        table, meta, culling, spec = k1_scene(mode, 218, slab, dev,
                                              park_aureole=True)
        t_build = time.perf_counter() - t0
        check(culling.park_aureole, f"{label}: culling does not park")
        tiles = tuple(range(culling.nb))
        lanes = k1_lanes(meta, culling, tiles, 8, 0.4, dev, spec[13])
        rem = torch.full((culling.nb,), kb.TILE // 4, dtype=torch.int32,
                         device=dev)
        act = torch.ones(culling.nb, dtype=torch.int32, device=dev)
        args = (table, culling, spec, tiles, 23, lanes, rem, act)
        pos_args, kw_on = k1_args(*args)
        kw_off = dict(kw_on, park_aureole=False)
        check(kw_on["park_aureole"], f"{label}: K1 not asked to park")
        got = kb.bounce_reflect_culled(*pos_args, **kw_on)
        off = kb.bounce_reflect_culled(*pos_args, **kw_off)
        want = kb.bounce_reflect_culled_ref(*pos_args, **kw_on)
        torch.cuda.synchronize()
        live = k1_live(lanes[2], rem, act)
        n_live = int(live.sum())
        err, flips, errs = k1_compare(
            got, want, live, max_flips=int(1e-5 * n_live) + 1,
            traced=k1_traced(*args))
        worst = max(worst, err)
        enc = got[3] <= -16
        n_enc, n_enc_ref = int(enc.sum()), int((want[3] <= -16).sum())
        reborn = (lanes[2] <= 0.0) & live
        check(n_enc > 0 and not bool((enc & ~reborn).any()),
              f"{label}: {n_enc} encoded sids, some on lanes not reborn")
        dec = torch.where(enc, -got[3] - 16, got[3])
        check(torch.equal(dec, off[3]), f"{label}: decoded sids differ "
              "from the kernel's without parking")
        for k in (0, 1, 2, 4):
            check(torch.equal(got[k], off[k]), f"{label}: output {k} "
                  "moved with parking")
        bnd = k1_bound(table, culling, spec, lanes, rem, want)
        del got, off, want

        order = torch.as_tensor(culling.order, device=dev)

        def call(kw):
            return lambda: kb.bounce_reflect_culled(*pos_args, order=order,
                                                    **kw)
        p1 = time_cuda(lambda: kb.bounce_reflect_culled_ref(*pos_args,
                                                            **kw_on), 3)
        t_off = [time_cuda(call(kw_off), 20)]
        t_on = [time_cuda(call(kw_on), 20), time_cuda(call(kw_on), 20)]
        t_off.append(time_cuda(call(kw_off), 20))
        log(f"K1 parking, {label}: culling {culling.nb} tiles (L_mean "
            f"{culling.stats['L_mean']:.1f}, L_max {culling.stats['L_max']}"
            f", built in {t_build:.1f} s); {n_live} live lanes, "
            f"{n_enc} encoded sids (plain {n_enc_ref}), flips {flips}, max "
            f"abs err {err:.2e} ("
            + ", ".join(f"{k} {v:.1e}" for k, v in errs.items())
            + f"); at {slab} lanes kernel with parking "
            f"{', '.join(f'{t:.4f}' for t in t_on)} ms, without "
            f"{', '.join(f'{t:.4f}' for t in t_off)} ms, plain {p1:.3f} ms,"
            f" bound {bnd[0]:.4f} ms ({bnd[1]}) ({card})")
        del lanes, pos_args, kw_on, kw_off
    return worst


def aureole_trace_phase(dev, card, kb, kn, culling0, t_culling0, unparked,
                        rect_unculled):
    """Phase 5's NSTTF trace (537,919,488 rays, slab 2,101,248, max_path
    8, min_energy 1e-6, the 50x50 receiver flux map) with a parked
    culling, beside the unparked ``culling0`` (built in ``t_culling0``
    s): one counted trace at full size (emit-drain cycles, lanes drained,
    aureole-parked lanes: encoded hits that survive min_energy, its
    wall), then three timed (median and every wall, K1 and K2 launches);
    the unparked culling's counted trace too. Guards:
    bench.py's (check_trace) on every trace, and the receiver within 3
    combined binomial sigma of phase 5's ``unparked`` (receiver fraction,
    rays, median wall). Then the rect-source NSTTF (phase 10's source,
    537,919,488 rays) with a parked culling once: closure below 1e-4, the
    flux map, the receiver above 0.02 and within phase 10's margins of
    its unculled trace ``rect_unculled`` (receiver 1.5%, mirrors 3%,
    escaped 0.5%). Returns (K1, K2) launches of the timed and rect
    traces."""
    import math
    import statistics
    import torch
    from tracer_tpu_torch import engine
    from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.engine import energy_closure
    from tracer_tpu_torch.models import nsttf
    base = (1 << 20) // kb.TILE * kb.TILE + kb.TILE
    # parked lanes stay frozen until no tile can emit, so a tile over
    # dense mirrors silts up and the emission tail runs long: the round
    # budget is phase 5's depth-1 trace's
    slab, total, max_rounds = 2 * base, 512 * base, 20_000
    table, meta, info = nsttf.build_scene(device=dev)
    source_fn = nsttf.make_source_fn(info, slab)
    t0 = time.perf_counter()
    culling = build_block_culling(table, meta, source_fn.pallas_spec, slab,
                                  park_aureole=True)
    t_build = time.perf_counter() - t0
    check(culling.park_aureole, "NSTTF: culling does not park")
    log(f"parked NSTTF culling: {culling.nb} tiles in {t_build:.1f} s, "
        f"L_mean {culling.stats['L_mean']:.2f}, L_max "
        f"{culling.stats['L_max']} (unparked: {t_culling0:.1f} s, L_mean "
        f"{culling0.stats['L_mean']:.2f}, L_max {culling0.stats['L_max']})"
        f" ({card})")
    fspec = flux_plan(meta, "receiver", resolution=50)

    def run(seed, table=table, source_fn=source_fn, culling=culling):
        return engine.trace_streaming(
            table, source_fn, torch.Generator().manual_seed(seed), total,
            max_rounds=max_rounds, max_path=8, min_energy=1e-6,
            culling=culling, fluxspecs=(fspec,))

    # one counted trace with each culling: rounds, the drains and the
    # lanes they take, K1's encoded hits and those that survive to park
    k1_fn, drain_fn = engine.bounce_reflect_culled, engine._chunked_drain
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    for label, cul in (("unparked", culling0), ("parked", culling)):
        seen = {"parked": torch.zeros((), dtype=torch.int64, device=dev),
                "hits": torch.zeros((), dtype=torch.int64, device=dev),
                "drains": 0, "drained": 0}

        def counted_k1(*args, **kw):
            out = k1_fn(*args, **kw)
            enc = out[3] <= -16
            seen["hits"] += enc.sum()
            seen["parked"] += (enc & (out[2] > 1e-6)).sum()
            return out

        def counted_drain(e, *args, **kw):
            seen["drains"] += 1
            seen["drained"] += int((e > 0.0).sum())
            return drain_fn(e, *args, **kw)
        engine.bounce_reflect_culled = counted_k1
        engine._chunked_drain = counted_drain
        try:
            l1 = kb.bounce_reflect_culled.launches
            l2 = kb.bounce_reflect.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            accum, emitted, source_e = run(0, culling=cul)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            rounds = kb.bounce_reflect_culled.launches - l1
            k2_counted = kb.bounce_reflect.launches - l2
        finally:
            engine.bounce_reflect_culled = k1_fn
            engine._chunked_drain = drain_fn
        check_trace(f"{label} NSTTF", accum, emitted, source_e, total,
                    energy_closure)
        parked, hits = int(seen["parked"]), int(seen["hits"])
        check((parked > 0) == (label == "parked"),
              f"{label} NSTTF: {parked} aureole lanes parked")
        log(f"{label} NSTTF, counted trace: {rounds} rounds (K1 launches),"
            f" {k2_counted} K2 launches in {seen['drains']} drains of "
            f"{seen['drained']} live lanes; {hits} aureole-born hits, "
            f"{parked} parked = {100 * parked / int(emitted):.4f}% of "
            f"{int(emitted)} refills; wall {wall:.3f} s ({card})")
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    walls, recs = [], []
    for rep in (1, 2, 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        accum, emitted, source_e = run(rep)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        rec, closure, flux_rec = check_trace("parked NSTTF", accum, emitted,
                                             source_e, total, energy_closure)
        recs.append((rec, int(emitted), closure))
    l1, l2 = kb.bounce_reflect_culled.launches, kb.bounce_reflect.launches
    check(kn.nearest_hit.launches == epilogue().launches == 0,
          "parked NSTTF: K3 or its epilogue launched")
    p0, n0, wall0 = unparked
    worst = 0.0
    for rec, n, _ in recs:
        sig = math.sqrt(p0 * (1 - p0) * (1 / n + 1 / n0))
        worst = max(worst, abs(rec - p0) / sig)
        check(abs(rec - p0) < 3 * sig, f"parked NSTTF: receiver {rec} vs "
              f"unparked {p0}, {abs(rec - p0) / sig:.2f} sigma")
    wall = statistics.median(walls)
    log(f"parked NSTTF: {recs[0][1]} rays emitted per call, receiver "
        f"{', '.join(f'{r[0]:.5f}' for r in recs)} (unparked {p0:.5f}, "
        f"largest difference {worst:.2f} sigma), closures "
        f"{max(abs(r[2]) for r in recs):.1e}, flux/receiver "
        f"{flux_rec:.6f}; K1 launches {l1}, K2 launches {l2} in 3 runs; "
        f"wall median {wall:.3f} s of {', '.join(f'{w:.3f}' for w in walls)}"
        f", {recs[0][1] / wall / 1e6:.1f} Mrays/s (unparked median "
        f"{wall0:.3f} s, {n0 / wall0 / 1e6:.1f} Mrays/s) ({card})")

    # the rect-source NSTTF with a parked culling, once
    rect_fn = nsttf.make_rect_source_fn(info, slab)
    t0 = time.perf_counter()
    rect_cul = build_block_culling(table, meta, rect_fn.pallas_spec, slab,
                                   park_aureole=True)
    t_build = time.perf_counter() - t0
    check(rect_cul.park_aureole, "rect: culling does not park")
    rec_row = int((meta.row_logical == meta.index_of("receiver"))
                  .nonzero()[0][0])
    r1, r2 = kb.bounce_reflect_culled.launches, kb.bounce_reflect.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    accum, emitted, source_e = run(5, source_fn=rect_fn, culling=rect_cul)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r1 = kb.bounce_reflect_culled.launches - r1
    r2 = kb.bounce_reflect.launches - r2
    em, se = int(emitted), float(source_e)
    check(em >= total, f"parked rect: emitted {em} of {total}")
    closure = energy_closure(accum, source_e)
    check(abs(closure) < 1e-4, f"parked rect: closure {closure}")
    for name in ("absorbed", "escaped", "culled", "residual"):
        check(bool(torch.isfinite(getattr(accum, name)).all()),
              f"parked rect: {name} not finite")
    ab = accum.absorbed.double().cpu()
    fsum = float(accum.flux[0].double().sum())
    check(abs(fsum - float(ab[rec_row])) < 5e-3 * float(ab[rec_row]),
          f"parked rect: flux map {fsum} vs receiver {float(ab[rec_row])}")
    rec = float(ab[rec_row]) / se
    f = dict(rec=rec, mir=float(ab.sum()) / se - rec,
             esc=float(accum.escaped) / se)
    check(rec > 0.02, f"parked rect: receiver fraction {rec}")
    sigmas = []
    for k, m in {"rec": 0.015, "mir": 0.03, "esc": 0.005}.items():
        u = rect_unculled[k]
        check(abs(f[k] - u) < m * u, f"parked rect: {k} {f[k]} vs "
              f"unculled {u}")
        sig = math.sqrt(max(u * (1 - u), 1e-12)
                        * (1 / em + 1 / rect_unculled["n"]))
        sigmas.append(f"{k} {abs(f[k] - u) / sig:.2f} sigma")
    log(f"parked rect-source NSTTF: culling in {t_build:.1f} s (L_mean "
        f"{rect_cul.stats['L_mean']:.2f}, L_max {rect_cul.stats['L_max']})"
        f"; {em} rays, receiver {rec:.5f} (unculled "
        f"{rect_unculled['rec']:.5f}), mirrors {f['mir']:.5f}, escaped "
        f"{f['esc']:.5f}, difference {', '.join(sigmas)}, closure "
        f"{closure:.1e}; K1 launches {r1}, K2 launches {r2}; wall "
        f"{wall:.3f} s, {em / wall / 1e6:.1f} Mrays/s ({card})")
    return l1 + r1, l2 + r2


# phase 13's scenes beside the bench configurations and phase 9's: name
# -> the beam (centre, direction, radius, pillbox half-angle, wavelength
# band) of benchmarks/suite.py's config it borrows
PHASE13_SCENES = {"mixed_iam": 7, "split_sheet": 6, "dispersive_split": 6}
PHASE13_BANDS = {"dispersive_split": (4e-7, 7e-7)}
# phase 9's stage (d)/(e) scenes that phase 13 traces on trace_fused
PHASE13_STAGE_DE = ("conductor", "iam_c2", "piecewise_2d", "periodic_hg")
TPU_FLUX_PEAK_SUNS = 6201     # config 2's peak, a 30M-ray TPU run (README)


def phase13_assembly(name):
    """The assembly of one of PHASE13_SCENES: "mixed_iam", two IAM rows
    with exponents 1 and 2 (a mirror and a Lambertian plate) side by side
    under config 7's beam in its dome; "split_sheet", an energy-splitting
    glass face over a scattering, absorbing sheet over a Lambertian
    floor; "dispersive_split", a dispersive splitting face over an
    absorber."""
    import tracer_tpu_torch as ptt
    G, M, sc = ptt.geometry, ptt.materials, ptt.scene
    if name == "mixed_iam":
        surfs = [sc.Surface(G.round_plate(0.3),
                            M.iam(M.reflective(0.1), 1.0, c=1.0),
                            location=[-0.3, 0.4, 0.0], name="iam1"),
                 sc.Surface(G.round_plate(0.3),
                            M.iam(M.lambertian(0.3), 0.5, c=2.0),
                            location=[0.3, 0.4, 0.5], name="iam2"),
                 sc.Surface(G.hemisphere(3.0), M.absorber(one_sided=False),
                            name="dome")]
    elif name == "split_sheet":
        surfs = [sc.Surface(G.round_plate(0.5), o, location=[0, 0, -i],
                            name=nm)
                 for i, (nm, o) in enumerate((
                     ("glass", M.refractive_homogenous(1.0, 1.5,
                                                       single_ray=False)),
                     ("sheet", M.scattering_interface(0.3, att_inside=0.2)),
                     ("floor", M.lambertian(0.6))))]
    else:
        surfs = [sc.Surface(G.round_plate(0.5), M.refractive_material(
            1.0, ([4e-7, 7e-7], [1.6, 1.4]), single_ray=False),
            name="glass"),
                 sc.Surface(G.round_plate(0.5), M.absorber(one_sided=False),
                            location=[0.0, 0.0, -1.0], name="rec")]
    return sc.Assembly([sc.AssembledObject(surfs)])


def disk_source(n, beam, band=None, spec=None):
    """source_fn(generator, device=None) of n pillbox disk rays of
    ``beam`` (centre, direction, radius, half-angle) at 1000 W/m^2, their
    wavelengths uniform in ``band``; ``spec`` its pallas_spec."""
    import torch
    from tracer_tpu_torch.sources import disk_bundle

    def source_fn(generator, device=None):
        b = disk_bundle(generator, n, *beam, flux=1000.0, device=device)
        if band is None:
            return b
        wl = band[0] + (band[1] - band[0]) * torch.rand(
            n, generator=generator, device=generator.device)
        return b.replace(wavelength=wl.to(b.pos.device))
    source_fn.num_rays = n
    if spec is not None:
        source_fn.pallas_spec = spec
    return source_fn


def fractions(accum, source_e):
    """Per-row shares of the source, then the medium's."""
    se = float(source_e)
    return (list(accum.absorbed.double().cpu().numpy() / se)
            + [float(accum.medium) / se])


def within_sigma(label, p, n_p, q, n_q, slack=0.0):
    """Every share of ``p`` (n_p rays) within 3 combined binomial sigma
    of ``q``'s (n_q rays), plus ``slack``."""
    import math
    for i, (a, b) in enumerate(zip(p, q)):
        sig = math.sqrt(max(b * (1 - b), 1e-12) * (1 / n_p + 1 / n_q))
        check(abs(a - b) < 3 * sig + slack, f"{label}: share {i} {a} vs "
              f"{b} +- {sig} (+ {slack})")


def record_bytes(rec) -> int:
    import torch
    n = 0
    for v in rec.__dict__.values():
        for t in (v if isinstance(v, tuple) else (v,)):
            if torch.is_tensor(t):
                n += t.numel() * t.element_size()
    return n


def unfused_phase(dev, card, kb, kn, physics, split_stream):
    """Phase 13: the unfused bounce (K3, the volumetric media and the
    shade of every optics kind) at the suite's 700,416 rays. Config 2's
    flux map through ray_tracer(record="tags") (benchmarks/suite.py
    :174-181, reps 20, resolution 20) with its peak in suns beside the
    TPU's recorded one; each bounce's record copied to the host (bytes,
    ms) on the same scene; trace_fused on configs 3, 7, 8, 8b and 7g,
    phase 9's conductor, IAM c = 2, piecewise and periodic scenes and
    PHASE13_SCENES, one of them profiled; ray_tracer on the split lens
    (config 6s); the general streaming path on PHASE13_SCENES (16
    emission rounds). Guards: closure below 1e-4; K3 launched once a
    bounce and K1 and K2 never on the bundle traces, the K3 epilogue
    after each K3 launch of the trace_fused calls whose gate holds
    (engine._epilogue_ok) and never elsewhere, K2 never on the general
    path's unfused bounce; every share within 3 combined binomial
    sigma of the plain megakernel's on the card for the same
    configuration (phases 7-9 and 11, or a megakernel trace of 8 rounds
    here for phase 9's scenes), of phase 11's split stream for the split
    lens (less both traces' culled shares), of trace_fused on the same
    scene for the general path, and of a float64 CPU ray_tracer on the
    first 65,536 rays for the mixed IAM scene. Returns the launches of K2
    (the megakernel references), of K3 and of the K3 epilogue."""
    import numpy as np
    import torch
    from test_torch_gpu import STAGE_DE, stage_de_assembly, stage_de_spec
    from tracer_tpu_torch import engine as eng_mod
    from tracer_tpu_torch.analysis.fluxmap import areas_of, surface_fluxmap
    from tracer_tpu_torch.engine import (TraceAccum, TraceOptions,
                                         TracerEngine, energy_closure,
                                         trace_fused, trace_streaming)
    from tracer_tpu_torch.models.bench_configs import (BENCH, bench_scene,
                                                       max_rounds)
    from tracer_tpu_torch.scene import compile_scene
    import tracer_tpu_torch as ptt
    t13 = time.perf_counter()
    n = BENCH_SLAB
    launches = {"k2": 0, "k3": 0, "epi": 0}

    def start():
        reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                       kn.nearest_hit)
        torch.cuda.synchronize()
        return time.perf_counter()

    def bundle_checks(label, bounces, max_bounces, alive, gated=False):
        """K3 once a bounce, K1 and K2 never, the K3 epilogue after each
        K3 launch where its gate held (``gated``) and never elsewhere;
        returns K3's launches."""
        l3 = kn.nearest_hit.launches
        check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
              == 0, f"{label}: K1 or K2 launched on a bundle trace")
        le = epilogue().launches
        check(le == (l3 if gated else 0), f"{label}: {le} K3 epilogue "
              f"launches for {l3} K3 launches (gate open: {gated})")
        launches["epi"] += le
        check(l3 == bounces if bounces is not None
              else (l3 == max_bounces if alive else 1 <= l3 <= max_bounces),
              f"{label}: {l3} K3 launches for {bounces} bounces "
              f"(max {max_bounces}, alive {alive})")
        launches["k3"] += l3
        return l3

    # config 2's flux map on the record path, at the suite's size
    table, meta, source_fn = bench_scene(2, n, dev)
    bundle = source_fn(torch.Generator().manual_seed(3), device=dev)
    t0 = start()
    res = TracerEngine(table, meta).ray_tracer(
        bundle, generator=torch.Generator(device=dev).manual_seed(4),
        opts=TraceOptions(max_bounces=20, record="tags"))
    wall = time.perf_counter() - t0
    l3 = kn.nearest_hit.launches
    bundle_checks("config 2 ray_tracer", None, 20,
                  bool(res.final.alive.any()))
    check(l3 > max(int(r.bounce) for r in res.records),
          "config 2 ray_tracer: fewer K3 launches than tagged bounces")
    bal = res.energy_balance()
    src = bal["source"]
    check(abs(bal["closure"]) < 1e-4 * src, f"config 2 ray_tracer: "
          f"closure {bal['closure'] / src}")
    flux, _ = surface_fluxmap(res, "rec", resolution=20)
    geom = meta.surfaces[meta.index_of("rec")].geometries[0]
    rec_w = float(res.absorbed_by_logical()[meta.index_of("rec")])
    mapped = float((flux * areas_of(geom.kind, geom.extent, 20)).sum())
    check(np.isfinite(flux).all() and flux.shape == (20, 20)
          and abs(mapped - rec_w) < 1e-4 * rec_w,
          f"config 2 flux map: {mapped} W mapped of {rec_w}")
    meta2, p2, em2 = physics[2]
    d, d_mega = rec_w / src, surface_fraction(meta2, p2, "rec")
    within_sigma("config 2 ray_tracer receiver", [d], n, [d_mega], em2)
    log(f"config 2 flux map (ray_tracer, record=\"tags\"): {n} rays, {l3} "
        f"bounces (K3 launches), {len(res.records)} tagged bounces, receiver "
        f"{d:.5f} of the source (megakernel {d_mega:.5f}), closure "
        f"{bal['closure'] / src:.1e}, peak {flux.max() / 1000.0:.1f} suns "
        f"(the TPU recorded {TPU_FLUX_PEAK_SUNS} from 30M rays), map "
        f"{mapped:.3f} W of {rec_w:.3f}; wall {wall:.3f} s ({card})")
    del res

    # each bounce's full record copied to the host on the same scene
    accum = TraceAccum.zeros(table.num_rows, device=dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    b, copies = bundle, []
    for i in range(20):
        b, accum, rec = eng_mod._bounce_step(table, b, accum, gen, 1e-6,
                                             None, 1e-6, 64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec.replace(bounce=i).to("cpu")
        copies.append((record_bytes(rec), time.perf_counter() - t0))
        if not bool(b.alive.any()):
            break
    log("config 2 records to the host (BounceRecord.to, record=True): "
        + ", ".join(f"{nb / 1e6:.1f} MB {dt * 1e3:.2f} ms"
                    for nb, dt in copies)
        + f"; {sum(nb for nb, _ in copies) / sum(dt for _, dt in copies) / 1e9:.2f}"
        f" GB/s over {len(copies)} bounces ({card})")

    # trace_fused on the bench configurations, phase 9's scenes and
    # phase 13's own, against the megakernel's shares
    def fused(label, table, bundle, max_bounces, seed=11):
        t0 = start()
        final, acc = trace_fused(
            table, bundle, torch.Generator(device=dev).manual_seed(seed),
            max_bounces=max_bounces)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        l3 = bundle_checks(label, None, max_bounces,
                           bool(final.alive.any()),
                           eng_mod._epilogue_ok(table, bundle))
        src = float(bundle.total_energy())
        left = float(final.total_energy())
        closure = (src - float(acc.absorbed.double().sum())
                   - float(acc.escaped) - float(acc.culled)
                   - float(acc.medium) - left) / src
        check(abs(closure) < 1e-4, f"{label}: closure {closure}")
        for k in ("absorbed", "escaped", "culled", "medium"):
            check(bool(torch.isfinite(getattr(acc, k)).all()),
                  f"{label}: {k} not finite")
        return fractions(acc, src), l3, wall, closure

    def show(label, p, q, l3, wall, closure, extra="", rays=n,
             what="bounces"):
        log(f"{label}: {rays} rays, {l3} {what} (K3 launches), closure "
            f"{closure:.1e}, shares " + ", ".join(f"{x:.5f}" for x in p)
            + f" (reference " + ", ".join(f"{x:.5f}" for x in q)
            + f"){extra}; wall {wall:.3f} s ({card})")

    for cfg in (3, 7, 8, "8b", "7g"):
        table, meta, source_fn = bench_scene(cfg, n, dev)
        bundle = source_fn(torch.Generator().manual_seed(30), device=dev)
        p, l3, wall, closure = fused(f"config {cfg} trace_fused", table,
                                     bundle, BENCH[cfg]["max_path"])
        _, q, em = physics[cfg]
        within_sigma(f"config {cfg} trace_fused", p, n, q, em)
        show(f"config {cfg} trace_fused", p, q, l3, wall, closure)
        if cfg == "8b":
            profile_path("config 8b trace_fused", lambda: trace_fused(
                table, bundle, torch.Generator(device=dev).manual_seed(12),
                max_bounces=BENCH[cfg]["max_path"]), "K3", "nearest_kernel",
                card, top=16)
    for name in PHASE13_STAGE_DE:
        table, _ = compile_scene(stage_de_assembly(ptt, name), device=dev)
        beam, band = STAGE_DE[name][:4], STAGE_DE[name][4]
        src_fn = disk_source(n, beam, band, stage_de_spec(name, n))
        t0 = start()
        acc, em, se = trace_streaming(table, src_fn,
                                      torch.Generator().manual_seed(31),
                                      8 * n, max_rounds=max_rounds(7, 8),
                                      max_path=20)
        check(kb.bounce_reflect.launches > 0 and kn.nearest_hit.launches
              == epilogue().launches == 0,
              f"{name}: the megakernel reference did not run on K2")
        launches["k2"] += kb.bounce_reflect.launches
        check(abs(energy_closure(acc, se)) < 1e-4, f"{name}: megakernel "
              f"closure {energy_closure(acc, se)}")
        q = fractions(acc, se)
        bundle = src_fn(torch.Generator().manual_seed(32), device=dev)
        p, l3, wall, closure = fused(f"{name} trace_fused", table, bundle,
                                     20)
        within_sigma(f"{name} trace_fused", p, n, q, int(em))
        show(f"{name} trace_fused", p, q, l3, wall, closure,
             f", megakernel reference {int(em)} rays")
    custom = {}
    for name, cfg in PHASE13_SCENES.items():
        table, meta = compile_scene(phase13_assembly(name), device=dev)
        c = BENCH[cfg]
        src_fn = disk_source(n, (c["center"], c["direction"], c["radius"],
                                 c["ang_range"]), PHASE13_BANDS.get(name))
        bundle = src_fn(torch.Generator().manual_seed(33), device=dev)
        p, l3, wall, closure = fused(f"{name} trace_fused", table, bundle,
                                     20)
        custom[name] = (table, meta, src_fn, bundle, p)
        log(f"{name} trace_fused: {n} rays, {l3} bounces (K3 launches), "
            f"closure {closure:.1e}, shares "
            + ", ".join(f"{x:.5f}" for x in p) + f"; wall {wall:.3f} s "
            f"({card})")
    # the mixed exponents against a float64 CPU ray_tracer
    table, meta, _, bundle, p = custom["mixed_iam"]
    ref = TracerEngine(phase13_assembly("mixed_iam"), dtype=torch.float64,
                       device="cpu").ray_tracer(
        head(bundle, MD_CPU, "cpu", torch.float64),
        opts=TraceOptions(t_eps=F32_T_EPS, record=False, max_bounces=20))
    q = list(ref.accum.absorbed.double().numpy()
             / ref.energy_balance()["source"]) + [0.0]
    within_sigma("mixed_iam trace_fused vs float64", p, n, q, MD_CPU)
    check(min(p[:2]) > 0.005, f"mixed_iam: IAM rows' shares {p[:2]}")

    # ray_tracer on the split lens: the host splitter
    table, meta, source_fn = bench_scene("6s", n, dev)
    bundle = source_fn(torch.Generator().manual_seed(34), device=dev)
    t0 = start()
    res = TracerEngine(table, meta).ray_tracer(
        bundle, reps=BENCH["6s"]["max_path"],
        generator=torch.Generator(device=dev).manual_seed(35))
    wall = time.perf_counter() - t0
    l3 = bundle_checks("split lens ray_tracer", len(res.records),
                       BENCH["6s"]["max_path"], None)
    bal = res.energy_balance()
    src = bal["source"]
    check(abs(bal["closure"]) < 1e-4 * src,
          f"split lens ray_tracer: closure {bal['closure'] / src}")
    d = float(res.absorbed_by_logical()[meta.index_of("rec")]) / src
    meta_s, p_s, em_s, culled_s = split_stream
    d_s = surface_fraction(meta_s, p_s, "rec")
    culled = bal["culled"] / src
    within_sigma("split lens ray_tracer receiver", [d], n, [d_s], em_s,
                 slack=max(culled, culled_s))
    check(0.75 < d < 0.98, f"split lens ray_tracer: receiver {d}")
    log(f"split lens ray_tracer: {n} rays grew to {res.final.num_rays} in "
        f"{len(res.records)} bounces ({l3} K3 launches), receiver {d:.5f} "
        f"(split stream {d_s:.5f}), culled {culled:.5f} (stream "
        f"{culled_s:.5f}), closure {bal['closure'] / src:.1e}; wall "
        f"{wall:.3f} s ({card})")
    del res

    # the general streaming path's unfused bounce
    for name, (table, meta, src_fn, _, q) in custom.items():
        total = 16 * n
        t0 = start()
        acc, em, se = trace_streaming(table, src_fn,
                                      torch.Generator().manual_seed(36),
                                      total, max_rounds=16 * 20 + 80,
                                      max_path=20)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        l3 = kn.nearest_hit.launches
        check(kb.bounce_reflect.launches == kb.bounce_reflect_culled.launches
              == epilogue().launches == 0 and l3 > 0, f"{name} general "
              f"path: K2 {kb.bounce_reflect.launches}, K3 {l3}, K3 "
              f"epilogue {epilogue().launches} launches")
        launches["k3"] += l3
        check(int(em) == total, f"{name} general path: emitted {int(em)}")
        closure = energy_closure(acc, se)
        check(abs(closure) < 1e-4, f"{name} general path: closure "
              f"{closure}")
        p = fractions(acc, se)
        within_sigma(f"{name} general path", p, total, q, n)
        show(f"{name} general path", p, q, l3, wall, closure,
             ", the reference trace_fused's", rays=total, what="rounds")
    log(f"phase 13: {time.perf_counter() - t13:.1f} s, K3 epilogue "
        f"launches {launches['epi']}")
    return launches["k2"], launches["k3"], launches["epi"]


# phase 14's cavities: config 5 (benchmarks/suite.py:692-699) and the
# Holman cavity (tests/test_thermal.py:24-28) with its analytic view
# factors
CONFIG5 = dict(apertureRadius=0.3, frustaRadii=[0.5, 0.5],
               frustaDepths=[0.4, 0.4], coneDepth=0.3, el_FRUs=[2, 2],
               el_CON=2)
HOLMAN = dict(apertureRadius=0.01, frustaRadii=[0.01] * 3,
              frustaDepths=[0.01] * 3, coneDepth=0.0, el_FRUs=[1, 1, 1],
              el_CON=1)
HOLMAN_VF = ((0.0, 0.63, 0.195, 0.075, 0.1),
             (0.315, 0.37, 0.2175, 0.06, 0.0375),
             (0.0975, 0.2175, 0.37, 0.2175, 0.0975),
             (0.0375, 0.06, 0.2175, 0.37, 0.315),
             (0.1, 0.075, 0.195, 0.63, 0.0))
VF_RAYS = 100_000             # rays an element a sample (the suite's)
TPU_APERTURE_LOSS_KW = 10.21  # config 5's aperture loss, the TPU's run
#                               (BENCHMARKS.md:73), a physics value
ACCEL_RAYS = 262_144          # the NSTTF rays of the Kd trace


def cavity_k3(rt, seed, kn, label, card):
    """K3 against its plain version on one sample of a cavity's batched
    fire: every element's rays, which start on the element surfaces where
    the float32 self-hit guard acts, through the cavity's packed rows with
    the fire's arguments (tests/test_torch_gpu.k3_compare on t and sid,
    all the fire reads: sid equal off ties, t within 1e-5 of its scale,
    at most 1e-5 of the lanes plus one flipped). The winner's normal is
    printed, not held: near the cone's apex the two float32 solves each
    land about 1e-5 from a float64 one, and the gradient there moves
    faster with t than k3_compare's aux tolerance allows. Returns the escaped share of K3's and of the plain
    version's results (sid -1: in a closed cavity, rays the guard or a
    seam lost), each (overall, the largest of any element's)."""
    import torch
    from test_torch_gpu import k3_compare
    from tracer_tpu_torch.kernels.bounce import pack_rows
    from tracer_tpu_torch.kernels.intersect import default_t_eps
    scene = rt.engine.scene
    pos, dirs, _ = rt._concat_sources(
        torch.Generator(device=rt.device).manual_seed(seed))
    n = pos.shape[0]
    args = (pack_rows(scene), pos, dirs, scene.groups,
            default_t_eps(pos.dtype))
    kw = dict(need_local=False, backside_miss="bifacial" in scene.features)
    got = kn.nearest_hit(*args, **kw)
    want = kn.nearest_hit_ref(*args, **kw)
    ties, flips = k3_compare(got, want, kn.nearest_two_t(
        *args, backside_miss=kw["backside_miss"]), pos, dirs, rtol=1e-5,
        max_flips=int(1e-5 * n) + 1, aux=False)
    hit = (want[1] >= 0) & (got[1] == want[1])
    t_err = float((got[0] - want[0]).abs()[hit].max())
    n_err = float((got[2]["normal"] - want[2]["normal"]).abs()[hit].max())

    def shares(sid):
        lost = (sid < 0).view(rt.n_elements, rt.num_rays).double().mean(1)
        return float(lost.mean()), float(lost.max())
    esc, esc_ref = shares(got[1]), shares(want[1])
    log(f"K3 on {label}'s fire sample: {n} lanes, {scene.num_rows} rows, "
        f"sid ties {ties}, flips {flips}, max abs err t {t_err:.2e}, "
        f"normal {n_err:.2e}; "
        f"escaped share K3 {esc[0]:.2e} (largest element {esc[1]:.2e}), "
        f"plain {esc_ref[0]:.2e} ({esc_ref[1]:.2e}) ({card})")
    return esc, esc_ref


def cavity_phase(dev, card, kb, kn, physics, nsttf):
    """Phase 14. (a) Config 5 at the suite's size
    (TwoNParametersCavityRTVF, 100,000 rays an element, precision 0.005,
    every sample's nearest hit on K3), then radiosity_rtvf with the
    suite's emissivities and temperatures, and radiosity_rtvf_torch on the
    card against it. Guards (suite.py:719, :732): row sums within 0.01,
    the enclosure balance below 3 x precision, the aperture loss within 3%
    of the TPU run's 10.21 kW, K3 launched once a sample. Printed: the
    reciprocity error, iterations, the escaped share, the adaptive wall
    and the steady throughput of one fire call. (b) The Holman cavity at
    100,000 rays an element against its analytic view factors (atol
    0.03). In (a) and (b), K3 against its plain version on one sample of
    the fire (cavity_k3), with both escaped shares. (c) ray_tracer with
    accel="lightweight" and without on phase 5's NSTTF scene, 262,144
    rays of its Buie disk, 8 bounces, one generator seed. Guards: closure below 1e-4 on both, K3 once a bounce
    without accel and never with it, at most 1e-5 of the lanes (plus one)
    with a flipped sid, per-surface absorbed equal within 1e-5 of the
    source plus the flipped lanes' energy. (d) A polychromatic ray_tracer
    on config 3's scene (its receiver tagged) from its Buie disk as a host
    bundle of 700,416 rays with a flat spectrum over the source's band on
    the silver table's 32 wavelengths, record="tags". Guards: closure
    below 1e-4, the receiver's, the mirror's and the medium's shares
    within 3 combined sigma of phase 7's monochromatic megakernel trace,
    the tagged hits' spectra absorbed. Returns K3's launches."""
    import logging
    import math
    import numpy as np
    import torch
    import tracer_tpu_torch as ptt
    from tracer_tpu_torch.accel import KdTree
    from tracer_tpu_torch.analysis.radiosity import (radiosity_rtvf,
                                                     radiosity_rtvf_torch)
    from tracer_tpu_torch.analysis.view_factors import (
        TwoNParametersCavityRTVF)
    from tracer_tpu_torch.engine import TraceOptions, TracerEngine
    from tracer_tpu_torch.models.bench_configs import (BENCH, bench_assembly,
                                                       bench_scene,
                                                       silver_table)
    from tracer_tpu_torch.models.nsttf import make_source_fn
    t14 = time.perf_counter()
    launches = 0

    def start():
        reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                       kn.nearest_hit)
        torch.cuda.synchronize()
        return time.perf_counter()

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def only_k3(label):
        check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
              == 0, f"{label}: K1 or K2 launched")
        return kn.nearest_hit.launches

    # (a) config 5 at the suite's size
    t0 = start()
    rt = TwoNParametersCavityRTVF(**CONFIG5, num_rays=VF_RAYS,
                                  precision=0.005, generator=gen(8),
                                  device=dev)
    wall = time.perf_counter() - t0
    l3 = only_k3("config 5")
    k = rt.iters_per_call
    check(l3 == -(-rt.iterations // k) * k, f"config 5: {l3} K3 launches "
          f"for {rt.iterations} iterations of {k} samples a call")
    launches += l3
    vf, areas, n = rt.VF_esperance, rt.areas, rt.n_elements
    row_sum_err = float(np.abs(vf.sum(axis=1) - 1.0).max())
    check(row_sum_err < 0.01, f"config 5: row sums {vf.sum(axis=1)}")
    eps = np.full(n, 0.85)
    eps[0] = 1.0
    T = np.full(n, 900.0)
    T[0] = 293.15
    AF = areas[:, None] * vf
    rec_err = float(np.abs(AF - AF.T).max() / AF.max())
    _, _, J, E, T_out, q, Q = radiosity_rtvf(vf, areas, eps, T=T)
    bal = float(abs(Q.sum()) / np.abs(Q).max())
    check(bal < 3.0 * rt.precision, f"config 5: enclosure balance {bal}")
    loss = -Q[0] / 1e3
    check(abs(loss / TPU_APERTURE_LOSS_KW - 1.0) < 0.03,
          f"config 5: aperture loss {loss} kW against the TPU's "
          f"{TPU_APERTURE_LOSS_KW}")
    tq = radiosity_rtvf_torch(torch.as_tensor(vf, device=dev), areas, eps, T,
                              np.zeros(n), np.ones(n, dtype=bool))
    check(tq[-1].device.type == "cuda"
          and np.allclose(tq[-1].cpu().numpy(), Q, rtol=1e-9,
                          atol=1e-9 * np.abs(Q).max()),
          "config 5: radiosity_rtvf_torch on the card differs")
    (esc, esc_max), _ = cavity_k3(rt, 9, kn, "config 5", card)
    fire = rt._build_fire_all()
    fire(gen(10))
    best = math.inf
    for i in range(5):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fire(gen(11 + i))
        best = min(best, time.perf_counter() - t1)
    per_call = k * n * VF_RAYS
    fired = l3 * n * VF_RAYS
    log(f"config 5 (TwoNParametersCavityRTVF, {n} elements, {VF_RAYS} rays "
        f"an element a sample, precision {rt.precision}): {rt.iterations} "
        f"iterations ({l3} K3 launches), {fired} rays fired "
        f"({k} samples a call), {float(rt.p.sum()):.0f} of them consumed "
        f"by the gates, in {wall:.2f} s ({fired / wall / 1e6:.1f} Mrays/s "
        f"fired end to end); row-sum error {row_sum_err:.5f}, reciprocity "
        f"error {rec_err:.5f}, escaped share {esc:.2e} (largest element "
        f"{esc_max:.2e}); radiosity balance {bal:.2e}, aperture loss "
        f"{loss:.3f} kW (the TPU run's {TPU_APERTURE_LOSS_KW}); one fire "
        f"call ({k} samples, {per_call} rays) {best * 1e3:.2f} ms, "
        f"{per_call / best / 1e6:.1f} Mrays/s ({card})")
    profile_path("config 5 fire call", lambda: fire(gen(20)), "K3",
                 "nearest_kernel", card, top=10)

    # (b) the Holman cavity
    t0 = start()
    rt = TwoNParametersCavityRTVF(**HOLMAN, num_rays=VF_RAYS, precision=0.02,
                                  generator=gen(12), device=dev)
    wall = time.perf_counter() - t0
    launches += only_k3("Holman cavity")
    err = np.abs(rt.VF_esperance - np.array(HOLMAN_VF))
    (esc, esc_max), _ = cavity_k3(rt, 13, kn, "the Holman cavity",
                                  card)
    log(f"Holman cavity (R = 0.01 m, {VF_RAYS} rays an element): "
        f"{rt.iterations} iterations, largest error against the analytic "
        f"view factors {err.max():.4f} (atol 0.03), row sums "
        + ", ".join(f"{x:.4f}" for x in rt.VF_esperance.sum(axis=1))
        + f", escaped share {esc:.2e} (largest element {esc_max:.2e}); "
        f"wall {wall:.2f} s ({card})")
    check(err.max() < 0.03, f"Holman cavity: error {err.max()}")

    # (c) the Kd accelerator on the NSTTF scene
    table, meta, info = nsttf
    bundle = make_source_fn(info, ACCEL_RAYS)(gen(14), device=dev)
    eng = TracerEngine(table, meta)
    t0 = time.perf_counter()
    tree = KdTree(meta)
    t_tree = time.perf_counter() - t0
    t0 = time.perf_counter()
    cand = TracerEngine._candidates(tree, bundle)
    t_cand = time.perf_counter() - t0
    n_cand = float((cand >= 0).sum(1).double().mean())
    runs = {}
    for accel in (None, "lightweight"):
        lines = []

        class Keep(logging.Handler):
            def emit(self, rec):
                lines.append(rec.getMessage())
        lg = logging.getLogger("tracer_tpu_torch")
        handler, level = Keep(), lg.level
        lg.addHandler(handler)
        lg.setLevel(logging.INFO)
        try:
            t0 = start()
            res = eng.ray_tracer(bundle, reps=8, generator=gen(15),
                                 accel=accel)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            lg.removeHandler(handler)
            lg.setLevel(level)
        l3 = only_k3(f"NSTTF ray_tracer accel={accel}")
        check(l3 == (0 if accel else len(res.records)),
              f"NSTTF ray_tracer accel={accel}: {l3} K3 launches in "
              f"{len(res.records)} bounces")
        launches += l3
        b = res.energy_balance()
        check(abs(b["closure"]) < 1e-4 * b["source"],
              f"NSTTF ray_tracer accel={accel}: closure "
              f"{b['closure'] / b['source']}")
        runs[accel] = (res, wall, lines)
    off, on = runs[None][0], runs["lightweight"][0]
    check(len(on.records) == len(off.records), "NSTTF accel: bounces differ")
    flipped = torch.zeros(ACCEL_RAYS, dtype=torch.bool)
    for a, c in zip(on.records, off.records):
        flipped |= (a.sid != c.sid) & (a.alive_in | c.alive_in)
    n_flip = int(flipped.sum())
    src = off.energy_balance()["source"]
    e_flip = float(bundle.energy[flipped.to(dev)].double().sum())
    diff = float(np.abs(on.absorbed_by_logical()
                        - off.absorbed_by_logical()).max())
    check(n_flip <= 1e-5 * ACCEL_RAYS + 1, f"NSTTF accel: {n_flip} lanes "
          f"flipped a sid")
    check(diff <= 1e-5 * src + e_flip, f"NSTTF accel: a surface's absorbed "
          f"energy differs by {diff / src} of the source")
    widths = [int(m.split(", ")[-1].split()[0]) for m in runs["lightweight"][2]
              if "candidates/ray" in m]
    per_bounce = [float(m.split("trace time ")[1].split()[0])
                  for m in runs["lightweight"][2] if "trace time" in m]
    log(f"NSTTF ray_tracer with and without the Kd tree ({table.num_rows} "
        f"rows, {ACCEL_RAYS} rays, {len(on.records)} bounces): tree build "
        f"{t_tree * 1e3:.1f} ms, {len(tree.nodes)} nodes; first bounce "
        f"{n_cand:.2f} candidates a ray (host traversal {t_cand * 1e3:.0f} "
        f"ms), widths " + ", ".join(map(str, widths)) + ", bounces "
        + ", ".join(f"{x * 1e3:.0f}" for x in per_bounce) + " ms; walls "
        f"accel {runs['lightweight'][1]:.3f} s, brute force (K3) "
        f"{runs[None][1]:.3f} s; {n_flip} lanes flipped, largest surface "
        f"difference {diff / src:.2e} of the source ({card})")
    del runs, on, off, cand

    # (d) a polychromatic bundle on config 3
    n = BENCH_SLAB
    asm, extra = bench_assembly(ptt, 3)
    for s in asm.get_surfaces():
        if s.name == "rec":
            s.optics = ptt.materials.receiver(s.optics)
    table3, meta3 = ptt.compile_scene(asm, extra_features=extra, device=dev)
    _, _, source_fn = bench_scene(3, n, dev)
    mono = source_fn(torch.Generator().manual_seed(16), device=dev)
    grid = torch.as_tensor(silver_table(ptt)[0], dtype=torch.float32,
                           device=dev)
    band = float(grid[-1] - grid[0])
    pb = mono.with_spectra(grid, (mono.energy / band)[:, None].expand(
        n, grid.shape[0]))
    check(float((pb.energy - mono.energy).abs().max())
          < 1e-5 * float(mono.energy.max()), "config 3: the flat spectra's "
          "trapezoids are not the rays' energies")
    t0 = start()
    res = TracerEngine(table3, meta3).ray_tracer(
        pb, generator=gen(17),
        opts=TraceOptions(max_bounces=BENCH[3]["max_path"], record="tags"))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    l3 = only_k3("config 3 polychromatic")
    check(1 <= l3 <= BENCH[3]["max_path"], f"config 3 polychromatic: {l3} "
          "K3 launches")
    launches += l3
    b = res.energy_balance()
    se = b["source"]
    check(abs(b["closure"]) < 1e-4 * se, f"config 3 polychromatic: closure "
          f"{b['closure'] / se}")
    p = (list(res.accum.absorbed.double().numpy() / se)
         + [float(res.accum.medium) / se])
    meta_m, q, em = physics[3]
    within_sigma("config 3 polychromatic", p, n, q, em)
    hits = res.hits_of("rec")
    check(hits["spectra"].shape == (len(hits["e_in"]), grid.shape[0])
          and len(hits["e_in"]) > 0.2 * n
          and np.isfinite(hits["spectra"]).all()
          and np.abs(hits["spectra"]).max() == 0.0,
          f"config 3 polychromatic: receiver spectra "
          f"{hits['spectra'].shape}")
    rec_w = float(res.absorbed_by_logical()[meta3.index_of("rec")])
    check(abs(hits["absorbed"].sum() - rec_w) < 1e-4 * rec_w,
          "config 3 polychromatic: the tagged hits are not the receiver's")
    log(f"config 3 polychromatic ray_tracer (record=\"tags\", receiver "
        f"tagged): {n} rays, {grid.shape[0]} wavelengths, "
        f"{pb.spectra.numel() * pb.spectra.element_size() / 1e6:.1f} MB of "
        f"spectra a bounce, {l3} bounces (K3 launches), {len(hits['e_in'])} "
        f"receiver hits recorded; shares " + ", ".join(f"{x:.5f}" for x in p)
        + " (megakernel " + ", ".join(f"{x:.5f}" for x in q) + f"), closure "
        f"{b['closure'] / se:.1e}; wall {wall:.3f} s ({card})")
    log(f"phase 14: {time.perf_counter() - t14:.1f} s")
    return launches


# phase 15: differentiable tracing and the field analyses
DIFF_RAYS = 1 << 20           # configs 9 and 9b (benchmarks/suite.py:608,
#                               :647)
DIFF_CHECK_RAYS = 65_536      # K3 against its plain version in 9b's step,
#                               config 9 on the card against the CPU
SWEEP_RAYS = 4_194_304        # rays a position of the annual sweep
SWEEP_SLAB = 342 * 3072       # its slab: 342 ray tiles
NSTTF_LATITUDE = 34.96        # Sandia NSTTF, Albuquerque [deg N]


def diff_step_phase(label, make, params, dev, card, kb, kn):
    """A gradient step at the suite's size: ``make()`` builds it; the
    launch counts and the peak memory are reset before it, then a warm-up
    (loss finite and positive, gradient finite and not 0) and three timed
    calls (bench_configs._time_step), then one profiled step and one
    profiled forward (the loss alone, which the checkpoint recomputes in
    the backward). Returns (step, K3 launches of the four calls)."""
    import torch
    from tracer_tpu_torch.models.bench_configs import _time_step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    step, table, beam = make()
    r = _time_step(step, params, dev)
    l3 = kn.nearest_hit.launches
    check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
          == 0, f"{label}: K1 or K2 launched")
    peak = torch.cuda.max_memory_allocated(dev)
    n = beam.num_rays
    log(f"{label}: {table.num_rows} rows, {n} rays, loss {r['loss']:.6g}, "
        f"gradient {r['grad']:.6g}; step walls "
        + ", ".join(f"{w:.4f}" for w in r["walls"])
        + f" s, median {r['wall']:.4f} s = {n / r['wall'] / 1e6:.2f} "
        f"Mrays/s; K3 launches {l3} in {len(params)} steps; peak memory "
        f"{peak / 2 ** 30:.2f} GiB allocated ({(peak - base) / 2 ** 30:.2f}"
        f" GiB over the {base / 2 ** 30:.2f} held before) ({card})")
    p = profile_run(lambda: step(params[1]))
    x = torch.tensor(float(params[1]), dtype=beam.pos.dtype, device=dev,
                     requires_grad=True)
    f = profile_run(lambda: step.loss(x), top=0)
    log(f"{label} profile of one step: wall {p['wall']:.1f} ms under the "
        f"profiler, device busy {p['busy']:.1f} ms in {p['events']} device "
        f"events, host-bound idle {100 * p['idle']:.1f}%; K3 "
        f"{p['kernel']:.2f} ms ({100 * p['kernel'] / p['busy']:.1f}%), the "
        f"gather backward "
        f"{p['gather']:.2f} ms ({100 * p['gather'] / p['busy']:.1f}%), the "
        f"forward (what the checkpoint recomputes) {f['busy']:.1f} ms of "
        f"device time in {f['wall']:.1f} ms ({card})")
    return step, l3, r


def diff_phase(dev, card, kb, kn, nsttf):
    """Phase 15. (a) Config 9 at the suite's size (1,048,576 rays, 3
    bounces, checkpoint): its 2 rows take the differentiable brute
    force, so no kernel launches. (b) Config 9b (1,048,576 rays through
    the 219-row NSTTF table, 2 bounces, checkpoint): the winner of every
    bounce from K3 under no_grad, launched in the forward and again in
    the checkpoint's recompute. Each: loss and gradient finite, the
    gradient not 0; the median wall of three steps after a warm-up in
    Mrays/s; the peak memory; one profiled step (K3's share, the gather
    backward, the host's idle share) and one profiled forward. (c) 9b's
    step at 65,536 rays with K3 and with K3's plain version on the card,
    the same seeds (tests/test_torch_gpu.fast_winner_compare, which
    states the tolerance). (d) Config 9 in float32 on
    the card against the port in float64 on the CPU, one beam cast to
    each, 65,536 rays, 2 bounces: rtol 1e-4 on the loss, 1e-3 on the
    gradient (a float32 hit point carries ~1e-6 m of rounding against the
    f = 1.7 spot's ~0.1 m). (e) field_losses on phase 14's NSTTF
    ray_tracer (262,144 rays, records): both audits below 1e-5 of the
    source. (f) efficiency_sweep of the NSTTF field at three noon
    positions (annual_sun_grid at the site's latitude, 3 days), culled,
    4,194,304 rays a position: |closure| < 5e-3, efficiency and cosine
    efficiency in (0, 1), each position's host build and trace walls.
    Between (b) and (c), the row gather's forward and backward at 9's and
    9b's table sizes, by index_select and by t[s]. Returns the main
    paths' launches (K1, K2, K3)."""
    import numpy as np
    import torch
    from tracer_tpu_torch.analysis.annual import (annual_sun_grid,
                                                  efficiency_sweep)
    from tracer_tpu_torch.analysis.losses import (field_losses,
                                                  projected_areas)
    from tracer_tpu_torch.engine import TracerEngine
    from tracer_tpu_torch.models.bench_configs import (diff_gradient_step,
                                                       dish_beam,
                                                       field_gradient_step)
    from tracer_tpu_torch.models.nsttf import make_source_fn
    t15 = time.perf_counter()
    launches = [0, 0, 0]

    # (a) config 9 and (b) config 9b at the suite's size
    _, l3, _ = diff_step_phase(
        "config 9 gradient step (dish focal length, brute force)",
        lambda: diff_gradient_step(DIFF_RAYS, 3, device=dev),
        [1.7 + 0.01 * i for i in range(4)], dev, card, kb, kn)
    check(l3 == 0, f"config 9: {l3} K3 launches on a 2-row scene")
    _, l3, r9b = diff_step_phase(
        "config 9b gradient step (NSTTF beam tilt, K3's fast winner)",
        lambda: field_gradient_step(DIFF_RAYS, 2, device=dev),
        [1e-4 * i for i in range(4)], dev, card, kb, kn)
    check(l3 > 0 and l3 % 4 == 0, f"config 9b: {l3} K3 launches in four "
          "steps: the fast winner did not run on K3")
    log(f"config 9b: {l3 // 4} K3 launches a step (2 bounces, forward and "
        f"the checkpoint's recompute) ({card})")
    launches[2] += l3

    # the gather backward the step pays: a scene table's row gather of
    # every lane, as the shade and _candidate_t make it (index_select,
    # whose backward is index_add_), against t[s] (index_put_ with
    # accumulate: sorted indices, each row's duplicates summed serially)
    for rows in (2, 219):
        tab = torch.randn(rows, 16, device=dev, requires_grad=True)
        idx = torch.randint(0, rows, (DIFF_RAYS,), device=dev)
        g = torch.randn(DIFF_RAYS, 16, device=dev)
        ms = [time_cuda(lambda: torch.autograd.grad(fn(), tab, g), 5)
              for fn in (lambda: tab.index_select(0, idx), lambda: tab[idx])]
        log(f"row gather of {DIFF_RAYS} lanes from a ({rows}, 16) table, "
            f"forward and backward: index_select {ms[0]:.3f} ms, t[s] "
            f"{ms[1]:.3f} ms ({card})")
    del tab, idx, g

    # (c) K3 against its plain version inside 9b's step
    from test_torch_gpu import fast_winner_compare
    step, table, beam = field_gradient_step(DIFF_CHECK_RAYS, 2, device=dev)
    c = fast_winner_compare(step, table, beam)
    (lk, lp), (gk, gp) = c["loss"], c["grad"]
    log(f"config 9b step with K3 against its plain version "
        f"({DIFF_CHECK_RAYS} rays, 2 bounces, same seeds): loss {lk:.7g} "
        f"against {lp:.7g} (difference {abs(lk - lp):.2e}, tolerance "
        f"{c['tol_loss']:.2e}), gradient {gk:.7g} against {gp:.7g} "
        f"(difference {abs(gk - gp):.2e}, tolerance {c['tol_grad']:.2e}); "
        f"{c['flipped']} lanes with a flipped sid in either bounce ({card})")
    check(abs(lk - lp) <= c["tol_loss"] and abs(gk - gp) <= c["tol_grad"],
          "config 9b: the step with K3 disagrees with its plain version")

    # (d) config 9: the card in float32 against the CPU in float64
    beam64 = dish_beam(DIFF_CHECK_RAYS, torch.float64, "cpu")
    got = diff_gradient_step(DIFF_CHECK_RAYS, 2, device=dev,
                             beam=beam64)[0](1.7)
    want = diff_gradient_step(DIFF_CHECK_RAYS, 2, dtype=torch.float64,
                              device="cpu", beam=beam64)[0](1.7)
    (l32, g32), (l64, g64) = ([float(v) for v in x] for x in (got, want))
    log(f"config 9 in float32 on the card against float64 on the CPU "
        f"({DIFF_CHECK_RAYS} rays, 2 bounces, f = 1.7): loss {l32:.7g} / "
        f"{l64:.7g} (relative {l32 / l64 - 1:.2e}, rtol 1e-4), gradient "
        f"{g32:.7g} / {g64:.7g} (relative {g32 / g64 - 1:.2e}, rtol 1e-3) "
        f"({card})")
    check(abs(l32 / l64 - 1) < 1e-4 and abs(g32 / g64 - 1) < 1e-3,
          "config 9: float32 on the card differs from the CPU's float64")
    del step, table, beam

    # (e) field_losses on phase 14's NSTTF ray_tracer
    table, meta, info = nsttf
    bundle = make_source_fn(info, ACCEL_RAYS)(
        torch.Generator(device=dev).manual_seed(14), device=dev)
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    t0 = time.perf_counter()
    res = TracerEngine(table, meta).ray_tracer(
        bundle, reps=8, generator=torch.Generator(device=dev).manual_seed(15))
    wall = time.perf_counter() - t0
    launches[2] += kn.nearest_hit.launches
    check(kn.nearest_hit.launches == len(res.records) > 1,
          "field_losses: K3 not once a bounce")
    t0 = time.perf_counter()
    fl = field_losses(res, flux=1000.0, proj_areas=projected_areas(
        info["normals"], info["sun"], 6.1 ** 2))
    t_fl = time.perf_counter() - t0
    src = fl["source"]
    a_src = abs(fl["audit_source"]) / src
    a_h = float(np.abs(fl["audit_per_heliostat"]).max()) / src
    log(f"field_losses on the NSTTF ray_tracer ({ACCEL_RAYS} rays, "
        f"{len(res.records)} bounces, trace {wall:.3f} s, attribution "
        f"{t_fl * 1e3:.0f} ms): source {src / 1e3:.2f} kW, incoming "
        f"{fl['incoming'].sum() / 1e3:.2f}, shading "
        f"{fl['shading'].sum() / 1e3:.2f}, mirror "
        f"{fl['mirror'].sum() / 1e3:.2f}, blocked "
        f"{fl['blocked'].sum() / 1e3:.3f}, spilled "
        f"{fl['spilled'].sum() / 1e3:.2f}, delivered "
        f"{fl['delivered'].sum() / 1e3:.2f}, other "
        f"{fl['other'].sum() / 1e3:.3f}, direct receiver "
        f"{fl['direct_receiver'] / 1e3:.3f}, escaped "
        f"{fl['escaped_source'] / 1e3:.2f} kW; audits {a_src:.1e} (source) "
        f"and {a_h:.1e} (largest heliostat) of the source ({card})")
    check(a_src < 1e-5 and a_h < 1e-5, "field_losses: an audit fails")
    del res

    # (f) a three-position annual sweep of the NSTTF field, culled
    angles = annual_sun_grid(np.deg2rad(NSTTF_LATITUDE), n_days=3,
                             n_hours=1)
    check(len(angles) == 3, f"{len(angles)} sweep positions")
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    sw = efficiency_sweep(info["assembly"], info["field"], angles,
                          total_mirror_area=len(info["positions"]) * 6.1 ** 2,
                          rays_per_position=SWEEP_RAYS, slab=SWEEP_SLAB,
                          use_culling=True, generator=21, device=dev)
    launches[0] += kb.bounce_reflect_culled.launches
    launches[1] += kb.bounce_reflect.launches
    check(kb.bounce_reflect_culled.launches > 0 and kn.nearest_hit.launches
          == 0, "annual sweep: not on K1")
    for i in range(3):
        log(f"annual sweep position {i}: azimuth {sw['azimuth'][i]:.4f}, "
            f"zenith {sw['zenith'][i]:.4f}, weight {sw['weight'][i]:.1f} h, "
            f"receiver {sw['receiver_kw'][i]:.1f} kW, efficiency "
            f"{sw['efficiency'][i]:.5f}, cosine efficiency "
            f"{sw['cosine_eff'][i]:.5f}, closure {sw['closure'][i]:.1e}; "
            f"host build (table and culling) {sw['build_s'][i]:.2f} s, "
            f"trace {sw['trace_s'][i]:.3f} s ({card})")
        check(abs(sw["closure"][i]) < 5e-3
              and 0.0 < sw["efficiency"][i] < 1.0
              and 0.0 < sw["cosine_eff"][i] < 1.0,
              f"annual sweep position {i} fails its guards")
    log(f"annual sweep: {SWEEP_RAYS} rays a position (slab {SWEEP_SLAB}), "
        f"K1 launches {kb.bounce_reflect_culled.launches}, K2 "
        f"{kb.bounce_reflect.launches}; annual efficiency "
        f"{sw['annual_efficiency']:.5f} ({sw['excluded_hours']:.0f} h "
        f"excluded), {sw['annual_receiver_mwh']:.1f} MWh ({card})")
    log(f"phase 15: {time.perf_counter() - t15:.1f} s")
    return launches


SIM_RAYS = 4_194_304          # phase 16 (a): simulate(nrays=...)
SIM_BATCH = 1_048_576         # rays a module a batch: 7,340,032 a batch
CURVED_RAYS = 4_194_304       # phase 16 (b): each curved-map trace
STL_RAYS = 1_048_576          # phase 16 (c): the STL receiver's rays
SG4_CPU_RAYS = 262_144        # SG4's lanes held against float64 on the CPU


def target_hits(res, target, n):
    """Every target hit of a ray_tracer run with record="tags", in the
    order of its key (bounce * n + lane): the key, the plate-local point
    and the incident energy, and the target's power map of them
    (Target.power, the binning of Target.evaluate_fluxmap)."""
    import numpy as np
    rows = res._rows_of(target.name)
    keys, locs, es = [], [], []
    for rec in res.records:
        m = np.isin(rec.sid.numpy(), rows) & rec.alive_in.numpy()
        keys.append(int(rec.bounce) * n + rec.slot.numpy()[m])
        locs.append(rec.local.numpy()[m].astype(float))
        es.append(rec.e_in.numpy()[m].astype(float))
    key, loc, e = (np.concatenate(a) for a in (keys, locs, es))
    order = np.argsort(key, kind="stable")
    key, loc, e = key[order], loc[order], e[order]
    return dict(key=key, loc=loc, e=e, map=target.power(loc, e))


def simulator_phase(dev, card, kb, kn):
    """Phase 16 (a): the seven-module high-flux simulator
    (models/solar_simulator.high_flux_simulator: Zhu lamps at 7 kW, 4.2
    kW of light each, 29.4 kW in all; a 0.2 m target of 50 x 50 bins at
    the common second focus) through SolarSimulator.simulate(nrays=
    4,194,304, ray_batch=1,048,576, reps=20): 4 batches of 7,340,032
    rays, after one untimed batch. simulate runs on a TracerEngine
    subclass that keeps each batch's source energy, balance and records'
    energy on the target (its own time is left out of the wall). Guards:
    every batch's closure below 1e-4 of its source and its emitted power
    29.4 kW to 1e-6, the map finite with a non-zero mean and a finite CI,
    the map's integral the energy the records put on the target to 1e-5,
    K3 once a bounce and K1 and K2 never. Then one batch again from one
    generator state with K3 (profiled) and with K3's plain version: at
    most 1e-5 of the lanes plus one flip their sid in the first bounce;
    the target hits of the lanes that agree in every bounce are the same
    (bounce, lane) pairs in both runs, with equal energies and points at
    most 1e-5 (1 + |p|) apart (rounding); the maps' totals differ by no
    more than the diverged lanes' energy. Printed: the wall in all and a
    batch, Mrays/s, K3's launches and its ms a launch on a batch's lamp
    rays beside its plain version's and its bound, the profiled batch's
    device time and its device-to-host copies, one batch's host binning
    (Target.evaluate_fluxmap), the target's share of the lamp power.
    Returns K3's launches in simulate."""
    import numpy as np
    import torch
    from tracer_tpu_torch.analysis.estimator import Estimator
    from tracer_tpu_torch.engine import TraceOptions, TracerEngine
    from tracer_tpu_torch.kernels.bounce import pack_rows
    from tracer_tpu_torch.models.solar_simulator import high_flux_simulator
    from test_torch_gpu import k3_compare
    sim = high_flux_simulator()
    target = sim.targets[0]
    batches, audit = [], [0.0]

    class Audited(TracerEngine):
        def ray_tracer(self, bundle, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            src = float(bundle.energy.double().sum())
            audit[0] += time.perf_counter() - t0
            res = super().ray_tracer(bundle, **kw)
            t0 = time.perf_counter()
            e_in = res.hits_of(target.name, keys=("e_in",))["e_in"]
            batches.append(dict(src=src, bal=res.energy_balance(),
                                e_in=float(e_in.sum())))
            audit[0] += time.perf_counter() - t0
            return res
    engine = Audited(sim, device=dev)
    table = engine.scene
    power = sum(m.lamp.P for m in sim.modules)
    check(len(sim.modules) == 7 and abs(power - 29400.0) < 1e-9,
          f"simulator: {len(sim.modules)} modules, {power} W")
    gen = torch.Generator(device=dev).manual_seed(16)
    sim.simulate(65_536, ray_batch=65_536,
                 generator=gen, device=dev, engine=engine)
    target.fluxmap = Estimator()
    batches.clear()
    audit[0] = 0.0
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.simulate(SIM_RAYS, ray_batch=SIM_BATCH, generator=gen, reps=20,
                 device=dev, engine=engine)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0 - audit[0]
    launches = kn.nearest_hit.launches
    check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
          == 0, "K1/K2 launched on the simulator")
    n_batch = len(sim.modules) * SIM_BATCH
    check(len(batches) == SIM_RAYS // SIM_BATCH, f"{len(batches)} batches")
    for i, b in enumerate(batches):
        bal = b["bal"]
        check(abs(b["src"] - power) < 1e-6 * power,
              f"simulator batch {i}: emitted {b['src']} W")
        check(abs(bal["closure"]) < 1e-4 * bal["source"],
              f"simulator batch {i}: closure {bal['closure']}")
    mean, ci = np.asarray(target.fluxmap.mean), np.asarray(target.fluxmap.ci)
    check(mean.shape == (50, 50) and np.isfinite(mean).all()
          and mean.sum() > 0 and np.isfinite(ci).all(),
          "simulator: the target map or its CI not finite, or empty")
    on_target = float(np.mean([b["e_in"] for b in batches]))
    integral = float((mean * target.areas).sum())
    check(abs(integral - on_target) <= 1e-5 * on_target,
          f"simulator: map integral {integral} vs records {on_target}")
    batch_wall = wall / len(batches)

    # K3 on a batch's lamp rays: time, plain version, bound
    rays = sim.fire(torch.Generator(device=dev).manual_seed(7), SIM_BATCH,
                    device=dev)
    args = (pack_rows(table), rays.pos, rays.dir, table.groups, F32_T_EPS)
    kw = dict(need_local=True, backside_miss=False)
    got = kn.nearest_hit(*args, **kw)
    want = kn.nearest_hit_ref(*args, **kw)
    ties, flips = k3_compare(got, want, kn.nearest_two_t(*args), rays.pos,
                             rays.dir, max_flips=int(1e-5 * n_batch) + 1)
    hit = (want[1] >= 0) & (got[1] == want[1])
    t_err = float((got[0] - want[0]).abs()[hit].max())
    del got, want
    k_ms = min(time_cuda(lambda: kn.nearest_hit(*args, **kw), 10)
               for _ in range(2))
    p_ms = time_cuda(lambda: kn.nearest_hit_ref(*args, **kw), 2)
    bnd = k3_bound(table, n_batch)

    # one batch with K3 (profiled) and with its plain version, one
    # generator state, on an engine of its own
    rerun = TracerEngine(sim, device=dev)
    g = torch.Generator(device=dev).manual_seed(161)
    state = g.get_state()
    real, runs, out = kn.nearest_hit, {}, {}
    for name, fn in (("K3", real), ("plain", kn.nearest_hit_ref)):
        sids = []

        def spy(*a, fn=fn, sids=sids, **k):
            o = fn(*a, **k)
            sids.append(o[1].clone())
            return o
        spy.launches = 0           # comparison launches count nowhere

        def run():
            out[name] = rerun.ray_tracer(
                sim.fire(g, SIM_BATCH, device=dev), generator=g,
                opts=TraceOptions(max_bounces=20, record="tags"))
        g.set_state(state)
        kn.nearest_hit = spy
        try:
            if name == "K3":
                prof = profile_run(run, kernel_key="DtoH", top=6)
            else:
                run()
        finally:
            kn.nearest_hit = real
        runs[name] = (sids, target_hits(out[name], target, n_batch))
    check(prof["kernel"] > 0, "simulator: the profile shows no "
          "device-to-host copies")
    t0 = time.perf_counter()
    target.evaluate_fluxmap(out["K3"])
    binning = time.perf_counter() - t0
    log(f"simulator (7 Zhu modules, {power / 1e3:.1f} kW of lamp light, "
        f"target 0.2 m, 50 x 50 bins): {len(batches)} batches of {n_batch}"
        f" rays, {len(batches) * n_batch} in all; wall {wall:.3f} s "
        f"({batch_wall:.3f} s a batch; the audit's {audit[0]:.3f} s left "
        f"out), {len(batches) * n_batch / wall / 1e6:.1f} Mrays/s; K3 "
        f"launches {launches} ({launches / len(batches):.1f} a batch); "
        f"target {on_target:.1f} W = {on_target / power:.5f} of the lamp "
        f"power, peak {mean.max() / 1e3:.1f} kW/m^2 (CI {ci.max() / 1e3:.2f})"
        f"; closures " + ", ".join(f"{b['bal']['closure'] / power:.1e}"
                                  for b in batches) + f" ({card})")
    log(f"simulator batch profiled: wall {prof['wall']:.1f} ms under the "
        f"profiler, device busy {prof['busy']:.1f} ms (idle "
        f"{100 * prof['idle']:.1f}%), device-to-host copies "
        f"{prof['kernel']:.1f} ms ({100 * prof['kernel'] / 1e3 / batch_wall:.1f}"
        f"% of a batch's wall); one batch's host binning "
        f"(Target.evaluate_fluxmap) {binning:.3f} s "
        f"({100 * binning / batch_wall:.1f}%) ({card})")
    log(f"K3 on a simulator batch's lamp rays: {n_batch} lanes, "
        f"{table.num_rows} rows (seven general quadrics and the target), "
        f"sid ties {ties}, flips {flips}, max abs err t {t_err:.2e}; kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {bnd[0]:.4f} ms "
        f"({bnd[1]}); {k3_geometry_line(kn, args[0], n_batch, kw)} ({card})")

    (sk, hk), (sp, hp) = runs["K3"], runs["plain"]
    diverged = torch.zeros(n_batch, dtype=torch.bool, device=dev)
    for b in range(max(len(sk), len(sp))):
        none = torch.full((n_batch,), -1, dtype=torch.int32, device=dev)
        k3_s = sk[b] if b < len(sk) else none
        pl_s = sp[b] if b < len(sp) else none
        if b == 0:
            first = int((k3_s != pl_s).sum())
        diverged |= k3_s != pl_s
    div = diverged.cpu().numpy()
    # the lanes that agree in every bounce hit the target at the same
    # (bounce, lane) in both runs, with the same energy, at points that
    # differ by rounding
    same = [~div[h["key"] % n_batch] for h in (hk, hp)]
    check(np.array_equal(hk["key"][same[0]], hp["key"][same[1]]),
          "simulator: the agreeing lanes' target hits differ")
    a, b = hk["loc"][same[0]], hp["loc"][same[1]]
    d_loc = np.abs(a - b).max(axis=1)
    over = d_loc / (1e-5 * (1.0 + np.abs(a).max(axis=1)))
    ea, eb = hk["e"][same[0]], hp["e"][same[1]]
    e_err = float(np.abs(ea - eb).max() / np.abs(ea).max())
    e_div = float(hk["e"][~same[0]].sum() + hp["e"][~same[1]].sum())
    tot = abs(float(hk["map"].sum() - hp["map"].sum()))
    check(first <= int(1e-5 * n_batch) + 1,
          f"simulator: {first} lanes flipped in the first bounce")
    check(over.max() <= 1.0, f"simulator: agreeing target hits "
          f"{d_loc.max()} m apart, {over.max()} x 1e-5 (1 + |p|)")
    check(e_err <= 1e-6, f"simulator: agreeing target hits' energies "
          f"differ by {e_err} of the largest")
    check(tot <= e_div + 1e-6 * float(hk["map"].sum()),
          f"simulator: map totals differ by {tot} W against {e_div} W "
          "diverged")
    diff = np.abs(hk["map"] - hp["map"])
    log(f"simulator batch with K3 and with its plain version (same "
        f"generator state, {n_batch} rays, {len(sk)} and {len(sp)} "
        f"bounces): {first} lanes flipped in the first bounce, "
        f"{int(div.sum())} diverged in any ({e_div:.4f} W on the target in "
        f"the two runs); the other {len(a)} target hits at most "
        f"{d_loc.max():.2e} m apart ({over.max():.3f} of 1e-5 (1 + |p|)), "
        f"energies within {e_err:.1e}; {int((diff > 0).sum())} bins differ, "
        f"at most {diff.max():.4f} W of a {hk['map'].max():.2f} W peak bin, "
        f"totals by {tot:.4f} W ({card})")
    return launches


def curved_maps_phase(dev, card, kb, kn):
    """Phase 16 (b): curved device flux maps through trace_fused at
    4,194,304 rays each: config 5's cavity (benchmarks/suite.py:695) lit
    through its aperture (tests/models/test_model_zoo.py:77-79), its
    conical frustum and its cylinder binned axially at resolution 50;
    SG4 at full size (25 m, f = 13.4 m, absMirrors 0.1, sigma 2e-3) under
    the test's 1,000 W/m^2 sun disk, its outer dish binned polar. Guards:
    each map's sum the energy absorbed on its rows to 1e-5, trace_fused's
    closure below 1e-4, and each map within 1e-4 (L1, of its total) of the
    host histogram (analysis/fluxmap.surface_fluxmap) of a ray_tracer run
    of the same rays: the two draw the same numbers from the same
    generator seed (test_torch_gpu.curved_map_compare, which shuts the K3
    epilogue's gate: the epilogue draws from its own Philox stream). Then
    the same rays through the default trace_fused, which takes the K3
    epilogue (its gate must hold): the epilogue launched after each K3
    launch, closure below 1e-4, each map's sum the energy absorbed on its
    rows to 1e-5, and each map and each row's absorbed energy against the
    gate-shut trace's, whose draws differ, within 3 sigma
    (test_torch_gpu.share_z on each row and each map's total: the disk
    sun's rays carry equal energy; maps_agree on the bins, each bin's
    sigma from ray_tracer's records of the gate-shut trace's draws). Then
    K3 on SG4's two layers, 1e-4 m apart (test_torch_gpu.sg4_k3_compare):
    on the 4,194,304 sun rays of the first bounce and on the rays that
    leave the dish after it, against its plain version, and on 262,144
    lanes of each against the plain version in float64 on the CPU, with a tie
    band narrower than the gap; at most 1e-5 of the lanes plus one flip.
    Returns the launches of K3 and of the K3 epilogue."""
    import torch
    from tracer_tpu_torch.models.sg4 import SG4
    from tracer_tpu_torch.models.two_n_cavity import TwoNParamCav
    from tracer_tpu_torch.scene import compile_scene
    from tracer_tpu_torch.sources import solar_disk_bundle
    from test_torch_gpu import SG4_TIE, curved_map_compare, sg4_k3_compare
    cases = (
        ("config 5 cavity", TwoNParamCav(
            apertureRadius=0.3, frustaRadii=[0.5, 0.5],
            frustaDepths=[0.4, 0.4], coneDepth=0.3, el_FRUs=[2, 2],
            el_CON=2), ("frustum_0", "frustum_1"),
         dict(center=[0, 0, 0.01], direction=[0, 0, 1.0], radius=0.29,
              ang_range=0.05, flux=5e5), 30),
        ("SG4", SG4(dishDiameter=25.0, dishFocus=13.4, absMirrors=0.1,
                    sigma=2e-3), ("dish_outer",),
         dict(center=[0, 0, 30.0], direction=[0, 0, -1.0], radius=13.0,
              ang_range=0.005, flux=1000.0), 20))
    launches = epi_launches = 0
    for label, asm, names, beam, bounces in cases:
        table, meta = compile_scene(asm, device=dev)
        sun = solar_disk_bundle(torch.Generator(device=dev).manual_seed(6),
                                CURVED_RAYS, device=dev, **beam)
        src = float(sun.energy.double().sum())
        reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                       kn.nearest_hit)
        maps, acc, final, wall = curved_map_compare(table, meta, names, sun,
                                                    16, bounces)
        launches += kn.nearest_hit.launches
        check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
              == epilogue().launches == 0,
              f"{label}: K1/K2 or the K3 epilogue launched")
        closure = (src - float(acc.absorbed.double().sum())
                   - float(acc.escaped) - float(acc.culled)
                   - float(final.total_energy())) / src
        check(abs(closure) < 1e-4, f"{label}: closure {closure}")
        for nm in names:
            c = maps[nm]
            kind = meta.surfaces[meta.index_of(nm)].geometries[0].kind
            hsum = float(c["hist"].sum())
            check(c["absorbed"] > 0 and abs(hsum - c["absorbed"])
                  <= 1e-5 * c["absorbed"],
                  f"{label} {nm}: map {hsum} vs absorbed {c['absorbed']}")
            check(c["l1"] < 1e-4, f"{label} {nm}: device map {c['l1']} "
                  "(L1 over the total) from the host histogram")
            log(f"{label} device flux map of {nm} ({kind}, 50 x 50): "
                f"{CURVED_RAYS} rays, absorbed {c['absorbed']:.1f} W "
                f"({c['absorbed'] / src:.4f} of the source), map sum / "
                f"absorbed - 1 = {hsum / c['absorbed'] - 1:.1e}, peak "
                f"{c['device'].max() / 1e3:.2f} kW/m^2, L1 from the host "
                f"histogram (same generator, same draws) {c['l1']:.1e} of "
                f"the total ({card})")
        log(f"{label} trace_fused: {CURVED_RAYS} rays, closure "
            f"{closure:.1e}, wall {wall:.3f} s, "
            f"{CURVED_RAYS / wall / 1e6:.1f} Mrays/s, K3 launches in it and "
            f"the ray_tracer {kn.nearest_hit.launches} ({card})")
        epi_launches += epilogue_maps(label, table, meta, names, sun, src,
                                      bounces, acc, maps, card)
        launches += kn.nearest_hit.launches
        if label != "SG4":
            continue
        for b, c in enumerate(sg4_k3_compare(asm, table, sun, SG4_CPU_RAYS)):
            log(f"K3 on SG4's layers, bounce {b + 1}: {c['n']} lanes, "
                f"{c['two']} crossing two rows; against its plain version "
                f"{c['diff']} sids differ, ties (within {SG4_TIE:g} (L + t))"
                f" {c['ties']}, flips {c['flips']}; against float64 on the "
                f"CPU ({c['m']} lanes) {c['diff64']} sids differ, ties "
                f"{c['ties64']}, flips {c['flips64']} ({card})")
    return launches, epi_launches


def epilogue_maps(label, table, meta, names, sun, src, bounces, plain,
                  maps, card):
    """Phase 16 (b)'s trace through the K3 epilogue (the default
    trace_fused, its gate held) against the gate-shut trace's
    accumulators ``plain`` and maps ``maps`` (curved_map_compare's), under
    curved_maps_phase's guards. Returns the epilogue's launches; K3's are
    left on its counter."""
    import torch
    from tracer_tpu_torch import engine
    from tracer_tpu_torch.analysis.device_fluxmap import flux_plan
    from tracer_tpu_torch.engine import trace_fused
    from tracer_tpu_torch.kernels import bounce as kb
    from tracer_tpu_torch.kernels import nearest as kn
    from test_torch_gpu import map_distance, maps_agree, share_z
    specs = tuple(flux_plan(meta, nm, resolution=50) for nm in names)
    check(engine._epilogue_ok(table, sun, specs),
          f"{label}: the K3 epilogue's gate is shut")
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, acc = trace_fused(table, sun,
                             torch.Generator(device=sun.pos.device)
                             .manual_seed(17), max_bounces=bounces,
                             fluxspecs=specs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    l3, le = kn.nearest_hit.launches, epilogue().launches
    check(le == l3 > 0, f"{label}: {le} K3 epilogue launches for {l3} K3 "
          "launches")
    n = sun.num_rays
    closure = (src - float(acc.absorbed.double().sum())
               - float(acc.escaped) - float(acc.culled)
               - float(final.total_energy())) / src
    check(abs(closure) < 1e-4, f"{label} K3 epilogue: closure {closure}")
    rows_a = acc.absorbed.double().cpu().numpy()
    rows_p = plain.absorbed.double().cpu().numpy()
    z_rows = max(share_z(x, y, src, n) for x, y in zip(rows_a, rows_p))
    check(z_rows <= 3.0, f"{label} K3 epilogue: a row's absorbed energy "
          f"{z_rows} sigma from the gate-shut trace's")
    for nm, spec, hist in zip(names, specs, acc.flux):
        c = maps[nm]
        h = hist.double().cpu().numpy()
        absorbed = float(rows_a[list(spec.rows)].sum())
        check(absorbed > 0 and abs(h.sum() - absorbed) <= 1e-5 * absorbed,
              f"{label} {nm} K3 epilogue: map {h.sum()} vs absorbed "
              f"{absorbed}")
        z_tot = share_z(float(h.sum()), float(c["hist"].sum()), src, n)
        r, limit = map_distance(h, c["hist"], c["sq"])
        check(maps_agree(h, c["hist"], c["sq"], src, n), f"{label} {nm} "
              f"K3 epilogue: total z {z_tot}, squared distance {r} of its "
              f"mean, 3-sigma limit {limit}")
        log(f"{label} device flux map of {nm} through the K3 epilogue: "
            f"absorbed {absorbed:.1f} W (gate shut {c['absorbed']:.1f} W, "
            f"z {z_tot:.2f}), map sum / absorbed - 1 = "
            f"{h.sum() / absorbed - 1:.1e}; squared distance from the "
            f"gate-shut map {r:.3f} of its mean (3-sigma limit "
            f"{limit:.3f}), largest row z {z_rows:.2f} ({card})")
    log(f"{label} trace_fused through the K3 epilogue: {n} rays, {l3} K3 "
        f"and {le} epilogue launches, closure {closure:.1e}, wall "
        f"{wall:.3f} s, {n / wall / 1e6:.1f} Mrays/s ({card})")
    return le


def stl_phase(dev, card, kb, kn):
    """Phase 16 (c): a CAD receiver from STL (test_torch_gpu.stl_receiver:
    the 48-gon cylinder wall, 1,008 vertices and 1,920 faces, written by
    make_stl to a temporary directory and loaded by load_stl_into_tracer
    as a receiving absorber) under 1,048,576 parallel rays across its
    axis over a 1.2 x 0.9 m window (test_torch_gpu.stl_rays), through
    ray_tracer on K3. Guards: closure below 1e-5; the hit share the
    48-gon's projected width (from the mesh's vertices) over 1.2 m within
    3 binomial sigma; K3 against its plain version on the first bounce
    (k3_compare: ties on shared edges counted, at most 1e-5 of the lanes
    plus one flipped). Printed: K3's ms a call on the 1,920-row table
    beside its plain version's and its bound (k3_bound), its launch
    geometry. Returns K3's launches."""
    import tempfile
    import torch
    from tracer_tpu_torch.bundle import RayBundle
    from tracer_tpu_torch.engine import TracerEngine
    from tracer_tpu_torch.kernels.bounce import pack_rows
    from test_torch_gpu import STL_WINDOW, k3_compare, stl_rays, stl_receiver
    with tempfile.TemporaryDirectory() as d:
        table, meta, verts = stl_receiver(d, dev)
    check(table.num_rows == 1920 and len(table.groups) == 1,
          f"STL receiver: {table.num_rows} rows, {table.groups}")
    n = STL_RAYS
    pos, dirs = stl_rays(n, 16, dev)
    bundle = RayBundle.create(pos=pos, dir=dirs, energy=1.0 / n, device=dev)
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = TracerEngine(table, meta).ray_tracer(bundle, reps=4)
    wall = time.perf_counter() - t0
    launches = kn.nearest_hit.launches
    check(launches == len(res.records) and kb.bounce_reflect.launches == 0
          and kb.bounce_reflect_culled.launches == epilogue().launches == 0,
          f"STL: {launches} K3 launches for {len(res.records)} bounces")
    bal = res.energy_balance()
    check(abs(bal["closure"]) < 1e-5 * bal["source"],
          f"STL: closure {bal['closure']}")
    share = float((res.records[0].sid >= 0).double().mean())
    p = float(verts[:, 1].max() - verts[:, 1].min()) / STL_WINDOW[0]
    sig = (p * (1 - p) / n) ** 0.5
    check(abs(share - p) < 3 * sig, f"STL: hit share {share} vs {p}")
    rows = pack_rows(table)
    args = (rows, pos, dirs, table.groups, F32_T_EPS)
    kw = dict(need_local=True, backside_miss=False)
    got = kn.nearest_hit(*args, **kw)
    want = kn.nearest_hit_ref(*args, **kw)
    ties, flips = k3_compare(got, want, kn.nearest_two_t(*args), pos, dirs,
                             max_flips=int(1e-5 * n) + 1)
    hit = (want[1] >= 0) & (got[1] == want[1])
    t_err = float((got[0] - want[0]).abs()[hit].max())
    del got, want
    k_ms = min(time_cuda(lambda: kn.nearest_hit(*args, **kw), 10)
               for _ in range(2))
    p_ms = time_cuda(lambda: kn.nearest_hit_ref(*args, **kw), 2)
    bnd = k3_bound(table, n)
    log(f"STL receiver (48-gon cylinder, {len(verts)} vertices, "
        f"{table.num_rows} triangle rows): {n} rays, {len(res.records)} "
        f"bounces, wall {wall:.3f} s, closure {bal['closure']:.1e}, hit "
        f"share {share:.5f} against {p:.5f} (3 sigma {3 * sig:.1e}); K3 vs "
        f"plain on the first bounce: sid ties (shared edges) {ties}, flips "
        f"{flips}, max abs err t {t_err:.2e}; kernel {k_ms:.4f} ms, plain "
        f"{p_ms:.3f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}); "
        f"{k3_geometry_line(kn, rows, n, kw)} ({card})")
    return launches


def model_phase(dev, card, kb, kn):
    """Phase 16: the model library on K3, (a) the simulator, (b) curved
    device maps, (c) the STL receiver. Returns the launches of K3 and of
    the K3 epilogue on their main paths."""
    t16 = time.perf_counter()
    sim = simulator_phase(dev, card, kb, kn)
    curved, epi = curved_maps_phase(dev, card, kb, kn)
    launches = [sim, curved, stl_phase(dev, card, kb, kn)]
    log(f"phase 16: {time.perf_counter() - t16:.1f} s, K3 launches "
        + " + ".join(str(n) for n in launches)
        + f", K3 epilogue launches {epi}")
    return sum(launches), epi


P17_SEED = 17
P17_CUT = 8                   # phase 17 (a)'s float64 config 1: 8 slabs


def free_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def walls3(run):
    """One warm-up call of ``run``, then three timed (synchronized) calls:
    (the last call's result, (min, median, max) walls in s)."""
    import torch
    run()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    walls.sort()
    return out, tuple(walls)


def walls_text(walls, n) -> str:
    return (f"walls min {walls[0]:.3f}, median {walls[1]:.3f}, max "
            f"{walls[2]:.3f} s, {n / walls[1] / 1e6:.1f} Mrays/s")


def float64_phase(dev, card, kb, kn, p_ref):
    """Phase 17 (a): float64 traces on the card, the oracle's nearest hits
    and the unfused shade on CUDA tensors. The MiniDish through
    trace_fused at 4,194,304 rays (closure, receiver within 3 sigma of
    phase 6's reference) and its first 65,536 rays against the same
    float64 trace on the CPU (the MiniDish draws nothing: per-row sums
    within 1e-9 relative); config 1 on the general streaming path at 8
    slabs (cut from the suite's 128: the float64 oracle's rounds are
    slower than K2's): full emission, closure below 1e-9, receiver within
    3 sigma of phase 6's reference. No kernel may launch."""
    import torch
    from tracer_tpu_torch.engine import (energy_closure, trace_fused,
                                         trace_streaming)
    from tracer_tpu_torch.models.bench_configs import (BENCH, bench_scene,
                                                       max_rounds)
    f64 = torch.float64
    n_md = P17_SIZES["md_lanes"]
    _, table, meta = minidish_scene(dev, f64)
    rec_i = meta.names.index("receiver")
    sun = head(minidish_sun(n_md, dev), n_md, dtype=f64)
    reset_launches(kb.bounce_reflect_culled, kb.bounce_reflect,
                   kn.nearest_hit)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, acc = trace_fused(table, sun, max_bounces=20)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    src = float(sun.total_energy())
    ab = acc.absorbed.cpu().numpy()
    closure = (src - ab.sum() - float(acc.escaped) - float(acc.culled)
               - float(final.total_energy())) / src
    check(acc.absorbed.dtype == f64 and abs(closure) < 1e-9,
          f"float64 MiniDish: closure {closure}")
    p = float(acc.absorbed.cpu()[torch.as_tensor(
        meta.row_logical == rec_i)].sum()) / src
    within_sigma("float64 MiniDish receiver", [p], n_md, [p_ref], MD_CPU)
    _, t_cpu, _ = minidish_scene("cpu", f64)
    h = head(sun, MD_CPU)
    _, a_dev = trace_fused(table, h, max_bounces=20)
    _, a_cpu = trace_fused(t_cpu, head(h, MD_CPU, "cpu"), max_bounces=20)
    got, want = a_dev.absorbed.cpu(), a_cpu.absorbed
    rel = float(((got - want).abs() / want.abs().clamp(min=1e-300))
                [want > 0].max())
    check(rel < 1e-9 and bool((got[want == 0] == 0).all()),
          f"float64 MiniDish head: per-row relative difference {rel}")
    log(f"float64 MiniDish trace_fused on the card: {n_md} rays, "
        f"receiver fraction {p:.5f} (phase 6's reference {p_ref:.5f}), "
        f"closure {closure:.1e}, wall {wall:.3f} s; its first {MD_CPU} rays "
        f"against the CPU's float64 trace: per-row sums within {rel:.1e} "
        f"relative ({card})")

    slab = BENCH_SLAB
    total = P17_CUT * slab
    table, meta, source_fn = bench_scene(1, slab, dev, dtype=f64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc, em, se = trace_streaming(
        table, source_fn, torch.Generator().manual_seed(P17_SEED), total,
        max_rounds=max_rounds(1, 4 * P17_CUT),
        max_path=BENCH[1]["max_path"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    closure = energy_closure(acc, se)
    p = surface_fraction(meta, acc.absorbed.cpu().numpy() / float(se),
                         "receiver")
    check(acc.absorbed.dtype == f64 and int(em) == total
          and abs(closure) < 1e-9,
          f"float64 config 1: emitted {int(em)}, closure {closure}")
    within_sigma("float64 config 1 receiver", [p], total, [p_ref], MD_CPU)
    check(kb.bounce_reflect_culled.launches == kb.bounce_reflect.launches
          == kn.nearest_hit.launches == epilogue().launches == 0,
          "a kernel ran in float64")
    log(f"float64 config 1 on the general streaming path on the card: "
        f"{total} rays (cut from the suite's {BENCH_ROUNDS * slab}), "
        f"receiver fraction {p:.5f}, closure {closure:.1e}, wall "
        f"{wall:.3f} s, {total / wall / 1e6:.1f} Mrays/s; no kernel "
        f"launched ({card})")


def nccl_phase(dev, card, kb, kn, p_ref, slab, culling, fspec, phase5):
    """Phase 17 (b): one rank over NCCL (init_process_group("nccl",
    world_size=1)). trace_sharded of the MiniDish at 4,194,304 rays
    equal bit for bit to trace_fused with the rank's generator;
    trace_streaming_sharded of config 1 at the suite's 89,653,248 rays
    (full emission, closure below 1e-4, receiver within 3 sigma of phase
    6's reference); the culled NSTTF at bench size on phase 5's culling
    (mesh_devices=1) under bench.py's guards, its receiver within 3 sigma
    of phase 5's. Returns (K1, K2, K3, K3 epilogue) launches and the
    one-rank results phase 17 (c) holds its ranks to."""
    import torch
    import torch.distributed as dist
    from tracer_tpu_torch import parallel
    from tracer_tpu_torch.engine import energy_closure, trace_fused
    from tracer_tpu_torch.models.bench_configs import (BENCH, bench_scene,
                                                       max_rounds)
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn
    t0 = time.perf_counter()
    # NCCL on the card (gloo only for a dry run on the CPU)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}",
                            world_size=1, rank=0)
    setup = time.perf_counter() - t0
    out = {}
    launches = [0, 0, 0, 0]
    wrappers = (kb.bounce_reflect_culled, kb.bounce_reflect, kn.nearest_hit,
                epilogue())
    try:
        n_md = P17_SIZES["md_lanes"]
        _, md_table, md_meta = minidish_scene(dev)
        sun = minidish_sun(n_md, dev)
        reset_launches(*wrappers)
        (final, acc), walls = walls3(lambda: parallel.trace_sharded(
            md_table, sun, P17_SEED, max_bounces=20))
        launches = [w.launches for w in wrappers]
        # the K3 epilogue after each K3 launch on the card (CUDA float32)
        check(launches[3] == (launches[2] if dev.type == "cuda" else 0),
              f"NCCL trace_sharded: K3 {launches[2]}, K3 epilogue "
              f"{launches[3]} launches")
        final_f, acc_f = trace_fused(
            md_table, sun, parallel.rank_generator(P17_SEED, 0, dev),
            max_bounces=20)
        for name in ("absorbed", "escaped", "culled"):
            check(torch.equal(getattr(acc, name), getattr(acc_f, name)),
                  f"NCCL trace_sharded: {name} differs from trace_fused")
        check(torch.equal(final.pos, final_f.pos)
              and torch.equal(final.energy, final_f.energy),
              "NCCL trace_sharded: final rays differ from trace_fused")
        src = float(sun.total_energy())
        rec = torch.as_tensor(md_meta.row_logical
                              == md_meta.names.index("receiver"))
        p = float(acc.absorbed.double().cpu()[rec].sum()) / src
        out["minidish"] = (acc.absorbed.double().cpu().numpy() / src,
                           n_md)
        log(f"NCCL 1 rank trace_sharded MiniDish: {n_md} rays, receiver"
            f" fraction {p:.5f}, equal bit for bit to trace_fused with the "
            f"rank's generator; {walls_text(walls, n_md)} ({card})")

        table, meta, source_fn = bench_scene(1, BENCH_SLAB, dev)
        total = BENCH_ROUNDS * BENCH_SLAB
        l0 = [w.launches for w in wrappers]
        (acc, em, se), walls = walls3(
            lambda: parallel.trace_streaming_sharded(
                table, source_fn, P17_SEED, total,
                max_rounds=max_rounds(1, BENCH_ROUNDS),
                max_path=BENCH[1]["max_path"]))
        launches = [a + w.launches - b
                    for a, w, b in zip(launches, wrappers, l0)]
        closure = energy_closure(acc, se)
        p = surface_fraction(meta, acc.absorbed.double().cpu().numpy()
                             / float(se), "receiver")
        check(int(em) >= total and abs(closure) < 1e-4,
              f"NCCL config 1: emitted {int(em)}, closure {closure}")
        within_sigma("NCCL config 1 receiver", [p], int(em), [p_ref],
                     MD_CPU)
        log(f"NCCL 1 rank trace_streaming_sharded config 1: {int(em)} rays "
            f"(slab {BENCH_SLAB}), receiver fraction {p:.5f}, closure "
            f"{closure:.1e}; {walls_text(walls, int(em))} ({card})")

        table, meta, info = build_scene(device=dev)
        source_fn = make_source_fn(info, slab)
        total = P17_SIZES["mesh_slabs"] * slab
        l0 = [w.launches for w in wrappers]
        (acc, em, se), walls = walls3(
            lambda: parallel.trace_streaming_sharded(
                table, source_fn, P17_SEED, total, max_rounds=600,
                max_path=8, min_energy=1e-6, culling=culling,
                fluxspecs=(fspec,)))
        launches = [a + w.launches - b
                    for a, w, b in zip(launches, wrappers, l0)]
        rec_frac, closure, flux_rec = check_trace(
            "NCCL culled NSTTF", acc, em, se, total, energy_closure)
        within_sigma("NCCL culled NSTTF receiver", [rec_frac], int(em),
                     [phase5[0]], phase5[1])
        log(f"NCCL 1 rank culled NSTTF: {int(em)} rays, {culling.nb} tiles "
            f"(mesh_devices {culling.mesh_devices}), receiver fraction "
            f"{rec_frac:.5f} (phase 5 {phase5[0]:.5f}), "
            f"closure {closure:.1e}, flux/receiver {flux_rec:.6f}; "
            f"{walls_text(walls, int(em))} ({card})")
    finally:
        dist.destroy_process_group()
    log(f"NCCL set-up (init_process_group) {setup:.2f} s; launches K1 "
        f"{launches[0]}, K2 {launches[1]}, K3 {launches[2]}, K3 epilogue "
        f"{launches[3]}")
    return launches, out


# phase 17's sizes: the NSTTF traces' slabs (bench size, the forced
# segments' run) and the MiniDish's rays
P17_SIZES = dict(mesh_slabs=256, segment_slabs=32, md_lanes=MD_LANES)


def rank17(rank, world, port, results, device, sizes, slab, culling_mesh,
           culling1, fspec):
    """One rank of phase 17 (c), spawned: the gloo group, its scenes on
    ``device`` (the card, or the CPU for a dry run), then each workload
    once untimed and three times between barriers. Rank 0 puts the
    reduced results, every rank its launches and walls, on ``results``; a
    rank prints nothing."""
    import torch
    import torch.distributed as dist
    t0 = time.perf_counter()
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    from tracer_tpu_torch import parallel
    from tracer_tpu_torch.kernels import bounce as kb
    from tracer_tpu_torch.kernels import build
    from tracer_tpu_torch.kernels import nearest as kn
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn
    if dev.type == "cuda":
        build.load()
    table, meta, info = build_scene(device=dev)
    source_fn = make_source_fn(info, slab)
    _, md_table, _ = minidish_scene(dev)
    sun = minidish_sun(sizes["md_lanes"], dev)
    dist.barrier()
    setup = time.perf_counter() - t0
    wrappers = (kb.bounce_reflect_culled, kb.bounce_reflect, kn.nearest_hit,
                epilogue())
    def nsttf(cul, slabs, **kw):
        # the parked culling's emit -> drain cycles take ~10x the rounds
        # of an unparked trace (phase 12): max_rounds as phase 12's
        return lambda n=slabs: parallel.trace_streaming_sharded(
            table, source_fn, P17_SEED, n * slab, max_rounds=20_000,
            max_path=8, min_energy=1e-6, culling=cul, fluxspecs=(fspec,),
            **kw)
    runs = {
        "nsttf_mesh": nsttf(culling_mesh, sizes["mesh_slabs"]),
        "nsttf_segments": nsttf(culling1, sizes["segment_slabs"],
                                _force_mesh_segments=2),
        "minidish": lambda n=None: parallel.trace_sharded(
            md_table, sun, P17_SEED, max_bounces=20)}
    mine = {"setup": setup}
    for name, run in runs.items():
        # one short untimed call first (4 slabs; the MiniDish's whole), so
        # the timed ones pay no first-use costs
        run(4)
        for w in wrappers:
            w.launches = 0
        walls = []
        for _ in range(3):
            dist.barrier()
            sync()
            t1 = time.perf_counter()
            out = run()
            sync()
            dist.barrier()
            walls.append(time.perf_counter() - t1)
        mine[name] = dict(walls=sorted(walls),
                          launches=[w.launches for w in wrappers])
        if rank == 0:
            # NumPy, so that the results outlive this process
            if name == "minidish":
                mine[name]["result"] = (
                    out[1].absorbed.double().cpu().numpy(),
                    float(sun.total_energy()))
            else:
                acc, em, se = out
                mine[name]["result"] = (
                    {k: ([f.cpu().numpy() for f in v] if k == "flux"
                         else v.cpu().numpy())
                     for k, v in acc.__dict__.items()}, int(em), float(se))
    results.put((rank, mine))
    dist.barrier()
    dist.destroy_process_group()


def gloo_phase(dev, card, kb, kn, slab, culling, fspec, phase5, one_rank):
    """Phase 17 (c): two ranks on the one card over gloo (NCCL refuses two
    ranks on one device), spawned with torch.multiprocessing after the
    kernels are built. The culled NSTTF at bench size built with
    mesh_devices=2 (342 tiles a rank, aureole parking on, as a mesh build
    sets it; each rank's row shard through K1), a forced two-segment
    row-shard run of phase 5's culling (32 slabs), and trace_sharded of
    the MiniDish at 4,194,304 rays: bench.py's guards on the NSTTF runs,
    each receiver within 3 sigma of its one-rank counterpart (phase 5's
    trace, phase 17 (b)'s MiniDish). Returns (K1, K2, K3, K3 epilogue)
    launches over both ranks' timed runs."""
    import torch
    import torch.multiprocessing as tmp
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.engine import TraceAccum, energy_closure
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn
    table, meta, info = build_scene(device=dev)
    spec = make_source_fn(info, slab).pallas_spec
    t0 = time.perf_counter()
    culling2 = build_block_culling(table, meta, spec, slab, mesh_devices=2)
    t_build = time.perf_counter() - t0
    check(culling2.park_aureole and culling2.nb == culling.nb,
          f"mesh culling: park {culling2.park_aureole}, {culling2.nb} tiles")
    ctx = tmp.get_context("spawn")
    results = ctx.SimpleQueue()
    t0 = time.perf_counter()
    procs = tmp.start_processes(
        rank17, args=(2, free_port(), results, str(dev), P17_SIZES, slab,
                      culling2, culling, fspec),
        nprocs=2, join=False, start_method="spawn")
    ranks = {}
    # drain the queue while joining: a rank blocked on a full pipe would
    # never exit, and join raises if a rank failed
    while True:
        while not results.empty():
            r, v = results.get()
            ranks[r] = v
        if procs.join(timeout=1):
            break
    while not results.empty():
        r, v = results.get()
        ranks[r] = v
    wall = time.perf_counter() - t0
    check(sorted(ranks) == [0, 1], f"ranks reported: {sorted(ranks)}")
    launches = [sum(ranks[r][name]["launches"][k] for r in ranks
                    for name in ("nsttf_mesh", "nsttf_segments", "minidish"))
                for k in range(4)]
    for r in ranks:
        l1, l2, l3, le = ranks[r]["minidish"]["launches"]
        check(le == (l3 if dev.type == "cuda" else 0),
              f"gloo rank {r} MiniDish: K3 {l3}, K3 epilogue {le} launches")
        for name in ("nsttf_mesh", "nsttf_segments"):
            check(ranks[r][name]["launches"][3] == 0,
                  f"gloo rank {r} {name}: the K3 epilogue launched")
    r0 = ranks[0]
    log(f"gloo 2 ranks: spawn and run {wall:.1f} s, each rank's set-up "
        f"(process group, build load, scenes) "
        f"{', '.join(f'{ranks[r]['setup']:.1f}' for r in sorted(ranks))} s;"
        f" mesh culling build {t_build:.1f} s, n_seg "
        f"{culling2.stats['mesh_n_seg']}, L_mean "
        f"{culling2.stats['L_mean']:.1f} (phase 5's "
        f"{culling.stats['L_mean']:.1f})")
    for name, label, total in (
            ("nsttf_mesh", "culled NSTTF, mesh_devices=2 build",
             P17_SIZES["mesh_slabs"] * slab),
            ("nsttf_segments", "culled NSTTF, forced 2 row-shard segments",
             P17_SIZES["segment_slabs"] * slab)):
        fields, em, se = r0[name]["result"]
        acc = TraceAccum(**{k: (tuple(torch.as_tensor(f) for f in v)
                                if k == "flux" else torch.as_tensor(v))
                            for k, v in fields.items()})
        rec_frac, closure, flux_rec = check_trace(
            f"gloo {label}", acc, em, se, total, energy_closure)
        within_sigma(f"gloo {label} receiver", [rec_frac], em,
                     [phase5[0]], phase5[1])
        log(f"gloo 2 ranks {label}: {em} rays, receiver fraction "
            f"{rec_frac:.5f} (phase 5 {phase5[0]:.5f}), "
            f"closure {closure:.1e}, flux/receiver {flux_rec:.6f}; "
            f"{walls_text(r0[name]['walls'], em)}; launches K1/K2/K3/"
            f"epilogue "
            f"{' + '.join(str(ranks[r][name]['launches']) for r in ranks)}"
            f" ({card})")
    ab, src = r0["minidish"]["result"]
    p = ab / src
    q, n_q = one_rank["minidish"]
    n_md = P17_SIZES["md_lanes"]
    within_sigma("gloo MiniDish rows", p, n_md, q, n_q)
    log(f"gloo 2 ranks trace_sharded MiniDish: {n_md} rays, largest "
        f"per-row difference from one rank {abs(p - q).max():.1e} of the "
        f"source; {walls_text(r0['minidish']['walls'], n_md)}; launches "
        f"K1/K2/K3/epilogue "
        f"{' + '.join(str(ranks[r]['minidish']['launches']) for r in ranks)}"
        f" ({card})")
    return launches


# phase 17 (d): a 64 x 64 grid of flat 0.45 m mirrors at a 1 m pitch
# under one receiver (tracer_tpu's mesh-scale field, cut from 20,001 rows
# to 4,097: its table is still 2.3 times K2's stage), the sun between
# the receiver and the field
GRID_MIRRORS = 4096
GRID_TILES = 128
GRID_SLABS = 32


def grid_field(dev):
    """(table, meta, source_fn) of phase 17 (d)'s field: a Buie sun
    (CSR 0.02) cast down from 45 m onto the mirrors, which send it up to
    the one-sided receiver at 50 m."""
    import math

    import numpy as np
    import tracer_tpu_torch as ptt
    G, M, sp = ptt.geometry, ptt.materials, ptt.spatial
    cols = int(math.ceil(math.sqrt(GRID_MIRRORS)))
    half = (cols - 1) / 2.0
    surfs = [ptt.Surface(G.rect_plate(0.45, 0.45), M.reflective(0.1),
                         location=[k // cols - half, k % cols - half, 0.0],
                         name=f"m{k}") for k in range(GRID_MIRRORS)]
    rec = ptt.Surface(G.rect_plate(3.0 * half, 3.0 * half),
                      M.absorber(one_sided=True), name="rec",
                      location=[0.0, 0.0, 50.0],
                      rotation=sp.rotx(np.pi)[:3, :3])
    table, meta = ptt.compile_scene(
        ptt.Assembly([ptt.AssembledObject(surfs + [rec])]), device=dev)
    slab = GRID_TILES * 3072
    sun = ([0.0, 0.0, 45.0], [0.0, 0.0, -1.0], half * math.sqrt(2.0) + 2.0,
           0.02, 1000.0)

    def source_fn(generator, device=None):
        return ptt.sources.buie_sunshape(generator, slab, *sun[:4],
                                         flux=sun[4], device=device)
    source_fn.num_rays = slab
    source_fn.pallas_spec = ptt.sources.buie_sunshape_pallas_spec(slab,
                                                                  *sun)
    return table, meta, source_fn


def oracle_drain_phase(dev, card, kb, kn):
    """Phase 17 (d): the culled trace of a table past K2's stage, whose
    drain runs through the oracle and the unfused shade
    (engine._oracle_bounce). The grid field with an aureole-parked
    culling (its aureole-born lanes' hits park and drain through the
    oracle) and with an unparked one (no lane outlives its corridor, so
    K1 alone traces it): full emission, closure below 1e-4, no K2 or K3
    launch, oracle drain bounces in the parked trace, and its receiver
    within 3 combined sigma of the unparked trace's. Returns (K1, K2, K3, K3
    epilogue) launches of the warm-up and timed calls."""
    import torch
    from tracer_tpu_torch import engine
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.engine import energy_closure, trace_streaming
    table, meta, source_fn = grid_field(dev)
    check(not engine._k2_fits(table), f"grid field: {table.num_rows} rows "
          "fit K2's stage")
    slab = source_fn.num_rays
    total = GRID_SLABS * slab
    wrappers = (kb.bounce_reflect_culled, kb.bounce_reflect, kn.nearest_hit,
                epilogue(), engine._oracle_bounce)
    launches, out = [0, 0, 0, 0], {}
    for park in (True, False):
        t0 = time.perf_counter()
        cul = build_block_culling(table, meta, source_fn.pallas_spec, slab,
                                  park_aureole=park)
        t_build = time.perf_counter() - t0
        reset_launches(*wrappers)
        (acc, em, se), walls = walls3(lambda: trace_streaming(
            table, source_fn, torch.Generator().manual_seed(P17_SEED),
            total, max_rounds=20_000, max_path=8, min_energy=1e-6,
            culling=cul))
        n = [w.launches for w in wrappers]
        launches = [a + b for a, b in zip(launches, n)]
        closure = energy_closure(acc, se)
        p = surface_fraction(meta, acc.absorbed.double().cpu().numpy()
                             / float(se), "rec")
        label = f"grid field, {'parked' if park else 'unparked'} culling"
        for name in ("absorbed", "escaped", "culled", "residual"):
            check(bool(torch.isfinite(getattr(acc, name)).all()),
                  f"{label}: {name} not finite")
        check(int(em) >= total and abs(closure) < 1e-4 and p > 0.05,
              f"{label}: emitted {int(em)}, closure {closure}, receiver {p}")
        # (K1 launches nothing in a dry run on the CPU)
        check((n[0] > 0 or dev.type != "cuda") and n[1] == n[2] == n[3]
              == 0, f"{label}: launches K1/K2/K3/epilogue {n[:4]}")
        check(n[4] > 0 or not park, f"{label}: the drain never ran")
        out[park] = (p, int(em))
        log(f"{label}: {table.num_rows} rows (K2's stage holds "
            f"{kb.MAX_STAGE_FLOATS // kb.row_width(table)}), {cul.nb} "
            f"tiles, L_mean {cul.stats['L_mean']:.1f}, build {t_build:.1f} "
            f"s; {int(em)} rays, receiver fraction {p:.5f}, closure "
            f"{closure:.1e}; {walls_text(walls, int(em))}; launches in "
            f"the warm-up and 3 timed calls K1 {n[0]}, K2 {n[1]}, K3 "
            f"{n[2]}, oracle drain bounces {n[4]} ({card})")
    within_sigma("grid field receiver, parked vs unparked", [out[True][0]],
                 out[True][1], [out[False][0]], out[False][1])
    return launches


def phase17(dev, card, kb, kn, p_ref, slab, culling, fspec, phase5):
    """Phase 17: float64 on the card (a), one rank over NCCL (b), two
    ranks on the card over gloo (c), the culled drain of a table past
    K2's stage (d). Returns each kernel's launches in (b), (c) and (d)
    (float64 launches none)."""
    t17 = time.perf_counter()
    float64_phase(dev, card, kb, kn, p_ref)
    t_a = time.perf_counter() - t17
    launches, one_rank = nccl_phase(dev, card, kb, kn, p_ref, slab, culling,
                                    fspec, phase5)
    t_b = time.perf_counter() - t17 - t_a
    gl = gloo_phase(dev, card, kb, kn, slab, culling, fspec, phase5,
                    one_rank)
    t_c = time.perf_counter() - t17 - t_a - t_b
    od = oracle_drain_phase(dev, card, kb, kn)
    launches = [a + b + c for a, b, c in zip(launches, gl, od)]
    log(f"phase 17: {time.perf_counter() - t17:.1f} s ((a) {t_a:.1f}, (b) "
        f"{t_b:.1f}, (c) {t_c:.1f}, (d) "
        f"{time.perf_counter() - t17 - t_a - t_b - t_c:.1f}), "
        f"launches K1 {launches[0]}, K2 {launches[1]}, K3 {launches[2]}, "
        f"K3 epilogue {launches[3]}")
    return launches


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
