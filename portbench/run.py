"""Run one cell of BENCHMARK.json once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up builds the kernel library (served from tracer_tpu_torch/_build/,
which the program keys by its sources), compiles the cell's scene and
culling, and runs one short warm-up call at the cell's shapes. The window
then runs whole calls back to back, one caller in a closed loop, each
ending in torch.cuda.synchronize(), until ``--seconds`` have passed. With
``--trace 1`` a few more calls run under torch.profiler after the window.
Once the program's state is freed, the plain reference traces the scene
and every call of the window is compared with it (check.py).

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (calls), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
beside its limit, which also end standard error.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "tracer_tpu")
NOT_MEASURED = "not measured"


def _process_age() -> float:
    """Seconds since this process started (/proc), or 0 where unknown."""
    try:
        start = float(Path("/proc/self/stat").read_text().rsplit(
            ")", 1)[1].split()[19])
        up = float(Path("/proc/uptime").read_text().split()[0])
        return max(up - start / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


# the monotonic time at which the process started: set-up runs from here
T_START = time.monotonic() - _process_age()
ROOT = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class RunData:
    """What a per-layer reader may read of a run."""
    cell: dict
    config: dict
    traffic: dict
    scene: object                 # reference.scene.Scene
    stats: object                 # reference.trace.Stats
    build_s: float
    window_s: float
    n_calls: int
    counters: dict                # launch-counter deltas over the window
    window_peak_bytes: object     # int, or None off the card
    slice: object = None          # profile.Slice of the traced run
    slice_calls: list = dataclasses.field(default_factory=list)
    # each call's rounds on each rank (cells on several cards)
    rank_rounds: list = dataclasses.field(default_factory=list)


def log(msg: str) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)


def load_json(rel: str) -> dict:
    return json.loads((ROOT / rel).read_text())


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, kind: str) -> list:
    """The cell's end-to-end or per-layer metric entries: those that list
    it, or list no cells and move an end-to-end metric the cell
    reports."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def run(bench: dict, cell_name: str, seed: int, seconds: float,
        trace: bool, device, traffic_overrides=None) -> dict:
    """One run of a cell on ``device``; returns the result object. Off
    the card (the tests' CPU runs) nothing is timed or profiled and every
    metric reads "not measured"."""
    import numpy as np
    import torch
    from . import check, profile, ranks, system
    from .reference import scene as ref_scene
    from .reference import trace as ref_trace
    cell = cell_of(bench, cell_name)
    cfg = load_json(f"portbench/configs/{cell['config']}.json")
    traffic = dict(load_json(f"portbench/traffic/{cell['traffic']}.json"),
                   **(traffic_overrides or {}))
    limits = check.limits_for(cell_name)
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t = time.monotonic()
    log(f"set-up: process start to harness {t - T_START:.3f} s")
    if on_card:
        from tracer_tpu_torch.kernels import build as kbuild
        kbuild.load()
        log(f"set-up: kernel library {time.monotonic() - t:.3f} s "
            f"(nvcc {kbuild.info.get('nvcc_s', 0.0):.1f} s, cache hit "
            f"{kbuild.info.get('cache_hit')})")
    warm_kw = ({"total": traffic["warmup_slabs"] * traffic["slab"]}
               if "warmup_slabs" in traffic else {})
    world = cell["chips"]
    if world > 1:
        # the other ranks load the library rank 0 built, then build and
        # warm up their studies beside rank 0's
        group = ranks.Ranks(world, (ROOT, cfg, traffic, seed, warm_kw),
                            device)
    study = system.build(cfg, traffic, device)
    log(f"set-up: scene and culling build {study.build_s:.3f} s")
    t = time.monotonic()
    warm = study.run(system.call_seed(seed, 3 * 10 ** 6), **warm_kw)
    sync()
    del warm
    log(f"set-up: warm-up call {time.monotonic() - t:.3f} s")
    setup_peak = None
    if on_card:
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    read = system.counters if on_card else (lambda: {})
    c0 = read()
    t_setup = time.monotonic()
    t0 = time.perf_counter()
    outs, walls, rounds = [], [], []
    while True:
        ts = time.perf_counter()
        call_seed = system.call_seed(seed, len(outs))
        if world > 1:
            group.order(ranks.CALL, call_seed)
            r0 = read()
        outs.append(study.run(call_seed))
        sync()
        te = time.perf_counter()
        walls.append(te - ts)
        if world > 1:
            rounds.append(sum(v - r0[k] for k, v in read().items()))
        if te - t0 >= seconds:
            break
    window_s = te - t0
    c1 = read()
    log(f"window: {len(walls)} calls in {window_s:.3f} s, call walls "
        f"min {min(walls):.4f} median {float(np.median(walls)):.4f} max "
        f"{max(walls):.4f} s (first {walls[0]:.4f} s)")
    log("window: call walls " + " ".join(f"{w:.4f}" for w in walls))
    window_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    ref = ref_scene.build(cfg)
    names = ref_trace.categories(ref, traffic["check"]["flux_coarse"])
    category_of = study.categories(names)
    calls = [check.host_outputs(o, category_of, len(names)) for o in outs]
    del outs
    sl, slice_calls, reports = None, [], []
    if trace and on_card:
        if world > 1:
            group.order(ranks.PROFILE, seed, traffic["profile_calls"])
        sl = profile.profile_calls(
            study, [system.call_seed(seed, 10 ** 6 + k)
                    for k in range(traffic["profile_calls"])], read)
        slice_calls = [check.host_outputs(o, category_of, len(names))
                       for o in sl.calls]
        sl.calls = []
    if world > 1:
        reports = group.finish()
    build_s, slab = study.build_s, study.slab
    del study
    if on_card:
        torch.cuda.empty_cache()
    e_ray = ref.source.ray_energy(slab)
    t = time.monotonic()
    stats = ref_trace.trace(
        ref, traffic["check"]["reference_rays"],
        system.call_seed(seed, 2 * 10 ** 6),
        max_hits=traffic.get("max_path") or traffic["max_bounces"],
        min_energy=traffic["min_energy"], e_ray=e_ray,
        flux_bins=traffic.get("flux_resolution") or 50,
        coarse=traffic["check"]["flux_coarse"], device=device)
    log(f"reference: {stats.n} rays, {stats.segments / stats.n:.4f} "
        f"segments a ray, {time.monotonic() - t:.3f} s")
    numbers, failed, where = check.compare(calls, stats, traffic, e_ray,
                                           limits)
    log(f"check: widest z {where}")
    correct = check.verdict(numbers, limits, len(calls))
    data = RunData(cell, cfg, traffic, ref, stats, build_s, window_s,
                   len(calls), {k: c1[k] - c0[k] for k in c1},
                   window_peak, sl, slice_calls,
                   [list(r) for r in zip(rounds, *(
                       rep["rounds"] for rep in reports))])
    result = {"correct": correct, "attempted": len(calls), "failed": failed}
    if trace:
        metrics = {}
        for m in metrics_for(bench, cell_name, "per_layer"):
            reader = importlib.import_module(
                "portbench.metrics." + m["name"].split(".")[0])
            v = reader.read(data) if on_card else NOT_MEASURED
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        rays = sum(c["emitted"] for c in calls)
        rate = rays / window_s / 1e6
        e2e = {"rays_per_s": rate, "field_rays_per_s": rate,
               "trace_p95_ms": 1e3 * float(np.percentile(walls, 95)),
               "setup_s": t_setup - T_START}
        metrics = {m["name"]: {"value": e2e[m["name"]] if on_card
                               else NOT_MEASURED, "unit": m["unit"]}
                   for m in metrics_for(bench, cell_name, "end_to_end")}
    result["metrics"] = metrics
    if on_card:
        result["device"] = {
            "platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": world, "memory_peak_bytes": max(
                [setup_peak, window_peak] + [r["peak"] for r in reports])}
        if sl is not None:
            busy = [sl.busy_s] + [r["busy_s"] for r in reports]
            result["device"].update(busy_s=sum(busy) / len(busy),
                                    window_s=sl.wall_s)
            result["breakdown"] = profile.breakdown(sl)
    else:
        result["device"] = {"platform": device.type, "kind": NOT_MEASURED,
                            "count": 1, "memory_peak_bytes": NOT_MEASURED}
    result["checks"] = check.report(numbers, limits)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_json("BENCHMARK.json")
    cell = cell_of(bench, args.workload)
    import torch
    if (not torch.cuda.is_available()
            or torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); torch sees {torch.cuda.device_count()} "
              f"(available: {torch.cuda.is_available()})", file=sys.stderr)
        return 2
    try:
        import tracer_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"portbench: the program tracer_tpu_torch is not in this "
              f"checkout ({exc})", file=sys.stderr)
        return 3
    result = run(bench, args.workload, args.seed, args.seconds,
                 bool(args.trace), torch.device("cuda", 0))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for k, v in result["checks"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
