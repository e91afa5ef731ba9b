"""The control of ``correct``: the plain reference put in the program's
place and traced in bfloat16 (the precision below the configurations'
float32), as many rays a call as the cell's traffic asks, then compared
with the float64 reference exactly as a run's calls are. Its numbers are
the upper readings the limits in ``limits/`` were set below.

    python3 -m portbench.control --workload <name> --seeds 1 2 3

Prints one JSON line a seed with the numbers compared.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import check, run, system
from .reference import scene as ref_scene
from .reference import trace as ref_trace


def control_call(stats, e_ray: float, n_rows: int) -> dict:
    """A reference trace's sums as one call's outputs."""
    total = stats.s1 * e_ray
    coarse = int(round(np.sqrt(len(stats.names) - n_rows - 2)))
    return dict(absorbed=total[:n_rows], escaped=float(total[n_rows]),
                lost=float(total[n_rows + 1]), emitted=stats.n,
                source_e=stats.n * e_ray,
                flux=total[n_rows + 2:].reshape(coarse, coarse))


def readings(bench: dict, cell_name: str, seed: int, device,
             traffic_overrides=None, dtype=torch.bfloat16) -> dict:
    cell = run.cell_of(bench, cell_name)
    cfg = run.load_json(f"portbench/configs/{cell['config']}.json")
    traffic = dict(run.load_json(
        f"portbench/traffic/{cell['traffic']}.json"),
        **(traffic_overrides or {}))
    scene = ref_scene.build(cfg)
    rays, _ = check.emit_window(traffic)
    slab = traffic.get("slab") or traffic["rays"]
    e_ray = scene.source.ray_energy(slab)
    kw = dict(max_hits=traffic.get("max_path") or traffic["max_bounces"],
              min_energy=traffic["min_energy"], e_ray=e_ray,
              flux_bins=traffic.get("flux_resolution") or 50,
              coarse=traffic["check"]["flux_coarse"], device=device)
    low = ref_trace.trace(scene, rays, system.call_seed(seed, 4 * 10 ** 6),
                          dtype=dtype, **kw)
    ref = ref_trace.trace(scene, traffic["check"]["reference_rays"],
                          system.call_seed(seed, 2 * 10 ** 6), **kw)
    call = control_call(low, e_ray, len(scene.rows))
    if not traffic.get("flux_resolution"):
        call["flux"] = None
    numbers, _, _ = check.compare([call], ref, traffic, e_ray,
                               check.limits_for(cell_name))
    return numbers


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = run.load_json("BENCHMARK.json")
    for seed in args.seeds:
        numbers = readings(bench, args.workload, seed,
                           torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": "bfloat16", **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
