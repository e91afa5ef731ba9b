"""How ``correct`` is decided: every study the window ran, held against
the plain reference's trace of the same scene.

Each call's outputs become fractions of its source energy per category
(every surface, escaped, lost, each coarse bin of the receiver's flux
map). A category's gap is a z-score: the call's fraction less the
reference's mean, over the standard error of the two (the reference's
per-ray variance, over the call's rays and over the reference's). The
numbers compared, each with a limit of its own (``limits/<cell>.json``):

  emitted_gap  rays emitted outside what the traffic asks (exact: 0)
  energy_gap   source energy against rays x the reference's ray energy
  absorbed_z   widest z over the calls, surfaces, escaped and lost
  flux_z       widest z over the calls and the coarse flux bins
"""
from __future__ import annotations

import json
import math

import numpy as np

from .reference import scene as ref_scene

ORDER = ("emitted_gap", "energy_gap", "absorbed_z", "flux_z")


def limits_for(cell: str) -> dict:
    return json.loads((ref_scene.ROOT / "limits" / f"{cell}.json")
                      .read_text())


def emit_window(traffic: dict):
    """(fewest, most) rays a call may emit: trace_streaming (sharded or
    not) emits at least the total and may pass it by less than a slab
    (the plain megakernel refills whole rounds; the culled trace rounds
    each source cell's equal-area quota up); trace_fused traces its
    bundle exactly."""
    if traffic["entry"] == "trace_fused":
        return traffic["rays"], traffic["rays"]
    rays = traffic["slab"] * traffic["slabs_per_call"]
    return rays, rays + traffic["slab"] - 1


def host_outputs(out: dict, category_of: np.ndarray, n_cat: int) -> dict:
    """One call's device outputs on the host, the absorbed energy summed
    into the reference's categories."""
    absorbed = np.zeros(n_cat)
    np.add.at(absorbed, category_of,
              out["absorbed"].double().cpu().numpy())
    flux = out["flux"]
    return dict(absorbed=absorbed, escaped=float(out["escaped"]),
                lost=float(out["lost"]), emitted=int(out["emitted"]),
                source_e=float(out["source_e"]),
                flux=None if flux is None else flux.double().cpu().numpy())


def compare(calls: list, stats, traffic: dict, e_ray: float,
            limits: dict) -> tuple:
    """(numbers, calls failed, where the widest z was): each number's
    widest value over ``calls`` (host_outputs dicts) against the
    reference ``stats``."""
    names = stats.names
    n_rows = names.index("escaped")
    flux0 = n_rows + 2
    mean, var = stats.mean(), np.maximum(stats.var(), 1.0 / stats.n)
    coarse = int(round(math.sqrt(len(names) - flux0)))
    lo, hi = emit_window(traffic)
    worst = dict.fromkeys(ORDER, 0.0)
    where = {}
    failed = 0
    for i, c in enumerate(calls):
        n = max(c["emitted"], 1)
        se = c["source_e"] if c["source_e"] > 0.0 else math.inf
        frac = np.concatenate([c["absorbed"][:n_rows],
                               [c["escaped"], c["lost"]]]) / se
        sig = np.sqrt(var * (1.0 / n + 1.0 / stats.n))
        got = dict(
            emitted_gap=float(max(0, lo - c["emitted"], c["emitted"] - hi)),
            energy_gap=abs(c["source_e"] / (n * e_ray) - 1.0),
            absorbed_z=float(np.max(np.abs(frac - mean[:flux0])
                                    / sig[:flux0])))
        z_all = np.abs(frac - mean[:flux0]) / sig[:flux0]
        if c["flux"] is not None and coarse:
            nu, nv = c["flux"].shape
            blocks = c["flux"].reshape(coarse, nu // coarse, coarse,
                                       nv // coarse).sum((1, 3)).ravel()
            zf = np.abs(blocks / se - mean[flux0:]) / sig[flux0:]
            got["flux_z"] = float(np.max(zf))
            z_all = np.concatenate([z_all, zf])
        got = {k: v if math.isfinite(v) else math.inf
               for k, v in got.items()}
        for k, v in got.items():
            worst[k] = max(worst[k], v)
        if np.isfinite(z_all).all() and z_all.size:
            k = int(np.argmax(z_all))
            if z_all[k] > where.get("z", -1.0):
                where = {"z": float(z_all[k]), "category": names[k],
                         "call": i}
        if any(got[k] > limits[k] for k in got):
            failed += 1
    if not any(c["flux"] is not None for c in calls):
        worst.pop("flux_z")
    return worst, failed, where


def verdict(numbers: dict, limits: dict, attempted: int) -> bool:
    return attempted > 0 and all(numbers[k] <= limits[k] for k in numbers)


def report(numbers: dict, limits: dict) -> dict:
    """The numbers beside their limits, in a fixed order."""
    return {k: {"value": numbers[k], "limit": limits[k]}
            for k in ORDER if k in numbers}
