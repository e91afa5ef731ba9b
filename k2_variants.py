#!/usr/bin/env python3
"""Time K2 (bounce_reflect) in variants of its design on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 k2_variants.py                 # the tree and its variants
    python3 k2_variants.py --parent DIR    # and an earlier tree beside

A variant is the tree's kernels/csrc with a text edit of
csrc/bounce.cu, built beside the tree with nvcc (all builds started
together, as k1_variants.py does). Each of the first puts one of K2's
levers back to the earlier design's code: rows staged at their own
stride rather than padded to 16-byte words, curved rows solving every
root form branch-free as K1 and K3 do, the spectral tables' segments
found by a scan rather than by bisection, a flat group with one rect
aperture tested through the loop over the aperture slots, rows with one
aperture slot scanned with the slot count read at run time, one chunk a
block in place of persistent blocks, two blocks of 256 threads a SM for
the instances that run five of 128 (K2Block's narrow ones: 16 warps
against 20). Then every instance's block size and __launch_bounds__ set
to each of BLOCKS; blocks of 128 threads for every instance, six a SM
where three of 256 (the same registers a thread); a diagnostic with
four blocks a SM for the stage (d)/(e) instances without refraction
(they spill there); and three diagnostics whose results differ by
design, to apportion the time: no row tests, no regeneration (dead lanes
keep their rays) and no shade epilogue (lanes keep their rays).

``--parent`` names a checkout of an earlier tree: its tracer_tpu_torch
package is loaded under another name, built from its own sources and
called through its own wrapper, and the NSTTF trace (each package's
phase 5 trace of chip_smoke.py) and bench configs 1 and 8 (each
package's plain megakernel at 89,653,248 rays) run end to end through
both, in turns.

The cases: phase 3's NSTTF rows at 2,101,248 lanes (the second round's
state, regeneration off, two thirds of the lanes dead); every mode of
test_torch_gpu.K2_MODES at 700,416 lanes, as chip_smoke.py's phases
7-11 call them (every K2 instance that a trace dispatches, each
backside_miss twin among them); and the drain's shape, the plain
megakernel's compacted tail of engine._drain_cap(700,416) = 89,088
lanes, half of them dead, no regeneration, on config 1's rows and the
lens, with their backside_miss twins. For each case the script prints,
per build, the lanes whose outputs differ from the tree's (any output,
every lane, dead ones too) and its device time (chip_smoke.time_cuda,
20 calls) in turns: parent, variants, the variants again in reverse,
parent; the case's bound (chip_smoke.k2_bound: every lane's row scan
and shade, dead ones included, against the plain version's outputs);
and the tree's launch geometry (blocks, threads, lanes a chunk, shared
bytes, blocks resident a SM, chunks a block). It prints each build's
ptxas report for K2 first,
with the local-memory stores, loads and calls in the SASS of each K2
instance (cuobjdump), and writes every number to
k2_variants_out/k2_variants.json, each build's full ptxas report and
the tree's SASS of each instance beside it. It needs the card; it exits
1 without it.
"""
import argparse
import json
import re
import statistics
import sys
import threading
import time
from pathlib import Path

from k1_variants import (differing, finish_build, load_parent, log,
                         sass_k1, start_build, trace_turns)

ROOT = Path(__file__).resolve().parent
# (threads a block, blocks resident a SM) that __launch_bounds__ asks for
# in every instance: at most 128, 72 and 72 registers a thread
BLOCKS = ((256, 2), (224, 4), (128, 7))
# the earlier design's code of each lever
NO_PAD = (("  return (K + 3) & ~3;", "  return K;"),
          ("    const float* r =\n        static_cast<const float*>("
           "__builtin_assume_aligned(sm + i * Kp, 16));",
           "    const float* r = sm + i * Kp;"))
NO_SOLVE = (("    row_hit_local<CLS, true>(", "    row_hit_local<CLS>("),)
SCAN = (("""  int k = start, k1 = hi;  // tab[2 k] <= wl < tab[2 k1] where wl is a number
  while (k1 - k > 1) {
    const int mid = (k + k1) >> 1;
    if (tab[2 * mid] <= wl)
      k = mid;
    else
      k1 = mid;
  }
  const float x0 = tab[2 * k], x1 = tab[2 * k + 2];
  if (!(wl >= x0 && wl < x1)) return 0.0f;
  const float w = (wl - x0) / (x1 == x0 ? 1.0f : x1 - x0);
  const float y0 = tab[2 * k + 1], y1 = tab[2 * k + 3];
  return y0 + fminf(fmaxf(w, 0.0f), 1.0f) * (y1 - y0);
""", """  for (int k = start; k < hi; ++k) {
    const float x0 = tab[2 * k], x1 = tab[2 * k + 2];
    if (wl >= x0 && wl < x1) {
      const float w = (wl - x0) / (x1 == x0 ? 1.0f : x1 - x0);
      const float y0 = tab[2 * k + 1], y1 = tab[2 * k + 3];
      return y0 + fminf(fmaxf(w, 0.0f), 1.0f) * (y1 - y0);
    }
  }
  return 0.0f;
"""),)
RECT_LOOP = (("""        if (mask == 1)
          rows_of_class<FLAT_RECT1>(at, first, count, Kp, kinds, mask, C,
                                    t_eps, disc_eps, bmiss_on, lane);
        else if (mask >= 0)""", "        if (mask >= 0)"),)
SLOTS = (("""  if (a.C == 1)
    scan_groups<true, false>(a.gmeta, a.G, a.meta_w, a.C, st.rows, st.Kp, 0,
                             a.S, a.t_eps, a.disc_eps, kBmiss, winner);
  else
""", ""),)
# K2Block's lines
THREADS = "  static constexpr int threads = narrow ? 128 : 256;"
MIN_BLOCKS = "  static constexpr int min_blocks = narrow ? 5 : 3;"
ONE_CHUNK = (("  const int blocks = chunks < sms * resident ? chunks : sms "
              "* resident;", "  const int blocks = chunks;"),)
# diagnostics, whose results differ by design
NO_ROWS = (("  for (int g = 0; g < G; ++g) {\n"
            "    const int* m = gmeta + g * meta_w;",
            "  for (int g = 0; g < 0; ++g) {\n"
            "    const int* m = gmeta + g * meta_w;"),)
NO_REGEN = (("  const bool reborn = a.regen && in.e <= 0.0f;",
             "  const bool reborn = false && in.e <= 0.0f;"),)
NO_SHADE = (("  const Shaded o = shade<kRefr, kScat, kMedia, kExtra, kSplit>("
             "\n      hit ?",
             "  Shaded o = {in.px, in.py, in.pz, in.dx, in.dy, in.dz, in.e, "
             "0.0f, ri,\n              mid, false, 0.0f, 0.0f, 0.0f, 0.0f, "
             "false};\n"
             "  if (false) o = shade<kRefr, kScat, kMedia, kExtra, kSplit>("
             "\n      hit ?"),)
# the drain's modes (test_torch_gpu.K2_MODES), also timed at its lanes
DRAIN_MODES = ("drain", "drain_lens", "drain_bmiss", "drain_lens_bmiss")
SLAB = 2 * ((1 << 20) // 3072 * 3072 + 3072)    # bench.py's: 684 tiles
BENCH_SLAB = 228 * 3072


def variants() -> dict:
    """name -> edits of csrc/bounce.cu."""
    def block(threads, blocks):
        return ((THREADS, f"  static constexpr int threads = {threads};"),
                (MIN_BLOCKS, f"  static constexpr int min_blocks = {blocks};"))
    out = {"unpadded rows": NO_PAD, "branch-free quadric": NO_SOLVE,
           "table scan": SCAN, "rect loop": RECT_LOOP,
           "slot count at run time": SLOTS,
           "one chunk a block": ONE_CHUNK,
           "two blocks of 256 for the narrow ones": block(
               256, "narrow ? 2 : 3")}
    for t, n in BLOCKS:
        out[f"{t} threads, min blocks {n}"] = block(t, n)
    out["128 threads, min blocks 6 (5 narrow)"] = block(128,
                                                        "narrow ? 5 : 6")
    out["min blocks 4 for (d)/(e) without refraction (diagnostic)"] = block(
        "narrow ? 128 : 256", "narrow ? 5 : !kRefr && kExtra ? 4 : 3")
    out["no row tests (diagnostic)"] = NO_ROWS
    out["no regeneration (diagnostic)"] = NO_REGEN
    out["no shade epilogue (diagnostic)"] = NO_SHADE
    return out


def k2_cases(dev, kb):
    """(label, positional args, keywords, table, regen) of every timed K2
    call."""
    import torch
    from test_torch_gpu import K2_MODES, k2_mode
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.engine import _drain_cap
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn
    table, meta, info = build_scene(device=dev)
    spec = make_source_fn(info, SLAB).pallas_spec
    culling = build_block_culling(table, meta, spec, SLAB)
    rows = kb.pack_rows(table)
    nb = culling.nb
    n = nb * kb.TILE
    kw = dict(bivar=True, one_sided=True, slope=True)
    o = kb.bounce_reflect_culled(
        rows, torch.as_tensor(culling.lists, device=dev),
        torch.as_tensor(culling.counts, device=dev),
        torch.arange(nb, dtype=torch.int32, device=dev),
        torch.as_tensor(culling.cell_bounds, device=dev), 5,
        torch.full((nb,), kb.TILE, dtype=torch.int32, device=dev),
        torch.ones((nb,), dtype=torch.int32, device=dev),
        torch.zeros((n, 3), device=dev),
        torch.tensor([0.0, 0.0, 1.0], device=dev).expand(n, 3).contiguous(),
        torch.zeros((n,), device=dev), table.groups, culling.group_offsets,
        3e-4, source_spec=spec, **kw)
    e = torch.where(o[3] >= 0, o[2], 0.0)
    yield ("NSTTF rows, phase 3", (rows, 7, o[0], o[1], e, table.groups,
                                    3e-4), kw, table, False)
    del o, e
    cap = _drain_cap(BENCH_SLAB)
    for mode, n in ([(m, BENCH_SLAB) for m in K2_MODES]
                    + [(m, cap) for m in DRAIN_MODES]):
        table, _, rows, pos, dirs, e, kw, regen = k2_mode(mode, n, 3, dev)
        yield (mode if n == BENCH_SLAB else f"{mode}, the drain's lanes",
               (rows, 17, pos, dirs, e, table.groups, 3e-4), kw, table,
               regen)


def bench_turns(dev, card, cfgs=(1, 8)) -> dict:
    """Bench configs ``cfgs`` through each package's plain megakernel
    (chip_smoke.py's phase 7 and 8 calls: 89,653,248 rays, the suite's
    max_rounds and max_path), after one short untimed trace each: wall
    times ending in a synchronize in turns (parent, tree, tree, parent)."""
    import importlib
    import torch
    out = {}
    for cfg in cfgs:
        runs = {}
        for name, pkg in (("tree", "tracer_tpu_torch"),
                          ("parent", "tracer_tpu_torch_parent")):
            bc = importlib.import_module(pkg + ".models.bench_configs")
            engine = importlib.import_module(pkg + ".engine")
            table, _, src = bc.bench_scene(cfg, BENCH_SLAB, dev)

            def run(seed, total, engine=engine, bc=bc, table=table,
                    src=src):
                return engine.trace_streaming(
                    table, src, torch.Generator().manual_seed(seed), total,
                    max_rounds=bc.max_rounds(cfg, 128),
                    max_path=bc.BENCH[cfg]["max_path"])
            run(1, 4 * BENCH_SLAB)
            runs[name] = run
        walls = {}
        for name in ("parent", "tree", "tree", "parent"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name](2 + len(walls.get(name, [])), 128 * BENCH_SLAB)
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
        log(f"config {cfg}, {128 * BENCH_SLAB:,} rays: " + "; ".join(
            f"{k} median {statistics.median(v):.3f} s of "
            f"{', '.join(f'{w:.3f}' for w in v)}" for k, v in walls.items())
            + f" ({card})")
        out[str(cfg)] = walls
    return out


def main(argv) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="a checkout of an earlier tree to time beside")
    opts = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k2_variants: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from chip_smoke import card_line, k2_bound, time_cuda
    from tracer_tpu_torch.kernels import bounce as kb
    from tracer_tpu_torch.kernels import build
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    work = ROOT / "tracer_tpu_torch" / "_build" / "k2_variants"
    edits = variants()
    # the tree's own source too, for its ptxas report (the package's
    # library may come from its cache, which keeps no report)
    jobs = {name: start_build(name, e, build,
                              work / re.sub(r"\W+", "_", name))
            for name, e in (("tree's report", ()), *edits.items())}
    parent = load_parent(opts.parent.resolve()) if opts.parent else None
    failed = []

    def load(b):
        try:
            b.load()
        except RuntimeError as exc:
            failed.append(exc)
    threads = [threading.Thread(target=load, args=(b,))
               for b in (build, *([parent[1]] if parent else []))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if failed:
        raise SystemExit(f"k2_variants: {failed[0]}")
    libs = {name: finish_build(name, *job, build)
            for name, job in jobs.items()}
    tree_report = libs.pop("tree's report")[1]
    log(f"builds: {time.perf_counter() - t0:.1f} s, all started together "
        f"({card})")
    record = {"card": card, "ptxas": {}, "sass": {}, "k2": []}
    reports = {"tree": tree_report}
    reports.update({name: err for name, (_, err) in libs.items()})
    paths = {"tree": build.info["path"]}
    paths.update({name: str(lib._name) for name, (lib, _) in libs.items()})
    if parent:
        reports["parent"] = parent[1].info["ptxas"]
        paths["parent"] = parent[1].info["path"]
    out = ROOT / "k2_variants_out"
    out.mkdir(exist_ok=True)
    for name, report in reports.items():
        tag = re.sub(r"\W+", "_", name)
        (out / f"k2_ptxas_{tag}.txt").write_text(report)
        lines = build.ptxas_lines(report, "bounce_kernel")
        record["ptxas"][name] = lines
        spilled = [ln for ln in lines if ln[3] or ln[4]]
        regs = [ln[1] for ln in lines] or [0]
        log(f"  ptxas {name}: {len(lines)} K2 instances, {min(regs)}-"
            f"{max(regs)} registers, {len(spilled)} spilling")
        if name in ("tree", "parent") or spilled:
            for entry, reg, stack, st, ld in lines:
                log(f"    {name}: {build.k2_instance_name(entry)}: {reg} "
                    f"registers, {stack} B stack, spill {st} / {ld} B")
    for name, path in paths.items():
        sass = sass_k1(path, build, "bounce_kernel")
        if name == "tree":
            for fn, d in sass.items():
                flags = build.k2_instance_name(fn)[1:-1].replace(", ", "")
                (out / f"k2_sass_{flags}.txt").write_text(d["sass"])
        record["sass"][name] = {fn: {k: d[k] for k in ("stl", "ldl",
                                                       "call")}
                                for fn, d in sass.items()}
        local = sum(d["stl"] + d["ldl"] for d in sass.values())
        log(f"  SASS {name}: {len(sass)} K2 instances, local stores + "
            f"loads {local}, calls "
            f"{sum(d['call'] for d in sass.values())}")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def variant_call(lib, pos_args, kw):
        def run():
            rc, res = kb.launch_k2(lib, *pos_args, stream, **kw)
            build.check(lib, rc, "k2 variant")
            return res
        return run

    for label, pos_args, kw, table, regen in k2_cases(dev, kb):
        calls = {"tree": lambda: kb.bounce_reflect(*pos_args, **kw)}
        calls.update({name: variant_call(lib, pos_args, kw)
                      for name, (lib, _) in libs.items()})
        if parent:
            calls["parent"] = (lambda: parent[0].bounce_reflect(
                *pos_args, **kw))
        ref = calls["tree"]()
        diffs = {name: differing(fn(), ref) for name, fn in calls.items()}
        torch.cuda.synchronize()
        n = pos_args[2].shape[0]
        dead = int((pos_args[4] <= 0.0).sum())
        del ref
        want = kb.bounce_reflect_ref(*pos_args, **kw)
        bound, bound_by = k2_bound(table, pos_args[0], kw, *pos_args[2:5],
                                   want, regen)
        del want
        geo = kb.k2_geometry(pos_args[0], n, **kw)
        names = [k for k in calls if k != "parent"]
        turns = (["parent"] if parent else []) + names + names[::-1] + (
            ["parent"] if parent else [])
        times = {}
        for name in turns:
            times.setdefault(name, []).append(time_cuda(calls[name], 20))
        log(f"K2 {label}: {n} lanes ({dead} dead, regeneration "
            f"{'on' if kw.get('regen') else 'off'}), bound {bound:.4f} ms "
            f"({bound_by}); {geo['blocks']} blocks "
            f"of {geo['threads']} threads, chunks of {geo['chunk']} lanes, "
            f"{geo['smem']} B shared, {geo['resident']} resident a SM on "
            f"{geo['sms']} SMs, {-(-n // geo['chunk']) / geo['blocks']:.2f} "
            f"chunks a block: " + "; ".join(
                f"{name} {', '.join(f'{t:.4f}' for t in ts)} ms"
                + (f" ({diffs[name]} lanes differ)" if diffs[name] else "")
                for name, ts in times.items()) + f" ({card})")
        record["k2"].append({"case": label, "lanes": n, "dead": dead,
                             "bound_ms": bound, "bound_by": bound_by,
                             "geometry": geo, "ms": times, "differ": diffs})
    if parent:
        record["bench"] = bench_turns(dev, card)
        record["trace"] = trace_turns(dev, card)
    (out / "k2_variants.json").write_text(json.dumps(record, indent=1))
    log(f"done in {time.perf_counter() - t0:.1f} s ({card})")


if __name__ == "__main__":
    main(sys.argv[1:])
