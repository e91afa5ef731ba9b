#!/usr/bin/env python3
"""Time K3 (nearest_hit) in variants of its design on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 k3_variants.py                 # the tree and its variants
    python3 k3_variants.py --parent DIR    # and an earlier tree beside

A variant is the tree's kernels/csrc with a text edit of csrc/nearest.cu
(or of the row code it includes, csrc/rows.cuh), nearest.cu built alone
beside the tree with nvcc, all builds started together as k1_variants.py
does. Each of the first puts one of K3's levers back to the earlier
design's code: a fixed 48 KB of shared memory for the rows whatever the
table ("static 48 KB"), one block per lane chunk in place of persistent
blocks (and, the other way, persistent blocks on a streamed table), rows
staged at their own stride rather than padded to 16-byte words, curved
rows solving every root form branch-free, no FLAT_RECT1 or one-slot
instances (a flat group with one rect aperture tested through the loop
over the aperture slots, the slot count read at run time), rays read by
scalar loads from device memory rather than staged by 16-byte cp.async.
Then two other designs: results leaving through each warp's shared
memory as 16-byte stores to each output array, and K2's lane state (the
whole winner kept row by row, BestLane) in place of the distance, row
and group with the aux made after the scan; blocks of 128, 256 and 512
threads (the same registers a thread); and a diagnostic whose results
differ by design: no row tests, to apportion the time. (Two lanes a
thread, each staged row read once for both, ran on an earlier tree and
lost: PERF.md.)

``--parent`` names a checkout of an earlier tree: its tracer_tpu_torch
package is loaded under another name, built from its own sources and
called through its own wrapper, and the MiniDish main paths run end to
end through both: trace_fused of 4,194,304 rays and ray_tracer of
1,048,576 rays with records (each package's own scene and sun), in
turns.

The cases: chip_smoke.py's phase 4 (the MiniDish's sun rays, with and
without the local hit point, and their second bounce at 4,194,304 lanes;
NSTTF's table under its Buie sun, the table with every quadric class and
aperture kind and its 2,017-row version at 2,101,248 lanes), a ragged
lane count (the sun rays less 13 lanes: not a multiple of any block,
chunk or 16-byte word), and the bifacial plates with backside_miss at
2,101,248 lanes. For each case the script prints, per build, the lanes
whose outputs differ from the tree's (every output, every lane) and its
device time (chip_smoke.time_cuda, 20 calls; 3 past 5 ms) in turns:
parent, variants, the variants again in reverse, parent; the case's
bound (chip_smoke.k3_bound) and the tree's launch geometry. It prints
each build's ptxas registers and spill for every K3 instance first, and
writes every number to k3_variants_out/k3_variants.json beside each
build's full ptxas report. It needs the card; it exits 1 without it.
"""
import argparse
import json
import re
import statistics
import sys
import threading
import time
from pathlib import Path

from k1_variants import finish_build, load_parent, log, start_build

ROOT = Path(__file__).resolve().parent
BLOCK = """constexpr int K3_THREADS = 1024;
constexpr int K3_MIN_BLOCKS = 1;"""
# the earlier design's code of each lever, or another design's
STATIC_48K = (("""  const size_t rows_fl = a.part >= a.S ? (size_t)a.S * a.Kp
                                       : 2 * (size_t)a.part * a.Kp;""",
               "  const size_t rows_fl = K3_TABLE_FLOATS;"),)
BLOCKS_LINE = """  const int blocks =
      a.part >= a.S && chunks > sms * resident ? sms * resident : chunks;"""
ONE_CHUNK = ((BLOCKS_LINE, "  const int blocks = chunks;"),)
PERSISTENT_STREAMED = ((BLOCKS_LINE, "  const int blocks = chunks > sms * "
                        "resident ? sms * resident : chunks;"),)
NO_PAD = (("  return (K + 3) & ~3;", "  return K;"),
          ("    const float* r =\n        static_cast<const float*>("
           "__builtin_assume_aligned(sm + i * Kp, 16));",
           "    const float* r = sm + i * Kp;"))
NO_SOLVE = (("row_t_local<CLS, true>(r, kinds, rect_mask, C,",
             "row_t_local<CLS>(r, kinds, rect_mask, C,"),)
NO_RECT1_C1 = (("""        if (mask == 1)
          rows_of_class<FLAT_RECT1>(at, first, count, Kp, kinds, mask, C,
                                    t_eps, disc_eps, bmiss_on, lane);
        else if (mask >= 0)""", "        if (mask >= 0)"),
               ("  if (C == 1) return bmiss", "  if (false) return bmiss"))
SCALAR_LOADS = (("""  warp_in(buf, a.pos + 3 * (size_t)first, 3 * count, lane);
  warp_in(buf + 96, a.dir + 3 * (size_t)first, 3 * count, lane);""",
                 "  (void)count;"),
                ("    const Ray q = {pos[0], pos[1], pos[2], dir[0], dir[1], "
                 "dir[2]};",
                 """    const size_t lr = (size_t)c * T + tid;
    const bool v = lr < (size_t)a.n;
    const Ray q = {v ? a.pos[3 * lr] : 1.0f, v ? a.pos[3 * lr + 1] : 1.0f,
                   v ? a.pos[3 * lr + 2] : 1.0f, v ? a.dir[3 * lr] : 1.0f,
                   v ? a.dir[3 * lr + 1] : 1.0f, v ? a.dir[3 * lr + 2] : 1.0f};
    (void)pos;
    (void)dir;"""))
# each warp's results through its shared memory (13 floats a lane) and out
# as 16-byte stores to each output array
STAGED_STORES = (
    ("// rows [r0, r0 + cnt) into the stage at k3_stride",
     """__device__ __forceinline__ void warp_out(void* dst_v, const float* src,
                                         int n_fl, int lane) {
  float* dst = static_cast<float*>(dst_v);
  const int words = n_fl >> 2;
  for (int i = lane; i < words; i += 32)
    reinterpret_cast<float4*>(dst)[i] =
        reinterpret_cast<const float4*>(src)[i];
  for (int i = 4 * words + lane; i < n_fl; i += 32) dst[i] = src[i];
}

// rows [r0, r0 + cnt) into the stage at k3_stride"""),
    ("  const size_t smem = (12 * (size_t)K3_THREADS + rows_fl) * "
     "sizeof(float);",
     "  const size_t smem = (25 * (size_t)K3_THREADS + rows_fl) * "
     "sizeof(float);"),
    ("  float* rows_sm = rays_sm + 12 * T;",
     "  float* wout = rays_sm + 12 * T + warp * 13 * 32;\n"
     "  int* wout_i = reinterpret_cast<int*>(wout);\n"
     "  float* rows_sm = rays_sm + 25 * T;"),
    ("""    const int l = c * T + tid;
    if (l >= a.n) continue;
    Best b;
    k3_aux(a, rows_sm, whole, w, b);
    const int kfi = static_cast<int>(b.kf);
    a.t[l] = w.t;
    a.sid[l] = w.sid;
    a.normal[3 * (size_t)l] = b.gx;
    a.normal[3 * (size_t)l + 1] = b.gy;
    a.normal[3 * (size_t)l + 2] = b.gz;
    a.local[3 * (size_t)l] = a.need_local ? b.lx : 0.0f;
    a.local[3 * (size_t)l + 1] = a.need_local ? b.ly : 0.0f;
    a.local[3 * (size_t)l + 2] = a.need_local ? b.lz : 0.0f;
    a.up[l] = b.up;
    a.kind[l] = kfi / 1024;
    a.flags[l] = kfi % 1024;
    a.p0[l] = b.p0;
    a.p1[l] = b.p1;
""",
     """    const int first = c * T + 32 * warp;
    const int count = max(0, min(32, a.n - first));
    Best b;
    k3_aux(a, rows_sm, whole, w, b);
    const int kfi = static_cast<int>(b.kf);
    wout[lane] = w.t;
    wout_i[32 + lane] = w.sid;
    wout[64 + lane] = b.up;
    wout_i[96 + lane] = kfi / 1024;
    wout_i[128 + lane] = kfi % 1024;
    wout[160 + lane] = b.p0;
    wout[192 + lane] = b.p1;
    wout[224 + 3 * lane] = b.gx;
    wout[224 + 3 * lane + 1] = b.gy;
    wout[224 + 3 * lane + 2] = b.gz;
    wout[320 + 3 * lane] = a.need_local ? b.lx : 0.0f;
    wout[320 + 3 * lane + 1] = a.need_local ? b.ly : 0.0f;
    wout[320 + 3 * lane + 2] = a.need_local ? b.lz : 0.0f;
    __syncwarp();
    warp_out(a.t + first, wout, count, lane);
    warp_out(a.sid + first, wout + 32, count, lane);
    warp_out(a.up + first, wout + 64, count, lane);
    warp_out(a.kind + first, wout + 96, count, lane);
    warp_out(a.flags + first, wout + 128, count, lane);
    warp_out(a.p0 + first, wout + 160, count, lane);
    warp_out(a.p1 + first, wout + 192, count, lane);
    warp_out(a.normal + 3 * (size_t)first, wout + 224, 3 * count, lane);
    warp_out(a.local + 3 * (size_t)first, wout + 320, 3 * count, lane);
"""))
# K2's lane state: the whole winner, row by row (BestLane)
WHOLE_WINNER = (
    ("    Near w = {q, INFINITY, INFINITY, -1, 0};",
     "    Near w = {q, INFINITY, INFINITY, -1, 0};\n    Best bw;\n"
     "    best_init(bw);\n    BestLane full = {q, bw};"),
    ("a.S, a.t_eps, a.disc_eps, kBmiss, w);",
     "a.S, a.t_eps, a.disc_eps, kBmiss, full);"),
    ("r1, a.t_eps, a.disc_eps, kBmiss, w);",
     "r1, a.t_eps, a.disc_eps, kBmiss, full);"),
    ("    Best b;\n    k3_aux(a, rows_sm, whole, w, b);",
     "    const Best& b = bw;"),
    ("    a.t[l] = w.t;\n    a.sid[l] = w.sid;",
     "    a.t[l] = b.t;\n    a.sid[l] = b.sid;"))
# a diagnostic, whose results differ by design
NO_ROWS = (("  for (int g = 0; g < G; ++g) {\n"
            "    const int* m = gmeta + g * meta_w;",
            "  for (int g = 0; g < 0; ++g) {\n"
            "    const int* m = gmeta + g * meta_w;"),)
# (threads a block, blocks resident a SM that __launch_bounds__ asks for)
BLOCKS = ((128, 8), (256, 4), (512, 2))
SLAB = 2 * ((1 << 20) // 3072 * 3072 + 3072)    # bench.py's: 684 tiles
MD_RECORDED = 1_048_576


def variants() -> dict:
    """name -> edits of csrc/nearest.cu (and rows.cuh)."""
    def block(threads, blocks):
        return ((BLOCK, f"constexpr int K3_THREADS = {threads};\n"
                 f"constexpr int K3_MIN_BLOCKS = {blocks};"),)
    out = {"static 48 KB": STATIC_48K, "one block per lane chunk": ONE_CHUNK,
           "persistent blocks on streamed tables": PERSISTENT_STREAMED,
           "stride-K rows": NO_PAD, "branch-free roots": NO_SOLVE,
           "no FLAT_RECT1 or one-slot instances": NO_RECT1_C1,
           "scalar ray loads": SCALAR_LOADS,
           "16-byte stores through shared memory": STAGED_STORES,
           "whole winner a lane (K2's)": WHOLE_WINNER}
    for t, n in BLOCKS:
        out[f"{t} threads, min blocks {n}"] = block(t, n)
    out["no row tests (diagnostic)"] = NO_ROWS
    return out


def k3_cases(dev):
    """(label, table, pos, dirs, keywords) of every timed K3 call."""
    import torch
    import tracer_tpu_torch as ptt
    from chip_smoke import k3_cases as phase4_cases
    from test_torch_gpu import bifacial_assembly, fuzz_rays
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn
    table, meta, info = build_scene(device=dev)
    cases = list(phase4_cases(dev, table, make_source_fn(info, SLAB)))
    label, md_table, pos, dirs, kw = cases[0]
    n = pos.shape[0] - 13
    cases.append((f"{label}, {n} lanes (ragged)", md_table,
                  pos[:n].contiguous(), dirs[:n].contiguous(), kw))
    bf_table, bf_meta = ptt.compile_scene(bifacial_assembly(ptt), device=dev)
    bf = [torch.as_tensor(a, device=dev) for a in fuzz_rays(bf_meta, SLAB, 8)]
    cases.append(("bifacial plates, backside_miss", bf_table, bf[0], bf[1],
                  dict(need_local=True, backside_miss=True)))
    return cases


def flat(res):
    """nearest_hit's results as one tuple of tensors."""
    t, sid, aux = res
    return (t, sid, *(aux[k] for k in ("normal", "local", "up_dot", "kind",
                                       "flags", "p0", "p1")))


def differing(got, ref) -> int:
    """Lanes on which any output differs (NaN equals NaN)."""
    bad = None
    for g, r in zip(flat(got), flat(ref)):
        ne = g != r
        if g.is_floating_point():
            ne &= ~(g.isnan() & r.isnan())
        ne = ne.any(1) if g.dim() == 2 else ne
        bad = ne if bad is None else bad | ne
    return int(bad.sum())


def md_turns(dev, card) -> dict:
    """chip_smoke.py's MiniDish main paths through the tree's package and
    the parent's, each with its own scene and sun: trace_fused of
    4,194,304 rays (20 bounces, the 50x50 receiver flux map) and
    ray_tracer of 1,048,576 rays with full records, after one untimed
    run each; wall times ending in a synchronize in turns (parent, tree,
    tree, parent, twice)."""
    import importlib
    import math
    import numpy as np
    import torch
    from chip_smoke import MD_LANES
    runs = {}
    for name, pkg in (("tree", "tracer_tpu_torch"),
                      ("parent", "tracer_tpu_torch_parent")):
        mods = {m: importlib.import_module(f"{pkg}.{m}") for m in (
            "spatial", "scene", "sources", "engine",
            "models.tau_minidish", "analysis.device_fluxmap")}
        asm = mods["models.tau_minidish"].MiniDish(5.0, 6.25, 0.9, 6.95,
                                                   0.4, 0.7, 0.9)
        asm.set_transform(mods["spatial"].rotx(-np.pi / 4))
        table, meta = mods["scene"].compile_scene(asm, dtype=torch.float32,
                                                  device=dev)
        x = -1.0 / math.sqrt(2.0)
        sun = mods["sources"].solar_disk_bundle(
            torch.Generator(device=dev).manual_seed(42), MD_LANES,
            center=[0.0, 7.0, 7.0], direction=[0.0, x, x], radius=3.0,
            ang_range=0.005, flux=1000.0, device=dev)
        spec = mods["analysis.device_fluxmap"].flux_plan(meta, "receiver",
                                                         resolution=50)
        eng = mods["engine"]
        head = type(sun)(**{k: None if v is None
                            else v[:MD_RECORDED].contiguous()
                            for k, v in sun.__dict__.items()})

        def fused(eng=eng, table=table, sun=sun, spec=spec):
            return eng.trace_fused(table, sun, max_bounces=20,
                                   fluxspecs=(spec,))

        def tracer(eng=eng, table=table, meta=meta, head=head):
            return eng.TracerEngine(table, meta).ray_tracer(head, reps=100)
        fused()
        tracer()
        runs[name] = {"trace_fused": fused, "ray_tracer": tracer}
    out = {}
    for path in ("trace_fused", "ray_tracer"):
        walls = {}
        for name in ("parent", "tree", "tree", "parent") * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[name][path]()
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
        log(f"MiniDish {path}: " + "; ".join(
            f"{k} median {statistics.median(v) * 1e3:.2f} ms of "
            f"{', '.join(f'{w * 1e3:.2f}' for w in v)}"
            for k, v in walls.items()) + f" ({card})")
        out[path] = walls
    return out


def main(argv) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="a checkout of an earlier tree to time beside")
    opts = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k3_variants: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from chip_smoke import card_line, k3_bound, k3_geometry_line, time_cuda
    from tracer_tpu_torch.kernels import bounce as kb
    from tracer_tpu_torch.kernels import build
    from tracer_tpu_torch.kernels import nearest as kn
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    work = ROOT / "tracer_tpu_torch" / "_build" / "k3_variants"
    edits = variants()
    # the tree's own source too, for its ptxas report (the package's
    # library may come from its cache, which keeps no report)
    jobs = {name: start_build(name, e, build,
                              work / re.sub(r"\W+", "_", name), "nearest.cu")
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
        raise SystemExit(f"k3_variants: {failed[0]}")
    libs = {name: finish_build(name, *job, build)
            for name, job in jobs.items()}
    tree_report = libs.pop("tree's report")[1]
    log(f"builds: {time.perf_counter() - t0:.1f} s, all started together "
        f"({card})")
    record = {"card": card, "ptxas": {}, "k3": []}
    reports = {"tree": tree_report}
    reports.update({name: err for name, (_, err) in libs.items()})
    if parent:
        reports["parent"] = parent[1].info["ptxas"]
    out = ROOT / "k3_variants_out"
    out.mkdir(exist_ok=True)
    for name, report in reports.items():
        tag = re.sub(r"\W+", "_", name)
        (out / f"k3_ptxas_{tag}.txt").write_text(report)
        lines = build.ptxas_lines(report, "nearest_kernel")
        record["ptxas"][name] = lines
        for entry, reg, stack, st, ld in lines:
            log(f"  ptxas {name}: K3 {build.k3_instance_name(entry)}: {reg} "
                f"registers, {stack} B stack, spill {st} / {ld} B")
    stream = torch.cuda.current_stream(dev).cuda_stream

    def variant_call(lib, args, kw):
        def run():
            rc, res = kn.launch_k3(lib, *args, stream, **kw)
            build.check(lib, rc, "k3 variant")
            return res
        return run

    for label, table, pos, dirs, kw in k3_cases(dev):
        rows = kb.pack_rows(table)
        args = (rows, pos, dirs, table.groups, 3e-4)
        calls = {"tree": lambda: kn.nearest_hit(*args, **kw)}
        calls.update({name: variant_call(lib, args, kw)
                      for name, (lib, _) in libs.items()})
        if parent:
            calls["parent"] = lambda: parent[2].nearest_hit(*args, **kw)
        ref = calls["tree"]()
        diffs = {name: differing(fn(), ref) for name, fn in calls.items()}
        torch.cuda.synchronize()
        del ref
        n = pos.shape[0]
        bnd = k3_bound(table, n)
        geo = kn.k3_geometry(rows, n, kw["backside_miss"])
        names = [k for k in calls if k != "parent"]
        turns = (["parent"] if parent else []) + names + names[::-1] + (
            ["parent"] if parent else [])
        reps = 20 if time_cuda(calls["tree"], 1) < 5.0 else 3
        times = {}
        for name in turns:
            times.setdefault(name, []).append(time_cuda(calls[name], reps))
        log(f"K3 {label}: {n} lanes, {table.num_rows} rows, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}); "
            f"{k3_geometry_line(kn, rows, n, kw)}: " + "; ".join(
                f"{name} {', '.join(f'{t:.4f}' for t in ts)} ms"
                + (f" ({diffs[name]} lanes differ)" if diffs[name] else "")
                for name, ts in times.items()) + f" ({card})")
        record["k3"].append({"case": label, "lanes": n,
                             "rows": table.num_rows, "bound_ms": bnd[0],
                             "bound_by": bnd[1], "geometry": geo,
                             "ms": times, "differ": diffs})
    if parent:
        record["minidish"] = md_turns(dev, card)
    (out / "k3_variants.json").write_text(json.dumps(record, indent=1))
    log(f"done in {time.perf_counter() - t0:.1f} s ({card})")


if __name__ == "__main__":
    main(sys.argv[1:])
