#!/usr/bin/env python3
"""Time K1 (bounce_reflect_culled) in variants of its design on one card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 k1_variants.py                 # the tree and its variants
    python3 k1_variants.py --parent DIR    # and an earlier tree beside

A variant is the tree's kernels/csrc with a text edit of
csrc/bounce.cu, built beside the tree with nvcc (all builds started
together): the sub-tile split K1_SPLIT set to each other value of
SPLITS, plain 16-byte loads in place of the asynchronous copies
("loads"), every K1 instance's __launch_bounds__ asking for each of
MIN_BLOCKS blocks resident a SM, or the NSTTF instance's lanes meeting
the candidate rows one at a time ("lanes one at a time"); and two
diagnostics whose results
differ by design, to apportion the time: no row tests, and no
regeneration. The tree's own build also runs with the tiles in their
identity order in place of the heaviest-first one ("identity order").
``--parent`` names a checkout of an earlier tree: its tracer_tpu_torch
package is loaded under another name, built from its own sources and
called through its own wrapper; K2 (on the NSTTF rows and the
MiniDish's) and K3 (on the NSTTF rows and the table with every class and
aperture kind) are timed against it too, since the row code of
csrc/rows.cuh is shared, and so is chip_smoke.py's phase 5 NSTTF trace
end to end (537,919,488 rays, each package's own scene, culling and
engine; host wall ending in a synchronize, in turns).

The K1 cases are chip_smoke.py's timed calls: phase 3's NSTTF slab
(2,101,248 lanes, the second round's state), phase 10's modes and phase
12's parked modes with parking on and off (every tile of the benchmark
slab, aimed lanes, 40% dead, a quarter tile's quota each). For each case
the script prints, per build, the lanes whose outputs differ from the
tree's and its device time (chip_smoke.time_cuda, 20 calls) in turns:
parent, variants, the variants again in reverse, parent. It prints each
build's ptxas report for K1 first, with the local-memory stores, loads
and calls in the SASS of each K1 instance (cuobjdump), and writes every
number to k1_variants_out/k1_variants.json, each build's full ptxas
report and the tree's K1 SASS beside it. It needs the card; it exits 1
without it.
"""
import argparse
import json
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SPLITS = (2, 3, 4, 6, 12)
MIN_BLOCKS = (2, 3, 4, 5)
BOUNDS = "  return kGeneral ? 3 : 4;"
# the NSTTF instance's lanes meet the rows one at a time, each lane reading
# every row again, in place of all of a thread's lanes a row
LANE_OUTER = (("    for (int g = 0; g < a.G; ++g) {\n"
               "      const int off = a.gmeta[a.meta_w * g];",
               "#pragma unroll\n    for (int jj = 0; jj < K1_PER; ++jj)\n"
               "    for (int g = 0; g < a.G; ++g) {\n"
               "      const int off = a.gmeta[a.meta_w * g];"),
              ("#pragma unroll\n        for (int j = 0; j < K1_PER; ++j) {\n"
               "          const float th =",
               "        for (int j = jj; j == jj; ++j) {\n"
               "          const float th ="))
# diagnostics, whose results differ by design: no row tests (every lane
# misses), no regeneration (dead lanes keep their staged rays)
NO_ROWS = (("const int cnt = a.counts[(size_t)b * a.G + g];",
            "const int cnt = 0;"),
           ("a.counts[(size_t)b * a.G + g], a.K, kinds,",
            "0, a.K, kinds,"))
NO_REGEN = (("remaining, warp_dead, running)) {",
             "remaining, warp_dead, running) && false) {"),
            ("      if (reborn) {\n        sample_cell(",
             "      if (false) {\n        sample_cell("))

SLAB = 2 * ((1 << 20) // 3072 * 3072 + 3072)    # bench.py's: 684 tiles
# plain 16-byte (and 4-byte) loads and stores in place of cp.async
LOADS = (("  __pipeline_memcpy_async(dst, src, 16);",
          "  *reinterpret_cast<float4*>(dst) =\n"
          "      *reinterpret_cast<const float4*>(src);"),
         ("  __pipeline_memcpy_async(dst, src, 4);", "  *dst = *src;"))


def log(msg: str) -> None:
    print(msg, flush=True)


def variants(source: str) -> dict:
    """name -> edits of csrc/bounce.cu: every other split, and loads."""
    split = int(re.search(r"constexpr int K1_SPLIT = (\d+);",
                          source).group(1))
    out = {f"split {s}": ((f"constexpr int K1_SPLIT = {split};",
                           f"constexpr int K1_SPLIT = {s};"),)
           for s in SPLITS if s != split}
    out["loads"] = LOADS
    for n in MIN_BLOCKS:
        out[f"min blocks {n}"] = ((BOUNDS, f"  return {n};"),)
    out["lanes one at a time"] = LANE_OUTER
    out["no row tests (diagnostic)"] = NO_ROWS
    out["no regeneration (diagnostic)"] = NO_REGEN
    return out


def sass_k1(lib_path, build, what: str = "bounce_culled") -> dict:
    """Each K1 instance's SASS (cuobjdump beside nvcc; with ``what``, each
    kernel whose mangled name holds it) and its counts of local stores,
    local loads and calls."""
    tool = Path(build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib_path)],
                          capture_output=True, text=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split()[0]
        if what in name:
            out[name] = dict(sass=part, stl=part.count(" STL"),
                             ldl=part.count(" LDL"), call=part.count(" CALL"))
    return out


def start_build(name, edits, build, out_dir, source="bounce.cu"):
    """nvcc on an edited copy of csrc/ into out_dir: ``source`` alone (the
    variants differ in one kernel), each (old, new) edit made in whichever
    of the copy's sources and headers holds ``old``. Returns (process,
    library path)."""
    if out_dir.exists():
        shutil.rmtree(out_dir)
    shutil.copytree(build._CSRC, out_dir)
    texts = {p: p.read_text() for p in sorted(out_dir.iterdir())
             if p.suffix in (".cu", ".cuh")}
    for old, new in edits:
        holders = [p for p, text in texts.items() if old in text]
        if not holders:
            raise SystemExit(f"k1_variants: {name}: {old!r} not in the "
                             "source")
        for p in holders:
            texts[p] = texts[p].replace(old, new)
    for p, text in texts.items():
        p.write_text(text)
    so = out_dir / "libk1.so"
    proc = subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
         "-o", str(so), str(out_dir / source)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    return proc, so


def finish_build(name, proc, so, build):
    import ctypes
    err = proc.communicate()[1]
    if proc.returncode != 0:
        raise SystemExit(f"k1_variants: nvcc failed on {name}:\n{err}")
    lib = ctypes.CDLL(str(so))
    for fn, args in build._SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = ctypes.c_int
    if hasattr(lib, "tt_error_string"):      # bounce.cu's
        lib.tt_error_string.argtypes = [ctypes.c_int]
        lib.tt_error_string.restype = ctypes.c_char_p
    return lib, err


def load_parent(path: Path):
    """An earlier tree's tracer_tpu_torch package, under the name
    tracer_tpu_torch_parent (its modules import one another relatively)."""
    import importlib
    import importlib.util
    pkg = path / "tracer_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "tracer_tpu_torch_parent", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["tracer_tpu_torch_parent"] = mod
    spec.loader.exec_module(mod)
    return (importlib.import_module("tracer_tpu_torch_parent.kernels.bounce"),
            importlib.import_module("tracer_tpu_torch_parent.kernels.build"),
            importlib.import_module(
                "tracer_tpu_torch_parent.kernels.nearest"))


def k1_cases(dev, kb):
    """(label, positional args, keywords, culling order) of every timed
    K1 call of chip_smoke.py's phases 3, 10 and 12."""
    import torch
    from chip_smoke import AUREOLE_K1_MODES, PHASE10_K1_MODES
    from test_torch_gpu import k1_args, k1_lanes, k1_scene
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn

    def i32(a):
        return torch.as_tensor(a, dtype=torch.int32, device=dev)

    table, meta, info = build_scene(device=dev)
    spec = make_source_fn(info, SLAB).pallas_spec
    culling = build_block_culling(table, meta, spec, SLAB)
    nb = culling.nb
    rows = kb.pack_rows(table)
    tab = (rows, i32(culling.lists), i32(culling.counts),
           torch.arange(nb, dtype=torch.int32, device=dev),
           torch.as_tensor(culling.cell_bounds, device=dev))
    kw = dict(source_spec=spec, bivar=True, one_sided=True, slope=True)
    n = nb * kb.TILE
    pos = torch.zeros((n, 3), device=dev)
    dirs = torch.zeros((n, 3), device=dev)
    dirs[:, 2] = 1.0
    rem = torch.full((nb,), kb.TILE, dtype=torch.int32, device=dev)
    act = torch.ones((nb,), dtype=torch.int32, device=dev)
    o = kb.bounce_reflect_culled(*tab, 5, rem, act, pos, dirs,
                                 torch.zeros((n,), device=dev), table.groups,
                                 culling.group_offsets, 3e-4, **kw)
    e = torch.where(o[3] >= 0, o[2], 0.0)
    yield ("NSTTF instance, phase 3",
           (*tab, 6, torch.full_like(rem, kb.TILE // 4), act, o[0], o[1], e,
            table.groups, culling.group_offsets, 3e-4), kw,
           i32(culling.order))
    del o, e
    for label, mode, park in ([(lb, m, False) for lb, m in PHASE10_K1_MODES]
                              + [(lb, m, True)
                                 for lb, m in AUREOLE_K1_MODES]):
        table, meta, culling, spec = k1_scene(mode, 218, SLAB, dev,
                                              park_aureole=park)
        tiles = tuple(range(culling.nb))
        lanes = k1_lanes(meta, culling, tiles, 8, 0.4, dev, spec[13])
        rem = torch.full((culling.nb,), kb.TILE // 4, dtype=torch.int32,
                         device=dev)
        act = torch.ones(culling.nb, dtype=torch.int32, device=dev)
        pos_args, kw = k1_args(table, culling, spec, tiles, 23, lanes, rem,
                               act)
        order = i32(culling.order)
        if park:
            yield f"{label}, parking", pos_args, kw, order
            yield (f"{label}, no parking", pos_args,
                   dict(kw, park_aureole=False), order)
        else:
            yield label, pos_args, kw, order


def differing(got, ref) -> int:
    """Lanes on which any output differs (NaN equals NaN)."""
    bad = got[3] != ref[3]
    for g, r in zip(got, ref):
        ne = g != r
        if g.is_floating_point():
            ne &= ~(g.isnan() & r.isnan())
        bad |= ne.any(1) if g.dim() == 2 else ne
    return int(bad.sum())


def main(argv) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="a checkout of an earlier tree to time beside")
    opts = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k1_variants: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    from chip_smoke import card_line, time_cuda
    from tracer_tpu_torch.kernels import bounce as kb
    from tracer_tpu_torch.kernels import build
    from tracer_tpu_torch.kernels import nearest as kn
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    work = ROOT / "tracer_tpu_torch" / "_build" / "variants"
    edits = variants((build._CSRC / "bounce.cu").read_text())
    jobs = {name: start_build(name, e, build,
                              work / re.sub(r"\W+", "_", name))
            for name, e in edits.items()}
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
        raise SystemExit(f"k1_variants: {failed[0]}")
    libs = {name: finish_build(name, *job, build)
            for name, job in jobs.items()}
    log(f"builds: {time.perf_counter() - t0:.1f} s, all started together "
        f"({card})")
    record = {"card": card, "ptxas": {}, "k1": [], "k2_k3": []}
    reports = {"tree": build.info["ptxas"]}
    reports.update({name: err for name, (_, err) in libs.items()})
    if parent:
        reports["parent"] = parent[1].info["ptxas"]
    out = ROOT / "k1_variants_out"
    out.mkdir(exist_ok=True)
    for name, report in reports.items():
        tag = re.sub(r"\W+", "_", name)
        (out / f"k1_ptxas_{tag}.txt").write_text(report)
    built = [("tree", build.info["path"])]
    if parent:
        built.append(("parent", parent[1].info["path"]))
    for name, path in built:
        for fn, d in sass_k1(path, build).items():
            log(f"  SASS {name}: {fn}: {d['stl']} STL, {d['ldl']} LDL, "
                f"{d['call']} CALL")
            if name == "tree":
                (out / f"k1_sass_{fn[-40:]}.txt").write_text(d["sass"])
    for name, report in reports.items():
        for what in ("bounce_culled", "bounce_kernel", "nearest"):
            lines = build.ptxas_lines(report, what)
            if what != "bounce_culled" and name != "tree" \
                    and name != "parent":
                continue
            record["ptxas"].setdefault(name, []).extend(lines)
            for entry, regs, stack, st, ld in lines:
                if what == "bounce_culled" or (st or ld):
                    log(f"  ptxas {name}: {entry}: {regs} registers, "
                        f"{stack} B stack, spill {st} / {ld} B")
        regs = [ln[1] for ln in build.ptxas_lines(report,
                                                      "bounce_kernel")]
        if regs and name in ("tree", "parent"):
            log(f"  ptxas {name}: K2's {len(regs)} instances {min(regs)}-"
                f"{max(regs)} registers; K3 "
                + ", ".join(str(ln[1]) for ln in build.ptxas_lines(
                    report, "nearest")))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def variant_call(lib, pos_args, kw, order):
        def run():
            rc, out = kb.launch_k1(lib, *pos_args, stream, order=order, **kw)
            build.check(lib, rc, "k1 variant")
            return out
        return run

    for label, pos_args, kw, order in k1_cases(dev, kb):
        identity = torch.arange(order.shape[0], dtype=torch.int32,
                                device=dev)
        calls = {"tree": lambda: kb.bounce_reflect_culled(
                     *pos_args, order=order, **kw),
                 "identity order": lambda: kb.bounce_reflect_culled(
                     *pos_args, order=identity, **kw)}
        calls.update({name: variant_call(lib, pos_args, kw, order)
                      for name, (lib, _) in libs.items()})
        if parent:
            calls["parent"] = (lambda: parent[0].bounce_reflect_culled(
                *pos_args, **kw))
        ref = calls["tree"]()
        diffs = {name: differing(fn(), ref) for name, fn in calls.items()}
        torch.cuda.synchronize()
        del ref
        names = [k for k in calls if k != "parent"]
        turns = (["parent"] if parent else []) + names + names[::-1] + (
            ["parent"] if parent else [])
        times = {}
        for name in turns:
            times.setdefault(name, []).append(time_cuda(calls[name], 20))
        log(f"K1 {label}: " + "; ".join(
            f"{name} {', '.join(f'{t:.4f}' for t in ts)} ms"
            + (f" ({diffs[name]} lanes differ)" if diffs[name] else "")
            for name, ts in times.items()) + f" ({card})")
        record["k1"].append({"case": label, "ms": times, "differ": diffs})
    if parent:
        record["k2_k3"] = k2_k3_turns(dev, kb, kn, parent, time_cuda, card)
        record["trace"] = trace_turns(dev, card)
    (out / "k1_variants.json").write_text(json.dumps(record, indent=1))
    log(f"done in {time.perf_counter() - t0:.1f} s ({card})")


def k2_k3_turns(dev, kb, kn, parent, time_cuda, card) -> list:
    """K2 on the NSTTF rows (bench slab, the second round's lanes, as
    chip_smoke.py's phase 3) and in the MiniDish mode (700,416 lanes), K3
    on the NSTTF rows and on the table with every class and aperture kind
    (2,101,248 lanes, as phase 4), the tree's and the parent's in turns
    (parent, tree, tree, parent)."""
    import torch
    import tracer_tpu_torch as ptt
    from test_torch_gpu import fuzz_assembly, fuzz_rays, k2_mode
    from tracer_tpu_torch.culling import build_block_culling
    from tracer_tpu_torch.models.nsttf import build_scene, make_source_fn
    p_kb, _, p_kn = parent
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
    pos, dirs, e = o[0], o[1], torch.where(o[3] >= 0, o[2], 0.0)
    mode = k2_mode("minidish", 228 * kb.TILE, 3, dev)
    fz_table, fz_meta = ptt.compile_scene(fuzz_assembly(ptt, 0), device=dev)
    fz = [torch.as_tensor(a, device=dev) for a in fuzz_rays(fz_meta, SLAB,
                                                             5)]
    fz_rows = kb.pack_rows(fz_table)
    cases = {
        "K2 NSTTF rows": lambda m: m[0].bounce_reflect(
            rows, 7, pos, dirs, e, table.groups, 3e-4, **kw),
        "K2 MiniDish mode": lambda m: m[0].bounce_reflect(
            mode[2], 17, mode[3], mode[4], mode[5], mode[0].groups, 3e-4,
            **mode[6]),
        "K3 NSTTF rows": lambda m: m[1].nearest_hit(
            rows, pos, dirs, table.groups, 3e-4),
        "K3 every class and aperture kind": lambda m: m[1].nearest_hit(
            fz_rows, fz[0], fz[1], fz_table.groups, 3e-4)}
    out = []
    for label, fn in cases.items():
        mods = {"tree": (kb, kn), "parent": (p_kb, p_kn)}
        times = {}
        for name in ("parent", "tree", "tree", "parent"):
            times.setdefault(name, []).append(
                time_cuda(lambda: fn(mods[name]), 20))
        log(f"{label}: " + "; ".join(
            f"{k} {', '.join(f'{t:.4f}' for t in v)} ms"
            for k, v in times.items()) + f" ({card})")
        out.append({"case": label, "ms": times})
    return out


def trace_turns(dev, card) -> dict:
    """chip_smoke.py's phase 5 trace (NSTTF scene, culling at the bench
    slab, 537,919,488 rays, max_rounds 600, max_path 8, min_energy 1e-6,
    the 50x50 receiver flux map) through the tree's package and the
    parent's, each with its own scene, culling and engine, after one
    short untimed trace each: wall times ending in a synchronize in turns
    (parent, tree, tree, parent, twice) and each trace's receiver
    fraction."""
    import importlib
    import statistics
    import torch
    runs = {}
    for name, pkg in (("tree", "tracer_tpu_torch"),
                      ("parent", "tracer_tpu_torch_parent")):
        nsttf = importlib.import_module(pkg + ".models.nsttf")
        culling = importlib.import_module(pkg + ".culling")
        engine = importlib.import_module(pkg + ".engine")
        fluxmap = importlib.import_module(pkg + ".analysis.device_fluxmap")
        table, meta, info = nsttf.build_scene(device=dev)
        src = nsttf.make_source_fn(info, SLAB)
        cul = culling.build_block_culling(table, meta, src.pallas_spec, SLAB)
        fspec = fluxmap.flux_plan(meta, "receiver", resolution=50)
        rec = int((meta.row_logical == meta.index_of("receiver"))
                  .nonzero()[0][0])

        def run(seed, total, engine=engine, table=table, src=src, cul=cul,
                fspec=fspec, rec=rec):
            accum, _, source_e = engine.trace_streaming(
                table, src, torch.Generator().manual_seed(seed), total,
                max_rounds=600, max_path=8, min_energy=1e-6, culling=cul,
                fluxspecs=(fspec,))
            return float(accum.absorbed[rec]) / float(source_e)
        run(1, 4 * SLAB)
        runs[name] = run
    walls, recs = {}, {}
    for name in ("parent", "tree", "tree", "parent") * 2:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frac = runs[name](len(walls.get(name, [])), 256 * SLAB)
        torch.cuda.synchronize()
        walls.setdefault(name, []).append(time.perf_counter() - t0)
        recs.setdefault(name, []).append(frac)
    log(f"NSTTF trace, {256 * SLAB:,} rays: " + "; ".join(
        f"{k} median {statistics.median(v):.3f} s of "
        f"{', '.join(f'{w:.3f}' for w in v)}, receiver "
        f"{', '.join(f'{r:.5f}' for r in recs[k])}"
        for k, v in walls.items()) + f" ({card})")
    return {"walls": walls, "receiver": recs}


if __name__ == "__main__":
    main(sys.argv[1:])
