"""K1 (the windowed segment aggregate) at its three shapes, for one or more
source trees in turns on one card.

    python3 bench_k1.py [--trees DIR [DIR ...]] [--only SHAPE ...]
                        [--seed 123] [--stages]

Each tree runs in a process of its own, from its own directory, through
that tree's `chip_smoke.compare_k1` (so two commits are held to the same
harness): K1 against its plain version, twice for bit-stable output, then
its times. The shapes are those `chip_smoke.py` measures:

- main: 4,320 rows x 12 segments, f64 (TSBS `cpu_max_all_8`, the shape
  the main path launches most);
- whole_table: 10,000,000 rows x 27,800 segments, f64 (the TSBS table in
  the `double_groupby` layout: 100 series, 278 buckets each);
- hits: 4,500,000 rows x 62 segments, int64, a segment id drawn anew for
  every row (the ClickBench hits phase's most launched shape).

`--only` keeps the named shapes (main, whole_table, hits) for a quick
run. `bound_ms` is computed here, from the function's own bytes (13 B a row
in, 28 B a segment out) at 3.35 TB/s, whatever the tree's harness counts.
To compare a commit with its parent, unpack the parent into the
git-ignored `_ab/` and give the trees in turns:

    git archive HEAD~1 | (mkdir -p _ab/parent && tar -x -C _ab/parent)
    python3 bench_k1.py --trees _ab/parent . . _ab/parent

`--stages` also times this script's own tree's kernel cut short after each
tile's loads, its serial pass and its warp scan (built with -DK1_STOP=1, 2,
3; their results are wrong and not checked), beside the whole kernel, at
the whole_table and hits shapes: where a tile's time goes.

Prints one JSON line per run, the card's name and power limit, and a last
JSON line with every run. Exits non-zero without a CUDA card or when a run
fails.
"""
import argparse
import json
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12         # H100 SXM, NVIDIA data sheet
SHAPES = {
    "main": dict(shape=(4320, 12, "torch.float64"), n_series=1),
    "whole_table": dict(shape=(10_000_000, 27_800, "torch.float64"),
                        n_series=100, grouped=True, call=False),
    "hits": dict(shape=(4_500_000, 62, "torch.int64"), scattered=True,
                 call_iters=5),
}
SEED_OFFSET = {"main": 0, "whole_table": 1, "hits": 3}   # as chip_smoke.py
KEYS = ("ms", "kernel_ms", "call_ms", "plain_ms", "library_ms",
        "max_abs_err")


def worker(tree: str, seed: int, only: list) -> int:
    """Run the shapes through `tree`'s chip_smoke.compare_k1."""
    tree = os.path.abspath(tree)
    sys.path[0] = tree
    import torch

    if not torch.cuda.is_available():
        print("bench_k1: no CUDA card", file=sys.stderr)
        return 2
    import chip_smoke
    from cnosdb_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    cuda_build.library("segment_window")
    out = {"tree": tree, "build_s": time.perf_counter() - t}
    for name, kw in SHAPES.items():
        if name not in only:
            continue
        kw = dict(kw)
        shape = kw.pop("shape")
        r = chip_smoke.compare_k1(shape, seed + SEED_OFFSET[name], dev, **kw)
        moved = shape[0] * (8 + 1 + 4) + shape[1] * (4 + 8 * 3)
        bound = moved / HBM_BYTES_PER_S * 1e3
        out[name] = {"at": list(shape), **{k: r[k] for k in KEYS},
                     "bound_ms": bound, "bytes": moved,
                     "bound_share": bound / r["kernel_ms"]}
    print(json.dumps(out), flush=True)
    return 0


def stage_worker(tree: str, seed: int) -> int:
    """kernel_ms of `tree`'s K1 built whole and cut at each stage."""
    import ctypes

    tree = os.path.abspath(tree)
    sys.path[0] = tree
    import numpy as np
    import torch

    import chip_smoke
    from cnosdb_tpu_torch.ops import cuda_build
    from cnosdb_tpu_torch.ops import pallas_kernels as pk

    out_dir = os.path.join(cuda_build.BUILD_DIR, "stages")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(cuda_build.CSRC, "segment_window.cu")
    nvcc = cuda_build._nvcc()
    procs = {}
    for stop in (0, 1, 2, 3):
        lib = os.path.join(out_dir, f"segment_window_stop{stop}.so")
        procs[stop] = (lib, subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, f"-DK1_STOP={stop}", "-o", lib,
             src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for stop, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-3000:], file=sys.stderr)
            return 1
        lib, held = ctypes.CDLL(path), ctypes.PyDLL(path)
        for fn, (argtypes, restype) in \
                cuda_build._SIGNATURES["segment_window"].items():
            f = getattr(held if fn in cuda_build._HOLD_GIL else lib, fn)
            f.argtypes, f.restype = argtypes, restype
            setattr(lib, fn, f)
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        libs[stop] = lib
    dev = torch.device("cuda", 0)
    out = {"tree": tree}
    for name in ("whole_table", "hits"):
        kw = SHAPES[name]
        n, ns, dt = kw["shape"]
        vals, valid, seg = chip_smoke.k1_case(
            n, ns, kw.get("n_series", 1), kw.get("grouped", False),
            dt.split(".")[1], seed + SEED_OFFSET[name], False, True,
            kw.get("scattered", False))
        args = [torch.from_numpy(vals).to(dev),
                torch.from_numpy(valid.astype(np.int8)).to(dev),
                torch.from_numpy(seg).to(dev)]
        layout = pk.window_layout(seg, ns)
        out[name] = {}
        for stop, lib in libs.items():
            cuda_build.library = lambda _name, lib=lib: lib
            launch = pk.prepare(*args, layout, ns)
            out[name][f"stop{stop}" if stop else "whole_kernel"] = \
                chip_smoke.cuda_ms(launch, iters=200)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--only", nargs="+", choices=list(SHAPES),
                    default=list(SHAPES))
    ap.add_argument("--stages", action="store_true")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--stage-worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.seed, args.only)
    if args.stage_worker:
        return stage_worker(args.stage_worker, args.seed)
    import torch

    if not torch.cuda.is_available():
        print("bench_k1: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = []
    jobs = [("--worker", tree) for tree in args.trees]
    if args.stages:
        jobs.append(("--stage-worker", os.path.dirname(__file__)))
    for flag, tree in jobs:
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), flag, tree,
             "--seed", str(args.seed), "--only", *args.only],
            cwd=tree, capture_output=True, text=True, timeout=1200)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"bench_k1: {tree} failed (rc {proc.returncode})",
                  file=sys.stderr)
            return 1
        line = proc.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        runs.append(json.loads(line))
    print(smi, flush=True)
    print(json.dumps({"card": smi, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
