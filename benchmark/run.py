"""The benchmark of cnosdb_tpu_torch: one run of one cell, one result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with the CUDA cards the
cell asks for. The last line of standard output is the result (JSON);
the numbers compared with the plain reference, each beside its limit,
are the last lines of standard error. `--control` also prints what the
float32 control reads (for setting limits); `--rehearse` runs the cell
at its mix's tiny sizes on the CPU (CNOSDB_TORCH_PLACEMENT=cpu) and
reports no device metric.

This file imports nothing heavy at its top: client processes are
spawned and re-import it.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".bench_cache")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rehearse", action="store_true")
    return p.parse_args(argv)


def main(argv=None) -> int:
    t_fallback = time.time()
    args = parse(argv)
    # compile caches at fixed paths inside the checkout (the port's own
    # kernel and codec builds stay in cnosdb_tpu_torch/_build, _native)
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from benchmark import harness

    try:
        t_start = harness.process_start()
    except (OSError, ValueError, StopIteration):
        t_start = t_fallback
    return harness.main(args, ROOT, t_start)


if __name__ == "__main__":
    sys.exit(main())
