"""The main path's query times (chip_smoke.py phases 3 and 4) for one or
more source trees in turns on one card.

    python3 bench_main.py [--trees DIR [DIR ...]] [--seed 123]
                          [--rows 10000000] [--repeats 7]

Each tree runs in a process of its own, from its own directory, through
that tree's chip_smoke.py (its Data, ingest, SQL and oracles, so two
commits are held to the same harness): build the kernels, ingest the TSBS
devops cpu-only table (--rows rows, 100 hosts, 10 s points, from --seed),
then each query once against its numpy oracle and --repeats times timed
(wall, after a card sync). The queries are the main path's
double_groupby_1 cold (the scan cache emptied before each run) and warm,
double_groupby_all, cpu_max_all_8 and last_loc warm, and one filtered
aggregate on the fused program (X2) with an OR, its filter stage's case:

    SELECT hostname, count(*) FROM cpu
    WHERE usage_user > 50 OR usage_system < 10 GROUP BY hostname

To compare a commit with its parent, unpack both into the git-ignored
`_ab/` (the same codecs in both: a tree from `git archive` has no native
host codecs on the card) and give the trees in turns:

    git archive HEAD | (mkdir -p _ab/parent && tar -x -C _ab/parent)
    git add -A && git archive $(git write-tree) \\
        | (mkdir -p _ab/change && tar -x -C _ab/change)
    python3 bench_main.py --trees _ab/parent _ab/change _ab/change _ab/parent

Prints one JSON line per run (each query's times in ms, their median,
and the X2/K1/K2 launches of one run), the card's name and power limit,
and a last JSON line with every run. Exits non-zero without a CUDA card
or when a run fails or disagrees with its oracle.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

FILTERED = ("SELECT hostname, count(*) AS c FROM cpu WHERE usage_user > 50 "
            "OR usage_system < 10 GROUP BY hostname")


def worker(tree: str, seed: int, rows: int, repeats: int) -> int:
    """Ingest and time the queries through `tree`'s own package."""
    import shutil

    tree = os.path.abspath(tree)
    sys.path[0] = tree
    os.environ["CNOSDB_SERVING"] = "0"   # repeats reach the operators
    os.environ["CNOSDB_MESH"] = "0"      # the legacy per-vnode path
    import numpy as np
    import torch

    import chip_smoke as cs
    from cnosdb_tpu_torch.ops import cuda_build
    from cnosdb_tpu_torch.ops import device_decode as dd
    from cnosdb_tpu_torch.ops import fused
    from cnosdb_tpu_torch.ops import pallas_kernels as pk
    from cnosdb_tpu_torch.parallel.coordinator import Coordinator
    from cnosdb_tpu_torch.parallel.meta import MetaStore
    from cnosdb_tpu_torch.sql.executor import QueryExecutor, Session
    from cnosdb_tpu_torch.storage.engine import TsKv
    from cnosdb_tpu_torch.utils.memory_pool import MemoryPool

    t = time.perf_counter()
    cuda_build.build_all()
    out = {"tree": tree, "build_s": time.perf_counter() - t}
    data = cs.Data(seed, rows)
    sql8, lo, hi, hosts = cs.cpu_max_sql(data)
    want_c = ((data.user > 50) | (data.syst < 10)).sum(axis=1)

    def check_filtered(rs):
        c = cs._cols(rs)
        got = dict(zip(cs._host_idx(c["hostname"]).tolist(),
                       np.asarray(c["c"], dtype=np.int64).tolist()))
        if got != dict(enumerate(want_c.tolist())):
            raise AssertionError("filtered: counts differ from the oracle")

    queries = [
        ("double_groupby_1 cold", cs.SQL["double_groupby_1"], True,
         lambda rs: cs.check_groupby(rs, data, {"m": data.user})),
        ("double_groupby_1 warm", cs.SQL["double_groupby_1"], False,
         lambda rs: cs.check_groupby(rs, data, {"m": data.user})),
        ("double_groupby_all warm", cs.SQL["double_groupby_all"], False,
         lambda rs: cs.check_groupby(rs, data, {"mu": data.user,
                                                "ms": data.syst})),
        ("cpu_max_all_8 warm", sql8, False,
         lambda rs: cs.check_cpu_max(rs, data, lo, hi, hosts)),
        ("last_loc warm", cs.SQL["last_loc"], False,
         lambda rs: cs.check_last(rs, data)),
        ("filtered warm", FILTERED, False, check_filtered),
    ]
    d = tempfile.mkdtemp(prefix="bench_main_")
    coord = None
    try:
        meta = MetaStore(d + "/meta.json")
        pool = MemoryPool(32 << 30)
        coord = Coordinator(meta, TsKv(d + "/data"), memory_pool=pool)
        ex = QueryExecutor(meta, coord, memory_pool=pool)
        s = Session(database="public")
        ex.execute_one(f"ALTER DATABASE public SET SHARD {cs.SHARDS}", s)
        out["ingest_s"], _ = cs.ingest(coord, data)
        out["queries"] = {}
        for name, sql, cold, check in queries:
            if cold:
                cs.clear_scan_cache(coord)
            check(ex.execute_one(sql, s))
            times = []
            for _ in range(repeats):
                if cold:
                    cs.clear_scan_cache(coord)
                x2, k1, k2 = fused.launch_count, pk.launches, dd.xor_launches
                t = time.perf_counter()
                ex.execute_one(sql, s)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            out["queries"][name] = {
                "ms": times, "median": statistics.median(times),
                "X2": fused.launch_count - x2, "K1": pk.launches - k1,
                "K2": dd.xor_launches - k2}
    finally:
        if coord is not None:
            coord.close()
        shutil.rmtree(d, ignore_errors=True)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=["."])
    ap.add_argument("--seed", type=int, default=123)
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker, args.seed, args.rows, args.repeats)
    import torch

    if not torch.cuda.is_available():
        print("bench_main: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    runs = []
    for tree in args.trees:
        tree = os.path.abspath(tree)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--seed", str(args.seed), "--rows", str(args.rows),
             "--repeats", str(args.repeats)],
            cwd=tree, capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"bench_main: {tree} failed (rc {proc.returncode})",
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
