"""Stress runs of chip_smoke.py's cluster phase, over two or more trees in
turns, while CPU-bound processes load the host: on a one-card machine the
host's load is what makes raft races and routing faults show.

    python3 cluster_stress.py --trees _ab/parent _ab/change
        --out <dir>/cluster_stress.jsonl [--runs 6] [--hogs 7]
        [--rows 864000] [--placement cpu]

Each run is a subprocess in its tree, which calls that tree's own
`chip_smoke.cluster_phase` (so the tree's `cnosdb_tpu_torch` is the one
its nodes run), without the crash sweep. Before every call of the tree's
`engaging_node` (the start and the heal of each device_loss step, and the
partition's heal where the tree has one) and when the restarted node's
reads end, the run reads the vnodes marked BROKEN in every node's view of
meta from the `cluster_schema.vnodes` system table, which every tree
serves. One JSON line a run: its tree, whether the phase passed, the
failure's first line, the phase's seconds, the restarted node's crash to
first answer, the records of the partition, read-your-writes, outsider,
deposed-leader and failover-read steps, the baseline's query times and
the read-index
and leader-read counters where the tree has them, and the marks read at
each point (also each
time a node's local-scan fault is cleared, labelled "restart_read");
each run's log lands beside it. Placement "cpu" runs the nodes on the
host (with the device decode lane forced, as on the card).
A run is cut after RUN_TIMEOUT_S, with its nodes. A trailing line sums
each tree up.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

HOG = "while True: pass"
SEED = 123           # chip_smoke.py's default --seed
RUN_TIMEOUT_S = 900.0


def _marks(nodes) -> dict:
    """{node id: [vnode ids marked BROKEN in its view of meta]}."""
    out = {}
    for n in nodes:
        try:
            text = n.sql("SELECT vnode_id, status FROM "
                         "cluster_schema.vnodes", db="public")
        except (AssertionError, OSError) as e:
            out[n.node_id] = f"unread: {str(e)[:200]}"
            continue
        out[n.node_id] = sorted(
            int(line.split(",")[0]) for line in text.splitlines()[1:]
            if line.strip().endswith("BROKEN"))
    return out


def run_one(tree: str, rows: int, placement: str | None) -> dict:
    """One cluster phase of the tree's chip_smoke.py, instrumented."""
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    os.chdir(tree)
    import chip_smoke

    assert os.path.dirname(os.path.abspath(chip_smoke.__file__)) == tree
    if placement == "cpu":
        chip_smoke.CLUSTER_ENV["CNOSDB_DEVICE_DECODE"] = "1"
    chip_smoke.crash_sweep = lambda root, env: {}
    seen: list = []
    state: dict = {}
    engaging_node, scans_local = chip_smoke.engaging_node, \
        chip_smoke.scans_local

    def engaging(cluster, start, data):
        state["nodes"] = cluster.nodes
        seen.append(["engaging_node", _marks(cluster.nodes)])
        return engaging_node(cluster, start, data)

    def local(node, on):
        scans_local(node, on)
        if not on and "nodes" in state:
            seen.append(["restart_read", _marks(state["nodes"])])

    chip_smoke.engaging_node, chip_smoke.scans_local = engaging, local
    rec = {"tree": tree, "ok": False, "error": None}
    t = time.perf_counter()
    try:
        out = chip_smoke.cluster_phase(SEED, rows, placement=placement)
        rec["ok"] = True
        rec["crash_to_first_answer_s"] = out.get("crash_to_first_answer_s")
        # the steps' records and the read timings where the tree has them
        for key in ("partition", "read_your_writes", "outsider_reads",
                    "deposed_leader_reads", "failover_reads", "query_ms",
                    "read_index", "leader_read"):
            rec[key] = out.get(key)
    except Exception as e:   # the record says why; the caller goes on
        lines = str(e).strip().splitlines()
        rec["error"] = f"{type(e).__name__}: {lines[0] if lines else ''}"
    rec["phase_s"] = time.perf_counter() - t
    rec["marks"] = seen
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", default=[])
    ap.add_argument("--runs", type=int, default=6, help="runs a tree")
    ap.add_argument("--hogs", type=int, default=7)
    ap.add_argument("--rows", type=int, default=864_000)
    ap.add_argument("--placement", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.one is not None:
        rec = run_one(a.one, a.rows, a.placement)
        print("RUN " + json.dumps(rec), flush=True)
        return 0
    if not a.trees or a.out is None:
        ap.error("--trees and --out are required")
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    hogs = [subprocess.Popen([sys.executable, "-c", HOG])
            for _ in range(a.hogs)]
    recs = []
    try:
        for i in range(a.runs):
            for tree in a.trees:
                cmd = [sys.executable, os.path.abspath(__file__), "--one",
                       tree, "--rows", str(a.rows)]
                if a.placement:
                    cmd += ["--placement", a.placement]
                # a session of its own: a run cut at its timeout takes its
                # meta and data nodes down with it
                p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)
                try:
                    text, _ = p.communicate(timeout=RUN_TIMEOUT_S)
                    lines = [ln for ln in text.splitlines()
                             if ln.startswith("RUN ")]
                    rec = json.loads(lines[-1][4:]) if lines else {
                        "tree": os.path.abspath(tree), "ok": False,
                        "error": f"rc {p.returncode}: {text[-500:]}"}
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, signal.SIGKILL)
                    p.wait()
                    rec = {"tree": os.path.abspath(tree), "ok": False,
                           "error": f"timeout after {RUN_TIMEOUT_S}s"}
                    text = ""
                rec["run"] = i
                recs.append(rec)
                name = os.path.basename(os.path.abspath(tree)) or "tree"
                with open(f"{os.path.splitext(a.out)[0]}_{i}_{name}.log",
                          "w") as f:
                    f.write(text)
                with open(a.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
                print(json.dumps(rec), flush=True)
    finally:
        for h in hogs:
            h.kill()
            h.wait()
    summary = {}
    for tree in a.trees:
        mine = [r for r in recs if r["tree"] == os.path.abspath(tree)]
        summary[tree] = {
            "runs": len(mine), "failed": [[r["run"], r["error"]]
                                          for r in mine if not r["ok"]],
            "phase_s": [round(r.get("phase_s", 0.0), 2) for r in mine],
            "first_answer_s": [r.get("crash_to_first_answer_s")
                               for r in mine],
            "marked_reads": sum(1 for r in mine for _, m in r.get("marks", [])
                                if any(isinstance(v, list) and v
                                       for v in m.values()))}
    print("SUMMARY " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
