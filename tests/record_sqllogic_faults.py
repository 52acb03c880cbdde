"""Record where the reference package (cnosdb_tpu) answers the SQL golden
corpora wrong, per branch, into tests/sqllogic_ref_faults.json.

    JAX_PLATFORMS=cpu python tests/record_sqllogic_faults.py [--workers 4]
    JAX_PLATFORMS=cpu python tests/record_sqllogic_faults.py --pkg \
        cnosdb_tpu_torch --report    # the port's answers, nothing written

Every file of tests/sqllogic/ and tests/sqllogic_ref/ runs through the
package once per branch (tests/sqllogic_port.py BRANCH_ENV), one worker
process per branch and file batch, and each statement whose answer is not
the golden one becomes an entry keyed "corpus/file:line" holding the
answer per branch. Reasons already in the file are kept; a new entry gets
"" and is explained by hand. With --report the statements off the golden
answers are printed instead, with the recorded reference answer beside
each (the port's test holds it to the same rule).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import tempfile
from concurrent.futures import ProcessPoolExecutor

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]
import sqllogic_port as slt  # noqa: E402


def _run(args):
    pkg, branch, corpus, names = args
    os.environ.update(slt.BRANCH_ENV[branch])
    # the reference's test environment (tests/conftest.py)
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    out = []
    for name in names:
        with tempfile.TemporaryDirectory() as d:
            try:
                recs = slt.run_file(corpus, name, d, pkg=pkg)
            except Exception as e:   # the file's set-up itself failed
                recs = [{"line": 0, "kind": "file", "sql": name,
                         "golden": "ok", "answer": slt._error(e)}]
        out.append((corpus, name, recs))
    return branch, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--pkg", default="cnosdb_tpu")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--report", action="store_true")
    args = ap.parse_args(argv)
    jobs = []
    for branch in slt.BRANCH_ENV:
        for corpus in slt.CORPORA:
            names = slt.corpus_files(corpus)
            for k in range(0, len(names), 8):
                jobs.append((args.pkg, branch, corpus, names[k:k + 8]))
    old = {}
    if os.path.exists(slt.FAULTS_PATH):
        old = slt.load_faults()
    found: dict = {}
    n = {}
    with ProcessPoolExecutor(
            args.workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        for branch, files in pool.map(_run, jobs):
            for corpus, name, recs in files:
                if args.report:
                    _p, _m, off = slt.judge(recs, corpus, name, branch, old)
                    for line in off:
                        print(line)
                for rec in recs:
                    n[branch] = n.get(branch, 0) + 1
                    if slt.same(rec["answer"], rec["golden"]):
                        continue
                    key = slt.fault_key(corpus, name, rec["line"])
                    e = found.setdefault(key, {
                        "reason": old.get(key, {}).get("reason", "")})
                    ans = rec["answer"]
                    # an error is kept by its type, which the port's must
                    # match (slt.same)
                    e[branch] = {"error": slt.error_type(ans)} \
                        if isinstance(ans, dict) else ans
    print(f"statements per branch {n}; off the golden answers: "
          + ", ".join(f"{b} {sum(b in e for e in found.values())}"
                      for b in slt.BRANCH_ENV), file=sys.stderr)
    if args.report:
        return 0
    with open(slt.FAULTS_PATH, "w") as f:
        json.dump({"about": "statements of the SQL golden corpora that the "
                   "reference package answers wrong, by branch; written by "
                   "tests/record_sqllogic_faults.py, reasons kept by hand",
                   "faults": dict(sorted(found.items()))}, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
