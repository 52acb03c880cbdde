"""Each cell rehearsed on the CPU at its mix's tiny sizes through the
real harness; the float32 control and the program's faults must come out
as not correct."""
import json
import os
import subprocess
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = tuple(w["name"] for w in json.load(_f)["workloads"])
KEYS = {"correct", "attempted", "failed", "metrics", "device"}

# faults planted in the program under the timed path, each in a child
# that then runs the harness (the node lives in the harness's process)
FAULTS = {
    "answer_altered": """
from cnosdb_tpu_torch.sql.executor import QueryExecutor
import numpy as np
orig = QueryExecutor.execute_sql
def altered(self, sql, session=None):
    out = orig(self, sql, session)
    for rs in out:
        for i, c in enumerate(rs.columns):
            if np.asarray(c).dtype.kind == "f" and len(c):
                c = np.array(c, dtype=np.float64)
                c[0] *= 1 + 1e-9
                rs.columns[i] = c
                break
    return out
QueryExecutor.execute_sql = altered
""",
    "half_the_rows": """
from cnosdb_tpu_torch.parallel import coordinator
orig = coordinator.scan_vnode
def half(*a, **k):
    b = orig(*a, **k)
    keep = slice(0, None, 2)
    b.ts, b.sid_ordinal = b.ts[keep], b.sid_ordinal[keep]
    b.fields = {n: (vt, v[keep], ok[keep]) for n, (vt, v, ok) in b.fields.items()}
    return b
coordinator.scan_vnode = half
""",
    "write_unapplied": """
from cnosdb_tpu_torch.server import http
from cnosdb_tpu_torch.models.points import WriteBatch
http.parse_lines = lambda body, prec: WriteBatch()
""",
}


def rehearse(cell, *extra, patch="", seconds=3):
    env = {**os.environ, "CNOSDB_TORCH_PLACEMENT": "cpu"}
    code = (f"import sys; sys.path.insert(0, {ROOT!r})\n{patch}\n"
            "from benchmark import run\n"
            f"sys.exit(run.main({['--workload', cell, '--seed', '2147483653', '--seconds', str(seconds), '--rehearse', *extra]!r}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().split("\n")[-1]), p.stderr


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_rehearsal_prints_the_contract_line(cell, trace):
    out, err = rehearse(cell, "--trace", trace)
    assert KEYS <= set(out) and list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert out["device"]["platform"] == "cpu"
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        m = json.load(f)
    kind = "per_layer" if trace == "1" else "end_to_end"
    want = {x["name"] for x in m[kind] if cell in x.get("workloads", [cell])
            and x["source"] != "device_trace"}
    assert set(out["metrics"]) == want
    for name, c in out["checks"].items():
        assert f"{name} {c['value']!r} limit {c['limit']!r}" in err


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_fails(cell):
    """The control in the program's place comes out not correct through
    the harness's own verdict, while the program's own numbers, printed
    beside it, pass."""
    out, err = rehearse(cell, "--control")
    assert out["correct"] is False, out["checks"]
    failing = [k for k, c in out["checks"].items() if c["value"] > c["limit"]]
    assert failing and all(f"{k} " in err for k in failing)
    program = [ln for ln in err.splitlines() if ln.startswith("# program ")]
    assert len(program) == len(out["checks"])
    assert not [ln for ln in program if ln.endswith("FAILED")], program


@pytest.mark.parametrize("cell,fault", [
    ("devops100-live", "answer_altered"),
    ("devops100-live", "half_the_rows"),
    ("devops100-live", "write_unapplied"),
])
def test_a_fault_in_the_timed_path_is_not_correct(cell, fault):
    out, _err = rehearse(cell, patch=FAULTS[fault])
    assert out["correct"] is False, out["checks"]


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={k: v for k, v in os.environ.items()
                            if k != "CNOSDB_TORCH_PLACEMENT"})
    if p.returncode == 0:
        pytest.skip("a CUDA card is present")
    assert p.stdout.strip() == ""
