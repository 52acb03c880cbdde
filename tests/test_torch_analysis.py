"""The port's invariant-analysis engine (cnosdb_tpu_torch/analysis).

- The gate: `run()` over cnosdb_tpu_torch/ is ok, every inline disable
  absorbs a finding, the baseline is the reference's one cell renamed,
  and host-sync sees the port's audited transfer points suppressed.
- Parity: with inline disables ignored, the port's (rule, path) counts
  over the held copies (tests/test_torch_copies.py) equal the JAX
  engine's over the same files of cnosdb_tpu/, for every rule but the
  three whose subject is the device plane.
- The registry: the reference's minus jax-purity and recompile-hazard,
  plus torch-sync; nothing in the port compiles a program.
- Fixture cases (tests/torch_analysis_fixtures/, linted as data) for
  torch-sync, the torch host-sync and lock-held-dispatch, and the CLI.

The engine's whole-tree walks take seconds each, so each runs once per
module.
"""
import ast
import json
import os
import subprocess
import sys
from unittest import mock

import pytest

from cnosdb_tpu import analysis as ref_analysis
from cnosdb_tpu.analysis import rules as ref_rules
from cnosdb_tpu_torch import analysis
from cnosdb_tpu_torch.analysis import interproc
from cnosdb_tpu_torch.analysis import rules as rules_mod

import test_torch_copies as copies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "cnosdb_tpu_torch")
FIXTURES = os.path.join(os.path.dirname(__file__), "torch_analysis_fixtures")

# the rules whose subject is the device plane: torch-sync is new, and
# host-sync / lock-held-dispatch follow the redesigned torch taint
DEVICE_RULES = {"torch-sync", "host-sync", "lock-held-dispatch"}
# (rule, held copy) cells where the counts differ, each with its reason
PARITY_DIFFS = {
    ("swallowed-exception", "parallel/coordinator.py"):
        "REWRITTEN Coordinator._upload_hook/_decode_hook: the port lets "
        "placement errors propagate, the reference swallows its device "
        "probe (two disabled except-pass blocks)",
    ("stale-suppression", "parallel/coordinator.py"):
        "the same two disables, gone with the rewritten hooks",
}


def _fx(name: str) -> str:
    return os.path.join(FIXTURES, name)


@pytest.fixture(scope="module")
def gate():
    return analysis.run()


def _raw_counts(pkg_analysis, pkg: str) -> dict:
    """(rule, package-relative path) → findings, inline disables
    ignored, over the held copies."""
    held = {r for r in copies._copied() if r not in copies.NOT_COPIED}
    with mock.patch.object(pkg_analysis.ModuleContext, "_suppressed",
                           lambda self, rule, line: False):
        rep = pkg_analysis.run()
    out: dict = {}
    for f in rep.findings:
        rel = f.path[len(pkg) + 1:]
        if rel in held:
            out[(f.rule, rel)] = out.get((f.rule, rel), 0) + 1
    return out


@pytest.fixture(scope="module")
def raw_counts():
    return (_raw_counts(ref_analysis, "cnosdb_tpu"),
            _raw_counts(analysis, "cnosdb_tpu_torch"))


# ---------------------------------------------------------------- gate
def test_gate_is_ok_with_no_stale_suppression(gate):
    assert gate.ok, ([f.render() for f in gate.violations], gate.stale)
    stale = [f.render() for f in gate.findings
             if f.rule == "stale-suppression"]
    assert stale == []


def test_baseline_is_the_reference_cell_renamed(gate):
    ref = ref_analysis.load_baseline()
    want = {(r, p.replace("cnosdb_tpu/", "cnosdb_tpu_torch/", 1)): n
            for (r, p), n in ref.items()}
    assert gate.baseline == want == {
        ("row-loop-fallback", "cnosdb_tpu_torch/sql/executor.py"): 3}
    assert gate.counts == gate.baseline


def test_every_port_disable_absorbs_a_finding_of_a_known_rule(gate):
    known = {r.name for r in rules_mod.all_rules()} | {"all"}
    n = 0
    for path in analysis.iter_py_files():
        with open(path, encoding="utf-8") as f:
            source = f.read()
        for _line, names in analysis._disable_comments(source):
            assert set(names.split(",")) <= known, (path, names)
            n += 1
    # the 13 disables of the copies and port files before the engine
    # ran over the port, the 7 audited transfer points it found, and the
    # strict CAST's failure flag in a device filter
    # (ops/device_filter.TorchXP.cast)
    assert n == 21
    assert not [f for f in gate.findings if f.rule == "stale-suppression"]


@pytest.fixture(scope="module")
def host_sync_sites():
    return interproc.rule_sites(interproc.HostSync())


@pytest.mark.parametrize("rel,line", [
    ("ops/kernels.py", 79),        # the ordered f64 sum's run count
    ("ops/kernels.py", 316),       # to_host
    ("ops/device_decode.py", 314), # the cold-scan write-back
    ("ops/fused.py", 84),          # PendingFused.fetch
    ("parallel/distributed_agg.py", 196),
    ("ops/mesh_exec.py", 554),
])
def test_host_sync_sees_the_transfer_points_suppressed(host_sync_sites,
                                                       rel, line):
    findings, suppressed = host_sync_sites
    relpath = "cnosdb_tpu_torch/" + rel
    assert line in suppressed.get(relpath, set()), (rel, line)
    with open(os.path.join(PORT, rel), encoding="utf-8") as f:
        text = f.read().splitlines()[line - 1]
    reason = text.split("lint: disable=host-sync", 1)[1]
    assert reason.strip().startswith("(") and len(reason) > 20, text
    assert not findings, [f.render() for f in findings]


def test_pinned_staging_buffers_are_host():
    # K1's page-locked staging buffers (_Slot.staging/result_buffer)
    # come from torch.empty(..., pin_memory=True): host memory, so
    # their .numpy() views are no crossing
    with mock.patch.object(analysis.ModuleContext, "_suppressed",
                           lambda self, rule, line: False):
        findings, _s = interproc.rule_sites(
            interproc.HostSync(), [os.path.join(PORT, "ops")])
    lines = {(f.path, f.line) for f in findings}
    pk = "cnosdb_tpu_torch/ops/pallas_kernels.py"
    with open(os.path.join(REPO, pk), encoding="utf-8") as f:
        src = f.read().splitlines()
    views = [i + 1 for i, t in enumerate(src) if "grown.numpy()" in t]
    assert len(views) == 2
    assert not {(pk, ln) for ln in views} & lines
    # ...while the same run, disables ignored, does see the real pulls
    assert ("cnosdb_tpu_torch/ops/kernels.py", 79) in lines
    assert ("cnosdb_tpu_torch/ops/fused.py", 84) in lines


# -------------------------------------------------------------- parity
def test_parity_with_the_jax_engine_on_the_held_copies(raw_counts):
    ref, port = raw_counts
    port_rules = {r.name for r in rules_mod.all_rules()} \
        | {"stale-suppression"}
    diffs = {}
    for cell in set(ref) | set(port):
        rule, rel = cell
        if rule in DEVICE_RULES or rule not in port_rules:
            continue
        if ref.get(cell, 0) != port.get(cell, 0):
            diffs[cell] = (ref.get(cell, 0), port.get(cell, 0))
    assert set(diffs) == set(PARITY_DIFFS), diffs
    for rule, rel in diffs:
        assert rel in copies.REWRITTEN, rel
    # the parity is not vacuous: the held copies carry findings of
    # several rules once their disables are ignored
    assert len({r for r, _p in port if r not in DEVICE_RULES}) >= 5
    # the dropped rules had no subject in the held copies either
    assert not [c for c in ref if c[0] in ("jax-purity",
                                           "recompile-hazard")]


def test_parity_of_the_device_rules_on_the_held_copies(raw_counts):
    # host-sync and lock-held-dispatch follow the torch taint, and still
    # see the same sites in the copies: the mesh lane's pull and the
    # checksum scan under the vnode lock
    ref, port = raw_counts
    for cell in (("host-sync", "ops/mesh_exec.py"),
                 ("lock-held-dispatch", "storage/vnode.py")):
        assert ref.get(cell) == port.get(cell) == 1, cell


# ------------------------------------------------------------ registry
def test_registry_is_the_reference_minus_jax_rules_plus_torch_sync():
    ref = {r.name for r in ref_rules.all_rules()}
    port = [r.name for r in rules_mod.all_rules()]
    assert len(port) == len(set(port))
    assert set(port) == (ref - {"jax-purity", "recompile-hazard"}) \
        | {"torch-sync"}
    for rule in rules_mod.all_rules():
        assert rule.motivation, rule.name


def test_no_port_module_compiles_a_program():
    # recompile-hazard is dropped because nothing in the port calls
    # torch.compile or torch.jit
    bad = []
    for path in analysis.iter_py_files():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) \
                    and node.attr in ("compile", "jit") \
                    and isinstance(node.value, ast.Name) \
                    and node.value.id == "torch":
                bad.append(f"{path}:{node.lineno}")
            elif isinstance(node, ast.ImportFrom) \
                    and (node.module or "").startswith("torch.jit"):
                bad.append(f"{path}:{node.lineno}")
    assert bad == []


def test_module_naming_binds_relative_imports_across_the_port():
    project = interproc.Project([
        analysis.ModuleContext(p, analysis.norm_relpath(p), open(p).read(),
                               ast.parse(open(p).read()), [])
        for p in (os.path.join(PORT, "ops", "kernels.py"),
                  os.path.join(PORT, "ops", "fused.py"))])
    fused = project.files["cnosdb_tpu_torch/ops/fused.py"]
    assert fused.module == "cnosdb_tpu_torch.ops.fused"
    # fused.py's `from .kernels import local_segment_partials` resolves,
    # so the fused program reaches the torch ops of X1
    program = next(i for i in project.functions
                   if i.qualname.endswith(":_build_kernel.program"))
    callees = {c.qualname for _n, c in program.call_sites if c}
    assert "cnosdb_tpu_torch/ops/kernels.py:local_segment_partials" \
        in callees, callees
    assert program.reaches_device


def test_the_port_analysis_imports_no_jax():
    child = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "from cnosdb_tpu_torch import analysis\n"
        "from cnosdb_tpu_torch.analysis import __main__, interproc, rules\n"
        f"rep = analysis.run([{_fx('bad_torch_sync.py')!r}], "
        "rules=[rules.TorchSync()], ignore_scope=True)\n"
        "assert rep.findings\n"
        "bad = sorted(m for m in sys.modules if m == 'cnosdb_tpu' or "
        "m.startswith('cnosdb_tpu.') or (m.startswith('jax') and "
        "sys.modules[m] is not None))\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", child], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "OK"


# ------------------------------------------------------------ fixtures
_CASES = [
    # Python truth tests on tensors (if/while/or/assert-not/IfExp/
    # comprehension if/not/in), .item(), an annotated param, a test
    # before the name is rebound to a host array; metadata, identity
    # tests, a CPU tensor after .cpu(), the host array and int() stay
    # silent
    ("bad_torch_sync.py", rules_mod.TorchSync(),
     [8, 10, 12, 13, 14, 15, 16, 17, 18, 34, 43]),
    # float/int/.item/.tolist/.cpu/.to("cpu")/np.asarray/iteration/
    # .synchronize, and .cpu() on an attribute; host-placed factories,
    # pinned buffers, from_numpy and metadata stay silent
    ("bad_torch_host_sync.py", interproc.HostSync(),
     [9, 10, 11, 12, 13, 14, 15, 16, 18, 27]),
    # a torch op two edges down, and a kernel library's entry points
    # (direct, through a local alias, through getattr); len() and
    # torch.cuda.is_available() under the lock stay silent
    ("bad_torch_lock_dispatch.py", interproc.LockHeldDispatch(),
     [20, 30, 31, 32]),
]


@pytest.mark.parametrize(
    "filename,rule,lines", _CASES,
    ids=[f"{rule.name}:{filename}" for filename, rule, _l in _CASES])
def test_rule_catches_fixture(filename, rule, lines):
    findings = analysis.lint_files([_fx(filename)], rules=[rule],
                                   ignore_scope=True)
    assert sorted(f.line for f in findings) == lines, \
        [f.render() for f in findings]
    assert all(f.rule == rule.name for f in findings)


def test_torch_sync_leaves_explicit_crossings_to_host_sync():
    findings = analysis.lint_files([_fx("bad_torch_sync.py")],
                                   rules=[interproc.HostSync()],
                                   ignore_scope=True)
    # `peak = t.max().item()`, `host = t.cpu()`, `k = int(t.sum())` and
    # `t = t.cpu().numpy()`
    assert sorted(f.line for f in findings) == [14, 26, 29, 45]


def test_cross_file_taint_through_to_device_two_edges():
    # to_device (the card) -> upload -> consume: int() in consume is two
    # resolved call edges and a file away from the .to(dev)
    outer, inner = _fx("torch_chain_outer.py"), _fx("torch_chain_inner.py")
    findings = analysis.lint_files([outer, inner],
                                   rules=[interproc.HostSync()],
                                   ignore_scope=True)
    assert [(f.path, f.line) for f in findings] == \
        [(analysis.norm_relpath(outer), 11)]
    # without the producer the value is not provably on the card
    assert analysis.lint_files([outer], rules=[interproc.HostSync()],
                               ignore_scope=True) == []


def test_inline_disables_silence_the_torch_rules():
    rules = [r for r in rules_mod.all_rules()
             if not r.name.startswith("row-loop")]
    findings = analysis.lint_files([_fx("torch_suppressed.py")],
                                   rules=rules, ignore_scope=True)
    assert findings == [], [f.render() for f in findings]
    # the full registry (with its stale audit) agrees: each disable
    # absorbed its finding; only the row-loop rules' missing-section
    # reports remain
    findings = analysis.lint_files([_fx("torch_suppressed.py")],
                                   ignore_scope=True)
    assert {f.rule for f in findings} == {"row-loop", "row-loop-fallback"}


@pytest.mark.parametrize("call,kind", [
    ("torch.cuda.is_available()", "metadata"),
    ("torch.cuda.device_count()", "metadata"),
    ("torch.device('cuda', 0)", "metadata"),
    ("torch.iinfo(torch.int64)", "metadata"),
    ("torch.from_numpy(a)", "host"),
    ("torch.zeros(4)", "host"),
    ("torch.zeros(4, device='cpu')", "host"),
    ("torch.empty(n, dtype=torch.uint8, pin_memory=True)", "host"),
    ("torch.empty(n, **kw)", "device"),
    ("torch.empty(n, pin_memory=True, **kw)", "host"),
    ("torch.empty(n, device='cpu', **kw)", "host"),
    ("torch.cuda.synchronize()", "host"),
    ("torch.zeros(4, device=dev)", "device"),
    ("torch.as_tensor(a, device=self.device)", "device"),
    ("torch.cumsum(x, 0)", "device"),
    ("torch.zeros_like(x)", "device"),
    ("len(x)", None),
])
def test_torch_call_kind(call, kind):
    assert interproc.torch_call_kind(ast.parse(call).body[0].value) == kind


@pytest.mark.parametrize("call,kind", [
    ("x.to(dev)", "device"),
    ("x.to(lead, non_blocking=True)", "device"),
    ("x.to(torch.device('cuda', 1))", "device"),
    ("x.to('cpu')", "host"),
    ("x.to(device='cpu')", "host"),
    ("x.to(torch.device('cpu'))", "host"),
    ("x.to(torch.int64)", "dtype"),
    ("x.to(values.dtype)", "dtype"),
    ("x.to(dtype=torch.float64)", "dtype"),
    ("x.cpu()", None),
])
def test_to_kind(call, kind):
    assert interproc.to_kind(ast.parse(call).body[0].value) == kind


# ----------------------------------------------------------------- CLI
def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "cnosdb_tpu_torch.analysis", *args],
        capture_output=True, text=True, cwd=REPO, timeout=300)


def test_cli_json_on_the_fixtures(tmp_path):
    empty = str(tmp_path / "empty_baseline.json")
    artifact = str(tmp_path / "report.json")
    p = _cli(FIXTURES, "--all-rules", "--baseline", empty, "--json",
             "--artifact", artifact)
    assert p.returncode == 1, p.stdout + p.stderr
    rep = json.loads(p.stdout)
    assert not rep["ok"]
    assert {"torch-sync", "host-sync", "lock-held-dispatch"} \
        <= {f["rule"] for f in rep["violations"]}
    with open(artifact, encoding="utf-8") as f:
        totals = json.load(f)["metrics"]["cnosdb_analysis_findings_total"]
    assert {r.name for r in rules_mod.all_rules()} <= set(totals)
    # bad_torch_sync.py's eleven, and the .item() of bad_torch_host_sync.py
    assert totals["torch-sync"] == 12
    assert "jax-purity" not in totals and "recompile-hazard" not in totals


def test_cli_callgraph_dumps_summaries():
    p = _cli(_fx("torch_chain_inner.py"), _fx("torch_chain_outer.py"),
             "--callgraph")
    assert p.returncode == 0, p.stdout + p.stderr
    lines = {ln.split(" ", 1)[0].rsplit(":", 1)[-1]: ln
             for ln in p.stdout.splitlines()}
    assert "returns-device" in lines["to_device"]
    assert "dispatches" in lines["to_device"]
    assert "returns-device" in lines["upload"]
    assert "torch_chain_inner.py:to_device" in lines["upload"]
    assert "returns-device" not in lines["consume"]
    assert "jit" not in p.stdout.replace("torch_chain", "")


def test_cli_fix_baseline_requires_whole_tree(tmp_path):
    p = _cli(FIXTURES, "--fix-baseline",
             "--baseline", str(tmp_path / "b.json"))
    assert p.returncode == 2


def test_cli_fix_baseline_prunes_and_keeps_the_reference_cell(tmp_path):
    bl = str(tmp_path / "b.json")
    analysis.write_baseline(
        {("swallowed-exception", "cnosdb_tpu_torch/long_gone.py"): 2}, bl)
    p = _cli("--fix-baseline", "--baseline", bl)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "pruned stale cell swallowed-exception:" \
        "cnosdb_tpu_torch/long_gone.py" in p.stdout
    assert analysis.load_baseline(bl) == {
        ("row-loop-fallback", "cnosdb_tpu_torch/sql/executor.py"): 3}
