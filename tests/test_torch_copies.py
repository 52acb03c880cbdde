"""Drift guard: the port's copied host modules are cnosdb_tpu's, verbatim.

cnosdb_tpu_torch carries copies of cnosdb_tpu's jax-free modules so that
their relative `from ..ops import …` lines bind to the port's own ops.
Each copy must equal its original except for the substitutions listed
here (module-name strings, placement tests, the jax probes) and the few
functions that were rewritten for the port, which are compared with the
rest of the module masked out. A deliberate divergence updates this list.
"""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "cnosdb_tpu")
DST = os.path.join(REPO, "cnosdb_tpu_torch")

COPIED_TREES = ("models", "storage", "sql", "utils", "protocol", "server")
COPIED_FILES = (
    "errors.py", "faults.py", "config.py",
    "ops/group_agg.py", "ops/zonemap.py", "ops/strkernels.py",
    "ops/mesh_exec.py", "ops/tpu_exec.py",
)
# parallel/ minus the two jax modules, which the port rewrites in torch
NOT_COPIED_PARALLEL = {"mesh.py", "distributed_agg.py"}

# every copy: string module names point at the port
GLOBAL_SUBS = [('"cnosdb_tpu.', '"cnosdb_tpu_torch.')]
# per file: exact line substitutions
SUBS = {
    "ops/tpu_exec.py": [('scan_device().platform == "cpu"',
                         'scan_device().type == "cpu"')],
    "ops/mesh_exec.py": [
        ('scan_device().platform == "cpu"', 'scan_device().type == "cpu"'),
        ("from jax.sharding import PartitionSpec as P",
         "from ..parallel.mesh import PartitionSpec as P"),
        # the merged partials are tensors on the lead device: one pull each
        ("np.asarray(v)[:n_seg] for k, v in out.items()",
         "v[:n_seg].cpu().numpy() for k, v in out.items()")],
    "ops/group_agg.py": [('return scan_device().platform == "tpu"',
                          'return scan_device().type == "cuda"')],
}
# per file: functions rewritten for the port (qualified names)
REWRITTEN = {
    "storage/native.py": {"_try_build"},
    "ops/strkernels.py": {"_topk_device_wanted"},
    "parallel/coordinator.py": {"Coordinator._upload_hook",
                                "Coordinator._decode_hook"},
}


def _copied() -> list[str]:
    out = list(COPIED_FILES)
    for tree in COPIED_TREES:
        for dirpath, _dirs, files in os.walk(os.path.join(SRC, tree)):
            for f in files:
                if f.endswith(".py"):
                    out.append(os.path.relpath(os.path.join(dirpath, f), SRC))
    for f in os.listdir(os.path.join(SRC, "parallel")):
        if f.endswith(".py") and f not in NOT_COPIED_PARALLEL:
            out.append(os.path.join("parallel", f))
    return sorted(out)


def _mask(text: str, names: set) -> str:
    """Blank the bodies of the named (qualified) functions."""
    lines = text.splitlines()
    found = set()

    def visit(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, prefix + child.name + ".")
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                q = prefix + child.name
                if q in names:
                    found.add(q)
                    for i in range(child.lineno - 1, child.end_lineno):
                        lines[i] = ""
                    lines[child.lineno - 1] = f"<rewritten {q}>"

    visit(ast.parse(text), "")
    assert found == names, f"rewritten functions not found: {names - found}"
    return "\n".join(ln for ln in lines if ln != "")


@pytest.mark.parametrize("rel", _copied())
def test_copy_is_verbatim_but_for_the_listed_edits(rel):
    with open(os.path.join(SRC, rel), encoding="utf-8") as f:
        want = f.read()
    path = os.path.join(DST, rel)
    assert os.path.exists(path), f"{rel} missing from the port"
    with open(path, encoding="utf-8") as f:
        got = f.read()
    for old, new in GLOBAL_SUBS + SUBS.get(rel, []):
        if (old, new) not in GLOBAL_SUBS:
            assert old in want, f"{rel}: substitution source gone: {old!r}"
        want = want.replace(old, new)
    names = REWRITTEN.get(rel)
    if names:
        want, got = _mask(want, names), _mask(got, names)
    assert got == want, f"{rel} drifted from cnosdb_tpu/{rel}"


@pytest.mark.parametrize("rel", sorted(
    f"{tree}/" for tree in COPIED_TREES + ("parallel",)))
def test_no_port_only_files_in_copied_trees(rel):
    """The copied subtrees hold copies only (the port's own modules live
    in ops/ and as the two listed parallel/ files)."""
    copied = set(_copied())
    for dirpath, _dirs, files in os.walk(os.path.join(DST, rel)):
        for f in files:
            if not f.endswith(".py"):
                continue
            r = os.path.relpath(os.path.join(dirpath, f), DST)
            if rel == "parallel/" and f in NOT_COPIED_PARALLEL:
                continue
            assert r in copied, f"{r} is not a copy of a cnosdb_tpu module"


def test_rewritten_functions_touch_no_jax():
    for rel, names in REWRITTEN.items():
        with open(os.path.join(DST, rel), encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                mods = ([a.name for a in node.names]
                        if isinstance(node, ast.Import) else [node.module])
                for m in mods:
                    assert not (m or "").split(".")[0] == "jax", rel
