"""Nothing the benchmark loads is JAX or the JAX package (by whole
top-level module names: cnosdb_tpu_torch is not cnosdb_tpu), and the
plain reference loads nothing of the program."""
import ast
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
FOREIGN = ("jax", "jaxlib", "flax", "cnosdb_tpu")


def top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_imports_jax_or_the_jax_package():
    for d, _s, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py") and not f.startswith("test_bm_imports"):
                names = set(top_names(os.path.join(d, f)))
                assert not names & set(FOREIGN), (f, names & set(FOREIGN))


def test_harness_judges_by_whole_top_level_names():
    sys.path.insert(0, ROOT)
    from benchmark import harness

    sys.modules.setdefault("cnosdb_tpu_torch_probe", sys)
    assert "cnosdb_tpu_torch_probe" not in harness.foreign_modules()
    assert harness.FOREIGN == FOREIGN


PROBE = """
import sys
sys.path.insert(0, {root!r})
{body}
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {names!r})
print(",".join(loaded))
"""


def loaded(body, names):
    p = subprocess.run([sys.executable, "-c", PROBE.format(
        root=ROOT, body=body, names=names)], capture_output=True, text=True,
        timeout=120, env={**os.environ, "CNOSDB_TORCH_PLACEMENT": "cpu"})
    assert p.returncode == 0, p.stderr[-2000:]
    return p.stdout.strip()


def test_the_reference_loads_nothing_of_the_program():
    body = ("import json\nfrom benchmark import reference, tsbs, check\n"
            "cfg = json.load(open('{}/configs/tsbs-devops-4000.json'))\n"
            "cfg['scale'] = 4\n"
            "q = json.load(open('{}/traffic/double-groupby-1.json'))"
            "['readers']['query']\n"
            "h = tsbs.history(cfg, 1)\n"
            "reference.answer(cfg, q, next(tsbs.query_stream(cfg, q, 1, 0)), h)"
            ).format(BENCH, BENCH)
    assert loaded(body, FOREIGN + ("cnosdb_tpu_torch", "torch")) == ""


def test_the_harness_and_the_program_load_no_jax():
    body = ("from benchmark import harness, node, devtrace, clients\n"
            "from benchmark.traffic import closed_query, writers_readers\n"
            "import cnosdb_tpu_torch.server.http, cnosdb_tpu_torch.ops.cuda_build")
    assert loaded(body, FOREIGN) == ""
