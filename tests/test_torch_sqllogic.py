"""Both SQL golden corpora through cnosdb_tpu_torch, statement by
statement, on the host branch and on the device branch.

Every file of tests/sqllogic/ (150) and tests/sqllogic_ref/ (235) runs
through the port's QueryExecutor once per branch (tests/sqllogic_port.py
says how each is set up, and its runner goes on past a failed statement).
Each statement must give the golden answer; where the reference package
answers it wrong in the same branch (tests/sqllogic_ref_faults.json, with
file, line and reason), the port may give the reference's answer instead.
The reference is not run here: its answers are recorded by
tests/record_sqllogic_faults.py.
"""
import pytest

import sqllogic_port as slt

FAULTS = slt.load_faults()
CASES = [(c, f) for c in slt.CORPORA for f in slt.corpus_files(c)]


def _run(corpus, name, branch, tmp_path, monkeypatch):
    for k, v in slt.BRANCH_ENV[branch].items():
        monkeypatch.setenv(k, v)
    recs = slt.run_file(corpus, name, str(tmp_path))
    return recs, slt.judge(recs, corpus, name, branch, FAULTS)


@pytest.mark.parametrize("branch", ["host", "device"])
@pytest.mark.parametrize("corpus,name", CASES,
                         ids=[f"{c}/{f}" for c, f in CASES])
def test_corpus_file(corpus, name, branch, tmp_path, monkeypatch):
    recs, (passed, _matched, off) = _run(corpus, name, branch, tmp_path,
                                         monkeypatch)
    assert not off, f"{len(off)} of {len(recs)} statements off their " \
        "rule:\n" + "\n".join(off)
    assert passed == len(recs)


# the statements that the port's device filter failed before it typed its
# operands as numpy does: BOOLEAN columns as predicates, an UNSIGNED
# column against a literal above 2^62
FILTER_STATEMENTS = {
    "gen_bool_logic.slt": ("WHERE b", "WHERE NOT b"),
    "gen_type_boolean.slt": ("WHERE v", "WHERE NOT v"),
    "gen_type_unsigned_bounds.slt": ("WHERE v > 4611686018427387904",),
}


@pytest.mark.parametrize("name", sorted(FILTER_STATEMENTS))
def test_device_filters_answer_through_x2(name, tmp_path, monkeypatch):
    from cnosdb_tpu_torch.ops import fused

    before = fused.launch_count
    recs, (_p, matched, off) = _run("sqllogic", name, "device", tmp_path,
                                    monkeypatch)
    assert not off and not matched, off
    assert fused.launch_count > before, "the fused program never launched"
    for tail in FILTER_STATEMENTS[name]:
        hit = [r for r in recs if r["sql"].endswith(tail)]
        assert hit and all(r["answer"] == r["golden"] for r in hit), tail


def test_recorded_reference_error_takes_only_its_type():
    """A `statement error` line takes any error; a recorded reference
    error takes only an error of its type, so a port fault that raises
    something else on such a line is off its rule."""
    rec = {"line": 7, "sql": "SELECT 1",
           "answer": {"error": "RuntimeError: where expected a bool"}}
    assert slt.same(rec["answer"], {"error": None})
    faults = {"c/f.slt:7": {"reason": "", "device": {"error": "TypeError"}}}
    for answer, on_rule in (({"error": "TypeError: x"}, True),
                            (rec["answer"], False), (["1"], False)):
        rec = dict(rec, answer=answer, golden=["0"])
        passed, matched, off = slt.judge([rec], "c", "f.slt", "device",
                                         faults)
        assert (passed, bool(matched), not off) == (on_rule,) * 3


@pytest.mark.parametrize("fn", ["floor", "ceil", "trunc"])
def test_rounding_functions_are_float64_on_any_numpy(fn):
    """numpy 2.3 keeps an integer input's dtype in floor, ceil and trunc
    (on the card `ceil(bigint)` rendered 0, not the golden 0.0); the port
    returns Float64 whatever numpy does. `xp` here rounds as numpy 2.3."""
    import types

    import numpy as np

    from cnosdb_tpu_torch.sql.expr import Column, Func

    xp = types.SimpleNamespace(**{
        name: (lambda a, f=getattr(np, name): a if np.asarray(a).dtype.kind
               in "iub" else f(a)) for name in ("floor", "ceil", "trunc")})
    out = Func(fn, [Column("v")]).eval(
        {"v": np.array([-2, 0, 7], dtype=np.int64)}, xp)
    assert out.dtype == np.float64 and out.tolist() == [-2.0, 0.0, 7.0]
