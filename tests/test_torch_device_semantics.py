"""The port's device branch answers as the host branch.

The fused program (X2, `cnosdb_tpu_torch/ops/fused.py`) is meant to be an
invisible accelerator of the host semantics: a query it takes must get
the answer the host branch gives. Held here on the CPU, with the device
branch forced as tests/sqllogic_port.py forces it:

- (a) the corpus statements that the reference package answers wrong on
  its device branch only (tests/sqllogic_ref_faults.json, the entries
  with no `host` answer) give their golden answer on the port's;
- (b) probe queries over a seeded table with NULLs: NULLs under OR and
  NOT, NOT IN with and then without a NULL in its list, integer x/0,
  CAST, a constant float division by zero, an int64 sum past 2^53 and an
  aggregate of a TAGS column each give the port's device branch the
  answer of the JAX package's host branch on the same data;
- (c) seeded random filters over nullable BIGINT, DOUBLE (with NaN and
  infinities) and BOOLEAN columns: the port's device count equals the
  JAX package's host count and the port's own host count (the device
  walk, ops/device_filter.py, is a second copy of the host's NULL rules
  in sql/expr.py), and X2 launched;
- (d) int64 sums past 2^53 and min/max at ±2^63 come back exact through
  X2, against Python ints.
"""
import contextlib
import os
import shutil
import tempfile

import numpy as np
import pytest
from hypothesis import HealthCheck, given, seed, settings
from hypothesis import strategies as st

import sqllogic_port as slt

N = 240
BASE_TS = 1_600_000_000_000_000_000
C = 2**52 + 1
DEVICE_ENV = slt.BRANCH_ENV["device"]
HOST_ENV = slt.BRANCH_ENV["host"]
# every query scans: no serving layer (it answers a repeat from its
# result cache) and no compressed-domain lane (it answers an unfiltered
# aggregate of flushed pages from their statistics)
BOTH_ENV = {"CNOSDB_COMPRESSED_DOMAIN": "0", "CNOSDB_SERVING": "0"}


@contextlib.contextmanager
def _branch(port: bool):
    """The port's device branch, or the host branch (no forcing env;
    both packages' scan device is the CPU)."""
    saved = {k: os.environ.get(k) for k in {**DEVICE_ENV, **BOTH_ENV}}
    for k, v in DEVICE_ENV.items():
        if port:
            os.environ[k] = v
        else:
            os.environ.pop(k, None)
    if not port:
        os.environ.update(HOST_ENV)
    os.environ.update(BOTH_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------- (a)
FAULTS = slt.load_faults()
DEVICE_ONLY = sorted(k for k, v in FAULTS.items()
                     if "host" not in v and "device" in v)
_FILE_RUNS: dict = {}


def _device_records(corpus: str, name: str) -> dict:
    if (corpus, name) not in _FILE_RUNS:
        d = tempfile.mkdtemp(prefix="dev_sem_")
        try:
            with _branch(port=True):
                recs = slt.run_file(corpus, name, d)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        _FILE_RUNS[(corpus, name)] = {r["line"]: r for r in recs}
    return _FILE_RUNS[(corpus, name)]


def test_the_device_only_faults_are_the_listed_ones():
    """17 statements the port shares with the reference's device branch
    before, and the 3 where only the reference is wrong."""
    assert len(DEVICE_ONLY) == 20


@pytest.mark.parametrize("key", DEVICE_ONLY)
def test_device_only_reference_fault_is_golden_on_the_port(key):
    path, line = key.rsplit(":", 1)
    corpus, name = path.split("/")
    rec = _device_records(corpus, name)[int(line)]
    assert slt.same(rec["answer"], rec["golden"]), (rec["sql"],
                                                    rec["answer"])


# ---------------------------------------------------------------- tables
def _table_rows():
    rng = np.random.default_rng(13)
    i = rng.integers(-4, 9, N)
    j = rng.integers(-2, 3, N)
    f = np.round(rng.normal(2.0, 4.0, N), 2)
    f[rng.choice(N, 12, replace=False)] = np.nan
    f[:4] = [np.inf, -np.inf, 0.0, -0.0]
    g = np.round(rng.uniform(-6, 6, N), 1)
    b = rng.integers(0, 2, N)
    nulls = {c: rng.random(N) < 0.15 for c in "ifgb"}
    rows = []
    for k in range(N):
        fl = [f"j={int(j[k])}i", f"c={C}i"]
        if not nulls["i"][k]:
            fl.append(f"i={int(i[k])}i")
        if not nulls["f"][k]:
            fl.append(f"f={float(f[k])!r}".replace("nan", "NaN")
                      .replace("inf", "Infinity"))
        if not nulls["g"][k]:
            fl.append(f"g={float(g[k])!r}")
        if not nulls["b"][k]:
            fl.append(f"b={'t' if b[k] else 'f'}")
        rows.append(f"t,h=h{k % 4} {','.join(fl)} {BASE_TS + k * 10**9}")
    return rows


def _bounds_rows():
    """int64 columns: s past 2^53 in its sums, m at ±2^63."""
    rng = np.random.default_rng(17)
    s = rng.integers(2**50, 2**52, 64)
    m = rng.integers(-(2**63), 2**63 - 1, 64, dtype=np.int64)
    m[:4] = [2**63 - 1, -(2**63), 2**63 - 2, -(2**63) + 1]
    rows = [f"w,h=h{k % 2} s={int(s[k])}i,m={int(m[k])}i "
            f"{BASE_TS + k * 10**9}" for k in range(64)]
    return rows, [int(x) for x in s], [int(x) for x in m]


def _write(d, pkg: str):
    import importlib

    def mod(p):
        return importlib.import_module(f"{pkg}.{p}")

    meta = mod("parallel.meta").MetaStore(os.path.join(d, "meta.json"))
    coord = mod("parallel.coordinator").Coordinator(
        meta, mod("storage.engine").TsKv(os.path.join(d, "data")))
    ex = mod("sql.executor").QueryExecutor(meta, coord)
    return coord, ex


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX host executor, port device executor) over copies of one data
    directory, written by the JAX package."""
    from cnosdb_tpu.parallel.meta import DEFAULT_TENANT
    from cnosdb_tpu.protocol.line_protocol import parse_lines
    from cnosdb_tpu.sql.executor import Session

    root = tmp_path_factory.mktemp("device_semantics")
    src = str(root / "src")
    coord, ex = _write(src, "cnosdb_tpu")
    try:
        # e is never written: a field absent from every batch
        ex.execute_one("CREATE TABLE t (i BIGINT, j BIGINT, c BIGINT, "
                       "e BIGINT, f DOUBLE, g DOUBLE, b BOOLEAN, TAGS(h))",
                       Session(database="public"))
        ex.execute_one("CREATE TABLE w (s BIGINT, m BIGINT, TAGS(h))",
                       Session(database="public"))
        rows, _s, _m = _bounds_rows()
        coord.write_points(DEFAULT_TENANT, "public",
                           parse_lines("\n".join(_table_rows() + rows)))
    finally:
        coord.close()
    shutil.copytree(src, root / "ref")
    shutil.copytree(src, root / "port")
    with _branch(port=False):
        ref = _write(str(root / "ref"), "cnosdb_tpu")
        port = _write(str(root / "port"), "cnosdb_tpu_torch")
    try:
        yield ref[1], port[1]
    finally:
        ref[0].close()
        port[0].close()


def _answer(ex, sql: str, port: bool, device: bool = True):
    if port:
        from cnosdb_tpu_torch.sql.executor import Session
    else:
        from cnosdb_tpu.sql.executor import Session
    with _branch(port and device):
        try:
            rs = ex.execute_one(sql, Session(database="public"))
        except Exception as e:
            return f"error {type(e).__name__}"
    return [tuple(x.item() if hasattr(x, "item") else x for x in col)
            for col in rs.columns]


def _same_as_host(pair, sql: str, launches: bool = True):
    from cnosdb_tpu_torch.ops import fused

    before = fused.launch_count
    got = _answer(pair[1], sql, port=True)
    launched = fused.launch_count > before
    want = _answer(pair[0], sql, port=False)
    assert got == want, sql
    if launches:
        assert launched, f"X2 did not launch: {sql}"
    return want


# ---------------------------------------------------------------- (b)
PROBES = {
    "or_across_nulls": "SELECT count(*) FROM t WHERE i > 0 OR f > 5.0",
    "not_across_nulls": "SELECT count(*) FROM t WHERE NOT (i > 2 AND f < 1)",
    "bool_or_not": "SELECT count(*) FROM t WHERE b OR NOT (i > 3)",
    "int_div_zero": "SELECT count(*) FROM t WHERE i / (i - i) = 0",
    "int_div_zero_or": "SELECT count(*) FROM t WHERE i / j > 1 OR j = 0",
    "cast_float_to_bigint": "SELECT count(*) FROM t WHERE CAST(g AS BIGINT) > 3",
    "const_float_div_zero": "SELECT count(*) FROM t WHERE f > 1.0/0",
    "const_nan": "SELECT count(*) FROM t WHERE f < 0.0/0 OR g > 0",
}


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_matches_the_host_branch(pair, name):
    want = _same_as_host(pair, PROBES[name])
    assert not isinstance(want, str), want


def test_sum_past_2_53_is_exact(pair):
    assert _same_as_host(pair, "SELECT sum(c) FROM t") == [(N * C,)]


def test_not_in_after_the_same_list_with_a_null(pair):
    """The fused program is keyed on the filter's structure: the NULL in
    the first list must not key the second's program."""
    with_null = _same_as_host(
        pair, "SELECT count(*) FROM t WHERE i NOT IN (1, 2, NULL)")
    without = _same_as_host(
        pair, "SELECT count(*) FROM t WHERE i NOT IN (1, 2)")
    assert with_null == [(0,)] and without[0][0] > 0


def test_cast_of_nan_fails_as_on_the_host(pair):
    assert _same_as_host(
        pair, "SELECT count(*) FROM t WHERE CAST(f AS BIGINT) > 3") \
        == "error PlanError"


def test_tag_aggregate_answers_from_the_series_keys(pair):
    """count(h) of a TAGS column goes to the host (it answered 0)."""
    want = _same_as_host(pair, "SELECT count(h) FROM t WHERE g > -1.0",
                         launches=False)
    assert want[0][0] > 0


def test_absent_field_aggregate_still_rides_x2(pair):
    """A field absent from every row of a batch is not a tag: X2 still
    takes its aggregate, and it answers as the host does."""
    assert _same_as_host(pair, "SELECT count(e), max(e) FROM t "
                               "WHERE g > 0") == [(0,), (None,)]


# ---------------------------------------------------------------- (c)
# Every node of these random filters reads a column, and they are held
# to the JAX package's host branch. It evaluates an operation of two
# constants with Python scalars, where it keeps faults the port repairs
# (`0 != 0` is `~True`, -2, so true; a comparison with an integer x/0 of
# two constants matches rows): (e) generates those operations and holds
# them to Python's answer. Here a zero divisor comes from the data (j
# holds zeros, i - i).
NUM_COLS = ("i", "j", "f", "g")
COL_EXPRS = NUM_COLS + ("CAST(g AS BIGINT)", "CAST(i AS DOUBLE)",
                        "CAST(b AS BIGINT)")
NUM_LITS = ("1", "3", "-2", "2.5", "-1.5")


def _num(depth: int):
    """A numeric expression that reads a column."""
    col = st.sampled_from(COL_EXPRS)
    if depth == 0:
        return col
    sub = _num(depth - 1)
    other = st.one_of(sub, st.sampled_from(NUM_LITS))
    return st.one_of(
        col, col,
        st.builds(lambda a, op, b, flip: f"({b} {op} {a})" if flip
                  else f"({a} {op} {b})", sub,
                  st.sampled_from(["+", "-", "*", "/"]), other,
                  st.booleans()))


def _pred(depth: int):
    num = _num(1)
    cmp = st.builds(lambda a, op, b: f"{a} {op} {b}", num,
                    st.sampled_from(["=", "!=", "<", "<=", ">", ">="]),
                    st.one_of(num, st.sampled_from(NUM_LITS + ("0",))))
    inl = st.builds(
        lambda a, neg, vals, null: f"{a}{' NOT' if neg else ''} IN "
        f"({', '.join(vals + (['NULL'] if null else []))})",
        st.sampled_from(NUM_COLS), st.booleans(),
        st.lists(st.sampled_from(["0", "1", "2", "-2", "2.5"]), min_size=1,
                 max_size=3), st.booleans())
    btw = st.builds(lambda a, neg, lo, hi: f"{a}{' NOT' if neg else ''} "
                    f"BETWEEN {lo} AND {hi}", num, st.booleans(),
                    st.sampled_from(["-2", "0", "1.5"]),
                    st.sampled_from(["1", "3", "4.5"]))
    boolean = st.sampled_from(["b", "b = true", "CAST(i AS BOOLEAN)",
                               "CAST(g AS BOOLEAN)"])
    leaf = st.one_of(cmp, cmp, inl, btw, boolean)
    if depth == 0:
        return leaf
    sub = _pred(depth - 1)
    return st.one_of(
        leaf,
        st.builds(lambda p: f"NOT ({p})", sub),
        st.builds(lambda a, op, b: f"({a}) {op} ({b})", sub,
                  st.sampled_from(["AND", "OR"]), sub))


@seed(20261017)
@settings(max_examples=80, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(p=_pred(2))
def test_random_filter_counts_match_the_host_branch(pair, p):
    """X2 launched wherever a row matched (the planner answers a filter
    it proves false, as `j = 2.5` over a BIGINT, with no scan)."""
    from cnosdb_tpu_torch.ops import fused

    sql = f"SELECT h, count(*) FROM t WHERE {p} GROUP BY h ORDER BY h"
    before = fused.launch_count
    want = _same_as_host(pair, sql, launches=False)
    assert fused.launch_count > before or want in ([(), ()],
                                                   "error PlanError")
    launched = fused.launch_count
    assert _answer(pair[1], sql, port=True, device=False) == want, sql
    assert fused.launch_count == launched, "the host branch launched X2"


# ---------------------------------------------------------------- (d)
def test_int64_sums_and_extremes_are_exact_through_x2(pair):
    _rows, s, m = _bounds_rows()
    got = _same_as_host(pair, "SELECT h, sum(s), min(m), max(m), "
                              "min(s), max(s) FROM w GROUP BY h ORDER BY h")
    want = []
    for hh in (0, 1):
        ss, mm = s[hh::2], m[hh::2]
        want.append((sum(ss), min(mm), max(mm), min(ss), max(ss)))
    assert list(zip(*got[1:])) == want
    assert max(w[0] for w in want) > 2**53
    assert {-(2**63), 2**63 - 1} <= {x for w in want for x in w[1:3]}
    filtered = _same_as_host(pair, "SELECT sum(s) FROM w WHERE m > 0")
    assert filtered == [(sum(x for x, y in zip(s, m) if y > 0),)]


# ---------------------------------------------------------------- (e)
# Operations of two constants, held to SQL's answer computed here in
# Python, on both branches of the port (the JAX package's host branch
# keeps the faults). An integer x/0 is NULL, a float one IEEE.
CONST_LITS = NUM_LITS + ("0",)


def _lit(text: str):
    return float(text) if "." in text else int(text)


def _arith_value(a, op: str, b):
    """`a op b` of two SQL constants: integers stay integers (`/`
    truncates toward zero, x/0 is NULL), a float on either side is
    float64."""
    if op == "/" and isinstance(a, int) and isinstance(b, int):
        if b == 0:
            return None
        q = abs(a) // abs(b)
        return q if (a < 0) == (b < 0) else -q
    with np.errstate(all="ignore"):
        x, y = np.float64(a), np.float64(b)
        r = {"+": x + y, "-": x - y, "*": x * y, "/": x / y}[op]
    if isinstance(a, int) and isinstance(b, int):
        return int(r)
    return float(r)


# every (a op b) of two constants: its SQL text and value
CONST_EXPRS = [(f"({a} {op} {b})", _arith_value(_lit(a), op, _lit(b)))
               for a in CONST_LITS for op in "+-*/" for b in CONST_LITS]
NULL_EXPRS = [e for e in CONST_EXPRS if e[1] is None]
_CMP = {"=": lambda x, y: x == y, "!=": lambda x, y: x != y,
        "<": lambda x, y: x < y, "<=": lambda x, y: x <= y,
        ">": lambda x, y: x > y, ">=": lambda x, y: x >= y}


def _not3(p):
    return None if p is None else not p


def _and3(p, q):
    if p is False or q is False:
        return False
    return None if p is None or q is None else True


def _or3(p, q):
    if p is True or q is True:
        return True
    return None if p is None or q is None else False


def _cmp3(x, op, y):
    return None if x is None or y is None else bool(_CMP[op](x, y))


def _const_pred(depth: int):
    """A predicate whose value is one constant: its SQL text and that
    value (True, False or None for NULL)."""
    const = st.sampled_from(CONST_EXPRS + [(t, _lit(t)) for t in NUM_LITS])
    cmp = st.builds(lambda a, op, b: (f"{a[0]} {op} {b[0]}",
                                      _cmp3(a[1], op, b[1])),
                    const, st.sampled_from(sorted(_CMP)), const)
    # a column compared with an integer x/0 of two constants: NULL on
    # every row, whichever side
    null_cmp = st.builds(
        lambda a, op, n, flip: ((f"{n[0]} {op} {a}" if flip
                                 else f"{a} {op} {n[0]}"), None),
        _num(1), st.sampled_from(sorted(_CMP)), st.sampled_from(NULL_EXPRS),
        st.booleans())

    def between(v, neg, lo, hi):
        inside = _and3(_cmp3(v[1], ">=", lo[1]), _cmp3(v[1], "<=", hi[1]))
        return (f"{v[0]}{' NOT' if neg else ''} BETWEEN {lo[0]} AND "
                f"{hi[0]}", _not3(inside) if neg else inside)

    btw = st.builds(between, const, st.booleans(), const, const)

    def in_list(v, neg, vals, null):
        hit = None if v[1] is None else (
            True if any(v[1] == x[1] for x in vals)
            else (None if null else False))
        items = [x[0] for x in vals] + (["NULL"] if null else [])
        return (f"{v[0]}{' NOT' if neg else ''} IN ({', '.join(items)})",
                _not3(hit) if neg else hit)

    inl = st.builds(in_list, const, st.booleans(),
                    st.lists(const, min_size=1, max_size=3), st.booleans())
    leaf = st.one_of(cmp, cmp, null_cmp, btw, inl)
    if depth == 0:
        return leaf
    sub = _const_pred(depth - 1)
    return st.one_of(
        leaf,
        st.builds(lambda p: (f"NOT ({p[0]})", _not3(p[1])), sub),
        st.builds(lambda p, op, q: (
            f"({p[0]}) {op} ({q[0]})",
            (_and3 if op == "AND" else _or3)(p[1], q[1])), sub,
            st.sampled_from(["AND", "OR"]), sub))


TWO_CONSTANT_PROBES = {
    "ne_of_equal_constants": ("0 != 0", False),
    "not_eq_of_equal_constants": ("NOT (0 = 0)", False),
    "int_div_zero_between": ("(i / 0) BETWEEN -2 AND 1", None),
    "int_div_zero_not_between": ("(i / 0) NOT BETWEEN -2 AND 1", None),
    "ne_int_div_zero_of_constants": ("(i / i) != (0 / 0)", None),
    "not_between_of_constants": ("1 NOT BETWEEN 0 AND 2", False),
    "null_constant_between": ("(1 / 0) BETWEEN -2 AND 1", None),
    "null_constant_not_in": ("(0 / 0) NOT IN (1, 2)", None),
}


@pytest.mark.parametrize("name", sorted(TWO_CONSTANT_PROBES))
def test_two_constant_probe_gives_the_sql_answer(pair, name):
    from cnosdb_tpu_torch.ops import fused

    p, value = TWO_CONSTANT_PROBES[name]
    want = [(N if value else 0,)]
    sql = f"SELECT count(*) FROM t WHERE {p}"
    before = fused.launch_count
    assert _answer(pair[1], sql, port=True) == want, sql
    assert fused.launch_count > before or not value
    assert _answer(pair[1], sql, port=True, device=False) == want, sql


@seed(20261018)
@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=list(HealthCheck))
@given(p=_const_pred(2), c=_pred(1),
       shape=st.sampled_from(["P", "P AND C", "P OR C", "NOT (P AND C)",
                              "NOT (P OR C)"]))
def test_two_constant_operations_give_the_sql_answer(pair, p, c, shape):
    """A filter `shape` of a predicate P whose value is one constant
    (Python's SQL answer) and a column predicate C: both branches of the
    port keep the rows that the JAX package's host branch keeps for the
    same filter with P replaced by a column predicate of that value on
    every row (it answers those right)."""
    where = shape.replace("P", "({p})").replace("C", "({c})")
    sql = f"SELECT h, count(*) FROM t WHERE {where} GROUP BY h ORDER BY h"
    twin = {True: "j = j", False: "j != j", None: "j > NULL"}[p[1]]
    want = _answer(pair[0], sql.format(p=twin, c=c), port=False)
    sql = sql.format(p=p[0], c=c)
    assert _answer(pair[1], sql, port=True) == want, sql
    assert _answer(pair[1], sql, port=True, device=False) == want, sql
