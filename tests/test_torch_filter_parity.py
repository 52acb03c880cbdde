"""The fused program's filter stage (X2) against the reference's, filter by
filter.

One seeded table (FLOAT f, BIGINT i near 2^24, BIGINT UNSIGNED u across
the whole uint64 range, BOOLEAN b with NULLs, a tag h), written once by
cnosdb_tpu, is queried through both packages' device branches, run on the
CPU as tests/test_torch_slice.py runs them (the JAX package's Pallas
kernels in interpret mode). Every filter gives the same count per tag in
both, or an error of the same type in both; where the reference's device
branch disagrees with its own host branch, the port's gives the host's.
The filters cover every operator of sql/expr.py's _BIN_OPS, NOT, IS
NULL, BETWEEN, IN and the math functions it sends through its `xp`
namespace, with the literals and columns mixed
the ways numpy and torch promote differently: an int64 column with a
float literal (float32 in torch), int64 / int64, a bool column in `~`,
uint64 above 2^63 (a literal of 2^63 or more is an OverflowError in
both, as jax.numpy takes a Python int only inside int64's range).
"""
import shutil

import numpy as np
import pytest

N = 400
BASE_TS = 1_600_000_000_000_000_000
I_LO = 16_777_100           # i spans 2^24 = 16,777,216, where float32 rounds

# the filters the port's device branch answered wrongly or not at all
# before it typed its operands as numpy does (each fails on that tree)
PROBES = {
    "int_times_float": "i * 1.5 > 25165830",
    "int_plus_float": "i + 0.1 > 16777216.1",
    "int_div_int": "i / 2 > 8388650",
    "unsigned_literal": "u > 9000000000000000000",
    "unsigned_plus": "u + 1 > 100",
    "not_bool_or": "NOT b OR f < 0",
    "bool_bare": "b",
    "bool_not": "NOT b",
}
FILTERS = [
    # + - * / %
    "f + i > 16777200", "i + 5 > 16777300", "u + u > 5",
    "u - 5 < 100", "i - f > 16777210", "5 - u > 10", "f - 1 < -5",
    "u * 3 > 9000000000000000000", "f * 2 > 7", "i * i > 281474976710656",
    "f / 3 > 1", "u / 3 > 1000000000000000000", "i / f > 0",
    "i / 0.5 > 33554432", "u / 16777216 > 549755813888",
    "i % 7 = 3", "u % 7 = 3", "f % 2 > 1", "i % 2.5 > 1",
    # = != < <= > >=
    "b = true", "i = 16777216", "f = f", "u = 18446744073709551615",
    "b != true", "i != 16777216", "u != 0",
    "u >= 9223372036854775808", "u < 9223372036854775808",
    "u <= 18446744073709551614", "u >= 9223372036854775807",
    "u - 1 >= 9223372036854775807", "u + 9223372036854775807 < 5",
    "u = -1", "u > -2", "i > 16777216.5", "i <= 16777216",
    "i >= 16777216.0", "f < 0", "u > i", "u > 1.5e19",
    # and or ^ NOT
    "f > 0 AND b", "b OR i > 16777300", "b AND NOT b",
    "NOT (i > 16777216)", "NOT (f > 1 AND i < 16777250)",
    "(i ^ 1) > 0", "-u > 5", "-i < -16777216", "b + 1 > 1",
    # IS NULL, BETWEEN, IN
    "b IS NULL", "b IS NOT NULL AND i > 16777216",
    "u BETWEEN 5 AND 9000000000000000000",
    "i BETWEEN 16777200 AND 16777216.5", "f NOT BETWEEN -1 AND 1",
    "u IN (0, 18446744073709551615)", "i IN (16777216, 16777217)",
    "i IN (16777216.0, 16777300.0)", "b IN (true)", "f NOT IN (0.5)",
    # the math functions sql/expr.py evaluates through xp
    "abs(f) > 5", "abs(i - 16777216) < 10", "abs(u) > 9000000000000000000",
    "floor(f) = 1", "ceil(f) > 2", "round(f) = 3", "round(f, 1) > 2.5",
    "trunc(f) = 2", "floor(i / 3) > 5592405", "sqrt(i) > 4096.00001",
    "sqrt(abs(f)) > 2", "sqrt(u) > 3000000000", "cbrt(f) > 1",
    "exp(f / 10) > 1.5", "ln(abs(f) + 1) > 2", "log10(i) > 7.2247",
    "log2(i) > 24.000001", "log(i) > 7.2247", "log(2, i) > 24",
    "sin(f) > 0.5", "cos(i) > 0", "tan(f) > 1", "sinh(f / 10) > 0.5",
    "cosh(f / 10) > 1.2", "tanh(f) > 0.5", "asin(f / 100) > 0.05",
    "acos(f / 100) < 1.5", "atan(f) > 1", "asinh(f) > 2",
    "acosh(abs(f) + 1) > 2", "atanh(f / 100) > 0.05", "atan2(f, i) > 0",
    "pow(f, 2) > 100", "power(i, 2) > 281474976710656", "pow(u, 2) > 5",
    "signum(f) > 0", "radians(i) > 292817", "degrees(f) > 300",
    "gcd(i, 12) = 4", "lcm(i, 3) > 50331700", "pi() < f",
]


def _data():
    rng = np.random.default_rng(2024)
    f = np.round(rng.normal(0, 10, N), 3)
    i = rng.integers(I_LO, I_LO + 240, N)
    u = rng.integers(0, 2**64, N, dtype=np.uint64)
    u[:4] = [0, 2**63 - 1, 2**63, 2**64 - 1]
    # odd values just above 2^24 are the ones float32 rounds to even
    i[:8] = [16777215, 16777216, 16777217, 16777219, 16777220, 16777221,
             16777223, 16777225]
    b = rng.integers(0, 3, N)          # 0 false, 1 true, 2 NULL
    return f, i, u, b


def test_probes_expose_float32():
    """The data straddles the values where float32 rounds: computed in
    float32 (torch's int64 × Python float) the int probes' counts differ
    from float64's."""
    _f, i, _u, _b = _data()
    for scale, add, edge in ((1.5, 0.0, 25165830.0), (1.0, 0.1, 16777216.1)):
        f64 = int(np.sum(i * scale + add > edge))
        f32 = int(np.sum(i.astype(np.float32) * np.float32(scale)
                         + np.float32(add) > np.float32(edge)))
        assert f32 != f64


def _write_source(d):
    from cnosdb_tpu.parallel.coordinator import Coordinator
    from cnosdb_tpu.parallel.meta import DEFAULT_TENANT, MetaStore
    from cnosdb_tpu.protocol.line_protocol import parse_lines
    from cnosdb_tpu.sql.executor import QueryExecutor, Session
    from cnosdb_tpu.storage.engine import TsKv

    meta = MetaStore(str(d / "meta.json"))
    coord = Coordinator(meta, TsKv(str(d / "data")))
    try:
        ex = QueryExecutor(meta, coord)
        ex.execute_one("CREATE TABLE p (f DOUBLE, i BIGINT, "
                       "u BIGINT UNSIGNED, b BOOLEAN, TAGS(h))",
                       Session(database="public"))
        f, i, u, b = _data()
        rows = []
        for k in range(N):
            flds = [f"f={float(f[k])!r}", f"i={int(i[k])}i", f"u={int(u[k])}u"]
            if b[k] < 2:
                flds.append(f"b={'t' if b[k] else 'f'}")
            rows.append(f"p,h=h{k % 3} {','.join(flds)} "
                        f"{BASE_TS + k * 1_000_000_000}")
        coord.write_points(DEFAULT_TENANT, "public",
                           parse_lines("\n".join(rows)))
    finally:
        coord.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference executor, port executor) over copies of one directory,
    both on their device branch."""
    root = tmp_path_factory.mktemp("filters")
    _write_source(root / "src")
    shutil.copytree(root / "src", root / "ref")
    shutil.copytree(root / "src", root / "port")
    with pytest.MonkeyPatch.context() as mp:
        for k, v in (("CNOSDB_TPU_FORCE_DEVICE_PATH", "1"),
                     ("CNOSDB_TPU_PALLAS", "1"),
                     ("CNOSDB_DEVICE_DECODE", "1"),
                     ("CNOSDB_SERVING", "0"),
                     ("CNOSDB_TORCH_PLACEMENT", "cpu")):
            mp.setenv(k, v)
        from cnosdb_tpu.parallel.coordinator import Coordinator as RC
        from cnosdb_tpu.parallel.meta import MetaStore as RM
        from cnosdb_tpu.sql.executor import QueryExecutor as RQ
        from cnosdb_tpu.storage.engine import TsKv as RT
        from cnosdb_tpu_torch.parallel.coordinator import Coordinator as PC
        from cnosdb_tpu_torch.parallel.meta import MetaStore as PM
        from cnosdb_tpu_torch.sql.executor import QueryExecutor as PQ
        from cnosdb_tpu_torch.storage.engine import TsKv as PT

        rm = RM(str(root / "ref" / "meta.json"))
        rc = RC(rm, RT(str(root / "ref" / "data")))
        pm = PM(str(root / "port" / "meta.json"))
        pc = PC(pm, PT(str(root / "port" / "data")))
        try:
            yield RQ(rm, rc), PQ(pm, pc)
        finally:
            rc.close()
            pc.close()


def _counts(ex, filt, port: bool):
    if port:
        from cnosdb_tpu_torch.sql.executor import Session
    else:
        from cnosdb_tpu.sql.executor import Session
    sql = f"SELECT h, count(*) AS c FROM p WHERE {filt} GROUP BY h ORDER BY h"
    try:
        rs = ex.execute_one(sql, Session(database="public"))
    except Exception as e:
        return f"error {type(e).__name__}"
    return [tuple(col.tolist()) for col in rs.columns]


def _agree(pair, filt):
    """The port's device branch gives the reference's device answer, or,
    where the reference's device and host branches disagree, its host
    answer: the port's device branch answers as the host branch (NULLs
    under OR and NOT, where the reference's device branch loses rows)."""
    from cnosdb_tpu_torch.ops import fused

    before = fused.launch_count
    got = _counts(pair[1], filt, port=True)
    ref = _counts(pair[0], filt, port=False)
    if got != ref:
        with pytest.MonkeyPatch.context() as mp:
            mp.delenv("CNOSDB_TPU_FORCE_DEVICE_PATH")
            host = _counts(pair[0], filt, port=False)
        if host != ref:
            ref = host
    assert got == ref, filt
    return ref, fused.launch_count > before


@pytest.mark.parametrize("name", sorted(PROBES))
def test_probe_filter_matches_reference(pair, name):
    ref, launched = _agree(pair, PROBES[name])
    assert not isinstance(ref, str), ref   # the reference answers it
    assert launched, "the port's fused program never launched"


@pytest.mark.parametrize("filt", FILTERS)
def test_filter_matches_reference(pair, filt):
    _agree(pair, filt)


def test_constant_filters_match_reference(pair):
    for filt in ("1 = 1", "1 = 0", "'a' LIKE 'a%'", "true", "false AND b"):
        _agree(pair, filt)
