"""The SQL golden corpora, statement by statement, through one package.

Two corpora: tests/sqllogic/ (expected blocks carry the header row and
compare exactly, as tests/test_sqllogic.py runs them) and
tests/sqllogic_ref/ (data rows only, `querysort`, and the directives of
tests/test_ref_sqllogic.py). Unlike those runners this one goes on past a
statement that fails and returns every statement's answer, so that each
can be held to its own rule:

- the answer must be the golden one;
- where the reference package (cnosdb_tpu) answers a statement wrong in
  the same branch, the answer may instead be the reference's. Those
  statements are recorded in sqllogic_ref_faults.json, each with its
  file, line, the reference's answer per branch and the reason
  (tests/record_sqllogic_faults.py writes the answers; the reasons are
  kept by hand).

An answer is the rendered rows of a query, "ok" for a statement that ran,
or an error. A `statement error` line takes any error, as in the corpus
runners (it asserts "an error", not its text); a recorded reference error
takes only an error of the same type.

Branches: "host" runs every operator on the host (the scan device is the
CPU); "device" forces the device branch on the CPU, as
tests/test_torch_slice.py does (the fused program, the segment kernel's
plain version, the decode lane). On a card no env is needed: the device
branch is the default there, and it is held to the "device" records.

Paths under /tmp/ in a corpus (COPY INTO targets, `cleandir`) are moved
under the run's own directory, so parallel runs do not share them.
"""
from __future__ import annotations

import importlib
import json
import os
import shutil

TESTS = os.path.dirname(os.path.abspath(__file__))
CORPORA = ("sqllogic", "sqllogic_ref")
FAULTS_PATH = os.path.join(TESTS, "sqllogic_ref_faults.json")
BRANCH_ENV = {
    "host": {"CNOSDB_TORCH_PLACEMENT": "cpu"},
    "device": {"CNOSDB_TPU_FORCE_DEVICE_PATH": "1",
               "CNOSDB_TPU_PALLAS": "1",
               "CNOSDB_DEVICE_DECODE": "1",
               "CNOSDB_SERVING": "0",
               "CNOSDB_TORCH_PLACEMENT": "cpu"},
}
_REF_DIRECTIVES = (("ok", "statement ok "), ("error", "statement error "),
                   ("lineproto", "lineproto "),
                   ("opentsdbjson", "opentsdbjson "),
                   ("opentsdb", "opentsdb "),
                   ("writeprecision", "writeprecision "),
                   ("cleandir", "cleandir "), ("usetenant", "usetenant "),
                   ("useuser", "useuser "), ("use", "usedb "))


def corpus_files(corpus: str) -> list[str]:
    d = os.path.join(TESTS, corpus)
    return sorted(f for f in os.listdir(d) if f.endswith(".slt"))


def parse(corpus: str, name: str) -> list[tuple]:
    """→ [(kind, body, expected rows or None, line of the statement)]."""
    with open(os.path.join(TESTS, corpus, name)) as f:
        lines = f.read().splitlines()
    blocks = []
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        lineno = i + 1
        i += 1
        if not line or line.startswith("#"):
            continue
        directives = _REF_DIRECTIVES if corpus == "sqllogic_ref" \
            else _REF_DIRECTIVES[:2]
        for kind, prefix in directives:
            if line.startswith(prefix):
                body = line[len(prefix):]
                if body == "<<":
                    # heredoc: a multi-line statement up to '>>'
                    part = []
                    while i < len(lines) and lines[i].rstrip() != ">>":
                        part.append(lines[i])
                        i += 1
                    i += 1
                    body = "\n".join(part)
                blocks.append((kind, body, None, lineno))
                break
        else:
            kinds = ("querysort", "query") if corpus == "sqllogic_ref" \
                else ("query",)
            for kind in kinds:
                if line.startswith(kind + " "):
                    expected = []
                    while i < len(lines) and lines[i].strip() != "":
                        expected.append(lines[i].rstrip())
                        i += 1
                    blocks.append((kind, line[len(kind) + 1:], expected,
                                   lineno))
                    break
    return blocks


def _error(e: BaseException) -> dict:
    return {"error": f"{type(e).__name__}: {str(e)[:200]}"}


def error_type(answer: dict) -> str:
    return answer["error"].split(":")[0]


def same(a, b) -> bool:
    """Answer `a` agrees with `b`: equal rows or "ok", or an error where
    `b` is one: any error for a `statement error` line's ({"error": None}),
    else one of `b`'s type."""
    if isinstance(a, dict) or isinstance(b, dict):
        return isinstance(a, dict) and isinstance(b, dict) and (
            b["error"] is None or error_type(a) == error_type(b))
    return a == b


def run_file(corpus: str, name: str, workdir: str,
             pkg: str = "cnosdb_tpu_torch") -> list[dict]:
    """Every statement of one corpus file through `pkg`'s QueryExecutor
    over a fresh data directory under `workdir`. → one record per
    statement: line, kind, sql, golden answer, the package's answer."""
    def mod(path):
        return importlib.import_module(f"{pkg}.{path}")

    meta = mod("parallel.meta").MetaStore(os.path.join(workdir, "meta.json"))
    engine = mod("storage.engine").TsKv(os.path.join(workdir, "data"))
    coord = mod("parallel.coordinator").Coordinator(meta, engine)
    exm = mod("sql.executor")
    ex = exm.QueryExecutor(meta, coord)
    session = exm.Session()
    format_csv = mod("server.http").format_csv
    tmp = os.path.join(workdir, "tmp") + "/"
    precision = "ns"   # set by the `writeprecision` directive
    out = []
    try:
        for kind, body, expected, line in parse(corpus, name):
            rec = {"line": line, "kind": kind, "sql": body}
            body = body.replace("/tmp/", tmp)
            if kind == "cleandir":
                shutil.rmtree(body, ignore_errors=True)
                continue
            if kind == "writeprecision":
                precision = body.strip()
                continue
            if kind == "usetenant":
                session.tenant = body
                continue
            if kind == "useuser":
                session.user = body
                continue
            if kind == "use":
                dbname = body.rstrip(";").strip()
                try:
                    ex.execute_one(
                        f"CREATE DATABASE IF NOT EXISTS {dbname}", session)
                except Exception:
                    pass
                session.database = dbname
                continue
            if kind in ("lineproto", "opentsdb", "opentsdbjson"):
                prec = mod("models.schema").Precision.parse(precision)
                if kind == "lineproto":
                    parser = mod("protocol.line_protocol").parse_lines
                else:
                    otsdb = mod("protocol.opentsdb")
                    parser = otsdb.parse_opentsdb_json \
                        if kind == "opentsdbjson" else otsdb.parse_opentsdb
                try:
                    coord.write_points(session.tenant, session.database,
                                       parser(body, prec))
                    rec["answer"] = "ok"
                except Exception as e:
                    rec["answer"] = _error(e)
                rec["golden"] = "ok"
                out.append(rec)
                continue
            try:
                rs = ex.execute_one(body, session)
            except Exception as e:
                rec["answer"] = _error(e)
            else:
                rec["answer"] = _rows(corpus, kind, rs, format_csv) \
                    if expected is not None else "ok"
            if kind == "error":
                rec["golden"] = {"error": None}
            elif kind == "ok":
                rec["golden"] = "ok"
            else:
                rec["golden"] = _golden(corpus, kind, expected)
                if kind == "querysort" and isinstance(rec["answer"], list):
                    rec["answer"] = sorted(rec["answer"])
            out.append(rec)
    finally:
        coord.close()
    return out


def _rows(corpus: str, kind: str, rs, format_csv) -> list[str]:
    if corpus == "sqllogic":
        # no strip: a trailing all-NULL row is an empty line, still a row
        return format_csv(rs)[:-1].split("\n")
    got = format_csv(rs)[:-1].split("\n")[1:]   # data rows only
    if got == [""] and rs.n_rows == 0:
        got = []
    return [ln.rstrip() for ln in got]


def _golden(corpus: str, kind: str, expected: list[str]) -> list[str]:
    if corpus == "sqllogic":
        return [ln.replace("\\N", "") for ln in expected]
    want = [ln.replace("\\N", "").rstrip() for ln in expected]
    return sorted(want) if kind == "querysort" else want


def load_faults() -> dict:
    with open(FAULTS_PATH) as f:
        return json.load(f)["faults"]


def fault_key(corpus: str, name: str, line: int) -> str:
    return f"{corpus}/{name}:{line}"


def judge(records: list[dict], corpus: str, name: str, branch: str,
          faults: dict) -> tuple[int, list[str], list[str]]:
    """Hold every statement to its rule. → (statements passed, keys of
    those that gave the recorded reference answer instead of the golden
    one, a line per statement off its rule)."""
    passed, matched, off = 0, [], []
    for rec in records:
        if same(rec["answer"], rec["golden"]):
            passed += 1
            continue
        key = fault_key(corpus, name, rec["line"])
        entry = faults.get(key, {})
        if branch in entry and same(rec["answer"], entry[branch]):
            passed += 1
            matched.append(key)
            continue
        off.append(f"{key} [{branch}] {rec['sql'][:160]!r}\n"
                   f"    golden: {str(rec['golden'])[:400]}\n"
                   f"       got: {str(rec['answer'])[:400]}"
                   + (f"\n reference: {str(entry[branch])[:400]}"
                      if branch in entry else ""))
    return passed, matched, off
