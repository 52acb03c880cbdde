"""Unified AST invariant-analysis engine.

One walk per file, a registry of project-invariant rules, inline
suppressions, and a checked-in baseline so new rules *ratchet* (existing
debt is frozen at its current count and may only shrink) instead of
demanding a flag-day cleanup.

Why this exists: the reference CnosDB leans on rustc to enforce the
invariants a distributed TSDB lives or dies by (no swallowed panics, no
blocking under a mutex the borrow checker can see, Send/Sync). The
Python/JAX rebuild had grown three ad-hoc AST tests that each re-walked
the tree with their own conventions and covered only two directories.
This package replaces them: rules live in :mod:`.rules`, every rule
names the incident that motivated it, and the whole tree is in scope.

Two rule shapes share the registry:

* per-file rules (:class:`Rule`) see one module at a time from the
  single shared AST walk;
* interprocedural rules (:class:`ProjectRule`) run once per lint run
  over the project call graph + per-function summaries built by
  :mod:`.interproc` — params/returns tagged host, device, or
  tainted-by-device, fixed-point over a worklist — so a device array
  produced two call edges away still counts as device at the sink.

Usage:

    python -m cnosdb_tpu_torch.analysis              # lint the package, exit 0/1
    python -m cnosdb_tpu_torch.analysis --json       # machine-readable findings
    python -m cnosdb_tpu_torch.analysis --fix-baseline   # re-freeze current debt
    python -m cnosdb_tpu_torch.analysis --changed REF    # findings only for files
                                                   # touched since git REF
    python -m cnosdb_tpu_torch.analysis --callgraph      # dump the call graph +
                                                   # summaries and exit

Suppressions: append ``# lint: disable=<rule>[,<rule>…]  (reason)`` to
the offending line (the line the finding points at — the ``with``/
``except``/call header). ``disable=all`` silences every rule for that
line. A suppression with no reason is a smell; say why it is safe.

Baseline: ``baseline.json`` maps rule → file → allowed count. A file
exceeding its allowance fails; a file *under* its allowance also fails
("stale baseline") so fixed debt is locked in by running
``--fix-baseline`` — the ratchet only turns one way.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import tokenize

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG_PARENT = os.path.dirname(PKG_DIR)
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")
_DISABLE_MARK = "lint: disable="


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str      # normalized: package-relative posix path when inside
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class Rule:
    """One invariant. Subclasses set ``name``/``motivation``, declare the
    AST node types they want via ``node_types`` (dispatched from the
    single shared walk), and/or override ``begin_module`` for whole-tree
    passes. ``applies_to`` scopes the rule to part of the package."""

    name: str = ""
    motivation: str = ""          # the incident/PR that created the rule
    node_types: tuple = ()

    def applies_to(self, relpath: str) -> bool:
        return True

    def begin_module(self, ctx: "ModuleContext") -> None:
        pass

    def visit(self, node: ast.AST, ctx: "ModuleContext") -> None:
        pass


class ProjectRule(Rule):
    """Interprocedural invariant: instead of per-node visits it gets one
    ``check(project)`` call over the whole-run call graph + summaries
    (:class:`cnosdb_tpu_torch.analysis.interproc.Project`). ``applies_to``
    scopes where findings may be *reported*; summaries are always built
    from every file in the run so taint crosses file boundaries."""

    def check(self, project) -> None:
        raise NotImplementedError


class ModuleContext:
    """Per-file state shared by every rule during the single walk."""

    def __init__(self, path: str, relpath: str, source: str,
                 tree: ast.Module, sink: list):
        self.path = path
        self.relpath = relpath
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self._sink = sink
        # --changed mode: muted files contribute call-graph summaries but
        # produce no findings
        self.muted = False
        # lines where an inline disable actually absorbed a finding this
        # run — the stale-suppression audit flags the rest
        self.suppressed_lines: set = set()

    def report(self, rule: Rule, node, message: str) -> None:
        line = node if isinstance(node, int) else node.lineno
        if self._suppressed(rule.name, line):
            self.suppressed_lines.add(line)
            return
        if self.muted:
            return
        self._sink.append(Finding(rule.name, self.relpath, line, message))

    def _suppressed(self, rule_name: str, line: int) -> bool:
        if not 1 <= line <= len(self.lines):
            return False
        text = self.lines[line - 1]
        at = text.find(_DISABLE_MARK)
        if at < 0 or "#" not in text[:at]:
            return False
        spec = text[at + len(_DISABLE_MARK):]
        # the rule list ends at whitespace/'(' — the rest is the reason
        names = spec.split()[0].rstrip("(") if spec.split() else ""
        listed = {n.strip() for n in names.split(",") if n.strip()}
        return rule_name in listed or "all" in listed


def norm_relpath(path: str) -> str:
    """Stable key for baselines/test-ids: package files become
    ``cnosdb_tpu_torch/...`` (posix); anything else stays absolute."""
    ap = os.path.abspath(path)
    if ap == PKG_PARENT or ap.startswith(PKG_PARENT + os.sep):
        return os.path.relpath(ap, PKG_PARENT).replace(os.sep, "/")
    return ap.replace(os.sep, "/")


def iter_py_files(paths=None):
    roots = list(paths) if paths else [PKG_DIR]
    for root in roots:
        if os.path.isfile(root):
            yield root
            continue
        for dirpath, dirnames, names in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in sorted(names):
                if name.endswith(".py"):
                    yield os.path.join(dirpath, name)


@dataclasses.dataclass
class Report:
    findings: list           # every finding (baselined or not)
    violations: list         # findings in cells over their baseline
    stale: list              # (rule, path, baselined, found) under-budget
    counts: dict             # (rule, path) → found count
    baseline: dict           # (rule, path) → allowed count
    rule_totals: dict = dataclasses.field(default_factory=dict)
    wall_ms: float = 0.0     # analyzer wall time for this run

    @property
    def ok(self) -> bool:
        return not self.violations and not self.stale

    def as_dict(self) -> dict:
        return {
            "ok": self.ok,
            "findings": [f.as_dict() for f in self.findings],
            "violations": [f.as_dict() for f in self.violations],
            "stale": [{"rule": r, "path": p, "baselined": b, "found": n}
                      for (r, p, b, n) in self.stale],
            "counts": {f"{r}:{p}": n for (r, p), n in sorted(self.counts.items())},
            # CI artifact: one-line-diffable per-rule totals (a gauge per
            # rule label, zero-filled for every registered rule)
            "metrics": {
                "cnosdb_analysis_findings_total":
                    dict(sorted(self.rule_totals.items())),
                "cnosdb_analysis_wall_ms": self.wall_ms,
            },
        }


def load_baseline(path: str = BASELINE_PATH) -> dict:
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        raw = json.load(f)
    return {(rule, relpath): n
            for rule, files in raw.items()
            for relpath, n in files.items()}


def write_baseline(counts: dict, path: str = BASELINE_PATH) -> dict:
    """Freeze ``counts`` ((rule, path) → n) as the new baseline."""
    out: dict[str, dict[str, int]] = {}
    for (rule, relpath), n in sorted(counts.items()):
        if n > 0:
            out.setdefault(rule, {})[relpath] = n
    with open(path, "w", encoding="utf-8") as f:
        json.dump(out, f, indent=1, sort_keys=True)
        f.write("\n")
    return out


def lint_files(paths=None, rules=None, ignore_scope: bool = False,
               report_filter=None) -> list:
    """Run every rule over ``paths`` (default: the whole package) with a
    single AST walk per file; returns raw findings (suppressions already
    honored, baseline NOT yet applied).

    ``report_filter``: optional set of relpaths; files outside it are
    still parsed and indexed (interprocedural summaries need the whole
    project) but report no findings — this is the --changed mode.

    When run with the full registry (``rules is None``), a trailing
    stale-suppression audit flags ``# lint: disable=`` comments that
    absorbed no finding during this run."""
    from . import rules as rules_mod

    active = list(rules) if rules is not None else rules_mod.all_rules()
    per_file = [r for r in active if not isinstance(r, ProjectRule)]
    project_rules = [r for r in active if isinstance(r, ProjectRule)]
    audit = rules is None
    findings: list[Finding] = []
    contexts: list[ModuleContext] = []
    for path in iter_py_files(paths):
        relpath = norm_relpath(path)
        muted = report_filter is not None and relpath not in report_filter
        scoped = [] if muted else [r for r in per_file
                                   if ignore_scope or r.applies_to(relpath)]
        if not scoped and not project_rules and not audit:
            continue
        try:
            with tokenize.open(path) as f:   # honors coding cookies
                source = f.read()
            tree = ast.parse(source, filename=path)
        except (SyntaxError, UnicodeDecodeError) as e:
            if not muted:
                findings.append(Finding("parse-error", relpath,
                                        getattr(e, "lineno", 1) or 1,
                                        repr(e)))
            continue
        ctx = ModuleContext(path, relpath, source, tree, findings)
        ctx.muted = muted
        contexts.append(ctx)
        dispatch: dict[type, list] = {}
        for rule in scoped:
            rule.begin_module(ctx)
            for nt in rule.node_types:
                dispatch.setdefault(nt, []).append(rule)
        if dispatch:
            for node in ast.walk(tree):
                for rule in dispatch.get(type(node), ()):
                    rule.visit(node, ctx)
    if project_rules and contexts:
        from . import interproc

        project = interproc.Project(contexts, ignore_scope=ignore_scope)
        for rule in project_rules:
            rule.check(project)
    if audit:
        _audit_suppressions(contexts, findings)
    return findings


def _disable_comments(source: str):
    """Yield ``(lineno, rule-list)`` for every REAL ``# lint: disable=``
    comment. Tokenized rather than text-scanned so docstrings/strings
    that merely *mention* the marker (this module's own docs, fixtures)
    don't count as suppressions."""
    reader = io.StringIO(source).readline
    try:
        for tok in tokenize.generate_tokens(reader):
            if tok.type != tokenize.COMMENT:
                continue
            at = tok.string.find(_DISABLE_MARK)
            if at < 0:
                continue
            spec = tok.string[at + len(_DISABLE_MARK):]
            names = spec.split()[0].rstrip("(") if spec.split() else ""
            yield tok.start[0], names
    except (tokenize.TokenError, IndentationError):
        return


def _audit_suppressions(contexts, findings) -> None:
    """Flag ``# lint: disable=`` comments that suppressed nothing in this
    run — dead weight at best, a typo'd rule name silently disabling
    nothing at worst. Only meaningful on full-registry runs (a subset run
    legitimately leaves other rules' suppressions idle)."""
    for ctx in contexts:
        if ctx.muted:
            continue
        for lineno, names in _disable_comments(ctx.source):
            if lineno in ctx.suppressed_lines:
                continue
            findings.append(Finding(
                "stale-suppression", ctx.relpath, lineno,
                f"suppression 'disable={names}' absorbed no finding — "
                f"the debt it excused is gone (or the rule name is "
                f"wrong); delete the comment"))


def run(paths=None, rules=None, baseline_path: str = BASELINE_PATH,
        ignore_scope: bool = False, report_filter=None) -> Report:
    import time as _time

    t0 = _time.perf_counter()
    findings = lint_files(paths, rules=rules, ignore_scope=ignore_scope,
                          report_filter=report_filter)
    baseline = load_baseline(baseline_path)
    counts: dict[tuple, int] = {}
    for f in findings:
        counts[(f.rule, f.path)] = counts.get((f.rule, f.path), 0) + 1
    violations = [f for f in findings
                  if counts[(f.rule, f.path)]
                  > baseline.get((f.rule, f.path), 0)]
    # stale cells only matter for files this run actually looked at —
    # a subset run must not flag the rest of the tree's baseline
    seen_paths = {norm_relpath(p) for p in iter_py_files(paths)}
    if report_filter is not None:
        seen_paths &= set(report_filter)
    stale = [(rule, relpath, allowed, counts.get((rule, relpath), 0))
             for (rule, relpath), allowed in sorted(baseline.items())
             if relpath in seen_paths
             and counts.get((rule, relpath), 0) < allowed]
    if rules is None:
        from . import rules as rules_mod

        rule_totals = {r.name: 0 for r in rules_mod.all_rules()}
    else:
        rule_totals = {r.name: 0 for r in rules}
    for f in findings:
        rule_totals[f.rule] = rule_totals.get(f.rule, 0) + 1
    return Report(findings=findings, violations=violations, stale=stale,
                  counts=counts, baseline=baseline,
                  rule_totals=rule_totals,
                  wall_ms=round((_time.perf_counter() - t0) * 1000.0, 1))


def finding_counts() -> dict:
    """Whole-tree summary for bench metadata: totals, per-rule finding
    counts, and the analyzer's wall time, so the cost of the static
    plane rides in the perf trajectory next to the numbers it guards."""
    rep = run()
    return {"findings": len(rep.findings),
            "baselined": len(rep.findings) - len(rep.violations),
            "violations": len(rep.violations),
            "stale_baseline_cells": len(rep.stale),
            "analyzer_wall_ms": rep.wall_ms,
            "per_rule": {r: n for r, n in sorted(rep.rule_totals.items())
                         if n}}
