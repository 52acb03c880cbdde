"""CLI: ``python -m cnosdb_tpu_torch.analysis [paths…] [--json] [--fix-baseline]
[--changed [REF]] [--callgraph] [--artifact PATH]``.

Exit status: 0 when the tree is clean (no findings beyond the baseline,
no stale baseline cells), 1 otherwise. CI runs this as a tier-1 gate
(tests/test_invariants.py); run it locally before pushing.

``--changed [REF]`` (default HEAD) parses the WHOLE tree — the
interprocedural summaries need every file — but reports findings only
for files touched since REF, so a pre-push check on a big tree reads as
a short diff. ``--callgraph`` dumps the resolved call graph with each
function's summary tags and exits.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

from . import (BASELINE_PATH, PKG_PARENT, load_baseline, norm_relpath,
               run, write_baseline)


def _changed_relpaths(ref: str) -> set:
    """Repo-relative .py paths touched since ``ref`` (committed, staged,
    or unstaged) plus untracked ones — the working set a pre-push lint
    cares about."""
    out: set = set()
    for args in (["git", "diff", "--name-only", ref, "--", "*.py"],
                 ["git", "ls-files", "--others", "--exclude-standard",
                  "--", "*.py"]):
        p = subprocess.run(args, capture_output=True, text=True,
                           cwd=PKG_PARENT, timeout=60)
        if p.returncode != 0:
            raise SystemExit(f"--changed: {' '.join(args)} failed: "
                             f"{p.stderr.strip()}")
        out |= {line.strip() for line in p.stdout.splitlines()
                if line.strip()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cnosdb_tpu_torch.analysis",
        description="AST + interprocedural dataflow lint over the "
                    "cnosdb_tpu_torch invariants")
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: the whole package)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable report on stdout")
    ap.add_argument("--fix-baseline", action="store_true",
                    help="freeze the current findings as the new baseline "
                         "(ratchet down after fixing debt, or absorb a "
                         "new rule's pre-existing findings); prunes and "
                         "reports cells whose findings are gone")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="baseline file (default: the package baseline)")
    ap.add_argument("--all-rules", action="store_true",
                    help="ignore per-rule path scoping (fixture testing)")
    ap.add_argument("--changed", nargs="?", const="HEAD", default=None,
                    metavar="REF",
                    help="report findings only for files touched since "
                         "git REF (default HEAD); the whole tree is "
                         "still parsed so cross-file dataflow stays "
                         "correct")
    ap.add_argument("--callgraph", action="store_true",
                    help="dump the interprocedural call graph + "
                         "per-function summary tags and exit")
    ap.add_argument("--artifact", metavar="PATH", default=None,
                    help="also write the JSON report (including the "
                         "cnosdb_analysis_findings_total gauge) to PATH")
    args = ap.parse_args(argv)

    if args.callgraph:
        from . import ModuleContext, interproc, iter_py_files
        import ast as _ast
        import tokenize as _tokenize

        contexts = []
        for path in iter_py_files(args.paths or None):
            relpath = norm_relpath(path)
            try:
                with _tokenize.open(path) as f:
                    source = f.read()
                tree = _ast.parse(source, filename=path)
            except (SyntaxError, UnicodeDecodeError):
                continue
            contexts.append(ModuleContext(path, relpath, source, tree, []))
        project = interproc.Project(contexts)
        print(project.render_callgraph())
        return 0

    report_filter = None
    if args.changed is not None:
        if args.paths:
            print("--changed analyzes the whole tree; drop the explicit "
                  "paths", file=sys.stderr)
            return 2
        report_filter = _changed_relpaths(args.changed)
        if not report_filter:
            print(f"no python files changed since {args.changed}")
            return 0

    rep = run(args.paths or None, baseline_path=args.baseline,
              ignore_scope=args.all_rules, report_filter=report_filter)

    if args.artifact:
        with open(args.artifact, "w", encoding="utf-8") as f:
            json.dump(rep.as_dict(), f, indent=1)
            f.write("\n")

    if args.fix_baseline:
        if args.paths or report_filter is not None:
            print("--fix-baseline requires a whole-tree run (no paths, "
                  "no --changed)", file=sys.stderr)
            return 2
        old = load_baseline(args.baseline)
        write_baseline(rep.counts, args.baseline)
        kept = {cell for cell, n in rep.counts.items() if n > 0}
        pruned = sorted(set(old) - kept)
        print(f"baseline rewritten: {len(rep.findings)} finding(s) in "
              f"{len(kept)} (rule, file) cell(s) -> {args.baseline}")
        for rule, relpath in pruned:
            print(f"pruned stale cell {rule}:{relpath} "
                  f"(findings no longer exist)")
        if pruned:
            print(f"pruned {len(pruned)} stale cell(s)")
        return 0

    if args.as_json:
        print(json.dumps(rep.as_dict(), indent=1))
        return 0 if rep.ok else 1

    for f in sorted(rep.violations, key=lambda f: (f.path, f.line)):
        print(f.render())
    for rule, path, allowed, found in rep.stale:
        print(f"{path}: [{rule}] baseline stale: {allowed} allowed but "
              f"only {found} found — lock the fix in with --fix-baseline")
    n_base = len(rep.findings) - len(rep.violations)
    if rep.ok:
        print(f"OK: 0 violations ({n_base} baselined finding(s))")
    else:
        print(f"FAIL: {len(rep.violations)} violation(s), "
              f"{len(rep.stale)} stale baseline cell(s) "
              f"({n_base} baselined)")
    return 0 if rep.ok else 1


if __name__ == "__main__":
    sys.exit(main())
