"""Project-invariant lint rules.

Every rule documents the incident or PR that motivated it (``motivation``)
— a rule that can't point at a real failure it prevents is noise. To add
one: subclass :class:`~cnosdb_tpu_torch.analysis.Rule`, set ``name`` (kebab-case;
it is the suppression token and the baseline key), declare ``node_types``
for the shared walk and/or override ``begin_module`` for whole-module
passes, and append it to :func:`all_rules`. Run ``--fix-baseline`` once if
the tree has pre-existing debt the new rule should ratchet rather than
block on.
"""
from __future__ import annotations

import ast
import re

from . import Rule

# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _call_name(node: ast.Call) -> str | None:
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def _recv_text(node: ast.Call) -> str:
    if isinstance(node.func, ast.Attribute):
        try:
            return ast.unparse(node.func.value)
        except Exception:
            return "?"
    return ""


def _walk_no_nested_funcs(root: ast.AST):
    """Walk a statement subtree without descending into nested function /
    lambda bodies (code merely *defined* there doesn't run under the
    enclosing lock/handler)."""
    stack = list(ast.iter_child_nodes(root))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _is_time_time_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "time"
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id in ("time", "_time"))


# --------------------------------------------------------------------------
# 1. no-bare-except — migrated from tests/test_no_bare_except.py (PR 1),
#    widened from parallel/+storage/ to the whole package
# --------------------------------------------------------------------------
class NoBareExcept(Rule):
    name = "no-bare-except"
    motivation = ("PR 1 chaos suite: a bare except in RPC/recovery paths "
                  "swallows KeyboardInterrupt/SystemExit, turning operator "
                  "Ctrl-C and injected crashes into silently-ignored events")
    node_types = (ast.ExceptHandler,)

    def visit(self, node, ctx):
        if node.type is None:
            ctx.report(self, node,
                       "bare 'except:' — catch Exception (or narrower) so "
                       "control-flow exceptions propagate")


# --------------------------------------------------------------------------
# 2. rpc-call-timeout — migrated from tests/test_no_bare_except.py (PR 4),
#    widened to the whole package
# --------------------------------------------------------------------------
class RpcCallTimeout(Rule):
    name = "rpc-call-timeout"
    motivation = ("PR 4 deadline plane: an rpc_call inheriting the 10 s "
                  "default ignores the caller's request deadline — one slow "
                  "peer absorbs the node for 10 s per split")
    node_types = (ast.Call,)

    def applies_to(self, relpath):
        # net.py defines rpc_call (wait_rpc_ready's probe is capped there)
        return relpath != "cnosdb_tpu_torch/parallel/net.py"

    def visit(self, node, ctx):
        if _call_name(node) != "rpc_call":
            return
        has_kw = any(kw.arg == "timeout" or kw.arg is None  # **kwargs
                     for kw in node.keywords)
        if not has_kw and len(node.args) < 4:   # positional timeout = 4th
            ctx.report(self, node,
                       "rpc_call without explicit timeout= — every hop must "
                       "pick a budget (the request deadline then caps it)")


# --------------------------------------------------------------------------
# 3/4. row-loop — migrated from tests/test_no_row_loops.py (PR 5)
# --------------------------------------------------------------------------
_VECTORIZED_FUNCS = ("_merge_distinct_vec", "_apply_gapfill",
                     "_merge_results_vec")
_FALLBACK_FUNC = "_merge_distinct"
_ROW_ITER_NAMES = {"idxs", "idx", "rows", "row_idxs"}


def _row_loops(fn: ast.AST):
    """For-loops whose iterable is a row-index array: a bare name from the
    denylist, or a direct np.nonzero(...) subscript."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.For):
            continue
        it = node.iter
        if isinstance(it, ast.Name) and it.id in _ROW_ITER_NAMES:
            yield node.lineno
        elif isinstance(it, ast.Subscript) \
                and isinstance(it.value, ast.Call) \
                and isinstance(it.value.func, ast.Attribute) \
                and it.value.func.attr == "nonzero":
            yield node.lineno


class _RowLoopBase(Rule):
    def applies_to(self, relpath):
        return relpath == "cnosdb_tpu_torch/sql/executor.py"

    def _funcs(self, ctx, names):
        found = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node.name in names:
                found[node.name] = node
        return found


class RowLoop(_RowLoopBase):
    name = "row-loop"
    motivation = ("PR 5 aggregation plane: a per-row Python loop in a "
                  "vectorized section regresses silently — results stay "
                  "right, only 10-100x slower at ClickBench cardinalities")

    def begin_module(self, ctx):
        found = self._funcs(ctx, _VECTORIZED_FUNCS)
        for name in _VECTORIZED_FUNCS:
            fn = found.get(name)
            if fn is None:
                ctx.report(self, 1,
                           f"vectorized section {name} not found — if it "
                           f"was renamed, update analysis/rules.py so the "
                           f"lint keeps covering it")
                continue
            for line in _row_loops(fn):
                ctx.report(self, line,
                           f"per-row loop in vectorized section {name} — "
                           f"use factorized codes + bincount/reduceat/"
                           f"grouped_order (ops/group_agg.py) instead")


class RowLoopFallback(_RowLoopBase):
    name = "row-loop-fallback"
    motivation = ("PR 5: _merge_distinct keeps per-row folds ONLY for "
                  "payloads that defeat factorization; the baseline pins "
                  "the count so new code paths can't quietly join them")

    def begin_module(self, ctx):
        fn = self._funcs(ctx, (_FALLBACK_FUNC,)).get(_FALLBACK_FUNC)
        if fn is None:
            ctx.report(self, 1,
                       f"{_FALLBACK_FUNC} not found — update "
                       f"analysis/rules.py if it was renamed")
            return
        for line in _row_loops(fn):
            ctx.report(self, line,
                       "scalar row-loop fallback in _merge_distinct "
                       "(baselined; new aggregation work belongs in "
                       "_merge_distinct_vec)")


# --------------------------------------------------------------------------
# 5. lock-blocking — new: blocking calls written inside `with <lock>:`
# --------------------------------------------------------------------------
_LOCKISH = ("lock", "mutex", "cond", "_cv")
_BLOCKING_NAMES = {"rpc_call", "wait_rpc_ready", "urlopen", "recv",
                   "recv_into", "sendall", "accept", "getresponse",
                   "run_all"}
_SUBPROCESS_NAMES = {"run", "check_call", "check_output", "Popen", "call"}


def _lockish_name(expr: ast.AST) -> str | None:
    if isinstance(expr, ast.Name):
        n = expr.id
    elif isinstance(expr, ast.Attribute):
        n = expr.attr
    elif isinstance(expr, ast.Call):
        # with self._registry.lock_for(x): — look at the callee name
        return _lockish_name(expr.func)
    else:
        return None
    low = n.lower()
    return n if any(k in low for k in _LOCKISH) else None


class LockBlocking(Rule):
    name = "lock-blocking"
    motivation = ("PRs 1-4 each found a stall where one slow peer/disk op "
                  "serialized the node because a mutex was held across it; "
                  "ROADMAP #1/#2 add more threads and more locks")
    node_types = (ast.With,)

    def visit(self, node, ctx):
        locks = [n for n in (_lockish_name(it.context_expr)
                             for it in node.items) if n]
        if not locks:
            return
        ctx_texts = set()
        for it in node.items:
            try:
                ctx_texts.add(ast.unparse(it.context_expr))
            except Exception:
                pass
        seen_lines = set()
        for inner in _walk_no_nested_funcs(node):
            if not isinstance(inner, ast.Call) or inner.lineno in seen_lines:
                continue
            what = self._blocking(inner, ctx_texts)
            if what:
                seen_lines.add(inner.lineno)
                ctx.report(self, inner,
                           f"{what} while holding {'/'.join(locks)} — move "
                           f"the blocking call outside the lock (snapshot "
                           f"state, drop the lock, then block)")

    @staticmethod
    def _blocking(call: ast.Call, ctx_texts: set) -> str | None:
        name = _call_name(call)
        recv = _recv_text(call)
        if name in _BLOCKING_NAMES:
            return f"{name}()"
        if name == "sleep" and recv in ("", "time"):
            return "time.sleep()"
        if name == "open" and isinstance(call.func, ast.Name):
            return "file open()"
        if name == "result" and recv:
            return "future .result()"
        if name == "wait" and recv and recv not in ctx_texts:
            # cv.wait() on the with-target releases the lock; .wait() on
            # anything else (Event, Thread, process) blocks while holding it
            return f"{recv}.wait()"
        if name in _SUBPROCESS_NAMES and recv == "subprocess":
            return f"subprocess.{name}()"
        return None


# --------------------------------------------------------------------------
# 6. swallowed-exception — new: `except Exception: pass` in the planes
#    where silence has already masked corruption
# --------------------------------------------------------------------------
class SwallowedException(Rule):
    name = "swallowed-exception"
    motivation = ("PR 3 integrity plane: quarantine/repair bugs hid behind "
                  "silent except-pass until a counter was added; in "
                  "parallel/+storage/ every swallow needs a log or metric")
    node_types = (ast.ExceptHandler,)

    def applies_to(self, relpath):
        return relpath.startswith(("cnosdb_tpu_torch/parallel/",
                                   "cnosdb_tpu_torch/storage/"))

    def visit(self, node, ctx):
        if not (isinstance(node.type, ast.Name)
                and node.type.id == "Exception"):
            return
        if len(node.body) == 1 and isinstance(node.body[0], ast.Pass):
            ctx.report(self, node,
                       "'except Exception: pass' with no log/metric — count "
                       "it (utils/stages.count_error) or narrow the except; "
                       "silent swallows have masked real corruption before")


# --------------------------------------------------------------------------
# 7. torch-sync — new: Python truth tests on tensors, .item()
# --------------------------------------------------------------------------
class TorchSync(Rule):
    """A Python truth test on a tensor (``if``/``while``/``assert``/
    ``x if t else y``/``and``/``or``/``not``, a comprehension's ``if``,
    ``x in t``) and ``.item()`` in the device files. On a CUDA tensor
    each is ``Tensor.__bool__``/``.item()``: a wait for the card and a
    copy back. Tensors are the values of torch tensor ops, device moves
    and params annotated ``torch.Tensor``; tensor metadata (``.shape``,
    ``.numel()``, ``.dim()``, ``.dtype``, ``.device``, ``.is_cuda``,
    ``len()``, ``is None``) does not sync. The explicit crossings
    (``int()``/``float()``/``bool()``/``.cpu()``/``.tolist()``) are
    host-sync's."""

    name = "torch-sync"
    motivation = ("the port's device plane is eager torch on a CUDA "
                  "card, where no tracer refuses a Python branch on a "
                  "tensor (jit tracing did, in the JAX package's "
                  "jax-purity): Tensor.__bool__ and .item() silently "
                  "stall the card's queue mid-query, once per call")
    # jax-purity's four files, plus the torch counterparts of X2 (fused)
    # and X5 (distributed_agg): jitted programs in the JAX package
    files = ("cnosdb_tpu_torch/ops/kernels.py",
             "cnosdb_tpu_torch/ops/group_agg.py",
             "cnosdb_tpu_torch/ops/pallas_kernels.py",
             "cnosdb_tpu_torch/ops/device_decode.py",
             "cnosdb_tpu_torch/ops/fused.py",
             "cnosdb_tpu_torch/parallel/distributed_agg.py")

    def applies_to(self, relpath):
        return relpath in self.files

    def begin_module(self, ctx):
        seen: set = set()
        for fn in ast.walk(ctx.tree):
            if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_function(fn, ctx, seen)
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "item" and not node.args \
                    and node.lineno not in seen:
                seen.add(node.lineno)
                ctx.report(self, node,
                           ".item() waits for the card and copies one "
                           "element back — keep values on the device or "
                           "pull whole tensors once at an audited "
                           "transfer point")

    @staticmethod
    def _tensorish(expr, tensors: set) -> bool:
        """May ``expr`` evaluate to a tensor (on the card)?"""
        from .interproc import (_HOST_CAST_METHODS, _TENSOR_META_ATTRS,
                                _TENSOR_META_METHODS, to_kind,
                                torch_call_kind)

        def tensorish(e) -> bool:
            if isinstance(e, ast.Name):
                return e.id in tensors
            if isinstance(e, ast.Attribute):
                return e.attr not in _TENSOR_META_ATTRS \
                    and tensorish(e.value)
            if isinstance(e, ast.Subscript):
                return tensorish(e.value)
            if isinstance(e, ast.Call):
                kind = torch_call_kind(e)
                if kind is not None:
                    return kind == "device"
                to = to_kind(e)
                if to is not None:
                    return to == "device" or (
                        to == "dtype" and tensorish(e.func.value))
                fn = e.func
                if not isinstance(fn, ast.Attribute):
                    return False
                if fn.attr == "cuda":
                    return True
                return fn.attr not in _HOST_CAST_METHODS \
                    and fn.attr not in _TENSOR_META_METHODS \
                    and tensorish(fn.value)
            if isinstance(e, ast.BinOp):
                return tensorish(e.left) or tensorish(e.right)
            if isinstance(e, ast.UnaryOp):
                return not isinstance(e.op, ast.Not) \
                    and tensorish(e.operand)
            if isinstance(e, ast.Compare):
                if any(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                       ast.NotIn)) for op in e.ops):
                    return False
                return any(tensorish(x) for x in [e.left, *e.comparators])
            if isinstance(e, ast.IfExp):
                return tensorish(e.body) or tensorish(e.orelse)
            if isinstance(e, ast.BoolOp):
                return any(tensorish(v) for v in e.values)
            return False

        return tensorish(expr)

    def _bool_sync(self, test, tensors: set) -> bool:
        """Does testing ``test`` for truth call Tensor.__bool__?"""
        if isinstance(test, ast.BoolOp):
            return any(self._bool_sync(v, tensors) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._bool_sync(test.operand, tensors)
        if isinstance(test, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn)) for op in test.ops):
            return any(self._tensorish(x, tensors)
                       for x in test.comparators)
        return self._tensorish(test, tensors)

    def _check_function(self, fn, ctx, seen: set) -> None:
        """One pass in line order: each truth test is judged by what its
        names hold at that line (a name rebound to a host value, as
        ``host = t.cpu()``, stops being a tensor)."""
        args = fn.args
        tensors = {a.arg for a in (list(args.posonlyargs) + list(args.args)
                                   + list(args.kwonlyargs))
                   if a.annotation is not None
                   and "Tensor" in ast.unparse(a.annotation)}
        events = []   # (line, 0 = truth test | 1 = binding, node, expr)
        for node in _walk_no_nested_funcs(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                events.append((node.lineno, 0, node, node.test))
            elif isinstance(node, ast.comprehension):
                events.extend((c.lineno, 0, c, c) for c in node.ifs)
            elif isinstance(node, ast.BoolOp):
                # every operand but the last is tested for truth
                events.extend((v.lineno, 0, v, v) for v in node.values[:-1])
            elif isinstance(node, ast.UnaryOp) \
                    and isinstance(node.op, ast.Not):
                events.append((node.lineno, 0, node, node.operand))
            elif isinstance(node, ast.Compare) and any(
                    isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
                events.append((node.lineno, 0, node, node))
            elif isinstance(node, (ast.Assign, ast.AugAssign,
                                   ast.AnnAssign, ast.For)):
                events.append((node.lineno, 1, node, None))
        for line, kind, node, test in sorted(events, key=lambda e: e[:2]):
            if kind == 1:
                self._bind(node, tensors)
            elif line not in seen and self._bool_sync(test, tensors):
                seen.add(line)
                what = ast.unparse(test)
                what = what if len(what) <= 40 else what[:37] + "..."
                ctx.report(self, node,
                           f"Python truth test on a tensor ({what}) inside "
                           f"{fn.name} — Tensor.__bool__ waits for the card "
                           f"and copies the value back; decide on the "
                           f"device (torch.where, masks) or on metadata "
                           f"(.shape, .numel())")

    def _bind(self, stmt, tensors: set) -> None:
        value = stmt.iter if isinstance(stmt, ast.For) else stmt.value
        if value is None:
            return
        targets = stmt.targets if isinstance(stmt, ast.Assign) \
            else [stmt.target]
        names = set()
        for t in targets:
            if not isinstance(t, (ast.Attribute, ast.Subscript)):
                names |= _names_in(t)
        if self._tensorish(value, tensors):
            tensors |= names
        elif not isinstance(stmt, ast.AugAssign):
            tensors -= names


# --------------------------------------------------------------------------
# 8. wallclock-duration — new: time.time() arithmetic where monotonic()
#    is required
# --------------------------------------------------------------------------
class WallclockDuration(Rule):
    name = "wallclock-duration"
    motivation = ("PR 4: deadline/backoff/breaker intervals measured with "
                  "time.time() jump under NTP step/slew — a clock step "
                  "mid-flight fires timeouts early or never")

    def begin_module(self, ctx):
        # each function is its own scope (the per-scope walks stop at
        # nested defs, so nothing is visited twice); module level last
        scopes = [n for n in ast.walk(ctx.tree)
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        scopes.append(ctx.tree)
        for scope in scopes:
            self._check_scope(scope, ctx)

    def _check_scope(self, scope, ctx):
        tainted: set = set()
        for n in _walk_no_nested_funcs(scope):
            if isinstance(n, ast.Assign) and _is_time_time_call(n.value):
                # only plain names: `kwargs["at"] = time.time()` stores a
                # timestamp in a container, it doesn't make the container
                # a clock reading
                tainted |= {t.id for t in n.targets
                            if isinstance(t, ast.Name)}
        reported: set = set()
        for n in _walk_no_nested_funcs(scope):
            if not isinstance(n, (ast.BinOp, ast.Compare)):
                continue
            if isinstance(n, ast.BinOp) \
                    and not isinstance(n.op, (ast.Add, ast.Sub)):
                continue
            hit = any(_is_time_time_call(x) for x in ast.walk(n))
            if not hit and tainted:
                hit = bool(_names_in(n) & tainted)
            if hit and n.lineno not in reported:
                reported.add(n.lineno)
                ctx.report(self, n,
                           "duration arithmetic on time.time() — wall "
                           "clock steps under NTP; use time.monotonic() "
                           "(wall clock is only for cross-process "
                           "timestamps, which deserve a disable= + reason)")


# --------------------------------------------------------------------------
# 9. metrics-naming — new: /metrics naming conventions
# --------------------------------------------------------------------------
_METRIC_NAME_RE = re.compile(r"^cnosdb_[a-z0-9_]+$")
_METRIC_METHODS = {"incr", "set_gauge", "set_counter", "observe"}


class MetricsNaming(Rule):
    name = "metrics-naming"
    motivation = ("dashboards and the bench-trajectory tooling key on "
                  "cnosdb_* naming; unprefixed or mis-suffixed series "
                  "silently fall out of every query")
    node_types = (ast.Call,)

    def visit(self, node, ctx):
        if not (isinstance(node.func, ast.Attribute)
                and node.func.attr in _METRIC_METHODS):
            return
        if not (node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            return
        name = node.args[0].value
        method = node.func.attr
        if not _METRIC_NAME_RE.match(name):
            ctx.report(self, node,
                       f"metric {name!r} must match cnosdb_[a-z0-9_]+ "
                       f"(prefixed, lowercase snake_case)")
            return
        if method in ("incr", "set_counter") \
                and not name.endswith("_total"):
            ctx.report(self, node,
                       f"counter {name!r} must end in _total "
                       f"(prometheus counter convention)")
        elif method == "observe" and not name.endswith(
                ("_ms", "_seconds", "_bytes")):
            ctx.report(self, node,
                       f"histogram {name!r} must end in a unit suffix "
                       f"(_ms, _seconds, _bytes)")


# --------------------------------------------------------------------------
# 10. stage-catalog — new: profiling stage names must come from the
#     documented catalog
# --------------------------------------------------------------------------
_STAGE_METHODS = {"stage", "count", "waited"}
_STAGE_RECEIVERS = {"stages", "_stages"}


class StageCatalog(Rule):
    name = "stage-catalog"
    motivation = ("PR 7 profiling plane: EXPLAIN ANALYZE, the slow-query "
                  "log and bench trend tooling all key on stage names; a "
                  "typo'd or undocumented name silently drifts out of "
                  "every report instead of failing")
    node_types = (ast.Call,)

    def visit(self, node, ctx):
        if _call_name(node) not in _STAGE_METHODS \
                or _recv_text(node) not in _STAGE_RECEIVERS \
                or not node.args:
            return
        from ..utils.stages import DYNAMIC_STAGE_PREFIXES, STAGE_CATALOG

        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            name = arg.value
            if name in STAGE_CATALOG \
                    or name.startswith(DYNAMIC_STAGE_PREFIXES):
                return
            ctx.report(self, node,
                       f"stage name {name!r} is not in the documented "
                       f"catalog (utils/stages.STAGE_CATALOG) — add it "
                       f"there with a description, or fix the typo")
        elif isinstance(arg, ast.JoinedStr):
            head = arg.values[0].value \
                if (arg.values and isinstance(arg.values[0], ast.Constant)
                    and isinstance(arg.values[0].value, str)) else ""
            if not head.startswith(DYNAMIC_STAGE_PREFIXES):
                ctx.report(self, node,
                           f"dynamic stage name (f-string head {head!r}) "
                           f"does not start with a registered prefix "
                           f"(utils/stages.DYNAMIC_STAGE_PREFIXES)")


# --------------------------------------------------------------------------
# 11. device-decode-accounting — new (PR 9): no silent host fallbacks
# --------------------------------------------------------------------------
_DDA_FUNCS = {
    "cnosdb_tpu_torch/storage/codecs.py": ("split_for_device",),
    "cnosdb_tpu_torch/storage/scan.py": ("_submit_device_page",),
    "cnosdb_tpu_torch/ops/device_decode.py": ("run", "attach_device_columns"),
}
_DDA_ACCOUNTING = {"_rejected", "_count_fallback", "count_outcome",
                   "declined", "submit", "note_engaged", "count_error"}


def _dda_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _DDA_ACCOUNTING:
            return True
    return False


def _dda_success_return(stmt: ast.AST) -> bool:
    """``return <plan>, None`` — split_for_device's accepted shape."""
    return (isinstance(stmt, ast.Return)
            and isinstance(stmt.value, ast.Tuple)
            and len(stmt.value.elts) == 2
            and isinstance(stmt.value.elts[1], ast.Constant)
            and stmt.value.elts[1].value is None)


def _dda_blocks(fn: ast.AST):
    """Every statement list in fn, nested functions excluded (a sink
    closure's exits belong to its own call-time contract)."""
    stack = [fn]
    while stack:
        node = stack.pop()
        for field in ("body", "orelse", "finalbody"):
            block = getattr(node, field, None)
            if isinstance(block, list) and block:   # IfExp's are exprs
                yield block
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


class DeviceDecodeAccounting(Rule):
    name = "device-decode-accounting"
    motivation = ("PR 9 device-decode plane: every page the device lane "
                  "examines but does not decode must book a (lane, "
                  "reason) outcome — an unaccounted early return/raise "
                  "reintroduces invisible host fallbacks, the exact "
                  "regression cnosdb_device_decode_total exists to catch")

    def applies_to(self, relpath):
        return relpath in _DDA_FUNCS

    def begin_module(self, ctx):
        want = _DDA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check — only
            # the real lane files owe us all of them
            want = tuple({n for names in _DDA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    prev = block[i - 1] if i else None
                    if _dda_has_accounting(stmt) \
                            or _dda_success_return(stmt) \
                            or (prev is not None
                                and _dda_has_accounting(prev)):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"device-decode lane exits must pass "
                               f"reason accounting (_rejected/declined/"
                               f"count_outcome/_count_fallback) so host "
                               f"fallbacks stay visible on /metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"device-decode guarded function {name} not "
                           f"found — if it was renamed, update "
                           f"analysis/rules.py so the lint keeps "
                           f"covering it")


# --------------------------------------------------------------------------
# 12. string-filter-accounting — new (PR 10): no silent per-row fallbacks
# --------------------------------------------------------------------------
_SFA_FUNCS = {
    "cnosdb_tpu_torch/ops/strkernels.py": ("unique_mask", "like_rows",
                                     "topk_order_indices"),
    "cnosdb_tpu_torch/sql/expr.py": ("_per_unique_cmp",),
}
_SFA_ACCOUNTING = {"note_path", "count", "note_engaged", "count_outcome"}


def _sfa_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _SFA_ACCOUNTING:
            return True
    return False


def _sfa_silent_none(stmt: ast.AST) -> bool:
    """``return None`` / bare ``return`` — a decline the CALLER books (the
    normal evaluator that then runs is not itself a string predicate, e.g.
    a numeric cmp falling out of _per_unique_cmp)."""
    return (isinstance(stmt, ast.Return)
            and (stmt.value is None
                 or (isinstance(stmt.value, ast.Constant)
                     and stmt.value.value is None)))


class StringFilterAccounting(Rule):
    name = "string-filter-accounting"
    motivation = ("PR 10 string/search plane: every exit out of the "
                  "per-unique/top-k lanes must book a (path, reason) "
                  "outcome or a topk.* stage — a silent early return "
                  "reintroduces invisible per-row host fallbacks, the "
                  "exact regression cnosdb_string_filter_total exists "
                  "to catch")

    def applies_to(self, relpath):
        return relpath in _SFA_FUNCS

    def begin_module(self, ctx):
        want = _SFA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _SFA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    prev = block[i - 1] if i else None
                    if _sfa_has_accounting(stmt) \
                            or _sfa_silent_none(stmt) \
                            or (prev is not None
                                and _sfa_has_accounting(prev)):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"string-lane exits must book a path/"
                               f"reason (note_path/stages.count) so "
                               f"per-row fallbacks stay visible on "
                               f"/metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"string-filter guarded function {name} not "
                           f"found — if it was renamed, update "
                           f"analysis/rules.py so the lint keeps "
                           f"covering it")


# --------------------------------------------------------------------------
# 13. cold-tier-accounting — new (PR 12): no silent cold-lane exits
# --------------------------------------------------------------------------
_CTA_FUNCS = {
    "cnosdb_tpu_torch/storage/tiering.py": (
        "tier_vnode", "_tier_file", "rehydrate_file", "recover_vnode",
        "fetch_pages", "_page_raw", "_read_page", "buffer_array",
        "verify_cold_file", "purge_vnode"),
}
_CTA_ACCOUNTING = {"_count_cold", "count", "count_error"}


def _cta_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _CTA_ACCOUNTING:
            return True
    return False


class ColdTierAccounting(Rule):
    name = "cold-tier-accounting"
    motivation = ("PR 12 cold-tier plane: every exit out of the tier/"
                  "fetch/rehydrate lanes must book a (lane, reason) into "
                  "cnosdb_cold_tier_total — an unaccounted early return/"
                  "raise hides exactly the events (skipped files, cache "
                  "overflows, remote divergence) the cold tier's "
                  "correctness story depends on observing")

    def applies_to(self, relpath):
        return relpath in _CTA_FUNCS

    def begin_module(self, ctx):
        want = _CTA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _CTA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    prev = block[i - 1] if i else None
                    if _cta_has_accounting(stmt) \
                            or (prev is not None
                                and _cta_has_accounting(prev)):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"cold-tier lane exits must book a (lane, "
                               f"reason) (_count_cold/stages.count) so "
                               f"tiering skips and fetch failures stay "
                               f"visible on /metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"cold-tier guarded function {name} not "
                           f"found — if it was renamed, update "
                           f"analysis/rules.py so the lint keeps "
                           f"covering it")


# --------------------------------------------------------------------------
# 14. serving-accounting — new (PR 15): no silent serving-plane exits
# --------------------------------------------------------------------------
_SVA_FUNCS = {
    "cnosdb_tpu_torch/server/serving.py": ("try_execute", "submit"),
}
_SVA_ACCOUNTING = {"_count_serving", "count", "count_error"}


def _sva_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _SVA_ACCOUNTING:
            return True
    return False


class ServingAccounting(Rule):
    name = "serving-accounting"
    motivation = ("PR 15 serving plane: every exit out of the cache/fuse "
                  "entry points must book a (layer, outcome) into "
                  "cnosdb_serving_total — an unaccounted early return "
                  "makes hit-ratio and batching telemetry lie, hiding "
                  "exactly the regressions (silent bypasses, declined "
                  "fusions) the serving-plane SLO depends on seeing")

    def applies_to(self, relpath):
        return relpath in _SVA_FUNCS

    def begin_module(self, ctx):
        want = _SVA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _SVA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    prev = block[i - 1] if i else None
                    if _sva_has_accounting(stmt) \
                            or (prev is not None
                                and _sva_has_accounting(prev)):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"serving-plane exits must book a (layer, "
                               f"outcome) (_count_serving/stages.count) "
                               f"so cache bypasses and declined fusions "
                               f"stay visible on /metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"serving guarded function {name} not "
                           f"found — if it was renamed, update "
                           f"analysis/rules.py so the lint keeps "
                           f"covering it")


# --------------------------------------------------------------------------
# 15. backup-accounting — new (PR 16): no silent DR-plane exits
# --------------------------------------------------------------------------
_BKA_FUNCS = {
    "cnosdb_tpu_torch/storage/backup.py": ("archive_segment", "create_backup",
                                     "restore_backup", "install_vnode"),
}
_BKA_ACCOUNTING = {"_count_backup", "count", "count_error"}


def _bka_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _BKA_ACCOUNTING:
            return True
    return False


class BackupAccounting(Rule):
    name = "backup-accounting"
    motivation = ("PR 16 disaster-recovery plane: every exit out of the "
                  "archive/backup/restore lanes must book an (op, "
                  "outcome) into cnosdb_backup_total — an unaccounted "
                  "early return makes the RPO/backup telemetry lie, and "
                  "a DR plane that silently skips segments or vnodes is "
                  "discovered exactly when the backup is needed")

    def applies_to(self, relpath):
        return relpath in _BKA_FUNCS

    def begin_module(self, ctx):
        want = _BKA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _BKA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    prev = block[i - 1] if i else None
                    if _bka_has_accounting(stmt) \
                            or (prev is not None
                                and _bka_has_accounting(prev)):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"DR-plane exits must book an (op, "
                               f"outcome) (_count_backup/stages.count) so "
                               f"skipped segments and failed installs "
                               f"stay visible on /metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"backup guarded function {name} not "
                           f"found — if it was renamed, update "
                           f"analysis/rules.py so the lint keeps "
                           f"covering it")


# --------------------------------------------------------------------------
# 16. fault-site-coverage — new (PR 13): every fire() site must be in the
#     FAULT_POINTS registry the crash sweep enumerates
# --------------------------------------------------------------------------
_FSC_RECEIVERS = {"faults", "_faults"}


class FaultSiteCoverage(Rule):
    name = "fault-site-coverage"
    motivation = ("PR 13 nemesis plane: the crash-point sweep enumerates "
                  "faults.FAULT_POINTS — a fire() site that never "
                  "registered is a fault point the sweep silently skips, "
                  "so its torn-state bugs go unexplored; every site must "
                  "register_point() in its module or carry a reasoned "
                  "disable")
    node_types = (ast.Call,)

    def begin_module(self, ctx):
        self._registered = set()
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) \
                    and _call_name(node) == "register_point" \
                    and _recv_text(node) in _FSC_RECEIVERS \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                self._registered.add(node.args[0].value)

    def visit(self, node, ctx):
        if _call_name(node) != "fire" \
                or _recv_text(node) not in _FSC_RECEIVERS \
                or not node.args:
            return
        arg = node.args[0]
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            if arg.value not in self._registered:
                ctx.report(self, node,
                           f"fault point {arg.value!r} fired here but "
                           f"never registered — add faults.register_point"
                           f"({arg.value!r}, __name__, ...) in this "
                           f"module so the crash sweep covers it")
        else:
            ctx.report(self, node,
                       "dynamic fault point name — the sweep registry is "
                       "static, so fire() must name a literal registered "
                       "point, or register every candidate point and "
                       "carry a reasoned lint disable")


# --------------------------------------------------------------------------
# 17. compressed-domain-accounting — new (PR 17): no silent lane bails
# --------------------------------------------------------------------------
_CDA_FUNCS = {
    "cnosdb_tpu_torch/storage/compressed_domain.py":
        ("build_spec", "_classify", "_answer", "_page_row_mask"),
}
_CDA_ACCOUNTING = {"count_outcome", "_declined", "_mat"}


def _cda_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _CDA_ACCOUNTING:
            return True
    return False


def _cda_success_return(stmt: ast.AST) -> bool:
    """``return <name>`` — handing back a computed result (a survivor
    mask, a spec) is the accepted shape; bails return None / a literal
    and must book why."""
    return isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Name)


class CompressedDomainAccounting(Rule):
    name = "compressed-domain-accounting"
    motivation = ("PR 17 compressed-domain lane: every page the lane "
                  "declines to answer/skip/mask must book a (lane, "
                  "reason) outcome — an unaccounted early return/raise "
                  "is a silent fall-through to full decode, the exact "
                  "regression cnosdb_compressed_domain_total exists to "
                  "catch")

    def applies_to(self, relpath):
        return relpath in _CDA_FUNCS

    def begin_module(self, ctx):
        want = _CDA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _CDA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    # accounting may land anywhere earlier in the same
                    # block (skip exits bump counters between the book
                    # and the return), or inside the return expression
                    if _cda_has_accounting(stmt) \
                            or _cda_success_return(stmt) \
                            or any(_cda_has_accounting(prev)
                                   for prev in block[:i]):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"compressed-domain lane exits must book a "
                               f"reason (count_outcome/_declined/_mat) so "
                               f"silent full-decode fallbacks stay "
                               f"visible on /metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"compressed-domain guarded function {name} "
                           f"not found — if it was renamed, update "
                           f"analysis/rules.py so the lint keeps "
                           f"covering it")


# --------------------------------------------------------------------------
# 18. hedge-accounting — new (PR 18): no silent hedge-lane exits
# --------------------------------------------------------------------------
_HGA_FUNCS = {
    "cnosdb_tpu_torch/parallel/coordinator.py": ("_scan_remote_hedged",),
}
_HGA_ACCOUNTING = {"count_hedge", "count", "count_error", "count_breaker"}


def _hga_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _HGA_ACCOUNTING:
            return True
    return False


def _hga_success_return(stmt: ast.AST) -> bool:
    """``return <name>`` / ``return None`` / bare ``return`` — the
    winner-settle shapes: won/lost were booked in the enclosing block
    before the result dispatch, so these carry no reason of their own.
    Literal returns and raises must book why."""
    return isinstance(stmt, ast.Return) and (
        stmt.value is None
        or isinstance(stmt.value, ast.Name)
        or (isinstance(stmt.value, ast.Constant)
            and stmt.value.value is None))


class HedgeAccounting(Rule):
    name = "hedge-accounting"
    motivation = ("PR 18 gray-failure plane: every exit out of the hedged "
                  "scan lane must book into cnosdb_hedge_total (fired/won/"
                  "lost/cancelled/suppressed) or a hedge.* stage — an "
                  "unaccounted early exit makes the hedge ledger lie, and "
                  "that ledger is the only proof hedging stays tail-only "
                  "instead of silently doubling cluster scan load")

    def applies_to(self, relpath):
        return relpath in _HGA_FUNCS

    def begin_module(self, ctx):
        want = _HGA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _HGA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    # accounting may land anywhere earlier in the same
                    # block (the settle path books won/lost, then
                    # dispatches on the result shape)
                    if _hga_has_accounting(stmt) \
                            or _hga_success_return(stmt) \
                            or any(_hga_has_accounting(prev)
                                   for prev in block[:i]):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"hedge-lane exits must book into "
                               f"cnosdb_hedge_total (count_hedge) or a "
                               f"hedge.* stage so the hedge ledger stays "
                               f"trustworthy on /metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"hedge guarded function {name} not found — "
                           f"if it was renamed, update analysis/rules.py "
                           f"so the lint keeps covering it")


# --------------------------------------------------------------------------
# 19. memory-accounting — new (PR 19): no silent ladder exits
# --------------------------------------------------------------------------
_MEM_FUNCS = {
    "cnosdb_tpu_torch/server/memory.py": ("write_admit", "rebalance"),
}
_MEM_ACCOUNTING = {"count", "_event"}


def _mem_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _MEM_ACCOUNTING:
            return True
    return False


def _mem_success_return(stmt: ast.AST) -> bool:
    """``return <name>`` / ``return None`` / bare ``return`` — the
    under-watermark fast paths: nothing was degraded, so there is
    nothing to book. Literal returns and raises must book why."""
    return isinstance(stmt, ast.Return) and (
        stmt.value is None
        or isinstance(stmt.value, ast.Name)
        or (isinstance(stmt.value, ast.Constant)
            and stmt.value.value is None))


class MemoryAccounting(Rule):
    name = "memory-accounting"
    motivation = ("PR 19 memory-governance plane: every degradation the "
                  "ladder takes (reclaim, shed, backpressure delay, "
                  "fail-closed) must book into cnosdb_memory_total "
                  "{pool,action} — an unaccounted exit means the node "
                  "degraded service with no trace, and those counters "
                  "are the only proof the broker (not an OOM kill) "
                  "handled the pressure")

    def applies_to(self, relpath):
        return relpath in _MEM_FUNCS

    def begin_module(self, ctx):
        want = _MEM_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _MEM_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    # booking may land anywhere earlier in the same
                    # block (the ladder counts, logs the event ring,
                    # then raises)
                    if _mem_has_accounting(stmt) \
                            or _mem_success_return(stmt) \
                            or any(_mem_has_accounting(prev)
                                   for prev in block[:i]):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"memory-ladder exits must book into "
                               f"cnosdb_memory_total (count/_event) so "
                               f"every degradation stays visible on "
                               f"/metrics and /debug/memory")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"memory guarded function {name} not found — "
                           f"if it was renamed, update analysis/rules.py "
                           f"so the lint keeps covering it")


# --------------------------------------------------------------------------
# 20. mesh-accounting — new (PR 20): no silent mesh-lane exits
# --------------------------------------------------------------------------
_MA_FUNCS = {
    "cnosdb_tpu_torch/ops/mesh_exec.py": ("try_mesh_aggregate",),
}
_MA_ACCOUNTING = {"count_outcome", "_declined", "count_error"}


def _ma_has_accounting(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _call_name(n) in _MA_ACCOUNTING:
            return True
    return False


def _ma_success_return(stmt: ast.AST) -> bool:
    """``return <name>`` — handing back a merged AggResult is the
    engaged shape (booked just above the return); bails return None /
    a literal and must book why."""
    return isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Name)


class MeshAccounting(Rule):
    name = "mesh-accounting"
    motivation = ("PR 20 mesh execution plane: every query the mesh lane "
                  "declines must book a (lane, reason) outcome into "
                  "cnosdb_mesh_total — an unaccounted early return/raise "
                  "is a silent fall-through to the host msgpack merge, "
                  "and those counters are the only proof on-mesh merges "
                  "actually stay collective instead of quietly regressing "
                  "to per-batch host hops")

    def applies_to(self, relpath):
        return relpath in _MA_FUNCS

    def begin_module(self, ctx):
        want = _MA_FUNCS.get(ctx.relpath)
        guarded = want is not None
        if want is None:
            # scope-ignored run (fixtures/self-tests): lint any function
            # bearing a guarded name, but skip the presence check
            want = tuple({n for names in _MA_FUNCS.values()
                          for n in names})
        found = set()
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name not in want:
                continue
            found.add(fn.name)
            terminal = fn.body[-1]
            for block in _dda_blocks(fn):
                for i, stmt in enumerate(block):
                    if not isinstance(stmt, (ast.Return, ast.Raise)) \
                            or stmt is terminal:
                        continue
                    # accounting may land anywhere earlier in the same
                    # block (engaged exits book both lane counters, then
                    # return the merged result)
                    if _ma_has_accounting(stmt) \
                            or _ma_success_return(stmt) \
                            or any(_ma_has_accounting(prev)
                                   for prev in block[:i]):
                        continue
                    kind = "return" if isinstance(stmt, ast.Return) \
                        else "raise"
                    ctx.report(self, stmt,
                               f"unaccounted early {kind} in {fn.name} — "
                               f"mesh-lane exits must book a reason "
                               f"(count_outcome/_declined) so silent "
                               f"host-merge fallbacks stay visible on "
                               f"/metrics")
        for name in want if guarded else ():
            if name not in found:
                ctx.report(self, 1,
                           f"mesh guarded function {name} not found — "
                           f"if it was renamed, update analysis/rules.py "
                           f"so the lint keeps covering it")


def all_rules() -> list:
    from .interproc import project_rules

    return [NoBareExcept(), RpcCallTimeout(), RowLoop(), RowLoopFallback(),
            LockBlocking(), SwallowedException(), TorchSync(),
            WallclockDuration(), MetricsNaming(), StageCatalog(),
            DeviceDecodeAccounting(), StringFilterAccounting(),
            ColdTierAccounting(), ServingAccounting(), BackupAccounting(),
            FaultSiteCoverage(), CompressedDomainAccounting(),
            HedgeAccounting(), MemoryAccounting(), MeshAccounting(),
            *project_rules()]
