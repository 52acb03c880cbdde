"""Interprocedural device-dataflow substrate + the device-plane rules.

The port of cnosdb_tpu/analysis/interproc.py, with the device taint
redesigned for eager torch on a CUDA card. The per-file rules in
:mod:`.rules` cannot see that ``int(x)`` is a device→host sync when
``x`` came out of a torch op two call edges away. This module builds
what they are missing:

* a **project index**: every function/method definition in the run,
  each file's imports, and the named locks (``lockwatch.Lock(...)`` /
  ``threading.Lock()`` targets);
* a **call graph** with deliberately conservative resolution — a call
  resolves only through (a) local names, (b) ``from mod import f``,
  (c) ``mod.f`` where ``mod`` is an imported project module,
  (d) ``self.m``/``cls.m`` to a same-file method, or (e) a bare
  attribute name with exactly ONE definition project-wide that is not a
  stdlib-common name. Ambiguity resolves to *nothing*: a missed edge
  costs a finding, a wrong edge costs a false positive, and false
  positives kill linters;
* **per-function summaries** (returns-device, dispatches-on-device,
  reaches-rpc, accepts-deadline) driven to fixpoint with a worklist —
  all flags are monotone booleans so the pass count is bounded by the
  longest call chain;
* a per-function **taint environment** mapping local names to
  host/device. Device values enter through ``torch.*`` tensor ops,
  ``.to(<a device that is not the CPU>)``, ``.cuda()``,
  ``put_sharded`` and device-returning callees (``device_cache._put``,
  ``kernels.to_device``). These stay host: torch metadata
  (``torch.cuda.is_available``, ``device_count``, ``torch.device``,
  ``torch.iinfo``, dtypes), ``torch.from_numpy``, factories whose
  ``device=`` is absent or the CPU (and that pass no ``**kw``),
  page-locked factories (``pin_memory=True``), and tensor metadata
  (``.shape``, ``.dtype``, ``.device``, ``.numel()``, ...).
  ``np.asarray``/``float()``/``int()``/``bool()``/``len()``/
  ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``/``.to("cpu")`` are
  the *crossings* — their results are host (and, in a hot path, the
  crossing itself is a finding).

Dispatch — what lock-held-dispatch looks for — is any torch op but the
metadata ones, ``.to()``/``.cuda()``/``.cpu()``, and the entry points
of a hand-written kernel's library (a name bound to
``cuda_build.library(...)``, called directly, through ``getattr`` or
through a local alias).

Deliberate non-goals: attribute taint (``self.dev_out``) is not
tracked — the designed transfer points in ops/ stage device handles on
objects precisely so the crossing is one audited place; tracking them
would re-flag every one through every accessor. ``.cpu()`` and
``.to("cpu")`` exist only on tensors, so they are crossings whatever
their receiver, attributes included.

Rules shipped on this substrate: host-sync, lock-held-dispatch,
deadline-propagation (see each class).
"""
from __future__ import annotations

import ast
import collections

from . import ProjectRule

_UNRESOLVED = object()                   # memo-table "no entry" marker

# torch.* calls that read host metadata: no tensor, no dispatch
_TORCH_METADATA = {
    "device", "dtype", "iinfo", "finfo", "is_tensor", "is_floating_point",
    "get_default_dtype", "is_available", "device_count", "current_device",
    "get_device_name", "get_device_properties", "get_device_capability",
    "is_initialized",
}
# torch.* factories: their result lives where device= says (the CPU when
# it is absent)
_TORCH_FACTORIES = {
    "empty", "zeros", "ones", "full", "arange", "linspace", "logspace",
    "eye", "tensor", "as_tensor", "empty_strided", "rand", "randn",
    "randint", "randperm", "frombuffer",
}
# calls by these names return device values the summaries cannot see
# through: put_sharded wraps its device shards in a ShardedTensor
_DEVICE_ENTRY_NAMES = {"put_sharded"}
# tensor attributes / methods that read metadata, not data: no sync
_TENSOR_META_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                      "layout", "itemsize", "nbytes", "requires_grad"}
_TENSOR_META_METHODS = {"numel", "dim", "size", "stride", "data_ptr",
                        "element_size", "nelement", "is_contiguous",
                        "is_pinned", "is_floating_point", "get_device",
                        "storage_offset"}
# builtins that pass device-ness through untouched (no sync of their own)
_TRANSPARENT_CALLS = {"zip", "sorted", "enumerate", "reversed", "list",
                      "tuple", "iter", "min", "max", "abs", "sum"}
# results of these are host-side by construction (they ARE the crossing)
_HOST_CAST_NAMES = {"float", "int", "bool", "len", "str"}
_HOST_CAST_ATTRS = {"asarray", "array"}          # on np/numpy
_HOST_CAST_METHODS = {"item", "tolist", "cpu", "numpy"}
# methods that move or convert a tensor: dispatch whatever the receiver
_DISPATCH_METHODS = {"to", "cuda", "cpu"}
# bare attribute names too generic for unique-definition resolution —
# they are stdlib/dict/file vocabulary, so `obj.get(...)` must never
# resolve to some lone project function that happens to share the name
_AMBIGUOUS_ATTRS = {
    "run", "get", "put", "eval", "check", "close", "open", "append",
    "add", "update", "pop", "read", "write", "count", "wait", "cancel",
    "copy", "join", "start", "stop", "send", "recv", "result", "clear",
    "sort", "extend", "remove", "acquire", "release", "sleep", "next",
    "items", "values", "keys", "setdefault", "submit", "format",
}
_LOCK_FACTORIES = {"Lock", "RLock", "Condition", "Semaphore",
                   "BoundedSemaphore"}


def _walk_no_nested(root: ast.AST):
    """Child walk that stops at nested function/lambda boundaries (each
    nested def is summarized as its own function)."""
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


def _attr_base(expr: ast.AST) -> str | None:
    """``torch.cuda.is_available`` → ``torch``; ``x.item`` → ``x``."""
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _param_names(args: ast.arguments) -> list:
    names = [a.arg for a in list(args.posonlyargs) + list(args.args)]
    if names and names[0] in ("self", "cls"):
        names = names[1:]
    return names


def _torch_chain(fn: ast.AST) -> list | None:
    """``torch.cuda.is_available`` → ``["cuda", "is_available"]``; None
    outside the torch namespace."""
    chain = []
    while isinstance(fn, ast.Attribute):
        chain.append(fn.attr)
        fn = fn.value
    if isinstance(fn, ast.Name) and fn.id == "torch" and chain:
        return chain[::-1]
    return None


def _is_cpu(expr: ast.AST) -> bool:
    """``"cpu"`` (``"cpu:0"``) or ``torch.device("cpu")``."""
    if isinstance(expr, ast.Constant):
        return isinstance(expr.value, str) \
            and expr.value.split(":")[0] == "cpu"
    if isinstance(expr, ast.Call) and _torch_chain(expr.func) == ["device"]:
        return bool(expr.args) and _is_cpu(expr.args[0])
    return False


def _is_dtype(expr: ast.AST) -> bool:
    """``torch.int64``, ``x.dtype`` or a name that says it holds one."""
    if isinstance(expr, ast.Attribute):
        return expr.attr == "dtype" or (
            isinstance(expr.value, ast.Name) and expr.value.id == "torch")
    return isinstance(expr, ast.Name) and "dtype" in expr.id


def _host_placed(call: ast.Call) -> bool:
    """A factory call that allocates on the host: page-locked, or with
    a CPU ``device=``, or with none and no ``**kw`` (which may carry
    one)."""
    for kw in call.keywords:
        if kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    for kw in call.keywords:
        if kw.arg == "device":
            return _is_cpu(kw.value)
    return all(kw.arg is not None for kw in call.keywords)


def torch_call_kind(call: ast.Call) -> str | None:
    """How a ``torch.*`` call acts: ``"metadata"`` (reads host state; no
    tensor, no dispatch), ``"host"`` (dispatches, but its result stays
    on the host: torch.from_numpy, a host-placed factory, torch.cuda's
    events/streams/synchronize) or ``"device"`` (a tensor op whose
    result may live on the card). None outside the torch namespace."""
    chain = _torch_chain(call.func)
    if chain is None:
        return None
    name = chain[-1]
    if "_C" in chain or name in _TORCH_METADATA:
        return "metadata"
    if chain[0] == "cuda" or name == "from_numpy":
        return "host"
    if name in _TORCH_FACTORIES and _host_placed(call):
        return "host"
    return "device"


def to_kind(call: ast.Call) -> str | None:
    """A ``.to(...)`` call: ``"host"`` when it moves to the CPU,
    ``"dtype"`` when it only converts (the result stays where its
    receiver is), ``"device"`` when it moves to any other device. None
    for any other call."""
    fn = call.func
    if not (isinstance(fn, ast.Attribute) and fn.attr == "to"):
        return None
    target = next((kw.value for kw in call.keywords if kw.arg == "device"),
                  call.args[0] if call.args else None)
    if target is None or _is_dtype(target):
        return "dtype"
    return "host" if _is_cpu(target) else "device"


def _is_host_cast(expr: ast.AST) -> bool:
    """True when ``expr`` is structurally a device→host crossing whose
    RESULT lives on the host: np.asarray(...), float/int/bool/len(...),
    .item()/.tolist()/.cpu()/.numpy()/.to("cpu"), tensor metadata, and
    any subscript/astype chain on one of those."""
    if isinstance(expr, ast.Subscript):
        return _is_host_cast(expr.value)
    if isinstance(expr, ast.Attribute):
        return expr.attr in _TENSOR_META_ATTRS
    if not isinstance(expr, ast.Call):
        return False
    fn = expr.func
    if isinstance(fn, ast.Name):
        return fn.id in _HOST_CAST_NAMES
    if isinstance(fn, ast.Attribute):
        if fn.attr in _HOST_CAST_ATTRS \
                and _attr_base(fn) in ("np", "numpy"):
            return True
        if fn.attr in _HOST_CAST_METHODS or fn.attr in _TENSOR_META_METHODS:
            return True
        if to_kind(expr) == "host":
            return True
        if fn.attr == "astype":          # host.astype(...) stays host
            return _is_host_cast(fn.value)
    return False


class FuncInfo:
    """One function/method definition + its dataflow summary."""

    __slots__ = ("qualname", "relpath", "name", "node", "params",
                 "call_sites",
                 "returns_device", "dispatches_device", "does_rpc",
                 "reaches_device", "reaches_rpc", "tainted",
                 "deadline_params", "taint_stmts", "returns")

    def __init__(self, qualname: str, relpath: str, node):
        self.qualname = qualname
        self.relpath = relpath
        self.name = qualname.split(":", 1)[-1].rsplit(".", 1)[-1]
        self.node = node
        self.params: list = []
        self.call_sites: list = []       # [(ast.Call, FuncInfo | None)]
        self.returns_device = False
        self.dispatches_device = False
        self.does_rpc = False
        self.reaches_device = False
        self.reaches_rpc = False
        self.tainted: set = set()
        self.deadline_params: set = set()
        self.taint_stmts: list = []      # line-ordered assign/for/comp
        self.returns: list = []          # ast.Return nodes, own body only

    @property
    def accepts_deadline(self) -> bool:
        return bool(self.deadline_params)


class FileIndex:
    """Per-file slice of the project index."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.relpath = ctx.relpath
        self.tree = ctx.tree
        # dotted module name: cnosdb_tpu_torch/ops/kernels.py →
        # cnosdb_tpu_torch.ops.kernels; files outside the package keep their
        # stem so fixture pairs can import each other by basename
        rp = ctx.relpath
        stem = rp[:-3] if rp.endswith(".py") else rp
        parts = stem.replace("\\", "/").split("/")
        self.is_pkg = parts[-1] == "__init__"
        if self.is_pkg:
            parts = parts[:-1]
        if parts and parts[0] == "cnosdb_tpu_torch":
            self.module = ".".join(parts)
            self.pkg_parts = parts if self.is_pkg else parts[:-1]
        else:
            self.module = parts[-1] if parts else stem
            self.pkg_parts = []
        self.funcs: dict = {}            # dotted-in-file name → FuncInfo
        self.by_bare: dict = {}          # bare name → [FuncInfo]
        self.toplevel: dict = {}         # module-level name → FuncInfo
        self.import_modules: dict = {}   # alias → dotted module
        self.from_targets: dict = {}     # name → (dotted module, orig)
        self.lock_names: set = set()


class Project:
    """Whole-run call graph + summaries; the substrate project rules
    query. Construction: index every file, link imports, resolve call
    sites once, then drive the monotone summary flags to fixpoint."""

    def __init__(self, contexts, ignore_scope: bool = False):
        self.ignore_scope = ignore_scope
        self._resolved: dict = {}        # id(ast.Call) → FuncInfo | None
        self.files: dict = {}            # relpath → FileIndex
        self.modules: dict = {}          # dotted module → FileIndex
        self.by_bare: dict = {}          # bare name → [FuncInfo]
        self.functions: list = []        # every FuncInfo, stable order
        self.lock_names: set = set()
        self._kernel_calls: set = set()  # id(ast.Call) of library entries
        for ctx in contexts:
            fi = FileIndex(ctx)
            self.files[fi.relpath] = fi
            self.modules[fi.module] = fi
            self._index_file(fi)
        self._link_imports()
        # one body walk per function: call sites (resolved + memoized),
        # the taint-relevant statements, and the returns — the fixpoint
        # revisits functions but never re-walks their ASTs
        for info in self.functions:
            fi = self.files[info.relpath]
            for n in _walk_no_nested(info.node):
                if isinstance(n, ast.Call):
                    info.call_sites.append((n, self.resolve_call(n, fi)))
                elif isinstance(n, (ast.Assign, ast.AnnAssign,
                                    ast.AugAssign, ast.For,
                                    ast.comprehension)):
                    info.taint_stmts.append(n)
                elif isinstance(n, ast.Return):
                    info.returns.append(n)
            info.taint_stmts.sort(
                key=lambda n: getattr(n, "lineno",
                                      getattr(getattr(n, "iter", None),
                                              "lineno", 0)))
            self._mark_kernel_calls(info)
        self._fixpoint()

    # ------------------------------------------------------------ index
    def _index_file(self, fi: FileIndex) -> None:
        def add_func(node, prefix):
            qual = f"{prefix}{node.name}" if prefix else node.name
            info = FuncInfo(f"{fi.relpath}:{qual}", fi.relpath, node)
            info.params = _param_names(node.args)
            for a in (list(node.args.posonlyargs) + list(node.args.args)
                      + list(node.args.kwonlyargs)):
                ann = ""
                if a.annotation is not None:
                    try:
                        ann = ast.unparse(a.annotation)
                    except Exception:
                        ann = ""
                if a.arg == "deadline" or "Deadline" in ann:
                    info.deadline_params.add(a.arg)
            fi.funcs[qual] = info
            fi.by_bare.setdefault(node.name, []).append(info)
            self.by_bare.setdefault(node.name, []).append(info)
            if not prefix:
                fi.toplevel[node.name] = info
            self.functions.append(info)
            return info

        def visit(node, prefix):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    info = add_func(child, prefix)
                    visit(child, info.qualname.split(":", 1)[1] + ".")
                elif isinstance(child, ast.ClassDef):
                    visit(child, f"{prefix}{child.name}.")
                else:
                    visit(child, prefix)

        visit(fi.tree, "")

        for node in ast.walk(fi.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    name = alias.asname or alias.name
                    if alias.asname or "." not in alias.name:
                        fi.import_modules[name] = alias.name
            elif isinstance(node, ast.ImportFrom):
                base = self._import_base(fi, node)
                if base is None:
                    continue
                for alias in node.names:
                    fi.from_targets[alias.asname or alias.name] = \
                        (base, alias.name)
            elif isinstance(node, ast.Assign) \
                    and isinstance(node.value, ast.Call):
                call = node.value
                cname = call.func.attr \
                    if isinstance(call.func, ast.Attribute) else (
                        call.func.id if isinstance(call.func, ast.Name)
                        else None)
                if cname in _LOCK_FACTORIES:
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            fi.lock_names.add(t.id)
                        elif isinstance(t, ast.Attribute):
                            fi.lock_names.add(t.attr)
        self.lock_names |= fi.lock_names

    def _mark_kernel_calls(self, info: FuncInfo) -> None:
        """Calls into a hand-written kernel's ctypes library: ``lib.f()``
        and ``getattr(lib, name)()`` where ``lib = cuda_build.library(
        ...)``, and ``f()`` where ``f`` was bound from ``lib``'s
        attributes (``f = lib.a if ... else lib.b``)."""
        libs: set = set()
        aliases: set = set()
        for n in info.taint_stmts:
            if not isinstance(n, ast.Assign):
                continue
            v = n.value
            targets = {t.id for t in n.targets if isinstance(t, ast.Name)}
            if isinstance(v, ast.Call) and (
                    (isinstance(v.func, ast.Attribute)
                     and v.func.attr == "library"
                     and _attr_base(v.func) == "cuda_build")
                    or (isinstance(v.func, ast.Name)
                        and v.func.id == "library")):
                libs |= targets
            elif any(isinstance(x, ast.Attribute)
                     and isinstance(x.value, ast.Name)
                     and x.value.id in libs for x in ast.walk(v)):
                aliases |= targets
        if not libs:
            return
        for call, _callee in info.call_sites:
            fn = call.func
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id in libs) \
                    or (isinstance(fn, ast.Name) and fn.id in aliases) \
                    or (isinstance(fn, ast.Call)
                        and isinstance(fn.func, ast.Name)
                        and fn.func.id == "getattr" and fn.args
                        and isinstance(fn.args[0], ast.Name)
                        and fn.args[0].id in libs):
                self._kernel_calls.add(id(call))

    def _import_base(self, fi: FileIndex, node: ast.ImportFrom):
        if node.level == 0:
            return node.module
        base = fi.pkg_parts[:len(fi.pkg_parts) - (node.level - 1)] \
            if node.level - 1 <= len(fi.pkg_parts) else None
        if base is None:
            return None
        if node.module:
            base = base + node.module.split(".")
        return ".".join(base) if base else None

    def _link_imports(self) -> None:
        """Second pass once every module is known: a ``from pkg import
        name`` binds either a submodule or a function."""
        for fi in self.files.values():
            for name, (base, orig) in fi.from_targets.items():
                sub = f"{base}.{orig}" if base else orig
                if sub in self.modules:
                    fi.import_modules[name] = sub
                elif orig in self.modules and not base:
                    fi.import_modules[name] = orig

    # ------------------------------------------------------- resolution
    def resolve_call(self, call: ast.Call, fi: FileIndex):
        # nodes are owned by this Project for its whole lifetime, so
        # id() is a stable memo key; resolution is pure after indexing
        key = id(call)
        hit = self._resolved.get(key, _UNRESOLVED)
        if hit is not _UNRESOLVED:
            return hit
        out = self._resolve_call(call, fi)
        self._resolved[key] = out
        return out

    def _resolve_call(self, call: ast.Call, fi: FileIndex):
        fn = call.func
        if isinstance(fn, ast.Name):
            n = fn.id
            if n in fi.toplevel:
                return fi.toplevel[n]
            tgt = fi.from_targets.get(n)
            if tgt is not None:
                tfi = self.modules.get(tgt[0]) if tgt[0] else None
                if tfi is not None:
                    return tfi.toplevel.get(tgt[1])
            return None
        if isinstance(fn, ast.Attribute):
            a = fn.attr
            v = fn.value
            if isinstance(v, ast.Name):
                mod = fi.import_modules.get(v.id)
                if mod is not None:
                    tfi = self.modules.get(mod)
                    if tfi is not None:
                        return tfi.toplevel.get(a)
                    return None
                if v.id in ("self", "cls"):
                    cands = [x for x in fi.by_bare.get(a, ())
                             if x not in fi.toplevel.values()]
                    return cands[0] if len(cands) == 1 else None
            # last resort: a bare method name with exactly one
            # definition anywhere in the project, and not so common
            # that stdlib objects answer to it too
            if a in _AMBIGUOUS_ATTRS:
                return None
            cands = self.by_bare.get(a, ())
            return cands[0] if len(cands) == 1 else None
        return None

    # -------------------------------------------------------- summaries
    def _is_device_call(self, call: ast.Call, fi: FileIndex) -> bool:
        """Does the call dispatch work to the card (or could it)?"""
        kind = torch_call_kind(call)
        if kind is not None:
            return kind != "metadata"
        if id(call) in self._kernel_calls:
            return True
        fn = call.func
        if isinstance(fn, ast.Attribute):
            return fn.attr in _DISPATCH_METHODS \
                or fn.attr in _DEVICE_ENTRY_NAMES
        return isinstance(fn, ast.Name) and fn.id in _DEVICE_ENTRY_NAMES

    def _makes_device_value(self, call: ast.Call) -> bool | None:
        """True/False when the call's own shape says where its result
        lives; None when that depends on its receiver or callee."""
        kind = torch_call_kind(call)
        if kind is not None:
            return kind == "device"
        to = to_kind(call)
        if to is not None:
            return True if to == "device" else None
        fn = call.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (
            fn.id if isinstance(fn, ast.Name) else None)
        if name == "cuda" or name in _DEVICE_ENTRY_NAMES:
            return True
        return None

    def _expr_device(self, expr, tainted: set, fi: FileIndex) -> bool:
        """Does ``expr`` evaluate to a device value? Host casts and
        metadata cut the flow; device-ness enters via torch tensor ops,
        device moves, device-returning callees, or already-tainted
        names."""
        if expr is None or _is_host_cast(expr):
            return False
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, ast.Call):
            own = self._makes_device_value(expr)
            if own is not None:
                return own
            if isinstance(expr.func, ast.Name) \
                    and expr.func.id in _TRANSPARENT_CALLS:
                return any(self._expr_device(a, tainted, fi)
                           for a in expr.args)
            callee = self.resolve_call(expr, fi)
            if callee is not None and callee.returns_device:
                return True
            # unresolved/host callee: its RESULT is not assumed device
            # (host helpers over device args are the common case), but
            # a device receiver keeps method-call results device:
            # dev.sum() / dev.reshape(...) / dev.to(torch.int64) stay
            # on the card
            if isinstance(expr.func, ast.Attribute) \
                    and self._expr_device(expr.func.value, tainted, fi):
                return True
            return False
        if isinstance(expr, (ast.JoinedStr, ast.Constant)):
            return False
        return any(self._expr_device(c, tainted, fi)
                   for c in ast.iter_child_nodes(expr))

    def taint_env(self, info: FuncInfo) -> set:
        """Device-tainted local names of ``info`` given current callee
        summaries. Two line-ordered passes approximate the intra-
        function fixpoint (real code assigns before use)."""
        fi = self.files[info.relpath]
        tainted: set = set()
        stmts = info.taint_stmts
        for _ in range(2):
            for n in stmts:
                if isinstance(n, (ast.Assign, ast.AnnAssign,
                                  ast.AugAssign)):
                    value = n.value
                    if value is None:
                        continue
                    targets = n.targets if isinstance(n, ast.Assign) \
                        else [n.target]
                    tnames = set()
                    for t in targets:
                        tnames |= _names_in(t) \
                            if not isinstance(t, (ast.Attribute,
                                                  ast.Subscript)) \
                            else set()
                    if _is_host_cast(value):
                        tainted -= tnames
                    elif self._expr_device(value, tainted, fi):
                        tainted |= tnames
                elif isinstance(n, ast.For):
                    if self._expr_device(n.iter, tainted, fi):
                        tainted |= _names_in(n.target)
                elif isinstance(n, ast.comprehension):
                    if not self._expr_device(n.iter, tainted, fi):
                        continue
                    # `.items()` of a tainted dict: keys stay host
                    it = n.iter
                    if isinstance(it, ast.Call) \
                            and isinstance(it.func, ast.Attribute) \
                            and it.func.attr == "items" \
                            and isinstance(n.target, ast.Tuple) \
                            and len(n.target.elts) == 2:
                        tainted |= _names_in(n.target.elts[1])
                    elif isinstance(it, ast.Call) \
                            and isinstance(it.func, ast.Attribute) \
                            and it.func.attr == "keys":
                        pass
                    else:
                        tainted |= _names_in(n.target)
        return tainted

    def _fixpoint(self) -> None:
        """Worklist pass: seed each function's direct facts, then
        re-summarize a function only when one of its callees' monotone
        flags changed. Termination: three booleans per function, each
        flips at most once, and a flip enqueues only the callers."""
        callers: dict = {}               # FuncInfo → [caller FuncInfo]
        for info in self.functions:
            fi = self.files[info.relpath]
            for call, callee in info.call_sites:
                if self._is_device_call(call, fi):
                    info.dispatches_device = True
                fname = call.func.id \
                    if isinstance(call.func, ast.Name) else (
                        call.func.attr
                        if isinstance(call.func, ast.Attribute)
                        else None)
                if fname == "rpc_call":
                    info.does_rpc = True
                if callee is not None:
                    callers.setdefault(callee, []).append(info)
            info.reaches_device = info.dispatches_device
            info.reaches_rpc = info.does_rpc
        pending = collections.deque(self.functions)
        queued = {id(i) for i in pending}
        while pending:
            info = pending.popleft()
            queued.discard(id(info))
            rd, rr = info.reaches_device, info.reaches_rpc
            for _call, callee in info.call_sites:
                if callee is None:
                    continue
                rd = rd or callee.reaches_device
                rr = rr or callee.reaches_rpc
            tainted = self.taint_env(info)
            ret_dev = info.returns_device
            if not ret_dev:
                fi = self.files[info.relpath]
                for n in info.returns:
                    if self._expr_device(n.value, tainted, fi):
                        ret_dev = True
                        break
            info.tainted = tainted
            if (rd, rr, ret_dev) != (info.reaches_device,
                                     info.reaches_rpc,
                                     info.returns_device):
                info.reaches_device = rd
                info.reaches_rpc = rr
                info.returns_device = ret_dev
                for caller in callers.get(info, ()):
                    if id(caller) not in queued:
                        queued.add(id(caller))
                        pending.append(caller)

    # -------------------------------------------------------- reporting
    def report(self, rule, relpath: str, node, message: str) -> None:
        ctx = self.files[relpath].ctx
        if not (self.ignore_scope or rule.applies_to(relpath)):
            return
        ctx.report(rule, node, message)

    def render_callgraph(self) -> str:
        lines = []
        for info in sorted(self.functions, key=lambda i: i.qualname):
            tags = [t for t, on in (
                ("returns-device", info.returns_device),
                ("dispatches", info.reaches_device),
                ("rpc", info.reaches_rpc),
                ("deadline", info.accepts_deadline)) if on]
            callees = sorted({c.qualname for _x, c in info.call_sites
                              if c is not None})
            lines.append(f"{info.qualname} [{','.join(tags)}]"
                         + (f" -> {', '.join(callees)}" if callees else ""))
        return "\n".join(lines)


# ==========================================================================
# the device-plane rule family
# ==========================================================================

_HOT_PATHS = ("cnosdb_tpu_torch/ops/",)
# the mesh lane's collective merge: in the JAX package a jitted program
# (the tracer guarded it), here eager torch whose pulls only this rule
# sees
_HOT_FILES = ("cnosdb_tpu_torch/storage/scan.py",
              "cnosdb_tpu_torch/sql/executor.py",
              "cnosdb_tpu_torch/parallel/distributed_agg.py")


class HostSync(ProjectRule):
    """Device→host pulls on values that flow (possibly through several
    call edges) from torch ops, inside the scan/exec/kernel hot paths,
    and the explicit syncs there: ``.cpu()``/``.to("cpu")`` on any
    receiver, and ``.synchronize()`` on a stream, an event or the
    card."""

    name = "host-sync"
    motivation = ("PR 9/10 device planes: a stray np.asarray/.item() on "
                  "a device array stalls the device pipeline mid-query — "
                  "the transfer is silent, correct, and 10-100x the cost "
                  "of the op it interrupts; every crossing must be one "
                  "of the audited single-transfer points")

    def applies_to(self, relpath):
        return relpath.startswith(_HOT_PATHS) or relpath in _HOT_FILES

    def check(self, project: Project) -> None:
        for info in project.functions:
            if not (project.ignore_scope
                    or self.applies_to(info.relpath)):
                continue
            fi = project.files[info.relpath]
            tainted = info.tainted
            seen: set = set()

            def flag(node, what, on=" on a device value"):
                if node.lineno in seen:
                    return
                seen.add(node.lineno)
                project.report(self, info.relpath, node,
                               f"{what}{on} inside {info.name} — a "
                               f"silent device->host sync in a hot "
                               f"path; keep it on device or route it "
                               f"through an audited transfer point")

            for node in _walk_no_nested(info.node):
                if isinstance(node, ast.Call):
                    fn = node.func
                    attr = fn.attr if isinstance(fn, ast.Attribute) \
                        else None
                    if attr in _HOST_CAST_ATTRS \
                            and _attr_base(fn) in ("np", "numpy") \
                            and node.args \
                            and project._expr_device(node.args[0],
                                                     tainted, fi):
                        flag(node, f"np.{attr}()")
                    elif isinstance(fn, ast.Name) \
                            and fn.id in ("float", "int", "bool") \
                            and node.args \
                            and project._expr_device(node.args[0],
                                                     tainted, fi):
                        flag(node, f"{fn.id}()")
                    elif attr in ("item", "tolist", "numpy") \
                            and not node.args \
                            and project._expr_device(fn.value,
                                                     tainted, fi):
                        flag(node, f".{attr}()")
                    elif attr in ("cpu", "synchronize") and not node.args:
                        flag(node, f".{attr}()", on="")
                    elif to_kind(node) == "host":
                        flag(node, '.to("cpu")', on="")
                elif isinstance(node, ast.For):
                    if isinstance(node.iter, ast.Name) \
                            and node.iter.id in tainted:
                        flag(node, "python iteration")


class LockHeldDispatch(ProjectRule):
    """Any path that reaches device dispatch or an RPC while a named
    lock is held — the static complement to utils/lockwatch's runtime
    watchdog, catching the transitive cases lock-blocking (direct calls
    only) cannot see."""

    name = "lock-held-dispatch"
    motivation = ("lockwatch (PR 6) fires at runtime when a dispatch "
                  "already stalled everyone queued on the mutex; this "
                  "catches the same bug in review — a callee that "
                  "reaches a torch op or rpc_call two edges down "
                  "serializes the node just as hard as an inline one")

    def check(self, project: Project) -> None:
        for info in project.functions:
            if not (project.ignore_scope
                    or self.applies_to(info.relpath)):
                continue
            fi = project.files[info.relpath]
            for node in _walk_no_nested(info.node):
                if not isinstance(node, ast.With):
                    continue
                held = []
                for it in node.items:
                    ce = it.context_expr
                    base = ce.func if isinstance(ce, ast.Call) else ce
                    nm = base.attr if isinstance(base, ast.Attribute) \
                        else (base.id if isinstance(base, ast.Name)
                              else None)
                    if nm is not None and nm in project.lock_names:
                        held.append(nm)
                if not held:
                    continue
                seen: set = set()
                for stmt in node.body:
                    for inner in [stmt, *_walk_no_nested(stmt)]:
                        if not isinstance(inner, ast.Call) \
                                or inner.lineno in seen:
                            continue
                        fname = inner.func.id \
                            if isinstance(inner.func, ast.Name) else (
                                inner.func.attr
                                if isinstance(inner.func, ast.Attribute)
                                else None)
                        if fname == "rpc_call":
                            continue   # lock-blocking owns direct RPCs
                        if project._is_device_call(inner, fi):
                            seen.add(inner.lineno)
                            project.report(
                                self, info.relpath, inner,
                                f"device dispatch while holding "
                                f"{'/'.join(held)} — one slow launch/"
                                f"transfer stalls every thread queued "
                                f"on the lock; snapshot state, drop "
                                f"the lock, then dispatch")
                            continue
                        callee = project.resolve_call(inner, fi)
                        if callee is None:
                            continue
                        if callee.reaches_device or callee.reaches_rpc:
                            what = "device dispatch" \
                                if callee.reaches_device else "an RPC"
                            seen.add(inner.lineno)
                            project.report(
                                self, info.relpath, inner,
                                f"call to {callee.name}() which reaches "
                                f"{what} while holding "
                                f"{'/'.join(held)} — move the call "
                                f"outside the lock")


class DeadlinePropagation(ProjectRule):
    """A function that accepts a Deadline must thread it into every
    deadline-accepting callee that transitively reaches an RPC —
    dropping it silently re-widens that hop to the 10 s default."""

    name = "deadline-propagation"
    motivation = ("PR 4 deadline plane: the budget shrinks hop by hop "
                  "ONLY if every layer passes it on; one dropped edge "
                  "and a nearly-expired query still burns the full "
                  "default timeout on its next RPC")

    def check(self, project: Project) -> None:
        for info in project.functions:
            if not info.accepts_deadline:
                continue
            if not (project.ignore_scope
                    or self.applies_to(info.relpath)):
                continue
            dl_names = info.deadline_params
            for call, callee in info.call_sites:
                if callee is None or not callee.accepts_deadline \
                        or not callee.reaches_rpc:
                    continue
                passed = any(kw.arg in callee.deadline_params
                             for kw in call.keywords if kw.arg)
                if not passed:
                    passed = any(
                        _names_in(a) & dl_names
                        for a in list(call.args)
                        + [kw.value for kw in call.keywords])
                if not passed:
                    project.report(
                        self, info.relpath, call,
                        f"{info.name} holds a Deadline but calls "
                        f"{callee.name}() — which reaches an RPC — "
                        f"without threading it; the hop falls back to "
                        f"the default timeout and the budget stops "
                        f"shrinking")


def rule_sites(rule, paths=None) -> tuple[list, dict]:
    """Run one rule (per-file or project) over ``paths`` (default: the
    whole package) → (its findings, {relpath: lines where an inline
    disable absorbed one of its findings}): which lines the rule
    reports, and which it sees suppressed. chip_smoke.py holds the
    card's own sync reports against these."""
    import tokenize

    from . import ModuleContext, iter_py_files, norm_relpath

    findings: list = []
    contexts = []
    for path in iter_py_files(paths):
        with tokenize.open(path) as f:
            source = f.read()
        contexts.append(ModuleContext(path, norm_relpath(path), source,
                                      ast.parse(source, filename=path),
                                      findings))
    if isinstance(rule, ProjectRule):
        rule.check(Project(contexts))
    else:
        for ctx in contexts:
            if not rule.applies_to(ctx.relpath):
                continue
            rule.begin_module(ctx)
            if rule.node_types:
                for node in ast.walk(ctx.tree):
                    if isinstance(node, rule.node_types):
                        rule.visit(node, ctx)
    return findings, {c.relpath: set(c.suppressed_lines) for c in contexts
                      if c.suppressed_lines}


def project_rules() -> list:
    # no recompile-hazard: it guarded jax.jit retraces, and nothing in
    # the port compiles a program (no torch.compile, no torch.jit)
    return [HostSync(), LockHeldDispatch(), DeadlinePropagation()]
