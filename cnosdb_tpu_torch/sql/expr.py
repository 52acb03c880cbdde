"""Expression IR.

The SQL layer plans WHERE/SELECT expressions into this tree; it evaluates
under EITHER numpy (host pre-filtering, string columns) or jax.numpy
(device filtering inside the fused scan kernel) via the `xp` module
parameter — one IR, two execution targets, no translation layer. Mirrors
the role of DataFusion's PhysicalExpr in the reference's scan filter
(tskv/src/reader/filter.rs) and domain extraction
(common/models/src/predicate/domain.rs push_down_filter).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from ..errors import PlanError
from ..models.predicate import (
    AllDomain, ColumnDomains, LikeDomain, NoneDomain, RangeDomain, SetDomain,
)
from ..models.strcol import DictArray


class Expr:
    def eval(self, env: dict, xp) -> Any:
        raise NotImplementedError

    def columns(self) -> set[str]:
        return set()

    def __repr__(self):
        return self.to_sql()

    def to_sql(self) -> str:
        raise NotImplementedError


@dataclass(repr=False)
class Column(Expr):
    name: str

    def eval(self, env, xp):
        if self.name not in env:
            # struct field access: `col.field` over a composite-valued
            # column (gauge/state/window dicts — reference struct columns
            # support dotted access, e.g. state.state_duration,
            # window.start)
            if "." in self.name:
                base, _, fld = self.name.rpartition(".")
                if base in env:
                    vals = env[base]
                    rows = vals if isinstance(vals, np.ndarray) \
                        and vals.dtype == object else None
                    if rows is not None and any(
                            isinstance(r, dict) for r in rows):
                        out = np.empty(len(rows), dtype=object)
                        for i, r in enumerate(rows):
                            out[i] = r.get(fld) if isinstance(r, dict) \
                                else None
                        return out
                    if isinstance(vals, dict):
                        return vals.get(fld)
            raise PlanError(f"unknown column {self.name!r}")
        return env[self.name]

    def columns(self):
        return {self.name}

    def to_sql(self):
        return self.name


@dataclass(repr=False)
class Literal(Expr):
    value: Any

    def eval(self, env, xp):
        return self.value

    def to_sql(self):
        if isinstance(self.value, str):
            return "'" + self.value.replace("'", "''") + "'"
        if self.value is None:
            return "NULL"
        if isinstance(self.value, bool):
            return "TRUE" if self.value else "FALSE"
        return str(self.value)


_BIN_OPS = {
    "+": lambda xp, a, b: a + b,
    "-": lambda xp, a, b: a - b,
    "*": lambda xp, a, b: a * b,
    "/": lambda xp, a, b: _div(xp, a, b),
    # SQL % is the REMAINDER (sign of the dividend, like DataFusion/C),
    # not python/numpy floor-mod: -7 % 3 = -1
    "%": lambda xp, a, b: xp.fmod(a, b),
    "=": lambda xp, a, b: _eq(xp, a, b),
    "!=": lambda xp, a, b: _ne(xp, a, b),
    "<": lambda xp, a, b: a < b,
    "<=": lambda xp, a, b: a <= b,
    ">": lambda xp, a, b: a > b,
    ">=": lambda xp, a, b: a >= b,
    "and": lambda xp, a, b: a & b,
    "or": lambda xp, a, b: a | b,
    # bitwise XOR over integers (DataFusion's ^)
    "^": lambda xp, a, b: _bit_xor(xp, a, b),
}


def _bit_xor(xp, a, b):
    def as_int(x):
        if isinstance(x, np.ndarray):
            if x.dtype.kind not in "iu":
                raise PlanError("^ takes integer operands")
            return x.astype(np.int64)
        if isinstance(x, (bool, np.bool_)) \
                or not isinstance(x, (int, np.integer)):
            raise PlanError("^ takes integer operands")
        return int(x)
    return as_int(a) ^ as_int(b)


def _math_float(xp, v):
    """Numeric math-function results promote to Float64 (DataFusion
    semantics the reference inherits); NULL-bearing object arrays map
    elementwise, NULLs preserved."""
    if isinstance(v, np.ndarray):
        if v.dtype == object:
            o = np.empty(len(v), dtype=object)
            o[:] = [None if x is None else float(x) for x in v]
            return o
        if v.dtype.kind in "iub":
            return v.astype(np.float64)
        return v
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return float(v)
    return v


_LIBM_FNS = None


def _libm_f32(name):
    """glibc float math via ctypes: the reference's Float32 math path
    (DataFusion coerces Int64→Float32 for log/atan2, computed with
    Rust/libm log10f/atan2f whose results differ from numpy's by an
    ulp — math_function/log.slt pins 0.30102998, glibc's log10f(2))."""
    global _LIBM_FNS
    if _LIBM_FNS is None:
        import ctypes

        lib = ctypes.CDLL("libm.so.6")
        _LIBM_FNS = {}
        for n, arity in (("log10f", 1), ("atan2f", 2), ("logf", 1)):
            fn = getattr(lib, n)
            fn.restype = ctypes.c_float
            fn.argtypes = [ctypes.c_float] * arity
            _LIBM_FNS[n] = fn
    return _LIBM_FNS[name]


def _all_int(*vs):
    for v in vs:
        if isinstance(v, np.ndarray):
            if v.dtype.kind not in "iub":
                return False
        elif isinstance(v, bool) or not isinstance(v, (int, np.integer)):
            return False
    return True


def _f32_lift(cname, *vs):
    """Elementwise glibc f32 evaluation; returns float32 array/scalar."""
    fn = _libm_f32(cname)
    if any(isinstance(v, np.ndarray) for v in vs):
        n = next(len(v) for v in vs if isinstance(v, np.ndarray))
        cols = [v if isinstance(v, np.ndarray) else [v] * n for v in vs]
        return np.array([fn(*(float(x) for x in row))
                         for row in zip(*cols)], dtype=np.float32)
    return np.float32(fn(*(float(v) for v in vs)))


def _f32_log10(xp, a):
    """DataFusion's Float32 log10: ln(x)/ln(10) evaluated in f32 —
    one ulp below glibc's log10f at 2.0 (log.slt pins 0.30102998)."""
    a32 = (a.astype(np.float32) if isinstance(a, np.ndarray)
           else np.float32(a))
    with np.errstate(divide="ignore", invalid="ignore"):
        return (xp.log(a32) / xp.log(np.float32(10.0))).astype(np.float32)


def _rust_atanh(xp, a):
    """Rust std's atanh: 0.5 * ln_1p(2x/(1-x)) — bit-different from
    numpy's arctanh (math_function/atanh.slt pins the last ulp)."""
    a = _math_float(xp, a)
    if isinstance(a, np.ndarray) and a.dtype == object:
        o = np.empty(len(a), dtype=object)
        o[:] = [None if x is None else _rust_atanh(xp, x) for x in a]
        return o
    if not isinstance(a, np.ndarray):
        a = np.float64(a)
    with np.errstate(divide="ignore", invalid="ignore"):
        return 0.5 * xp.log1p(2.0 * a / (1.0 - a))


def _div(xp, a, b):
    # SQL division: integer/integer stays integral in CnosDB? DataFusion
    # yields float for `/` on floats, TRUNC-div on ints (toward zero —
    # numpy's // floors, so -7/2 would wrongly give -4). Follow DataFusion.
    a_int = _is_int(a) and _is_int(b)
    if a_int:
        safe_b = xp.where(b == 0, 1, b)
        qf = a // safe_b
        rem = a - qf * safe_b
        q = qf + ((rem != 0) & ((a < 0) != (b < 0)))
        zero = b == 0
        if xp is np and bool(np.any(zero)):
            # integer x/0 is NULL (arrow divide_opt — sqlancer pins the
            # 0/0 row surviving through IS NULL)
            if np.isscalar(q) or getattr(q, "shape", None) == ():
                return None
            out = np.asarray(q).astype(object)
            out[np.asarray(zero)] = None
            return out
        if xp is not np:
            # a device filter's x/0 is NULL too: not valid there (None
            # for two constants, as above)
            if zero is True and getattr(q, "shape", None) == ():
                return None
            return xp.null_where(zero, q)
        return xp.where(b != 0, q, 0)
    # IEEE semantics for scalar constants too (1.0/0 → inf, 0.0/0 →
    # nan — same as the column path), on either branch, and no warning
    # spam in logs
    with np.errstate(divide="ignore", invalid="ignore"):
        if np.isscalar(a) and np.isscalar(b):
            return float(np.float64(a) / np.float64(b))
        return a / b


def _is_int(v):
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return True
    dt = getattr(v, "dtype", None)
    return dt is not None and np.issubdtype(dt, np.integer)


def _eq(xp, a, b):
    return a == b


def _ne(xp, a, b):
    # two Python scalars compare to a Python bool, whose `~` is an int
    # (-2 for True) that a filter takes as true
    eq = _eq(xp, a, b)
    return (not eq) if isinstance(eq, bool) else ~eq


def _none_mask(v):
    """Where an object array holds None (an integer x/0, a NULL-bearing
    column), else False."""
    if _is_obj_arr(v):
        return np.array([x is None for x in v], dtype=bool)
    return False


def _cmp_truths(op: str, env, xp, ea, a, eb, b):
    """The comparison `a op b` of the values of expressions `ea`, `eb`
    → (where it is true, where it is false) under three-valued logic:
    neither where an operand is NULL (a NULL constant, an object array's
    None, an integer x/0 on the device, a NULL slot of a column either
    side reads). A NaN compares false, so it is false, as `~` of the
    comparison took it."""
    if a is None or b is None:
        return False, False
    f = _BIN_OPS[op]
    if xp is not np:
        return xp.truths(f(xp, a, b), env, ea.columns() | eb.columns())
    if _is_obj_arr(a) or _is_obj_arr(b) or isinstance(a, DictArray) \
            or isinstance(b, DictArray):
        r = _obj_binop(op, f, xp, a, b)
        known = np.logical_not(_none_mask(a) | _none_mask(b))
    else:
        r = f(xp, a, b)
        known = True
    true = r & known
    false = ((not r) if isinstance(r, (bool, np.bool_)) else ~r) & known
    return (_mask_operand_validity(true, env, ea, eb),
            _mask_operand_validity(false, env, ea, eb))


def _is_obj_arr(v) -> bool:
    return isinstance(v, np.ndarray) and v.dtype == object


def _mask_operand_validity(out, env, *exprs):
    """3VL at the comparison LEAF: a predicate over a NULL operand is
    UNKNOWN → False as a filter. Masking here (instead of post-hoc over
    the whole filter) keeps disjunctions correct: in
    `a IS NULL OR b = 0`, a NULL-b row can still match through the left
    branch. Typed columns carry NULLs out-of-band as __valid__ masks."""
    if not isinstance(out, np.ndarray) or out.dtype != bool:
        return out
    masked = out
    for e in exprs:
        for c in e.columns():
            vm = env.get(f"__valid__:{c}")
            if vm is not None and len(vm) == len(out) and not vm.all():
                if masked is out:
                    masked = out.copy()
                masked &= vm
    return masked


def _obj_binop(op: str, f, xp, a, b):
    """NULL-propagating elementwise op when an operand is an OBJECT array
    (NULL-bearing int columns ride as objects to keep integer identity):
    arithmetic yields NULL where any operand is NULL; comparisons yield
    FALSE there (3VL as a filter)."""
    n = next((len(x) for x in (a, b)
              if isinstance(x, (np.ndarray, DictArray))), 1)

    def clean(v):
        if isinstance(v, DictArray):
            return v.materialize(), np.zeros(n, dtype=bool)
        if not _is_obj_arr(v):
            return v, np.zeros(n, dtype=bool)
        nulls = np.array([x is None for x in v], dtype=bool)
        vals = [0 if x is None else x for x in v]
        # int64 only when every value IS an integer — np.array(...,
        # dtype=int64) silently truncates floats (1.5 → 1)
        if all(isinstance(x, (int, np.integer))
               and not isinstance(x, (bool, np.bool_)) for x in vals):
            try:
                return np.array(vals, dtype=np.int64), nulls
            except (TypeError, ValueError, OverflowError):
                pass
        if all(isinstance(x, (int, float, np.integer, np.floating))
               and not isinstance(x, (bool, np.bool_)) for x in vals):
            try:
                return np.array(vals, dtype=np.float64), nulls
            except (TypeError, ValueError, OverflowError):
                pass
        # strings etc: operate on objects, with NULL slots filled so
        # elementwise comparisons don't hit None >= None TypeErrors
        # (the nulls mask zeroes those lanes afterwards). Numeric
        # STRINGS must stay strings — '12' < '5' lexicographically.
        if all(isinstance(x, str) for x, isn in zip(v, nulls)
               if not isn):
            filled = np.array(["" if x is None else x for x in v],
                              dtype=object)
            return filled, nulls
        return v, nulls

    aa, an = clean(a)
    bb, bn = clean(b)
    nulls = an | bn
    try:
        out = f(xp, aa, bb)
    except TypeError:
        if op not in ("=", "!=", "<", "<=", ">", ">="):
            raise
        # genuinely mixed object operands (fuzzer-built expressions):
        # compare same-type pairs row-wise; cross-type pairs don't match
        def rows(x):
            if isinstance(x, np.ndarray):
                return list(x)
            return [x] * n

        ra, rb = rows(aa), rows(bb)
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            x, y = ra[i], rb[i]
            if x is None or y is None:
                continue
            try:
                out[i] = bool(f(xp, x, y))
            except TypeError:
                sx = x if isinstance(x, str) else _str_coerce(x)
                sy = y if isinstance(y, str) else _str_coerce(y)
                out[i] = bool(f(xp, sx, sy))
    if op in ("=", "!=", "<", "<=", ">", ">=", "and", "or"):
        out = np.asarray(out, dtype=bool)
        if nulls.any():
            out = out & ~nulls
        return out
    if nulls.any():
        out = np.asarray(out).astype(object)
        out[nulls] = None
    return out


@dataclass(repr=False)
class BinOp(Expr):
    op: str
    left: Expr
    right: Expr

    def eval(self, env, xp):
        f = _BIN_OPS.get(self.op)
        if f is None:
            raise PlanError(f"unknown operator {self.op!r}")
        if xp is np and self.op in ("=", "!=", "<", "<=", ">", ">=") \
                and "__unique_eval__" not in env:
            out = self._per_unique_cmp(env)
            if out is not None:
                return out
        a = self.left.eval(env, xp)
        b = self.right.eval(env, xp)
        if a is None or b is None:
            # SQL three-valued logic: NULL compares unknown (false as a
            # filter, e.g. an empty scalar subquery or an integer x/0 of
            # two constants, against any operand); NULL arithmetic is
            # NULL
            if self.op in ("=", "!=", "<", "<=", ">", ">="):
                other = b if a is None else a
                shape = getattr(other, "shape", None)
                if shape:
                    return xp.zeros(shape, dtype=bool)
                return False
            return None
        if xp is np and (_is_obj_arr(a) or _is_obj_arr(b)):
            return _obj_binop(self.op, f, xp, a, b)
        if self.op in ("=", "!=", "<", "<=", ">", ">=") and xp is np:
            # timestamp-column vs date/timestamp-string comparison:
            # coerce the literal to i64 ns (DataFusion's implicit
            # Utf8→Timestamp coercion; tpch.slt compares CSV-inferred
            # timestamp columns against DATE literals)
            a, b = _coerce_ts_cmp(a, b)
        if self.op in ("+", "-", "*", "/", "%"):
            # arithmetic over BOOLEAN is a type error (DataFusion:
            # 'SELECT 3 + TRUE' cannot coerce — example/world.slt)
            for side in (a, b):
                if isinstance(side, (bool, np.bool_)) or (
                        isinstance(side, np.ndarray)
                        and side.dtype == bool):
                    raise PlanError(
                        f"cannot apply {self.op!r} to a BOOLEAN operand")
        if self.op in ("+", "-"):
            iv = b if _is_interval(b) else (a if _is_interval(a) else None)
            if iv is not None and not (_is_interval(a) and _is_interval(b)):
                other = a if iv is b else b
                if not (iv is a and self.op == "-"):   # interval - ts: no
                    return _ts_interval_arith(other, iv, self.op)
        out = f(xp, a, b)
        if xp is np and self.op in ("=", "!=", "<", "<=", ">", ">="):
            out = _mask_operand_validity(out, env, self.left, self.right)
        return out

    def _per_unique_cmp(self, env):
        """substr-equality lane (ops/strkernels): a comparison whose only
        column is a DictArray reached through pure string funcs evaluates
        once per UNIQUE — the same tree runs against a one-row-per-unique
        surrogate env (host semantics by construction, `__unique_eval__`
        stops recursion) and the bool mask gathers through the codes.
        Returns None for any shape outside the lane (caller books nothing:
        the row path itself is not a string-plane fallback for e.g.
        numeric cmps)."""
        if not (isinstance(self.left, Func) or isinstance(self.right, Func)):
            return None   # bare col-vs-literal is already per-unique
        if not (_unique_safe(self.left) and _unique_safe(self.right)):
            return None
        cols = self.columns()
        if len(cols) != 1:
            return None
        (cname,) = cols
        try:
            da = env.get(cname)
        except AttributeError:
            return None
        if not isinstance(da, DictArray) or not len(da.values):
            return None
        from ..ops import strkernels

        if not strkernels.enabled():
            strkernels.note_path("host_fallback", "lane_disabled")
            return None
        senv = {cname: strkernels.unique_surrogate(da),
                "__unique_eval__": True}
        try:
            um = self.eval(senv, np)
        except Exception:
            return None
        if not (isinstance(um, np.ndarray) and um.dtype == bool
                and um.shape == (len(da.values),)):
            return None
        strkernels.note_path("per_unique", "cmp")
        out = strkernels.broadcast_codes(um, da.codes)
        return _mask_operand_validity(out, env, self.left, self.right)

    def columns(self):
        return self.left.columns() | self.right.columns()

    def to_sql(self):
        op = self.op.upper() if self.op in ("and", "or") else self.op
        return f"({self.left.to_sql()} {op} {self.right.to_sql()})"


_UNIQUE_SAFE_FUNCS = frozenset({
    # pure value→value string scalars: per-unique evaluation is exact
    "substr", "substring", "lower", "upper", "trim", "ltrim", "rtrim",
    "btrim", "reverse", "replace", "left", "right", "repeat", "length",
    "char_length", "character_length", "octet_length", "bit_length",
    "concat", "translate", "lpad", "rpad", "split_part", "strpos",
    "position", "starts_with", "ends_with", "initcap", "md5", "ascii",
    "chr", "to_hex",
})


def _unique_safe(e) -> bool:
    """True when `e` is a pure scalar tree (columns, literals, whitelisted
    string funcs) whose value depends only on the row's own value — the
    admission test for BinOp's per-unique surrogate lane."""
    if isinstance(e, Column):
        return True
    if isinstance(e, Literal):
        return not isinstance(e.value, Expr)
    if isinstance(e, Func):
        return (e.name.lower() in _UNIQUE_SAFE_FUNCS
                and e.agg_order is None
                and all(isinstance(a, Expr) and _unique_safe(a)
                        for a in e.args))
    return False


def _is_interval(v) -> bool:
    return hasattr(v, "ns") and hasattr(v, "months")


def _add_months_ns(ts_ns: int, months: int) -> int:
    """Calendar month addition on an ns timestamp (day clamps to the
    target month's end — arrow IntervalMonthDayNano semantics)."""
    import calendar
    from datetime import datetime, timezone

    secs, frac = divmod(int(ts_ns), 1_000_000_000)
    dt = datetime.fromtimestamp(secs, tz=timezone.utc)
    total = dt.year * 12 + (dt.month - 1) + months
    y, m = divmod(total, 12)
    day = min(dt.day, calendar.monthrange(y, m + 1)[1])
    out = dt.replace(year=y, month=m + 1, day=day)
    return int(out.timestamp()) * 1_000_000_000 + frac


def _ts_interval_arith(other, iv, op: str):
    """timestamp ± INTERVAL: calendar-true months plus the fixed ns
    remainder (tpch date '1993-07-01' + interval '3' month)."""
    sign = 1 if op == "+" else -1
    months = sign * iv.months
    ns = sign * (iv.sub_ns if iv.sub_ns is not None
                 and iv.months else iv.ns)

    def one(x):
        if x is None:
            return None
        if isinstance(x, str):
            from .parser import parse_timestamp_string

            x = parse_timestamp_string(x)
        x = int(x)
        if months:
            x = _add_months_ns(x, months)
        return x + ns

    if isinstance(other, np.ndarray):
        if other.dtype.kind in "iu" and not months:
            return other.astype(np.int64) + ns
        out = np.empty(len(other), dtype=object)
        for i, v in enumerate(other):
            out[i] = one(None if v is None else
                         (v.item() if hasattr(v, "item") else v))
        if all(o is not None for o in out):
            return out.astype(np.int64)
        return out
    return one(other.item() if hasattr(other, "item") else other)


def _coerce_ts_cmp(a, b):
    """If one side is an integer array and the other a date-looking
    string, parse the string to i64 ns (only strings containing '-' or
    ':' qualify — bare numeric strings keep erroring like DataFusion's
    Int64-vs-Utf8)."""
    def datey(s):
        return isinstance(s, str) and ("-" in s[1:] or ":" in s)

    def ints(x):
        return isinstance(x, np.ndarray) and x.dtype.kind in "iu"

    try:
        if ints(a) and datey(b):
            from .parser import parse_timestamp_string

            return a, int(parse_timestamp_string(b))
        if ints(b) and datey(a):
            from .parser import parse_timestamp_string

            return int(parse_timestamp_string(a)), b
    except Exception:
        pass
    return a, b


def _eval_false_mask(e, env, xp):
    """Definite-FALSE mask under 3VL, or None when not derivable.

    Filter evaluation produces definite-TRUE masks (comparison leaves are
    validity-masked). NOT needs the definite-FALSE mask of its operand —
    `NOT (i = 5 OR i < 0)` must exclude NULL-i rows (inner UNKNOWN →
    NOT UNKNOWN = UNKNOWN), which ~true_mask would wrongly include."""
    if isinstance(e, BinOp):
        if e.op == "and":
            fa = _eval_false_mask(e.left, env, xp)
            fb = _eval_false_mask(e.right, env, xp)
            return None if fa is None or fb is None else (fa | fb)
        if e.op == "or":
            fa = _eval_false_mask(e.left, env, xp)
            fb = _eval_false_mask(e.right, env, xp)
            return None if fa is None or fb is None else (fa & fb)
        neg = {"=": "!=", "!=": "=", "<": ">=", "<=": ">",
               ">": "<=", ">=": "<"}.get(e.op)
        if neg is not None:
            # the negated comparison, leaf-masked: exactly definite-false
            return np.asarray(BinOp(neg, e.left, e.right).eval(env, xp),
                              dtype=bool)
        return None
    if isinstance(e, UnaryOp) and e.op == "not":
        v = e.operand.eval(env, xp)   # definite-true of the operand
        return np.asarray(v, dtype=bool) if isinstance(v, np.ndarray) \
            else None
    if isinstance(e, IsNull):
        return np.asarray(IsNull(e.expr, not e.negated).eval(env, xp),
                          dtype=bool)
    if isinstance(e, Between):
        return np.asarray(
            Between(e.expr, e.low, e.high, not e.negated).eval(env, xp),
            dtype=bool)
    if isinstance(e, InList):
        return np.asarray(
            InList(e.expr, e.values, not e.negated,
                   e.null_present).eval(env, xp), dtype=bool)
    if isinstance(e, Like):
        return np.asarray(
            Like(e.expr, e.pattern, not e.negated).eval(env, xp),
            dtype=bool)
    if isinstance(e, Column):
        v = e.eval(env, xp)
        if not isinstance(v, np.ndarray):
            return None
        out = ~np.asarray(v, dtype=bool)
        return _mask_operand_validity(out, env, e)
    if isinstance(e, Literal):
        return None if e.value is None else (not bool(e.value))
    return None


@dataclass(repr=False)
class UnaryOp(Expr):
    op: str  # 'not' | '-'
    operand: Expr

    def eval(self, env, xp):
        if self.op == "not":
            if xp is np:
                fm = _eval_false_mask(self.operand, env, xp)
                if isinstance(fm, np.ndarray):
                    return fm
            v = self.operand.eval(env, xp)
            if v is None:
                return None   # NOT NULL is NULL
            if isinstance(v, (bool, np.bool_)):
                return not v   # ~True is -2 (bitwise), not False
            if isinstance(v, np.ndarray) and v.dtype == object:
                out = np.empty(len(v), dtype=object)
                out[:] = [None if x is None else (not bool(x)) for x in v]
                return out
            return ~v
        v = self.operand.eval(env, xp)
        if self.op == "-":
            if v is None:
                return None
            return -v
        raise PlanError(f"unknown unary {self.op!r}")

    def columns(self):
        return self.operand.columns()

    def to_sql(self):
        return f"({'NOT ' if self.op == 'not' else '-'}{self.operand.to_sql()})"


@dataclass(repr=False)
class InList(Expr):
    expr: Expr
    values: list
    negated: bool = False
    # a NULL among the comparison values (e.g. from an IN-subquery): per
    # SQL three-valued logic it can never satisfy IN, and it makes NOT IN
    # unknown (hence false as a filter) for EVERY row
    null_present: bool = False

    def eval(self, env, xp):
        v = self.expr.eval(env, xp)
        if self.negated and self.null_present:
            # a constant operand gives a constant (a one-row mask would
            # be broadcast to every row)
            shape = getattr(v, "shape", None)
            return xp.zeros(shape, dtype=bool) if shape else False
        if v is None:
            return False    # NULL [NOT] IN (...) is NULL
        m = self._isin_fast(v, xp)
        if m is None:
            for lit in self.values:
                c = _eq(xp, v, lit)
                m = c if m is None else (m | c)
        if m is None:
            m = xp.zeros(getattr(v, "shape", (1,)), dtype=bool)
        if self.negated:
            # python-bool scalars: `~True` is the INT -2, not False
            out = (not m) if isinstance(m, (bool, np.bool_)) else ~m
        else:
            out = m
        if xp is np:
            out = _mask_operand_validity(out, env, self.expr)
        return out

    def _isin_fast(self, v, xp):
        """np.isin for long homogeneous lists (decorrelated EXISTS can
        carry thousands of keys; one vectorized pass per VALUE would be
        O(list) column scans). None → per-literal fallback."""
        if xp is not np or len(self.values) < 9:
            return None
        if not isinstance(v, np.ndarray) or v.dtype == object:
            return None
        vals = self.values

        def plain_num(x):
            return isinstance(x, (int, float, np.integer, np.floating)) \
                and not isinstance(x, (bool, np.bool_))

        if np.issubdtype(v.dtype, np.integer):
            # int column vs float keys would compare through float64 and
            # alias above 2^53 — keep the exact per-literal path there
            if all(isinstance(x, (int, np.integer))
                   and not isinstance(x, (bool, np.bool_)) for x in vals):
                try:
                    return np.isin(v, np.asarray(vals, dtype=np.int64))
                except OverflowError:
                    return None
            return None
        if np.issubdtype(v.dtype, np.floating) and all(
                plain_num(x) for x in vals):
            return np.isin(v, np.asarray([float(x) for x in vals]))
        if v.dtype.kind == "U" and all(isinstance(x, str) for x in vals):
            return np.isin(v, np.asarray(vals))
        return None

    def columns(self):
        return self.expr.columns()

    def to_sql(self):
        vals = ", ".join(Literal(v).to_sql() for v in self.values)
        neg = " NOT" if self.negated else ""
        return f"({self.expr.to_sql()}{neg} IN ({vals}))"


@dataclass(repr=False)
class Between(Expr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def eval(self, env, xp):
        v = self.expr.eval(env, xp)
        lo = self.low.eval(env, xp)
        hi = self.high.eval(env, xp)
        if xp is np:
            v2, lo = _coerce_ts_cmp(v, lo)
            v2, hi = _coerce_ts_cmp(v, hi)
            v = v2
        # v >= lo AND v <= hi, each comparison true, false or NULL: a
        # NULL operand (an integer x/0, a NULL constant or column) makes
        # BETWEEN NULL unless the other comparison settles it, and NOT
        # BETWEEN is true only where one comparison is false
        ge, not_ge = _cmp_truths(">=", env, xp, self.expr, v, self.low, lo)
        le, not_le = _cmp_truths("<=", env, xp, self.expr, v, self.high, hi)
        if self.negated:
            return not_ge | not_le
        return ge & le

    def columns(self):
        return self.expr.columns() | self.low.columns() | self.high.columns()

    def to_sql(self):
        neg = " NOT" if self.negated else ""
        return f"({self.expr.to_sql()}{neg} BETWEEN {self.low.to_sql()} AND {self.high.to_sql()})"


@dataclass(repr=False)
class IsNull(Expr):
    expr: Expr
    negated: bool = False

    def eval(self, env, xp):
        # validity masks ride in env under '__valid__:<col>'
        cols = self.expr.columns()
        if len(cols) == 1 and isinstance(self.expr, Column):
            key = f"__valid__:{next(iter(cols))}"
            if key in env:
                valid = env[key]
                return valid if self.negated else ~valid
        v = self.expr.eval(env, xp)
        if v is None:   # NULL literal / NULL-valued scalar expression
            return np.array([not self.negated])
        dt = getattr(v, "dtype", None)
        if dt is not None and dt.kind == "f":
            m = xp.isnan(v)
        elif dt is not None and dt == object:
            # join-filled columns ride as object arrays with None holes
            m = np.array([x is None or (isinstance(x, float) and x != x)
                          for x in v], dtype=bool)
        else:
            m = xp.zeros(getattr(v, "shape", (1,)), dtype=bool)
        if not isinstance(self.expr, (Column, Literal)):
            # composite expression: a NULL in any null-propagating input
            # makes the result NULL (SQL 3VL — `(NOT (x = t0)) IS NULL`
            # is TRUE on NULL-t0 rows even though the bool eval says
            # False); NULL-defining nodes (CASE/IS NULL) are excluded by
            # propagating_columns
            for c in propagating_columns(self.expr):
                nm = _column_null_mask(c, env, xp)
                if nm is not None:
                    m = m | nm
        return ~m if self.negated else m

    def columns(self):
        return self.expr.columns()

    def to_sql(self):
        neg = " NOT" if self.negated else ""
        return f"({self.expr.to_sql()} IS{neg} NULL)"


@dataclass(repr=False)
class Like(Expr):
    """SQL LIKE with % and _ wildcards (host-evaluated; string columns
    never ride to the device anyway)."""

    expr: Expr
    pattern: str
    negated: bool = False

    def _regex(self):
        rx = getattr(self, "_rx", None)
        if rx is None:
            import re as _re

            out = []
            for ch in self.pattern:
                if ch == "%":
                    out.append(".*")
                elif ch == "_":
                    out.append(".")
                else:
                    out.append(_re.escape(ch))
            rx = _re.compile("^" + "".join(out) + "$", _re.DOTALL)
            object.__setattr__(self, "_rx", rx)
        return rx

    @staticmethod
    def _compile(pattern: str):
        import re as _re

        out = []
        for ch in pattern:
            if ch == "%":
                out.append(".*")
            elif ch == "_":
                out.append(".")
            else:
                out.append(_re.escape(ch))
        return _re.compile("^" + "".join(out) + "$", _re.DOTALL)

    def _eval_dynamic(self, env, xp):
        """Pattern is an EXPRESSION (sqlancer: x LIKE (cast(...)||t0)):
        evaluate both sides row-wise, compile per distinct pattern."""
        from ..ops import strkernels

        strkernels.note_path("host_fallback", "dynamic_pattern")
        v = self.expr.eval(env, xp)
        p = self.pattern.eval(env, xp)
        n = _env_rows(env)
        vr = _rows_of(v, n)
        pr = _rows_of(p, n)
        cache: dict = {}
        out = np.zeros(n, dtype=bool)
        nulls = np.zeros(n, dtype=bool)
        for i in range(n):
            val, pat = vr[i], pr[i]
            if val is None or pat is None:
                nulls[i] = True   # NULL operand: UNKNOWN either way
                continue
            rx = cache.get(pat)
            if rx is None:
                rx = cache[pat] = self._compile(str(pat))
            out[i] = bool(rx.match(str(val)))
        if self.negated:
            out = ~out & ~nulls
        if xp is np:
            out = _mask_operand_validity(out, env, self.expr)
        return out

    def eval(self, env, xp):
        if isinstance(self.pattern, Expr):
            return self._eval_dynamic(env, xp)
        from ..ops import strkernels

        v = self.expr.eval(env, xp)
        rx = self._regex()
        if isinstance(v, DictArray):
            if strkernels.enabled():
                # per-unique lane: classified vectorized mask over the
                # dictionary (or regex-per-unique), gathered through codes
                out = strkernels.like_rows(v, self.pattern, rx=rx,
                                           negated=self.negated)
            else:
                strkernels.note_path("host_fallback", "lane_disabled")
                out = v.map_values(
                    lambda x: bool(rx.match(x))
                    if isinstance(x, str) else False,
                    out_dtype=bool)
                out = ~out if self.negated else out
            if xp is np:
                out = _mask_operand_validity(out, env, self.expr)
            return out
        arr = np.asarray(v, dtype=object) if not np.isscalar(v) else None
        if arr is None:
            m = bool(rx.match(str(v)))
            return (not m) if self.negated else m
        strkernels.note_path("host_fallback", "unencoded_rows")
        out = np.fromiter(
            (bool(rx.match(x)) if isinstance(x, str) else False for x in arr),
            dtype=bool, count=len(arr))
        out = ~out if self.negated else out
        if xp is np:
            out = _mask_operand_validity(out, env, self.expr)
        return out

    def columns(self):
        out = set(self.expr.columns())
        if isinstance(self.pattern, Expr):
            out |= self.pattern.columns()
        return out

    def to_sql(self):
        neg = " NOT" if self.negated else ""
        pat = self.pattern.to_sql() if isinstance(self.pattern, Expr) \
            else Literal(self.pattern).to_sql()
        return f"({self.expr.to_sql()}{neg} LIKE {pat})"


@dataclass(repr=False)
class Func(Expr):
    """Scalar function call evaluated row-wise (abs, floor, ceil, sqrt...)."""

    name: str
    args: list
    # aggregate-call ordering: array_agg(x ORDER BY time DESC) — (col, asc)
    agg_order: tuple | None = None

    # math scalars return Float64 regardless of input type (reference via
    # DataFusion's math_expressions: abs(BIGINT) renders 1.0 — pinned by
    # function/common/math_function/abs.slt)
    _FUNCS = {
        "abs": lambda xp, a: _math_float(xp, xp.abs(a)),
        # numpy 2.3 keeps an integer input's dtype in floor, ceil and
        # trunc; the reference returns Float64 (math_function/ceil.slt)
        "floor": lambda xp, a: _math_float(xp, xp.floor(a)),
        "ceil": lambda xp, a: _math_float(xp, xp.ceil(a)),
        "round": lambda xp, a, *nd: _math_float(
            xp, xp.round(a, *[int(d) for d in nd])),
        "sqrt": lambda xp, a: xp.sqrt(a),
        "cbrt": lambda xp, a: xp.cbrt(a),
        "exp": lambda xp, a: xp.exp(a),
        "ln": lambda xp, a: xp.log(a),
        "log10": lambda xp, a: xp.log10(a),
        "log2": lambda xp, a: xp.log2(a),
        "sin": lambda xp, a: xp.sin(a),
        "cos": lambda xp, a: xp.cos(a),
        "tan": lambda xp, a: xp.tan(a),
        "sinh": lambda xp, a: xp.sinh(a),
        "cosh": lambda xp, a: xp.cosh(a),
        "tanh": lambda xp, a: xp.tanh(a),
        "asin": lambda xp, a: xp.arcsin(a),
        "acos": lambda xp, a: xp.arccos(a),
        "atan": lambda xp, a: xp.arctan(a),
        "asinh": lambda xp, a: xp.arcsinh(a),
        "acosh": lambda xp, a: xp.arccosh(_math_float(xp, a)),
        "atanh": _rust_atanh,
        "atan2": lambda xp, a, b: (_f32_lift("atan2f", a, b)
                                   if _all_int(a, b)
                                   else xp.arctan2(a, b)),
        "pow": lambda xp, a, b: xp.power(a, b),
        "power": lambda xp, a, b: xp.power(a, b),
        # reference signum(0) = 1.0 (math_function/signum.slt) — sign
        # of the IEEE positive zero, not the three-valued sign
        "signum": lambda xp, a: _math_float(
            xp, xp.where(xp.isnan(a), a,
                         xp.where(xp.asarray(a) >= 0, 1.0, -1.0))
            if hasattr(a, "__len__") or hasattr(a, "shape")
            else (float("nan") if a != a else (1.0 if a >= 0 else -1.0))),
        "trunc": lambda xp, a: _math_float(xp, xp.trunc(a)),
        "radians": lambda xp, a: xp.radians(a),
        "degrees": lambda xp, a: xp.degrees(a),
        "gcd": lambda xp, a, b: xp.gcd(_as_i64(xp, a), _as_i64(xp, b)),
        "lcm": lambda xp, a, b: xp.lcm(_as_i64(xp, a), _as_i64(xp, b)),
        "pi": lambda xp: xp.pi,
        # log(x) = log10 in the reference (DataFusion math_expressions);
        # log(base, x) is explicit-base
        "log": lambda xp, a, *b: (xp.log(b[0]) / xp.log(a)) if b
        else (_f32_log10(xp, a) if _all_int(a) else xp.log10(a)),
        "random": lambda xp: float(np.random.random()),
        "nullif": lambda xp, a, b: _fn_nullif(a, b),
        # analyzer-injected marker: timestamp - timestamp yields an
        # INTERVAL (arrow-rendered); wraps the subtraction's ns result
        "__to_interval": lambda xp, a: _to_interval(a),
        # scalar/constant form (SELECT time_window(cast(1 as timestamp),
        # interval '3 day')): the row-expanding form is rewritten by the
        # executor before evaluation (executor._expand_time_window)
        "time_window": lambda xp, t, window, *rest: _time_window_scalar(
            t, window, *rest),
    }

    def eval(self, env, xp):
        f = self._FUNCS.get(self.name.lower())
        if f is None:
            raise PlanError(f"unknown function {self.name!r}")
        try:
            return f(xp, *[a.eval(env, xp) for a in self.args])
        except TypeError as e:
            # wrong arity / argument kinds surface as plan errors
            # (current_date(1), current_time(current_time()), …)
            raise PlanError(
                f"no function matches the given argument types: {e}")

    def columns(self):
        out = set()
        for a in self.args:
            out |= a.columns()
        return out

    def to_sql(self):
        if self.name == "__to_interval" and self.args:
            # analyzer-injected rendering marker: invisible in output
            # column names and EXPLAIN
            return self.args[0].to_sql()
        return f"{self.name}({', '.join(a.to_sql() for a in self.args)})"


def trunc_mod(a: int, b: int) -> int:
    """Rust/C truncating remainder (sign of the dividend) in exact int
    arithmetic — np.fmod on python scalars would round through float64."""
    r = a % b
    if r and (a < 0) != (b < 0):
        r -= b
    return r


def _interval_arg_ns(v) -> int:
    """Interval-typed argument value → ns (IntervalValue literal or int)."""
    if hasattr(v, "ns"):
        return int(v.ns)
    if isinstance(v, (int, np.integer)) and not isinstance(v, bool):
        return int(v)
    raise PlanError("time_window durations must be INTERVAL values")


def _time_window_scalar(t, window, *rest):
    """Tumbling window containing t (reference TIME_WINDOW with the slide
    defaulted to the window width; origin = epoch or the 4th argument)."""
    if t is None:
        return None
    if hasattr(t, "item"):
        t = t.item()
    w = _interval_arg_ns(window)
    slide = _interval_arg_ns(rest[0]) if rest else w
    origin = 0
    if len(rest) > 1:
        origin = rest[1]
        if isinstance(origin, str):
            from .parser import parse_timestamp_string

            origin = parse_timestamp_string(origin)
    if w <= 0 or slide <= 0:
        raise PlanError("time_window durations must be positive")
    t = int(t)
    # st_mod uses the WINDOW duration (transform_time_window.rs:270-274)
    st_mod = trunc_mod(int(origin), w)
    start = t - trunc_mod(t - st_mod + slide, slide)
    return {"kind": "window", "start": start, "end": start + w}


def _regexp_replace(v, pat, rep, flags=""):
    """DataFusion regexp_replace (Rust regex \\1 backrefs match python
    re.sub's); 'g' flag = replace all, else first occurrence; i/m/s/x
    map to the matching regex modes, anything else is an error (never
    silently dropped)."""
    import re as _re

    if isinstance(pat, (np.ndarray, DictArray)) \
            or isinstance(rep, (np.ndarray, DictArray)):
        raise PlanError("regexp_replace pattern must be a constant")
    count = 1
    fl = 0
    for ch in str(flags):
        if ch == "g":
            count = 0
        elif ch == "i":
            fl |= _re.IGNORECASE
        elif ch == "m":
            fl |= _re.MULTILINE
        elif ch == "s":
            fl |= _re.DOTALL
        elif ch == "x":
            fl |= _re.VERBOSE
        else:
            raise PlanError(
                f"regexp_replace() does not support the \"{ch}\" flag")
    rx = _re.compile(str(pat), fl)

    def one(x):
        return None if x is None else rx.sub(str(rep), str(x),
                                             count=count)

    if isinstance(v, DictArray):
        return v.map_values(one)
    if isinstance(v, np.ndarray):
        out = np.empty(len(v), dtype=object)
        out[:] = [one(x) for x in v]
        return out
    return one(v)


def _fn_nullif(a, b):
    """NULLIF(a, b): NULL where a == b, else a."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray) \
            or isinstance(a, DictArray) or isinstance(b, DictArray):
        n = next(len(x) for x in (a, b)
                 if isinstance(x, (np.ndarray, DictArray)))
        ar = _rows_of(a, n)
        br = _rows_of(b, n)
        out = np.empty(n, dtype=object)
        for i in range(n):
            x, y = ar[i], br[i]
            eq = (x is not None and y is not None and x == y)
            out[i] = None if eq else x
        return out
    if a is None:
        return None
    return None if (b is not None and a == b) else a


def _fn_date_bin(iv, ts, origin):
    """DATE_BIN(interval, ts[, origin]) → bucket start ns (floor toward
    -inf relative to origin, DataFusion semantics)."""
    if not _is_interval(iv):
        raise PlanError("date_bin's first argument must be an INTERVAL")
    step = int(iv.ns)
    if step <= 0:
        raise PlanError("date_bin interval must be positive")
    if isinstance(origin, str):
        from .parser import parse_timestamp_string

        origin = parse_timestamp_string(origin)
    o = int(origin) if origin is not None else 0
    if isinstance(ts, np.ndarray):
        t = ts.astype(np.int64)
        return o + ((t - o) // step) * step
    if ts is None:
        return None
    t = int(ts.item() if hasattr(ts, "item") else ts)
    return o + ((t - o) // step) * step


def _to_interval(a):
    from .tsfuncs import IntervalNs

    if isinstance(a, np.ndarray):
        out = np.empty(len(a), dtype=object)
        for i, v in enumerate(a):
            out[i] = None if v is None else IntervalNs(int(v))
        return out
    return None if a is None else IntervalNs(int(a))


def _str_func(fn, *, out=object, strict=True):
    """Lift a python string function elementwise over object columns
    (DataFusion-inherited string scalars in the reference). strict
    functions reject non-string inputs ('The function can only accept
    strings' — string_func/*.slt); ascii and the concat family coerce."""
    def run(xp, arr, *rest):
        import numpy as _np

        if strict:
            _require_string_input(arr)
        rest = tuple(r.materialize() if isinstance(r, DictArray) else r
                     for r in rest)
        arr_rest = [r for r in rest
                    if isinstance(r, _np.ndarray) and r.shape != ()]
        if arr_rest:
            # column-valued extra args (strpos(t0, t1)): elementwise zip
            if isinstance(arr, DictArray):
                arr = arr.materialize()
            n = len(arr) if isinstance(arr, _np.ndarray) \
                else len(arr_rest[0])
            cols = [arr if isinstance(arr, _np.ndarray) else [arr] * n]
            for r in rest:
                cols.append(r if isinstance(r, _np.ndarray)
                            and r.shape != ()
                            else [r.item() if hasattr(r, "item") else r]
                            * n)
            try:
                vals = [None if row[0] is None
                        or any(x is None for x in row[1:])
                        else fn(str(row[0]), *row[1:])
                        for row in zip(*cols)]
            except TypeError as exc:
                raise PlanError(
                    f"no function matches the given argument types: "
                    f"{exc}")
            if out is object:
                o = _np.empty(len(vals), dtype=object)
                o[:] = vals
                return o
            return _np.array([out() if v is None else v for v in vals],
                             dtype=out)
        rest = [r.item() if hasattr(r, "item") else r for r in rest]
        if any(r is None for r in rest):
            # a NULL argument makes every row NULL (strict scalar
            # semantics: replace(s, x, NULL) → NULL)
            if isinstance(arr, (DictArray, _np.ndarray)):
                n_ = len(arr)
                o = _np.empty(n_, dtype=object)
                o[:] = None
                return o
            return None
        if isinstance(arr, DictArray):
            return arr.map_values(lambda x: fn(str(x), *rest),
                                  out_dtype=out if out is not object
                                  else object)
        try:
            if isinstance(arr, _np.ndarray):
                vals = [None if x is None else fn(_str_coerce(x), *rest)
                        for x in arr]
                if out is object:
                    o = _np.empty(len(vals), dtype=object)
                    o[:] = vals
                    return o
                return _np.array([out() if v is None else v
                                  for v in vals], dtype=out)
            return None if arr is None else fn(_str_coerce(arr), *rest)
        except TypeError as exc:
            # mismatched argument types surface as plan errors, like the
            # reference's "No function matches the given name and
            # argument types"
            raise PlanError(
                f"no function matches the given argument types: {exc}")
    return run


def _str_coerce(x) -> str:
    """Implicit cast-to-string for the LENIENT string functions: bools
    render '1'/'0' (matching CAST(bool AS STRING) — ascii(f2) over a
    BOOLEAN column yields 49/48 in the reference)."""
    if isinstance(x, (bool, np.bool_)):
        return "1" if x else "0"
    if isinstance(x, (float, np.floating)):
        return repr(float(x))
    return str(x)


def _fn_substr(s, start, length=None):
    """SQL substr: 1-based; a start < 1 consumes the length window before
    position 1 (PostgreSQL/DataFusion semantics)."""
    start = _int_n(start, "substr")
    if length is None:
        return s[max(0, start - 1):]
    length = _int_n(length, "substr")
    if length < 0:
        raise PlanError("substr length must not be negative")
    end = start + length                     # exclusive 1-based end
    lo = max(1, start)
    if end <= lo:
        return ""
    return s[lo - 1:end - 1]


def _fn_lpad(s, n, p=" "):
    n = _int_n(n, "lpad")
    p = _str_coerce(p)            # numeric pad coerces (reference:
    if n <= len(s):               # rpad.slt pads with a bigint column)
        return s[:n]              # SQL lpad truncates to the target length
    if not p:
        return s
    return (p * n)[:n - len(s)] + s


def _fn_rpad(s, n, p=" "):
    n = _int_n(n, "rpad")
    p = _str_coerce(p)
    if n <= len(s):
        return s[:n]
    if not p:
        return s
    return s + (p * n)[:n - len(s)]


def _fn_concat_op(xp, a, b):
    """The || OPERATOR: NULL-propagating (unlike concat(), which skips
    NULL arguments — DataFusion distinguishes the two; sqlancer pins a
    NULL || x as NULL through CAST/SUM)."""
    import numpy as _np

    parts = [p.materialize() if isinstance(p, DictArray) else p
             for p in (a, b)]
    arrays = [p for p in parts if isinstance(p, _np.ndarray)]
    if not arrays:
        if a is None or b is None:
            return None
        return _cap_result(_str_coerce(a) + _str_coerce(b))
    n = len(arrays[0])
    cols = [p if isinstance(p, _np.ndarray) else [p] * n for p in parts]
    o = _np.empty(n, dtype=object)
    o[:] = [None if (x is None or y is None)
            else _cap_result(_str_coerce(x) + _str_coerce(y))
            for x, y in zip(*cols)]
    return o


def _fn_concat(xp, *parts):
    import numpy as _np

    if not parts:
        raise PlanError("concat takes at least one argument")

    parts = [p.materialize() if isinstance(p, DictArray) else p
             for p in parts]
    arrays = [p for p in parts if isinstance(p, _np.ndarray)]
    if not arrays:
        return _cap_result("".join("" if p is None else _str_coerce(p)
                                   for p in parts))
    n = len(arrays[0])
    cols = [p if isinstance(p, _np.ndarray) else [p] * n for p in parts]
    o = _np.empty(n, dtype=object)
    o[:] = [_cap_result("".join("" if v is None else _str_coerce(v)
                                for v in row))
            for row in zip(*cols)]
    return o


def _as_i64(xp, a):
    """gcd/lcm demand integer operands (DataFusion casts, erroring on
    fractional input); numpy would silently truncate floats."""
    arr = xp.asarray(a)
    if arr.dtype.kind == "f":
        if not bool(xp.all(arr == xp.floor(arr))):
            raise PlanError("gcd/lcm require integer arguments")
    return arr.astype(xp.int64) if hasattr(arr, "astype") else arr


def _require_string_input(arr):
    import numpy as _np

    bad = False
    if isinstance(arr, DictArray):
        return
    if isinstance(arr, _np.ndarray):
        if arr.dtype.kind in "iufb":
            bad = True
        elif arr.dtype == object:
            bad = any(isinstance(x, (int, float, _np.number, bool))
                      and not isinstance(x, str)
                      for x in arr if x is not None)
    elif isinstance(arr, (bool, int, float, _np.number)):
        bad = True
    if bad:
        raise PlanError("the function can only accept strings")


def _exact1(fn):
    def run(s, *rest):
        if rest:
            raise PlanError("function takes exactly one argument")
        return fn(s)
    return run


def _fn_ascii(s):
    return ord(s[0]) if s else 0


def _fn_initcap(s):
    """Uppercase the first alphanumeric of each word, lowercase the rest
    (word = alphanumeric run, PostgreSQL/DataFusion initcap)."""
    out = []
    new_word = True
    for ch in s:
        if ch.isalnum():
            out.append(ch.upper() if new_word else ch.lower())
            new_word = False
        else:
            out.append(ch)
            new_word = True
    return "".join(out)


def _fn_left(s, n):
    n = _int_n(n, "left")
    if n >= 0:
        return _cap_result(s[:n])
    return _cap_result(s[:max(0, len(s) + n)])


def _fn_right(s, n):
    n = _int_n(n, "right")
    if n >= 0:
        return _cap_result(s[max(0, len(s) - n):] if n else "")
    return _cap_result(s[-n:])


def _fn_split_part(s, delim, n):
    n = _int_n(n, "split_part")
    if n <= 0:
        # reference: field position must be greater than zero
        # (query_server/sqllogicaltests/cases/function/string_func/
        #  split_part.slt)
        raise PlanError("split_part field position must be greater "
                        "than zero")
    delim = _str_coerce(delim)      # int delimiter coerces ('123')
    if delim == "":
        return ""           # reference renders empty, not an error
    parts = s.split(delim)
    return parts[n - 1] if n <= len(parts) else ""


def _fn_translate(s, src, dst):
    src, dst = _str_coerce(src), _str_coerce(dst)
    table = {ord(c): (dst[i] if i < len(dst) else None)
             for i, c in enumerate(src)}
    return s.translate(table)


def _fn_md5(s):
    import hashlib

    return hashlib.md5(s.encode()).hexdigest()


def _fn_iso(x):
    from datetime import datetime, timezone

    ns = int(x)
    secs, frac = divmod(ns, 1_000_000_000)
    dt = datetime.fromtimestamp(secs, tz=timezone.utc)
    base = dt.strftime("%Y-%m-%dT%H:%M:%S")
    if frac:
        digits = f"{frac:09d}"
        # trim in 3-digit groups (ns -> us -> ms), matching arrow's
        # timestamp rendering ('.010', not '.01')
        while digits.endswith("000"):
            digits = digits[:-3]
        base += "." + digits
    return base


def _fn_chr(x):
    n = int(x)
    if n <= 0 or n > 0x10FFFF:
        raise PlanError(f"chr() argument out of range: {n}")
    return chr(n)


def _int_n(v, what: str) -> int:
    """Length/position arguments must be INTEGERS (reference errors on
    LEFT('Hello', 2.7)); bools reject too."""
    if isinstance(v, bool) or (isinstance(v, float) and v != int(v)):
        raise PlanError(f"{what} requires an integer argument, got {v!r}")
    return int(v)


def _fn_repeat(s, n):
    n = _int_n(n, "repeat")
    if n < 0:
        n = 0
    if len(s) * n > (1 << 28):
        raise PlanError("repeat result exceeds the 256MiB string limit")
    return s * n


def _cap_result(s: str) -> str:
    """left/right/concat outputs are bounded at 2^22 bytes (the
    reference errors on LEFT(huge, 10_000_000) and on a 4,294,305-char
    CONCAT but passes REPEAT alone)."""
    if len(s) > (1 << 22):
        raise PlanError("string result exceeds the 4MiB limit")
    return s


class TimeOfDayLit(Literal):
    """current_time(): a Time64 value carried as its 'HH:MM:SS.ffffff'
    rendering — lexical comparisons work, but string functions reject it
    (reference: length(current_time()) is a type error)."""


class DateLit(Literal):
    """DATE '2024-08-08': behaves as its ISO string everywhere except
    scalar signature checks (reference: substr(DATE …) is a type error —
    Date32 is not Utf8)."""


def _fn_to_hex(x):
    v = int(x)
    # DataFusion to_hex renders the two's-complement i64 bit pattern
    return format(v & 0xFFFFFFFFFFFFFFFF, "x") if v < 0 else format(v, "x")


def _to_hex_lift(xp, arr, *rest):
    """to_hex(Int64): a bare NULL literal is untypable upstream and
    errors; NULL column slots yield NULL."""
    if rest:
        raise PlanError("to_hex takes exactly one argument")
    if arr is None:
        raise PlanError("to_hex does not support a NULL literal")
    return _obj_func(_fn_to_hex, numeric=False)(xp, arr)


def _fn_concat_ws(xp, sep, *parts):
    import numpy as _np

    if not parts:
        raise PlanError("concat_ws takes a separator and at least one "
                        "argument")

    if isinstance(sep, DictArray):
        sep = sep.materialize()
    if isinstance(sep, _np.ndarray) and sep.shape != ():
        # column-valued separator: per-row join (reference:
        # concat_ws(f0, f0) joins each row with its own value)
        parts = [p.materialize() if isinstance(p, DictArray) else p
                 for p in parts]
        n = len(sep)
        cols = [p if isinstance(p, _np.ndarray) else [p] * n
                for p in parts]
        o = _np.empty(n, dtype=object)
        o[:] = [None if s is None else
                _cap_result(_str_coerce(s).join(
                    _str_coerce(v) for v in row if v is not None))
                for s, *row in zip(sep, *cols)]
        return o
    sep_v = sep.item() if hasattr(sep, "item") else sep
    if sep_v is None:
        # NULL separator → NULL result (PostgreSQL/DataFusion)
        arrs = [p for p in parts if isinstance(p, _np.ndarray)]
        if not arrs:
            return None
        o = _np.empty(len(arrs[0]), dtype=object)
        o[:] = None
        return o
    parts = [p.materialize() if isinstance(p, DictArray) else p
             for p in parts]
    arrays = [p for p in parts if isinstance(p, _np.ndarray)]
    if not arrays:
        vals = [_str_coerce(p) for p in parts if p is not None]
        return _cap_result(str(sep_v).join(vals))
    n = len(arrays[0])
    cols = [p if isinstance(p, _np.ndarray) else [p] * n for p in parts]
    o = _np.empty(n, dtype=object)
    o[:] = [_cap_result(str(sep_v).join(_str_coerce(v) for v in row
                                        if v is not None))
            for row in zip(*cols)]
    return o


# -- time scalars (int64 ns timestamps; reference renders these as arrow
#    timestamps — query_server scalar set inherited from DataFusion) ------

_NS = 1_000_000_000


def _ns_to_dt(ns: int):
    from datetime import datetime, timezone

    return datetime.fromtimestamp(int(ns) / 1e9, tz=timezone.utc)


def _fn_date_part(field, ns):
    from datetime import timezone

    dt = _ns_to_dt(ns)
    f = str(field).lower()
    if f in ("year", "years"):
        v = dt.year
    elif f in ("quarter",):
        v = (dt.month - 1) // 3 + 1
    elif f in ("month", "months"):
        v = dt.month
    elif f in ("week", "weeks"):
        v = dt.isocalendar()[1]
    elif f in ("day", "days"):
        v = dt.day
    elif f in ("doy",):
        v = dt.timetuple().tm_yday
    elif f in ("dow",):
        v = (dt.weekday() + 1) % 7   # Sunday = 0 (PostgreSQL dow)
    elif f in ("hour", "hours"):
        v = dt.hour
    elif f in ("minute", "minutes"):
        v = dt.minute
    elif f in ("second", "seconds"):
        v = dt.second + dt.microsecond / 1e6
    elif f in ("millisecond", "milliseconds"):
        v = (dt.second + dt.microsecond / 1e6) * 1e3
    elif f in ("microsecond", "microseconds"):
        v = (dt.second + dt.microsecond / 1e6) * 1e6
    elif f in ("nanosecond", "nanoseconds"):
        v = dt.second * 1e9 + (int(ns) % _NS)
    elif f in ("epoch",):
        v = int(ns) / 1e9
    else:
        raise PlanError(f"date_part: unknown field {field!r}")
    return float(v)


def _fn_date_trunc(granularity, ns):
    from datetime import datetime, timezone

    dt = _ns_to_dt(ns)
    g = str(granularity).lower()
    if g == "year":
        dt2 = datetime(dt.year, 1, 1, tzinfo=timezone.utc)
    elif g == "quarter":
        dt2 = datetime(dt.year, ((dt.month - 1) // 3) * 3 + 1, 1,
                       tzinfo=timezone.utc)
    elif g == "month":
        dt2 = datetime(dt.year, dt.month, 1, tzinfo=timezone.utc)
    elif g == "week":
        from datetime import timedelta

        d0 = datetime(dt.year, dt.month, dt.day, tzinfo=timezone.utc)
        dt2 = d0 - timedelta(days=dt.weekday())
    elif g == "day":
        dt2 = datetime(dt.year, dt.month, dt.day, tzinfo=timezone.utc)
    elif g == "hour":
        return (int(ns) // (3600 * _NS)) * 3600 * _NS
    elif g == "minute":
        return (int(ns) // (60 * _NS)) * 60 * _NS
    elif g == "second":
        return (int(ns) // _NS) * _NS
    elif g == "millisecond":
        return (int(ns) // 1_000_000) * 1_000_000
    elif g == "microsecond":
        return (int(ns) // 1_000) * 1_000
    else:
        raise PlanError(f"date_trunc: unknown granularity {granularity!r}")
    return int(dt2.timestamp()) * _NS


_DAY_NS = 86_400 * _NS


def _vec_date_part(field, ns):
    """Array form of _fn_date_part over int64 ns columns: datetime64
    calendar math instead of per-row datetime.fromtimestamp (the single
    hottest scalar loop in the relational path — ClickBench q19 spends
    seconds here). Integer arithmetic throughout, so results are exact
    where the float-seconds scalar path can round near bucket edges.
    Returns float64 (the scalar path always returns float) or None for
    unknown fields (caller's scalar loop raises the canonical error)."""
    import numpy as _np

    f = str(field).lower()
    ns = ns.astype(_np.int64, copy=False)
    if f in ("minute", "minutes"):
        return ((ns // (60 * _NS)) % 60).astype(_np.float64)
    if f in ("hour", "hours"):
        return ((ns // (3600 * _NS)) % 24).astype(_np.float64)
    if f in ("dow",):
        # epoch day 0 = Thursday; PostgreSQL dow has Sunday = 0
        return ((ns // _DAY_NS + 4) % 7).astype(_np.float64)
    if f in ("second", "seconds"):
        return (ns % (60 * _NS)) / 1e9
    if f in ("millisecond", "milliseconds"):
        return (ns % (60 * _NS)) / 1e6
    if f in ("microsecond", "microseconds"):
        return (ns % (60 * _NS)) / 1e3
    if f in ("nanosecond", "nanoseconds"):
        return (((ns // _NS) % 60) * _NS + ns % _NS).astype(_np.float64)
    if f in ("epoch",):
        return ns / 1e9
    d = ns.astype("datetime64[ns]")
    if f in ("year", "years"):
        return (d.astype("datetime64[Y]").astype(_np.int64)
                + 1970).astype(_np.float64)
    mo = d.astype("datetime64[M]").astype(_np.int64)
    if f in ("month", "months"):
        return (mo % 12 + 1).astype(_np.float64)
    if f in ("quarter",):
        return ((mo % 12) // 3 + 1).astype(_np.float64)
    days = d.astype("datetime64[D]")
    if f in ("day", "days"):
        return ((days - mo.astype("datetime64[M]").astype("datetime64[D]"))
                .astype(_np.int64) + 1).astype(_np.float64)
    if f in ("doy",):
        y0 = d.astype("datetime64[Y]").astype("datetime64[D]")
        return ((days - y0).astype(_np.int64) + 1).astype(_np.float64)
    if f in ("week", "weeks"):
        # ISO week = ordinal of this week's Thursday within ITS year
        epoch_days = days.astype(_np.int64)
        th = epoch_days - (epoch_days + 3) % 7 + 3
        thd = th.astype("datetime64[D]")
        ty0 = thd.astype("datetime64[Y]").astype("datetime64[D]")
        return (((thd - ty0).astype(_np.int64)) // 7 + 1).astype(_np.float64)
    return None


def _vec_date_trunc(granularity, ns):
    """Array form of _fn_date_trunc; int64 output matching the scalar
    path's all-int listcomp dtype. None for unknown granularities."""
    import numpy as _np

    g = str(granularity).lower()
    ns = ns.astype(_np.int64, copy=False)
    unit = {"hour": 3600 * _NS, "minute": 60 * _NS, "second": _NS,
            "millisecond": 1_000_000, "microsecond": 1_000}.get(g)
    if unit is not None:
        return (ns // unit) * unit
    if g == "day":
        return (ns // _DAY_NS) * _DAY_NS
    if g == "week":
        days = ns // _DAY_NS
        return (days - (days + 3) % 7) * _DAY_NS   # back to Monday
    d = ns.astype("datetime64[ns]")
    if g == "month":
        return d.astype("datetime64[M]").astype("datetime64[ns]") \
            .astype(_np.int64)
    if g == "quarter":
        mo = d.astype("datetime64[M]").astype(_np.int64)
        return ((mo // 3) * 3).astype("datetime64[M]") \
            .astype("datetime64[ns]").astype(_np.int64)
    if g == "year":
        return d.astype("datetime64[Y]").astype("datetime64[ns]") \
            .astype(_np.int64)
    return None


def _fn_from_unixtime(x):
    if isinstance(x, (float, np.floating)) or isinstance(x, str):
        # reference signature: from_unixtime(Int64) only
        raise PlanError(
            "from_unixtime does not support this input type (Int64 only)")
    return int(x) * _NS


def _fn_to_timestamp(x, scale_ns: int = 1):
    """String → ns (ISO-8601), or INTEGER scaled by the unit variant
    (to_timestamp=ns, _seconds/_millis/_micros — DataFusion signatures
    reject Float64)."""
    if isinstance(x, str):
        from .parser import parse_timestamp_string

        return parse_timestamp_string(x)
    if isinstance(x, (float, np.floating)):
        raise PlanError(
            "to_timestamp does not support Float64 input")
    return int(x) * scale_ns


def _register_time_scalars():
    import time as _time
    from datetime import datetime, timezone

    Func._FUNCS.update({
        "now": lambda xp: int(_time.time() * 1e9),

        "current_timestamp": lambda xp: int(_time.time() * 1e9),
        "current_date": lambda xp: datetime.now(timezone.utc)
        .strftime("%Y-%m-%d"),
        "current_time": lambda xp: datetime.now(timezone.utc)
        .strftime("%H:%M:%S.%f"),
        "date_part": _scalar_first_obj(_fn_date_part, vec=_vec_date_part),
        "datepart": _scalar_first_obj(_fn_date_part, vec=_vec_date_part),
        "date_trunc": _scalar_first_obj(_fn_date_trunc,
                                        vec=_vec_date_trunc),
        # relational-path DATE_BIN (the single-table path lowers it into
        # the bucket kernel; derived subqueries evaluate it row-wise —
        # tsbench avg_daily_driving_duration buckets inside a CTE)
        "date_bin": lambda xp, iv, ts, *origin: _fn_date_bin(
            iv, ts, origin[0] if origin else 0),
        "datetrunc": _scalar_first_obj(_fn_date_trunc,
                                       vec=_vec_date_trunc),
        "from_unixtime": _obj_func(_fn_from_unixtime),
        "to_timestamp": _obj_func(_fn_to_timestamp),
        "to_timestamp_seconds": _obj_func(
            lambda x: _fn_to_timestamp(x, _NS) if not isinstance(x, str)
            else (_fn_to_timestamp(x) // _NS) * _NS),
        "to_timestamp_millis": _obj_func(
            lambda x: _fn_to_timestamp(x, 1_000_000) if not isinstance(x, str)
            else (_fn_to_timestamp(x) // 1_000_000) * 1_000_000),
        "to_timestamp_micros": _obj_func(
            lambda x: _fn_to_timestamp(x, 1_000) if not isinstance(x, str)
            else (_fn_to_timestamp(x) // 1_000) * 1_000),
    })


def _scalar_first_obj(fn, vec=None):
    """Lift fn(scalar_opt, value) where the FIRST argument is a scalar
    option (field name / granularity) and the second is the column.
    `vec` is an optional whole-array fast path for integer columns (the
    timestamp case); it returns None to defer to the scalar loop."""
    def run(xp, opt, arr):
        import numpy as _np

        opt = opt.item() if hasattr(opt, "item") else opt
        if isinstance(arr, _np.ndarray):
            if vec is not None and arr.dtype.kind in "iu" and len(arr):
                out = vec(opt, arr)
                if out is not None:
                    return out
            vals = [None if x is None else fn(opt, x) for x in arr]
            if vals and all(isinstance(v, int) for v in vals):
                return _np.array(vals, dtype=_np.int64)
            if vals and all(v is None or isinstance(v, (int, float))
                            for v in vals):
                return _np.array([_np.nan if v is None else float(v)
                                  for v in vals])
            o = _np.empty(len(vals), dtype=object)
            o[:] = vals
            return o
        return None if arr is None else fn(opt, arr)
    return run


def _obj_func(fn, *, numeric: bool = True):
    """Lift a python function over object columns (gauge/state composites
    from sql.tsfuncs). Extra args arrive as evaluated scalars."""
    def run(xp, arr, *rest):
        import numpy as _np

        if isinstance(arr, DictArray):
            arr = arr.materialize()
        rest = [r.item() if hasattr(r, "item") else r for r in rest]
        if isinstance(arr, _np.ndarray):
            vals = [None if x is None else fn(x, *rest) for x in arr]
            if numeric:
                # exact type check: int SUBCLASSES (IntervalNs) must stay
                # objects so their interval rendering survives
                if all(v is None or type(v) in (int, float) for v in vals):
                    if any(v is None for v in vals):
                        return _np.array([_np.nan if v is None else float(v)
                                          for v in vals])
                    if all(isinstance(v, int) for v in vals):
                        return _np.array(vals, dtype=_np.int64)
                    return _np.array(vals, dtype=_np.float64)
            out = _np.empty(len(vals), dtype=object)
            out[:] = vals
            return out
        return None if arr is None else fn(arr, *rest)
    return run


def _binary_obj_func(fn):
    """Pairwise lift for two-geometry scalars (st_distance)."""
    def run(xp, a, b, *rest):
        import numpy as _np

        if isinstance(a, DictArray):
            a = a.materialize()
        if isinstance(b, DictArray):
            b = b.materialize()

        if isinstance(a, _np.ndarray) or isinstance(b, _np.ndarray):
            n = len(a) if isinstance(a, _np.ndarray) else len(b)
            aa = a if isinstance(a, _np.ndarray) else [a] * n
            bb = b if isinstance(b, _np.ndarray) else [b] * n
            return _np.array([
                _np.nan if (x is None or y is None) else fn(x, y, *rest)
                for x, y in zip(aa, bb)])
        if a is None or b is None:
            return None
        return fn(a, b, *rest)
    return run


def _binary_pred(fn):
    """Pairwise lift for boolean geometry predicates: NULL in → NULL
    out (object arrays keep None; _binary_obj_func's NaN would render
    'NaN')."""
    def run(xp, a, b, *rest):
        import numpy as _np

        if isinstance(a, DictArray):
            a = a.materialize()
        if isinstance(b, DictArray):
            b = b.materialize()
        if isinstance(a, _np.ndarray) or isinstance(b, _np.ndarray):
            n = len(a) if isinstance(a, _np.ndarray) else len(b)
            aa = a if isinstance(a, _np.ndarray) else [a] * n
            bb = b if isinstance(b, _np.ndarray) else [b] * n
            out = _np.empty(n, dtype=object)
            out[:] = [None if (x is None or y is None) else fn(x, y)
                      for x, y in zip(aa, bb)]
            return out
        if a is None or b is None:
            return None
        return fn(a, b)
    return run


def _register_tsfuncs():
    """Gauge/state accessors + GIS scalars (reference scalar_function/
    gauge/*.rs, duration_in.rs, state_at.rs, gis/*.rs). Registered lazily
    at module bottom to avoid an import cycle with sql.tsfuncs."""
    from . import gis as _gis
    from . import tsfuncs as tf

    Func._FUNCS.update({
        "delta": _obj_func(tf.gauge_delta),
        "time_delta": _obj_func(tf.gauge_time_delta),
        "rate": _obj_func(tf.gauge_rate),
        "first_val": _obj_func(lambda g: g["first"][1]),
        "last_val": _obj_func(lambda g: g["last"][1]),
        "first_time": _obj_func(lambda g: g["first"][0]),
        "last_time": _obj_func(lambda g: g["last"][0]),
        "idelta_left": _obj_func(tf.gauge_idelta_left),
        "idelta_right": _obj_func(tf.gauge_idelta_right),
        "num_elements": _obj_func(lambda g: g["num_elements"]),
        "duration_in": _obj_func(tf.duration_in),
        "state_at": _obj_func(tf.state_at, numeric=False),
        "st_distance": _binary_obj_func(tf.st_distance),
        "st_area": _obj_func(tf.st_area),
        "st_asbinary": _obj_func(_gis.st_asbinary, numeric=False),
        "st_geomfromwkb": _obj_func(_gis.st_geomfromwkb, numeric=False),
        "st_intersects": _binary_pred(_gis.st_intersects),
        "st_disjoint": _binary_pred(_gis.st_disjoint),
        "st_contains": _binary_pred(_gis.st_contains),
        "st_within": _binary_pred(_gis.st_within),
        "st_equals": _binary_pred(_gis.st_equals),
        # string scalars (DataFusion-inherited set in the reference)
        "upper": _str_func(str.upper),
        "lower": _str_func(str.lower),
        "length": _str_func(len, out=np.int64),
        "regexp_replace": lambda xp, v, pat, rep, *flags: _regexp_replace(
            v, pat, rep, flags[0] if flags else ""),
        "char_length": _str_func(len, out=np.int64),
        # TRIM takes exactly one argument (the charset form is btrim /
        # TRIM(BOTH..FROM)); ltrim/rtrim accept an optional charset
        # (reference ltrim.slt: ltrim('   sdf', ' s') works)
        "trim": _str_func(_exact1(str.strip)),
        "ltrim": _str_func(lambda s, *c: s.lstrip(*[str(x) for x in c])),
        "rtrim": _str_func(lambda s, *c: s.rstrip(*[str(x) for x in c])),
        "reverse": _str_func(lambda s: s[::-1]),
        "substr": _str_func(_fn_substr),
        "substring": _str_func(_fn_substr),
        "replace": _str_func(
            lambda s, a, b: s.replace(_str_coerce(a), _str_coerce(b))),
        # starts/ends_with coerce non-strings (reference:
        # starts_with(123, 'hello') → false)
        "starts_with": _str_func(
            lambda s, p: s.startswith(_str_coerce(p)), out=np.bool_,
            strict=False),
        "ends_with": _str_func(
            lambda s, p: s.endswith(_str_coerce(p)), out=np.bool_,
            strict=False),
        "concat": _fn_concat,
        "__concat_op": _fn_concat_op,
        "strpos": _str_func(lambda s, sub: s.find(_str_coerce(sub)) + 1,
                            out=np.int64),
        "repeat": _str_func(_fn_repeat),
        "lpad": _str_func(_fn_lpad),
        "rpad": _str_func(_fn_rpad),
        "ascii": _str_func(_fn_ascii, out=np.int64, strict=False),
        # internal: timestamp → ISO string (analyzer wraps time args of
        # lenient string functions so ascii(time) sees '1999-…' like the
        # reference's implicit timestamp→utf8 cast)
        "__iso__": _obj_func(_fn_iso, numeric=False),
        "chr": _obj_func(_fn_chr, numeric=False),
        "bit_length": _str_func(lambda s: len(s.encode()) * 8,
                                out=np.int64),
        "octet_length": _str_func(lambda s: len(s.encode()), out=np.int64),
        "character_length": _str_func(len, out=np.int64),
        "btrim": _str_func(lambda s, *c: s.strip(*c)),
        "ltrim_chars": _str_func(lambda s, c: s.lstrip(c)),
        "rtrim_chars": _str_func(lambda s, c: s.rstrip(c)),
        "initcap": _str_func(_fn_initcap),
        "left": _str_func(_fn_left),
        "right": _str_func(_fn_right),
        "split_part": _str_func(_fn_split_part),
        "translate": _str_func(_fn_translate),
        "md5": _str_func(_fn_md5),
        "to_hex": _to_hex_lift,
        "concat_ws": _fn_concat_ws,
    })
    _register_time_scalars()


def _parse_bool_str(s: str) -> bool:
    low = str(s).strip().lower()
    if low in ("t", "true", "1", "yes"):
        return True
    if low in ("f", "false", "0", "no"):
        return False
    raise ValueError(f"invalid boolean string {s!r}")


def _cast_scalar(x, kind: str):
    """One value → cast target kind (i/u/f/s/b/t/v). Raises ValueError/
    OverflowError on impossible casts (DataFusion-style strict CAST)."""
    if kind == "v":   # INTERVAL: '3 day' → ns span (arrow-rendered)
        from .parser import parse_interval_string
        from .tsfuncs import IntervalNs

        if isinstance(x, str):
            return IntervalNs(parse_interval_string(x))
        raise ValueError(f"cannot cast {x!r} to INTERVAL")
    if kind == "t" and isinstance(x, str):
        # arrow parses string→timestamp as RFC3339 text, never as an
        # integer ("Error parsing timestamp from '0'" — sqlancer pins it)
        s = x.strip()
        if "-" not in s[1:] and ":" not in s:
            raise ValueError(f"Error parsing timestamp from {s!r}")
        from .parser import parse_timestamp_string

        return parse_timestamp_string(s)
    if kind in ("i", "t", "u"):
        if isinstance(x, str):
            out = int(x.strip())
        elif isinstance(x, (float, np.floating)):
            if np.isnan(x) or np.isinf(x):
                raise ValueError(f"cannot cast {x} to integer")
            out = int(x)          # truncation toward zero
        else:
            out = int(x)
        if kind == "u" and out < 0:
            raise ValueError(f"cannot cast negative {out} to unsigned")
        return out
    if kind == "f":
        return float(x.strip()) if isinstance(x, str) else float(x)
    if kind == "s":
        if isinstance(x, (bool, np.bool_)):
            # the reference renders CAST(bool AS STRING) as '0'/'1'
            # (data_type/type_conversion/between.slt pins it)
            return "1" if x else "0"
        if isinstance(x, (float, np.floating)):
            return repr(float(x))
        if isinstance(x, (int, np.integer)):
            return str(int(x))
        return str(x)
    if kind == "b":
        if isinstance(x, str):
            return _parse_bool_str(x)
        return bool(x != 0) if not isinstance(x, (bool, np.bool_)) else bool(x)
    raise ValueError(f"unknown cast kind {kind}")


_CAST_KINDS = {"BIGINT": "i", "INT": "i", "INTEGER": "i",
               "BIGINT UNSIGNED": "u", "UNSIGNED": "u",
               "DOUBLE": "f", "FLOAT": "f",
               "STRING": "s", "VARCHAR": "s", "TEXT": "s",
               "BOOLEAN": "b", "BOOL": "b", "TIMESTAMP": "t",
               "CHAR": "s", "INTERVAL": "v"}


def iter_child_exprs(e):
    """Every direct child Expr of a node — the ONE traversal helper all
    tree walks share (attr children, Func args, CASE arms)."""
    for attr in ("left", "right", "operand", "expr", "low", "high",
                 "else_", "pattern"):
        c = getattr(e, attr, None)
        if isinstance(c, Expr):
            yield c
    for a in getattr(e, "args", None) or []:
        if isinstance(a, Expr):
            yield a
    for c, r in getattr(e, "whens", None) or []:
        if isinstance(c, Expr):
            yield c
        if isinstance(r, Expr):
            yield r


def _column_null_mask(col: str, env: dict, xp):
    """Per-row NULL mask for a column in env, from its validity mask when
    present, else from the value representation (None in object arrays,
    NaN in float columns). None when the column can't be resolved."""
    key = f"__valid__:{col}"
    if key in env:
        return ~np.asarray(env[key], dtype=bool)
    v = env.get(col)
    if v is None:
        return None
    if isinstance(v, DictArray):
        return None   # dictionary columns have no NULL holes
    dt = getattr(v, "dtype", None)
    if dt is None:
        return None
    if dt == object:
        return np.array([x is None or (isinstance(x, float) and x != x)
                         for x in v], dtype=bool)
    if dt.kind == "f":
        return xp.isnan(v)
    return None


def propagating_columns(e) -> set:
    """Columns whose NULLs propagate to this expression's result — i.e.
    every referenced column EXCEPT those only seen inside NULL-aware nodes
    (IS NULL, CASE), which define their own NULL behavior. The executor's
    blanket NULL-out mask uses this instead of columns() so
    `CASE WHEN i IS NULL THEN -1 ...` can map NULL to a value."""
    if isinstance(e, (IsNull, Case, IsDistinct, IsBool, KeyInSet,
                      CorrExists)):
        # NULL-defining nodes: their result is never NULL regardless of
        # input NULLs
        return set()
    if not isinstance(e, Expr):
        return set()
    out = set()
    if isinstance(e, Column):
        out.add(e.name)
    for attr in ("left", "right", "operand", "expr", "low", "high"):
        child = getattr(e, attr, None)
        if isinstance(child, Expr):
            out |= propagating_columns(child)
    for a in getattr(e, "args", None) or []:
        out |= propagating_columns(a)
    return out


@dataclass(repr=False)
class Case(Expr):
    """CASE [operand] WHEN cond/value THEN result ... [ELSE d] END
    (reference: DataFusion Expr::Case). First matching arm wins; no match
    and no ELSE → NULL. NULL conditions/operands never match (3VL)."""

    operand: Expr | None
    whens: list            # [(cond_or_value, result_expr)]
    else_: Expr | None = None

    @staticmethod
    def _env_invalid(e, env, n):
        """Rows where any NULL-propagating column of `e` is invalid."""
        invalid = None
        for c in propagating_columns(e):
            key = f"__valid__:{c}"
            if key in env and len(env[key]) == n:
                bad = ~np.asarray(env[key], dtype=bool)
                invalid = bad if invalid is None else (invalid | bad)
        return invalid

    def _conds(self, env, xp, n):
        base = self.operand.eval(env, xp) if self.operand is not None \
            else None
        base_bad = (self._env_invalid(self.operand, env, n)
                    if self.operand is not None else None)
        for cond, _ in self.whens:
            if self.operand is not None:
                m = _eq(xp, base, cond.eval(env, xp))
                cond_bad = self._env_invalid(cond, env, n)
            else:
                m = cond.eval(env, xp)
                cond_bad = self._env_invalid(cond, env, n)
            m = np.asarray(m)
            if m.dtype == object:
                m = np.array([bool(x) if x is not None else False
                              for x in m], dtype=bool)
            elif m.dtype.kind == "f":
                m = ~np.isnan(m) & (m != 0)
            else:
                m = m.astype(bool)
            if not m.shape:
                m = np.full(n, bool(m))
            # 3VL: a NULL operand or NULL in the condition's propagating
            # columns never matches (typed NULL slots carry garbage)
            for bad in (base_bad, cond_bad):
                if bad is not None:
                    m = m & ~bad
            yield m

    def _arm_values(self, e, env, xp, n, pick):
        """Values of one arm for the picked rows. Full-vector eval when it
        succeeds; an arm that errors on rows its WHEN excludes (CAST over
        a guarded Inf row) re-evaluates on the picked subset only."""
        def vec(e_, env_, n_):
            if e_ is None:
                return np.full(n_, None, dtype=object)
            v = e_.eval(env_, xp)
            v = np.asarray(v.materialize() if hasattr(v, "materialize")
                           else v)
            if not v.shape:
                v = np.full(n_, v[()])
            if v.dtype != object:
                v = v.astype(object)
            vf = v.copy()
            nanm = [isinstance(x, float) and x != x for x in vf]
            if any(nanm):
                vf[nanm] = None
            bad = self._env_invalid(e_, env_, n_)
            if bad is not None and bad.any():
                vf[bad] = None
            return vf

        try:
            return vec(e, env, n)[pick]
        except Exception:
            if pick.all():
                raise
            k = int(pick.sum())
            sub = {key: (v[pick] if hasattr(v, "__len__")
                         and not isinstance(v, (str, bytes))
                         and len(v) == n else v)
                   for key, v in env.items()}
            return vec(e, sub, k)

    def eval(self, env, xp):
        # row count from any column in scope (scalar-only CASE gets n=1)
        n = 1
        for vv in env.values():
            if hasattr(vv, "__len__") and not isinstance(vv, (str, bytes)):
                n = len(vv)
                break
        result = np.full(n, None, dtype=object)
        taken = np.zeros(n, dtype=bool)
        for m, (_, res) in zip(self._conds(env, xp, n), self.whens):
            pick = m & ~taken
            taken |= m
            if pick.any():
                result[pick] = self._arm_values(res, env, xp, n, pick)
        rest = ~taken
        if self.else_ is not None and rest.any():
            result[rest] = self._arm_values(self.else_, env, xp, n, rest)
        # downcast homogeneous results so renders stay native (5 not 5.0)
        vals = [x for x in result if x is not None]
        if vals and len(vals) == n:
            if all(isinstance(x, (bool, np.bool_)) for x in vals):
                return np.array([bool(x) for x in result])
            if all(isinstance(x, (int, np.integer))
                   and not isinstance(x, (bool, np.bool_)) for x in vals):
                return np.array([int(x) for x in result], dtype=np.int64)
            if all(isinstance(x, (float, np.floating)) for x in vals):
                return np.array([float(x) for x in result])
        return result

    def columns(self):
        out = set()
        if self.operand is not None:
            out |= self.operand.columns()
        for c, r in self.whens:
            out |= c.columns() | r.columns()
        if self.else_ is not None:
            out |= self.else_.columns()
        return out

    def to_sql(self):
        parts = ["CASE"]
        if self.operand is not None:
            parts.append(self.operand.to_sql())
        for c, r in self.whens:
            parts.append(f"WHEN {c.to_sql()} THEN {r.to_sql()}")
        if self.else_ is not None:
            parts.append(f"ELSE {self.else_.to_sql()}")
        parts.append("END")
        return " ".join(parts)


@dataclass(repr=False)
class Cast(Expr):
    """CAST(expr AS type) / TRY_CAST (NULL instead of error) — reference
    inherits DataFusion's cast kernels; semantics here follow them:
    float→int truncates toward zero, NaN/Inf→int errors, bool→'true'."""

    expr: Expr
    target: str
    safe: bool = False

    def eval(self, env, xp):
        kind = _CAST_KINDS.get(self.target.upper())
        if kind is None:
            raise PlanError(f"unknown CAST target {self.target!r}")
        v = self.expr.eval(env, xp)
        if v is None:
            return None
        if xp is not np and not self.safe and not np.isscalar(v) \
                and not isinstance(v, (np.ndarray, DictArray)):
            # a device filter's value: the same conversions there, and a
            # failed one raises as below
            out, failed = xp.cast(v, kind, env.get(
                f"__valid__:{self.expr.name}")
                if isinstance(self.expr, Column) else None)
            if failed:
                raise PlanError("CAST failed: NaN/Inf/negative to integer")
            return out
        if isinstance(v, DictArray):
            def cast_u(x):
                try:
                    return _cast_scalar(x, kind)
                except (ValueError, OverflowError) as e:
                    if self.safe:
                        return None
                    raise PlanError(f"CAST failed: {e}")
            return v.map_values(cast_u)
        if isinstance(v, np.ndarray) and v.dtype != object:
            # NULL slots of a typed column carry garbage values — they
            # must neither abort a strict CAST nor poison TRY_CAST
            vm = None
            if isinstance(self.expr, Column):
                vm = env.get(f"__valid__:{self.expr.name}")
            if kind in ("i", "t", "u"):
                bad = (~np.isfinite(v) if v.dtype.kind == "f"
                       else np.zeros(len(v), dtype=bool))
                if kind == "u":
                    bad = bad | (np.asarray(v, dtype=np.float64) < 0)
                relevant = bad if vm is None else (bad & vm)
                if relevant.any() and not self.safe:
                    raise PlanError(
                        "CAST failed: NaN/Inf/negative to integer")
                vsafe = np.where(bad, 0, v)
                tgt = np.uint64 if kind == "u" else np.int64
                out_i = (np.trunc(vsafe) if v.dtype.kind == "f"
                         else vsafe).astype(tgt)
                if relevant.any():
                    # TRY_CAST is per-element: only failed slots go NULL
                    out = out_i.astype(object)
                    out[relevant] = None
                    return out
                return out_i
            if kind == "f":
                return v.astype(np.float64)
            if kind == "b":
                return v != 0
            out = np.empty(len(v), dtype=object)
            out[:] = [_cast_scalar(x, "s") for x in v.tolist()]
            return out
        if isinstance(v, np.ndarray):   # object (string) column
            out = np.empty(len(v), dtype=object)
            vals = []
            for x in v:
                if x is None:
                    vals.append(None)
                    continue
                try:
                    vals.append(_cast_scalar(x, kind))
                except (ValueError, OverflowError) as e:
                    if self.safe:
                        vals.append(None)
                    else:
                        raise PlanError(f"CAST failed: {e}")
            out[:] = vals
            return out
        try:
            return _cast_scalar(v, kind)
        except (ValueError, OverflowError) as e:
            if self.safe:
                return None
            raise PlanError(f"CAST failed: {e}")

    def columns(self):
        return self.expr.columns()

    def to_sql(self):
        fn = "TRY_CAST" if self.safe else "CAST"
        return f"{fn}({self.expr.to_sql()} AS {self.target})"


@dataclass(repr=False)
class Subquery(Expr):
    """Uncorrelated scalar subquery — the executor resolves it to a Literal
    before evaluation (reference gets these via DataFusion's subquery
    decorrelation; we support the uncorrelated forms)."""

    select: object   # ast.SelectStmt | ast.UnionStmt

    def eval(self, env, xp):
        raise PlanError("unresolved scalar subquery (executor must resolve)")

    def columns(self):
        return set()

    def to_sql(self):
        return "(<subquery>)"


@dataclass(repr=False)
class InSubquery(Expr):
    """expr [NOT] IN (SELECT ...) — resolved to an InList by the executor."""

    expr: Expr
    select: object
    negated: bool = False

    def eval(self, env, xp):
        raise PlanError("unresolved IN subquery (executor must resolve)")

    def columns(self):
        return self.expr.columns()

    def to_sql(self):
        neg = " NOT" if self.negated else ""
        return f"({self.expr.to_sql()}{neg} IN (<subquery>))"


@dataclass(repr=False)
class Exists(Expr):
    """[NOT] EXISTS (SELECT ...) — resolved to a boolean literal by the
    executor (uncorrelated, like InSubquery; reference: DataFusion's
    scalar-subquery decorrelation handles the same class)."""

    select: object
    negated: bool = False

    def eval(self, env, xp):
        raise PlanError("unresolved EXISTS subquery (executor must resolve)")

    def columns(self):
        return set()

    def to_sql(self):
        neg = "NOT " if self.negated else ""
        return f"({neg}EXISTS (<subquery>))"


def _rows_of(v, n):
    """Per-row python values for an eval() result: scalars broadcast,
    np scalars unwrap (so tuple hashing matches the python values the
    inner query produced), NaN normalizes to None (NULL semantics)."""
    if isinstance(v, DictArray):
        v = v.materialize()
    if isinstance(v, np.ndarray):
        out = []
        for x in v.tolist() if v.dtype != object else v:
            if isinstance(x, float) and x != x:
                out.append(None)
            elif isinstance(x, np.generic):
                out.append(x.item())
            else:
                out.append(x)
        return out
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float) and v != v:
        v = None
    return [v] * n


def _env_rows(env: dict) -> int:
    for val in env.values():
        if isinstance(val, (np.ndarray, DictArray)):
            return len(val)
    return 1


_SCALAR_DUP = object()   # sentinel: correlation key had >1 inner row


@dataclass(repr=False)
class CorrLookup(Expr):
    """Decorrelated correlated SCALAR subquery: per row, the correlation
    key exprs (`args`) evaluate and the tuple maps through `mapping`
    (built by grouping the inner query by its correlation columns);
    missing keys — including NULL key components, which can never equal
    anything — yield `default` (0 for COUNT bodies, else NULL).
    Reference surface: DataFusion's scalar_subquery_to_join
    (query_server/query/src/sql/logical/optimizer.rs:66-108)."""

    args: list
    mapping: dict
    default: object = None

    def eval(self, env, xp):
        n = _env_rows(env)
        cols = [_rows_of(a.eval(env, xp), n) for a in self.args]
        out = np.empty(n, dtype=object)
        for i in range(n):
            key = tuple(c[i] for c in cols)
            if any(k is None for k in key):
                out[i] = self.default
                continue
            v = self.mapping.get(key, self.default)
            if v is _SCALAR_DUP:
                raise PlanError(
                    "scalar subquery must return a single value")
            out[i] = v
        return out

    def columns(self):
        s = set()
        for a in self.args:
            s |= a.columns()
        return s

    def to_sql(self):
        return "(<correlated scalar subquery>)"


@dataclass(repr=False)
class CorrIn(Expr):
    """Decorrelated correlated IN subquery: `probe [NOT] IN (SELECT v
    FROM .. WHERE inner_k = outer_k ..)`. args = [probe, *outer_keys];
    `pairs` holds (key.., v) tuples from the inner query, `keyed` the
    correlation keys with any row, `null_keys` those whose value set
    contained NULL. Three-valued logic folds to a filter mask: UNKNOWN
    rows (NULL probe against a non-empty set, or a miss against a set
    containing NULL) never match, for IN and NOT IN alike."""

    args: list
    pairs: set
    keyed: set
    null_keys: set
    negated: bool = False

    def eval(self, env, xp):
        n = _env_rows(env)
        cols = [_rows_of(a.eval(env, xp), n) for a in self.args]
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            probe = cols[0][i]
            key = tuple(c[i] for c in cols[1:])
            if any(k is None for k in key) or key not in self.keyed:
                res = False          # empty set: IN false, NOT IN true
            elif probe is None:
                res = None
            elif key + (probe,) in self.pairs:
                res = True
            elif key in self.null_keys:
                res = None
            else:
                res = False
            if res is None:
                out[i] = False       # UNKNOWN excludes under both forms
            else:
                out[i] = (not res) if self.negated else res
        return out

    def columns(self):
        s = set()
        for a in self.args:
            s |= a.columns()
        return s

    def to_sql(self):
        neg = " NOT" if self.negated else ""
        return f"({self.args[0].to_sql()}{neg} IN (<correlated subquery>))"


def _tri_rows(e, env, xp, n):
    """Row values of an expression with 3VL NULL recovered for PREDICATE
    subtrees: a boolean expr is NULL where neither its true mask nor its
    definite-false mask holds (x NOT IN (...) over NULL x is NULL — both
    IS DISTINCT FROM and IS TRUE/FALSE observe that)."""
    v = e.eval(env, xp)
    rows = _rows_of(v, n)
    is_boolish = (isinstance(v, np.ndarray) and v.dtype == bool) \
        or isinstance(v, (bool, np.bool_))
    if is_boolish and xp is np:
        f = _eval_false_mask(e, env, xp)
        if isinstance(f, np.ndarray):
            fr = _rows_of(f, n)
            rows = [None if (not t) and (not fl) else t
                    for t, fl in zip(rows, fr)]
    return rows


@dataclass(repr=False)
class IsDistinct(Expr):
    """x IS [NOT] DISTINCT FROM y — NULL-safe comparison (two NULLs are
    NOT distinct; a NULL vs a value is)."""

    left: Expr
    right: Expr
    negated: bool = False   # negated == IS NOT DISTINCT FROM

    def eval(self, env, xp):
        n = _env_rows(env)
        ar = _tri_rows(self.left, env, xp, n)
        br = _tri_rows(self.right, env, xp, n)
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            x, y = ar[i], br[i]
            if x is None or y is None:
                distinct = (x is None) != (y is None)
            else:
                try:
                    distinct = not (x == y)
                except TypeError:
                    distinct = True
            out[i] = (not distinct) if self.negated else distinct
        return out

    def columns(self):
        return self.left.columns() | self.right.columns()

    def to_sql(self):
        neg = " NOT" if self.negated else ""
        return (f"({self.left.to_sql()} IS{neg} DISTINCT FROM "
                f"{self.right.to_sql()})")


@dataclass(repr=False)
class IsBool(Expr):
    """x IS [NOT] TRUE/FALSE (sqlancer): NULL inputs are not the target
    (so IS NOT TRUE keeps NULL rows)."""

    expr: Expr
    target: bool
    negated: bool = False

    def eval(self, env, xp):
        n = _env_rows(env)
        rows = _tri_rows(self.expr, env, xp, n)
        out = np.zeros(n, dtype=bool)
        for i, x in enumerate(rows):
            m = (x is not None) and bool(x) == self.target
            out[i] = (not m) if self.negated else m
        return out

    def columns(self):
        return self.expr.columns()

    def to_sql(self):
        neg = " NOT" if self.negated else ""
        t = "TRUE" if self.target else "FALSE"
        return f"({self.expr.to_sql()} IS{neg} {t})"


@dataclass(repr=False)
class CorrExists(Expr):
    """Generalized decorrelated EXISTS: equality conjuncts hash-partition
    the inner rows; remaining cross-correlation conjuncts (inner col vs
    outer col, e.g. tpch q21's l2.l_suppkey <> l1.l_suppkey) evaluate
    per (outer row, inner candidate). args = eq outer key exprs followed
    by the outer column exprs the cross conjuncts reference."""

    args: list
    n_eq: int
    outer_names: list        # env names for args[n_eq:] in cross conjs
    inner_rows: dict         # eq key tuple → list of {inner name: value}
    cross: list              # conjunct Exprs over inner + outer names
    negated: bool = False

    def eval(self, env, xp):
        n = _env_rows(env)
        cols = [_rows_of(a.eval(env, xp), n) for a in self.args]
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            key = tuple(c[i] for c in cols[:self.n_eq])
            found = False
            if not any(k is None for k in key):
                outer_env = {nm: cols[self.n_eq + j][i]
                             for j, nm in enumerate(self.outer_names)}
                for aux in self.inner_rows.get(key, ()):
                    cenv = {**aux, **outer_env}
                    ok = True
                    for cj in self.cross:
                        r = cj.eval(cenv, np)
                        if isinstance(r, np.ndarray):
                            r = bool(r.all()) if r.size else False
                        if not bool(r):
                            ok = False
                            break
                    if ok:
                        found = True
                        break
            out[i] = (not found) if self.negated else found
        return out

    def columns(self):
        s = set()
        for a in self.args:
            s |= a.columns()
        return s

    def to_sql(self):
        neg = "NOT " if self.negated else ""
        return f"({neg}EXISTS (<correlated subquery>))"


@dataclass(repr=False)
class KeyInSet(Expr):
    """Decorrelated multi-conjunct EXISTS: membership of the outer
    correlation key tuple in the inner key set. A NULL key component
    matches nothing (EXISTS false → NOT EXISTS keeps the row, the
    anti-join rule)."""

    args: list
    keys: set
    negated: bool = False

    def eval(self, env, xp):
        n = _env_rows(env)
        cols = [_rows_of(a.eval(env, xp), n) for a in self.args]
        out = np.zeros(n, dtype=bool)
        for i in range(n):
            key = tuple(c[i] for c in cols)
            m = (not any(k is None for k in key)) and key in self.keys
            out[i] = (not m) if self.negated else m
        return out

    def columns(self):
        s = set()
        for a in self.args:
            s |= a.columns()
        return s

    def to_sql(self):
        neg = "NOT " if self.negated else ""
        return f"({neg}EXISTS (<correlated subquery>))"


@dataclass(repr=False)
class WindowFunc(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ...) — evaluated by the
    relational executor over the post-filter row set; generic eval is
    invalid because window semantics need whole-partition context."""

    name: str
    args: list
    partition_by: list = None    # list[Expr]
    order_by: list = None        # list[(Expr, asc)]
    # frame: None (default: cumulative when ordered, whole partition
    # otherwise) | 'full' | 'cum' | 'rev' (CURRENT ROW → UNBOUNDED
    # FOLLOWING) — the ROWS BETWEEN shapes the reference corpus uses
    frame: str | None = None

    def eval(self, env, xp):
        raise PlanError(
            f"window function {self.name} outside relational context")

    def columns(self):
        out = set()
        for a in self.args:
            out |= a.columns()
        for e in (self.partition_by or []):
            out |= e.columns()
        for e, _ in (self.order_by or []):
            out |= e.columns()
        return out

    def to_sql(self):
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY "
                         + ", ".join(e.to_sql() for e in self.partition_by))
        if self.order_by:
            parts.append("ORDER BY " + ", ".join(
                e.to_sql() + ("" if asc else " DESC")
                for e, asc in self.order_by))
        return (f"{self.name}({', '.join(a.to_sql() for a in self.args)}) "
                f"OVER ({' '.join(parts)})")


# ---------------------------------------------------------------------------
# domain extraction (predicate pushdown)
# ---------------------------------------------------------------------------
def extract_domains(expr: Expr | None, columns: set[str]) -> ColumnDomains:
    """Sound over-approximation of `expr` restricted to `columns` — used to
    push tag/time constraints into the index and file pruning (reference
    predicate::domain push_down_filter). Rows outside the returned domains
    can never satisfy expr; the full expr is still re-checked at execution.
    """
    if expr is None:
        return ColumnDomains.all()
    return _extract(expr, columns)


def _extract(e: Expr, cols: set[str]) -> ColumnDomains:
    if isinstance(e, BinOp):
        if e.op == "and":
            return _extract(e.left, cols).intersect(_extract(e.right, cols))
        if e.op == "or":
            return _extract(e.left, cols).union(_extract(e.right, cols))
        if e.op in ("=", "<", "<=", ">", ">="):
            col, lit, op = _col_lit(e)
            if col is not None and col in cols:
                dom = {
                    "=": lambda v: SetDomain([v]),
                    "<": RangeDomain.lt, "<=": RangeDomain.le,
                    ">": RangeDomain.gt, ">=": RangeDomain.ge,
                }[op](lit)
                return ColumnDomains.of(col, dom)
        return ColumnDomains.all()
    if isinstance(e, InList) and not e.negated and isinstance(e.expr, Column):
        if e.expr.name in cols:
            return ColumnDomains.of(e.expr.name, SetDomain(e.values))
        return ColumnDomains.all()
    if isinstance(e, Between) and not e.negated and isinstance(e.expr, Column):
        if (e.expr.name in cols and isinstance(e.low, Literal)
                and isinstance(e.high, Literal)):
            return ColumnDomains.of(
                e.expr.name,
                RangeDomain.of(low=e.low.value, high=e.high.value))
        return ColumnDomains.all()
    if (isinstance(e, Like) and not e.negated
            and isinstance(e.expr, Column) and isinstance(e.pattern, str)
            and e.expr.name in cols):
        if "%" not in e.pattern and "_" not in e.pattern:
            # wildcard-free LIKE is equality — plus the $-accepts-a-
            # trailing-newline quirk of the host automaton
            return ColumnDomains.of(
                e.expr.name, SetDomain([e.pattern, e.pattern + "\n"]))
        return ColumnDomains.of(e.expr.name, LikeDomain(e.pattern))
    return ColumnDomains.all()


def _col_lit(e: BinOp):
    """Normalize col-op-literal / literal-op-col → (col, lit, op)."""
    flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "="}
    if isinstance(e.left, Column) and isinstance(e.right, Literal):
        return e.left.name, e.right.value, e.op
    if isinstance(e.left, Literal) and isinstance(e.right, Column):
        return e.right.name, e.left.value, flip[e.op]
    return None, None, None


_register_tsfuncs()
