"""The filter stage of the fused program (X2): sql/expr.py's filter
evaluation over device tensors, in numpy's types.

The JAX package evaluates a device filter with `Expr.eval(env, jnp)`,
and jax.numpy with x64 types every operation as numpy does. The port
evaluates the same expression tree over `FilterValue`s, which carry that
typing onto torch tensors, with `TorchXP` as the `xp` namespace.

NULLs follow the host branch (`xp is np` in sql/expr.py), not the JAX
package's device branch. `row_mask` walks the filter's AND, OR and NOT
itself, as the host does: a comparison, IN or BETWEEN is definitely true
where its value is true and every column it reads is valid (the
`__valid__` masks), and NOT takes the definitely-false rows of its
operand (the negated comparison, IN or BETWEEN; sql/expr.py
`_eval_false_mask`). So an OR keeps a row that one branch matched while
the other branch's column is NULL, and NOT of a comparison with NaN is
false, both as on the host. A FilterValue carries the NULLs an integer
x/0 makes through every operator after it.

That walk is a second copy of the host's NULL rules, which act only on
numpy arrays. Each function here mirrors these of sql/expr.py, and a
change to one side's rules goes to the other in the same change:

- `_true`: `BinOp.eval` for AND and OR, `UnaryOp.eval` for NOT (a
  constant's `not`, and `~` of an int);
- `_false`: `_eval_false_mask`;
- `_definite`: `_mask_operand_validity` as `BinOp.eval`, `InList.eval`
  and `_eval_false_mask` (a negated column) call it, and `_obj_binop`'s
  object-array comparison, which skips that mask;
- `TorchXP.truths`: `_cmp_truths`, the true and the false rows of each
  comparison of a BETWEEN;
- `TorchXP.null_where`: `_div`'s integer x/0;
- `row_mask`'s conjunctive mask: ops/tpu_exec.py `host_row_mask`'s mask
  after the filter.

tests/test_torch_device_semantics.py holds the device count to the
port's own host branch and the JAX package's on random filters.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..models.schema import ValueType
from ..sql.expr import Between, BinOp, Column, Expr, InList, Literal, UnaryOp
from .device_cache import U64_BIAS as _BIAS
from .device_cache import DeviceBatch

_NP_DTYPE = {"b": np.dtype(bool), "i": np.dtype(np.int64),
             "u": np.dtype(np.uint64), "f": np.dtype(np.float64)}
_TORCH_DTYPE = {"b": torch.bool, "i": torch.int64, "u": torch.int64,
                "f": torch.float64}


class FilterValue:
    """A column or an intermediate of a filter on the device, with numpy's
    types: bool, int64, uint64 or float64 (`kind` "b", "i", "u", "f").

    sql/expr.py evaluates a filter with the operators and numpy names of
    its operands, and the JAX package gets numpy's promotion from
    jax.numpy with x64. Torch promotes otherwise: an int64 tensor times a
    Python float is float32, int64 / int64 is float32, a bool tensor takes
    no `-`, and uint64 has next to no arithmetic or comparison. So every
    operand of a device filter is one of these, and each operator computes
    in the type numpy gives the pair:

    - a float on either side: float64 (a uint64 converts exactly rounded);
    - uint64 with uint64, or with a Python int (a "weak" scalar: jax.numpy
      takes one inside int64's range and wraps it mod 2^64): uint64 that
      wraps; uint64 with an int64 column: float64;
    - otherwise int64; a BOOLEAN column counts as int64 0/1 in arithmetic
      and comparison (the JAX package stages it as int64) and as a truth
      value in `~`, `&`, `|`.

    A uint64 lives in `t` as its order-preserving int64, u ^ 2^63, so an
    ordered comparison is one int64 comparison; arithmetic un-biases,
    wraps in int64 (two's complement wraps as uint64 does) and re-biases.
    """

    __slots__ = ("t", "kind", "nulls")

    def __init__(self, t: torch.Tensor, kind: str, nulls=None):
        self.t = t
        self.kind = kind
        # the NULLs an integer x/0 made: (where valid, whether the host
        # holds the value as an object array, a 0-d bool), None if none
        self.nulls = nulls

    @property
    def valid(self) -> torch.Tensor | None:
        return None if self.nulls is None else self.nulls[0]

    @property
    def dtype(self):
        return _NP_DTYPE[self.kind]

    @property
    def shape(self):
        return tuple(self.t.shape)

    def __len__(self):
        return self.t.shape[0]

    def __bool__(self):
        # the jitted reference refuses a host branch on a device value
        raise TypeError("the truth value of a device filter value is not "
                        "known on the host")

    def raw(self) -> torch.Tensor:
        """The value's tensor with a uint64 un-biased to its bits."""
        return self.t ^ _BIAS if self.kind == "u" else self.t

    def f64(self) -> torch.Tensor:
        if self.kind == "f":
            return self.t
        if self.kind != "u":
            return self.t.to(torch.float64)
        r = self.raw()
        # two exact halves, one rounding: uint64 → float64 as numpy does
        return ((r >> 32) & 0xFFFFFFFF).to(torch.float64) * 4294967296.0 \
            + (r & 0xFFFFFFFF).to(torch.float64)

    def as_kind(self, kind: str) -> "FilterValue":
        """numpy's astype to another kind."""
        if kind == self.kind:
            return self
        if kind == "f":
            return FilterValue(self.f64(), "f", self.nulls)
        if kind == "b":
            return FilterValue(self.raw() != 0 if self.kind != "f"
                               else self.t != 0, "b", self.nulls)
        if self.kind != "f":
            raw = self.raw().to(torch.int64)
            return FilterValue(raw ^ _BIAS if kind == "u" else raw, kind,
                               self.nulls)
        t = torch.trunc(self.t)   # numpy truncates toward zero
        if kind == "i":
            return FilterValue(t.to(torch.int64), "i", self.nulls)
        # to uint64's biased form: u ^ 2^63 is u - 2^63 as int64, exact
        # in float64 for u >= 2^63 (Sterbenz), and below through int64
        big = t >= 9223372036854775808.0
        lo = t.masked_fill(big, 0).to(torch.int64) ^ _BIAS
        hi = (t.masked_fill(~big, 9223372036854775808.0)
              - 9223372036854775808.0).to(torch.int64)
        return FilterValue(torch.where(big, hi, lo), "u", self.nulls)

    # arithmetic
    def __add__(self, o):
        return _arith(self, o, torch.add)

    def __radd__(self, o):
        return _arith(o, self, torch.add)

    def __sub__(self, o):
        return _arith(self, o, torch.sub)

    def __rsub__(self, o):
        return _arith(o, self, torch.sub)

    def __mul__(self, o):
        return _arith(self, o, torch.mul)

    def __rmul__(self, o):
        return _arith(o, self, torch.mul)

    def __truediv__(self, o):
        return _true_div(self, o)

    def __rtruediv__(self, o):
        return _true_div(o, self)

    def __floordiv__(self, o):
        return _floor_div(self, o)

    def __rfloordiv__(self, o):
        return _floor_div(o, self)

    def __neg__(self):
        if self.kind == "f":
            return FilterValue(-self.t, "f", self.nulls)
        if self.kind == "u":
            return FilterValue((-self.raw()) ^ _BIAS, "u", self.nulls)
        return FilterValue(-self.t.to(torch.int64), "i", self.nulls)

    # comparisons
    def __eq__(self, o):
        return _compare(self, o, torch.eq)

    def __ne__(self, o):
        return _compare(self, o, torch.ne)

    def __lt__(self, o):
        return _compare(self, o, torch.lt)

    def __le__(self, o):
        return _compare(self, o, torch.le)

    def __gt__(self, o):
        return _compare(self, o, torch.gt)

    def __ge__(self, o):
        return _compare(self, o, torch.ge)

    # logic on booleans, bitwise on integers
    def __and__(self, o):
        return _bitwise(self, o, torch.bitwise_and)

    __rand__ = __and__

    def __or__(self, o):
        return _bitwise(self, o, torch.bitwise_or)

    __ror__ = __or__

    def __xor__(self, o):
        return _bitwise(self, o, torch.bitwise_xor)

    __rxor__ = __xor__

    def __invert__(self):
        if self.kind == "f":
            raise TypeError("~ takes a boolean or integer operand")
        # ~(u ^ 2^63) == (~u) ^ 2^63: the biased form inverts in place
        return FilterValue(~self.t, self.kind, self.nulls)


def _nulls(*operands):
    """The NULLs of an operation on `operands`: valid where every one
    is, an object array on the host where any one is."""
    out = None
    for o in operands:
        n = o.nulls if isinstance(o, FilterValue) else None
        if n is not None:
            out = n if out is None else (out[0] & n[0], out[1] | n[1])
    return out


def _scalar_kind(x) -> str | None:
    """The kind of a Python or numpy scalar, None for anything else."""
    if isinstance(x, (bool, np.bool_)):
        return "b"
    if isinstance(x, (int, np.integer)):
        return "i"
    if isinstance(x, (float, np.floating)):
        return "f"
    return None


def _weak(x) -> bool:
    """A Python scalar or a 0-d value: it takes the other operand's type
    (jax.numpy's weak types), as `jnp.where(b == 0, 1, b)` does in
    sql/expr.py's `_div`."""
    return not isinstance(x, FilterValue) or x.t.dim() == 0


def _kind(x) -> str:
    if isinstance(x, FilterValue):
        return x.kind
    k = _scalar_kind(x)
    if k is None:
        raise TypeError(f"a device filter cannot take {type(x).__name__} "
                        "operands")
    return k


def _common(a, b) -> str:
    """The kind numpy computes `a op b` in (booleans count as int64)."""
    ka, kb = _kind(a), _kind(b)
    if "f" in (ka, kb):
        return "f"
    if "u" in (ka, kb):
        other = b if ka == "u" else a
        if _kind(other) == "u" or _weak(other):
            return "u"
        return "f"
    return "i"


def _int_scalar(x) -> int:
    """A Python int as int64 bits. jax.numpy takes a weak int only inside
    int64's range, even against uint64 (where it then wraps mod 2^64);
    outside it raises, and so does this."""
    x = int(x)
    if not -(1 << 63) <= x < (1 << 63):
        raise OverflowError(f"{x} does not fit int64")
    return x


def _as(x, kind: str):
    """Operand `x` in `kind`: a tensor, or a Python scalar torch keeps in
    that kind (an int for int64 and raw uint64 bits, a float for
    float64). uint64 comes back as its raw bits, not biased."""
    if isinstance(x, FilterValue):
        if kind == "f":
            return x.f64()
        t = x.raw()
        return t.to(torch.int64) if t.dtype is torch.bool else t
    if kind == "f":
        return float(x)
    return _int_scalar(x)


def _arith(a, b, op):
    kind = _common(a, b)
    out = op(_tensor(_as(a, kind), a, b), _as(b, kind))
    return FilterValue(out ^ _BIAS if kind == "u" else out, kind,
                       _nulls(a, b))


def _true_div(a, b):
    # numpy's `/` is float64 for every numeric pair
    return FilterValue(torch.div(_tensor(_as(a, "f"), a, b), _as(b, "f")),
                       "f", _nulls(a, b))


def _floor_div(a, b):
    kind = _common(a, b)
    x, y = _tensor(_as(a, kind), a, b), _as(b, kind)
    if kind == "f":
        return FilterValue(torch.floor(x / y), "f", _nulls(a, b))
    if kind == "i":
        return FilterValue(torch.div(x, y, rounding_mode="floor"), "i",
                           _nulls(a, b))
    q, _r = _udivmod(x, y)
    return FilterValue(q ^ _BIAS, "u", _nulls(a, b))


def _udivmod(x: torch.Tensor, y):
    """Unsigned 64-bit division on raw int64 bits: (quotient, remainder).
    A divisor of 0 gives 2^64 - 1 and 0, as jax.numpy does."""
    y = torch.as_tensor(y, dtype=torch.int64, device=x.device)
    zero = y == 0
    d = torch.where(zero, 1, y)
    big = d < 0                 # divisor ≥ 2^63: the quotient is 0 or 1
    d_lo = torch.where(big, 1, d)
    # (x >>> 1) // d, doubled, is at most one short of x // d
    q = torch.div((x >> 1) & 0x7FFFFFFFFFFFFFFF, d_lo,
                  rounding_mode="floor") << 1
    r = x - q * d_lo
    q = q + ((r ^ _BIAS) >= (d_lo ^ _BIAS)).to(torch.int64)
    q = torch.where(big, ((x ^ _BIAS) >= (d ^ _BIAS)).to(torch.int64), q)
    q = torch.where(zero, -1, q)
    r = torch.where(zero, 0, x - q * d)
    return q, r


def _tensor(v, *operands) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    dev = next(o.t.device for o in operands if isinstance(o, FilterValue))
    dt = torch.bool if isinstance(v, bool) else (
        torch.float64 if isinstance(v, float) else torch.int64)
    return torch.tensor(v, dtype=dt, device=dev)


def _compare(a, b, op):
    if isinstance(b, str) or b is None:
        raise TypeError("a device filter compares numbers only")
    kind = _common(a, b)
    if kind == "u":
        # both sides biased: u ^ 2^63 orders as int64
        x, y = (v.t if isinstance(v, FilterValue) and v.kind == "u"
                else _as(v, kind) ^ _BIAS for v in (a, b))
    else:
        x, y = _as(a, kind), _as(b, kind)
    return FilterValue(op(_tensor(x, a, b), y), "b", _nulls(a, b))


def _bitwise(a, b, op):
    if _kind(a) == "b" and _kind(b) == "b":
        x, y = (v.t if isinstance(v, FilterValue) else bool(v)
                for v in (a, b))
        return FilterValue(op(_tensor(x, a, b), y), "b", _nulls(a, b))
    kind = _common(a, b)
    if kind == "f":
        raise TypeError("bitwise operators take boolean or integer operands")
    out = op(_tensor(_as(a, kind), a, b), _as(b, kind))
    return FilterValue(out ^ _BIAS if kind == "u" else out, kind,
                       _nulls(a, b))


def filter_key(x):
    """A filter's whole structure as a hashable key (the fused program's
    cache key): every field of every node with its type, so that nodes
    that print the same SQL (`InList.null_present`, 1 against 1.0) key
    different programs."""
    if isinstance(x, Expr) and dataclasses.is_dataclass(x):
        return (type(x).__name__,) + tuple(
            filter_key(getattr(x, f.name)) for f in dataclasses.fields(x))
    if isinstance(x, (list, tuple)):
        return ("seq",) + tuple(filter_key(v) for v in x)
    try:
        hash(x)
    except TypeError:
        return (type(x).__name__, repr(x))
    return (type(x).__name__, x)


_NEGATED = {"=": "!=", "!=": "=", "<": ">=", "<=": ">", ">": "<=",
            ">=": "<"}


def row_mask(e: Expr, env: dict, xp: "TorchXP", n: int,
             conjunctive: bool) -> torch.Tensor:
    """Filter `e` → the [n] torch.bool mask of the rows where it is
    definitely true, as the host branch takes them. A `conjunctive`
    filter (ops/tpu_exec.is_conjunctive) also drops every row where one
    of its columns is NULL, as the host does after the filter."""
    v = _true(e, env, xp)
    if not isinstance(v, FilterValue):
        m = torch.full((n,), bool(v), dtype=torch.bool, device=xp.device)
    else:
        m = v.t if v.kind == "b" else v.raw() != 0
        m = m.expand(n) if m.numel() == 1 else m
    if conjunctive:
        for c in sorted(e.columns()):
            valid = env.get(f"__valid__:{c}")
            if valid is not None:
                m = m & valid
    return m


def _true(e: Expr, env: dict, xp: "TorchXP"):
    """Where `e` is definitely true: a truth FilterValue, a Python bool
    or int for a constant, or None for NULL. sql/expr.py's host
    evaluation (an int where it gives one, as `NOT` of an integer):
    AND and OR of their operands' definite truths (NULL if either is
    NULL), NOT the definite falsehood of its operand, and any other node
    its value where every operand is valid."""
    if isinstance(e, BinOp) and e.op in ("and", "or"):
        a, b = _true(e.left, env, xp), _true(e.right, env, xp)
        if a is None or b is None:
            return None
        return a & b if e.op == "and" else a | b
    if isinstance(e, UnaryOp) and e.op == "not":
        f = _false(e.operand, env, xp)
        if f is not None:
            return f
        if isinstance(e.operand, (BinOp, UnaryOp)) \
                and e.operand.op in ("and", "or", "not"):
            v = _true(e.operand, env, xp)
            return v if v is None else (
                not v if isinstance(v, bool) else ~v)
        return _definite(e.operand.eval(env, xp), e.operand, env, xp,
                         invert=True)
    return _definite(e.eval(env, xp), e, env, xp)


def _false(e: Expr, env: dict, xp: "TorchXP"):
    """Where `e` is definitely false, or None where that is not derived
    (sql/expr.py `_eval_false_mask`): a comparison's is the negated
    comparison, IN's and BETWEEN's the negated node, so NaN is neither
    true nor false under NOT, as on the host."""
    if isinstance(e, BinOp):
        if e.op in ("and", "or"):
            fa, fb = _false(e.left, env, xp), _false(e.right, env, xp)
            if fa is None or fb is None:
                return None
            return fa | fb if e.op == "and" else fa & fb
        neg = _NEGATED.get(e.op)
        return None if neg is None \
            else _bool(_true(BinOp(neg, e.left, e.right), env, xp))
    if isinstance(e, UnaryOp) and e.op == "not":
        v = _true(e.operand, env, xp)
        return v if isinstance(v, FilterValue) else None
    if isinstance(e, Between):
        return _bool(_true(Between(e.expr, e.low, e.high, not e.negated),
                           env, xp))
    if isinstance(e, InList):
        return _bool(_true(InList(e.expr, e.values, not e.negated,
                                  e.null_present), env, xp))
    if isinstance(e, Column):
        v = e.eval(env, xp)
        return _definite(v, e, env, xp, invert=True) \
            if isinstance(v, FilterValue) else None
    if isinstance(e, Literal):
        return None if e.value is None else (not bool(e.value))
    return None


def _bool(v):
    """As `np.asarray(v, dtype=bool)` takes a constant."""
    return bool(v) if isinstance(v, int) else v


def _definite(v, e: Expr, env: dict, xp: "TorchXP", invert=False):
    """Node `e`'s value `v` (negated, with `invert`) as a definite truth:
    false where an integer x/0 made it NULL, and for a comparison, IN,
    BETWEEN and a negated column false where one of the columns it reads
    is NULL, where the host masks (`_mask_operand_validity`); any other
    node keeps its value there, as on the host (a NULL slot holds 0). A
    boolean is itself, an integer is true where it is not 0, as
    `np.asarray(v, dtype=bool)` takes it; a float is refused, as the JAX
    package's device branch refuses it."""
    if v is None:
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v) != invert
    if isinstance(v, (int, np.integer)):
        return ~int(v) if invert else int(v)
    if isinstance(v, np.ndarray) and v.dtype.kind in "biu":
        # a host-evaluated constant predicate (LIKE over literals)
        kind = "b" if v.dtype == bool else "i"
        v = FilterValue(torch.as_tensor(
            v if kind == "b" else v.astype(np.int64),
            device=xp.device).reshape(-1), kind)
    if not isinstance(v, FilterValue):
        raise TypeError(f"a filter gave {type(v).__name__}, not a predicate")
    if v.kind == "f":
        raise TypeError("a filter gave float64 values, not a predicate")
    m = v.t if v.kind == "b" else v.raw() != 0
    if v.valid is not None:
        # a NULL an integer x/0 made is false in a comparison, before
        # IN's own negation (sql/expr.py `_obj_binop`)
        if isinstance(e, InList) and e.negated:
            m = m | ~v.valid
        else:
            m = m & v.valid
    if invert:
        m = ~m
    # BETWEEN masks each of its comparisons itself (`TorchXP.truths`)
    if isinstance(e, InList) or invert and isinstance(e, Column) \
            or isinstance(e, BinOp) and e.op in _NEGATED:
        masked = m
        for c in sorted(e.columns()):
            valid = env.get(f"__valid__:{c}")
            if valid is not None:
                masked = masked & valid
        if v.nulls is not None and isinstance(e, BinOp):
            # a comparison of an object array returns before the host's
            # column masking (sql/expr.py `BinOp.eval`, `_obj_binop`)
            masked = torch.where(v.nulls[1], m, masked)
        m = masked
    return FilterValue(m, "b")


# numpy names whose result is float64 for any numeric input
_FLOAT_FNS = {
    "sqrt": torch.sqrt, "exp": torch.exp, "log": torch.log,
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "radians": torch.deg2rad, "degrees": torch.rad2deg,
}


class TorchXP:
    """The numpy names sql/expr.py evaluates filters with
    (expr.py:98-227, 931-975, 1315-1322), over FilterValues on one
    device, with numpy's result types."""

    pi = math.pi
    int64 = np.int64

    def __init__(self, device: torch.device):
        self.device = device

    def asarray(self, a) -> FilterValue:
        if isinstance(a, FilterValue):
            return a
        kind = _kind(a)
        v = _as(a, kind) if kind != "b" else bool(a)
        return FilterValue(torch.tensor(v, dtype=_TORCH_DTYPE[kind],
                                        device=self.device), kind)

    def zeros(self, shape, dtype=None) -> FilterValue:
        kind = "f" if dtype is None else np.dtype(dtype).kind
        return FilterValue(torch.zeros(shape, dtype=_TORCH_DTYPE[kind],
                                       device=self.device), kind)

    def where(self, cond, a, b) -> FilterValue:
        c = self.asarray(cond)
        kind = _common(a, b)
        if not isinstance(a, FilterValue) and not isinstance(b, FilterValue):
            kind = _kind(a) if _kind(a) == _kind(b) else kind
        x, y = (self._in(v, kind) for v in (a, b))
        return FilterValue(torch.where(c.as_kind("b").t, x, y), kind,
                           _nulls(c, a, b))

    def null_where(self, cond, a) -> FilterValue:
        """`a`, NULL where `cond` holds (sql/expr.py's integer x/0)."""
        a, c = self.asarray(a), self.asarray(cond).as_kind("b")
        ok = ~c.t if c.valid is None else ~c.t & c.valid
        # the host holds the quotient as an object array, None at x/0,
        # when any divisor is 0 (a NULL slot's 0 included)
        return FilterValue(a.t, a.kind, _nulls(a, FilterValue(
            c.t, "b", (ok, c.t.any()))))

    def cast(self, a, kind: str, vm) -> tuple[FilterValue, bool]:
        """sql/expr.py's strict CAST of a device value to a number or a
        truth value, with numpy's conversions. → (the value, whether it
        failed: NaN or ±inf to an integer, a negative to an unsigned).
        A row where `vm` (the operand column's validity, None for
        another operand) is false cannot fail, as on the host."""
        a = self.asarray(a)
        if kind not in _NP_DTYPE:
            raise TypeError(f"a device filter cannot CAST to {kind!r}")
        bad = None
        if kind in "iu" and a.kind == "f":
            bad = ~torch.isfinite(a.t)
        if kind == "u" and a.kind in "if":
            bad = a.t < 0 if bad is None else bad | (a.t < 0)
        if bad is None:
            return a.as_kind(kind), False
        seen = bad if vm is None else bad & vm
        failed = bool(seen.any())  # lint: disable=host-sync (a strict CAST that can fail raises as the host's does: one flag, only for float→integer and →unsigned)
        safe = FilterValue(a.t.masked_fill(bad, 0), a.kind, a.nulls)
        return safe.as_kind(kind), failed

    def _in(self, v, kind: str) -> torch.Tensor:
        """`v` in `kind`'s stored form (uint64 biased, booleans as
        booleans) as a tensor on the device."""
        if kind == "b":
            return self.asarray(v).as_kind("b").t
        if isinstance(v, FilterValue) and v.kind == kind:
            return v.t
        x = _as(v, kind)
        if kind == "u":
            x = x ^ _BIAS
        return torch.as_tensor(x, dtype=_TORCH_DTYPE[kind],
                               device=self.device)

    def truths(self, r, env: dict, columns) -> tuple:
        """A comparison's value `r` → (where it is true, where it is
        false), neither where an integer x/0 made an operand NULL or one
        of `columns` (those its operands read) is NULL (sql/expr.py
        `_cmp_truths`, the host's)."""
        if not isinstance(r, FilterValue):
            r = bool(r)
            return r, not r
        known = r.valid
        for c in sorted(columns):
            valid = env.get(f"__valid__:{c}")
            if valid is not None:
                known = valid if known is None else known & valid
        true, false = r.t, ~r.t
        if known is not None:
            true, false = true & known, false & known
        return FilterValue(true, "b"), FilterValue(false, "b")

    def all(self, a) -> FilterValue:
        return FilterValue(torch.all(self.asarray(a).as_kind("b").t), "b")

    def isnan(self, a) -> FilterValue:
        a = self.asarray(a)
        if a.kind == "f":
            return FilterValue(torch.isnan(a.t), "b", a.nulls)
        return FilterValue(torch.zeros_like(a.t, dtype=torch.bool), "b",
                           a.nulls)

    def abs(self, a) -> FilterValue:
        a = self.asarray(a)
        if a.kind == "u":
            return a
        kind = "f" if a.kind == "f" else "i"
        return FilterValue(torch.abs(_as(a, kind)), kind, a.nulls)

    def _int_kept(self, a, op) -> FilterValue:
        # jax.numpy's floor/ceil/trunc/round return an integer unchanged
        a = self.asarray(a)
        if a.kind != "f":
            return a.as_kind("i") if a.kind == "b" else a
        return FilterValue(op(a.t), "f", a.nulls)

    def floor(self, a):
        return self._int_kept(a, torch.floor)

    def ceil(self, a):
        return self._int_kept(a, torch.ceil)

    def trunc(self, a):
        return self._int_kept(a, torch.trunc)

    def round(self, a, decimals=0):
        d = int(decimals)
        a = self.asarray(a)
        if a.kind != "f" and d < 0:
            raise NotImplementedError(
                "integer round is not implemented for decimals < 0")
        return self._int_kept(a, lambda t: torch.round(t, decimals=d))

    def cbrt(self, a) -> FilterValue:
        a = self.asarray(a)
        t = a.f64()
        return FilterValue(torch.sign(t) * torch.pow(torch.abs(t),
                                                     1.0 / 3.0), "f", a.nulls)

    def arctan2(self, a, b) -> FilterValue:
        return FilterValue(torch.atan2(*(self.asarray(v).f64()
                                         for v in (a, b))), "f",
                           _nulls(a, b))

    def fmod(self, a, b) -> FilterValue:
        """C's remainder; an integer remainder by 0 is 0, as in
        jax.numpy."""
        kind = _common(a, b)
        x, y = self._in(a, kind), self._in(b, kind)
        if kind == "f":
            return FilterValue(torch.fmod(x, y), "f", _nulls(a, b))
        if kind == "u":
            _q, r = _udivmod(x ^ _BIAS, y ^ _BIAS)
            return FilterValue(r ^ _BIAS, "u", _nulls(a, b))
        zero = y == 0
        r = torch.fmod(x, torch.where(zero, 1, y))
        return FilterValue(torch.where(zero, 0, r), "i", _nulls(a, b))

    def power(self, a, b) -> FilterValue:
        kind = _common(a, b)
        x, y = self._in(a, kind), self._in(b, kind)
        if kind == "u":
            return FilterValue(torch.pow(x ^ _BIAS, y ^ _BIAS) ^ _BIAS, "u",
                               _nulls(a, b))
        if kind == "i" and not isinstance(b, FilterValue) and int(b) < 0:
            # jax.numpy refuses a negative integer literal exponent
            raise TypeError("integers cannot be raised to negative powers")
        return FilterValue(torch.pow(x, y), kind, _nulls(a, b))

    def _int_pair(self, a, b, op) -> FilterValue:
        a, b = self.asarray(a), self.asarray(b)
        if "f" in (a.kind, b.kind):
            raise TypeError("gcd/lcm take integer operands")
        return FilterValue(op(_as(a, "i"), _as(b, "i")), "i", _nulls(a, b))

    def gcd(self, a, b):
        return self._int_pair(a, b, torch.gcd)

    def lcm(self, a, b):
        return self._int_pair(a, b, torch.lcm)

    def __getattr__(self, name):
        fn = _FLOAT_FNS.get(name)
        if fn is None:
            raise AttributeError(name)

        def call(a):
            a = self.asarray(a)
            return FilterValue(fn(a.f64()), "f", a.nulls)
        return call


def filter_env(dbatch: DeviceBatch, names) -> dict:
    """The environment a filter evaluates in: each column a FilterValue
    of its SQL type (a BOOLEAN a truth value, an UNSIGNED its biased
    int64 from the staging), and the `__valid__:` mask of each column
    that has NULLs. A column's NULLs ride in that mask, not in its
    value's validity: as on the host, a node is masked by the validity of
    the columns it reads once it is evaluated, after BETWEEN's or IN's
    negation. A NULL slot holds 0, as the host's does."""
    env = {}
    for name in names:
        vt, vals, valid = dbatch.fields[name]
        kind = "b" if vt == ValueType.BOOLEAN else (
            "u" if vt == ValueType.UNSIGNED else (
                "f" if vals.dtype.is_floating_point else "i"))
        if valid is not None:
            vals = vals.masked_fill(~valid, -(1 << 63) if kind == "u" else 0)
        env[name] = FilterValue(vals != 0 if kind == "b" else vals, kind)
        if valid is not None:
            env[f"__valid__:{name}"] = valid
    return env
