"""Scalar expression AST + binder + torch evaluators (port of
ballista_tpu/exprs.py).

An expression is bound against a Schema at plan time, producing a closure
`(Batch) -> Column` that runs eagerly on the batch's device.

- Three-valued (Kleene) NULL logic carried as validity masks.
- DECIMAL arithmetic on scaled int64 (exact, like Arrow decimal128).
- String comparisons with literals are translated into dictionary-code
  space at bind time: on a sorted dictionary code order is lexicographic
  order. A RAW column (`Schema.unsorted`: the dictionary is the column's
  values in row order, code == row index) answers =, != and IN through a
  boolean LUT over its values; a range compare, and every key use above
  (grouping, sorting, joining, min/max, window keys), re-encodes it first
  (`sorted_recode`: a dense-rank LUT onto its sorted distinct values). Two
  RAW columns are never compared with each other.
- LIKE, IN over strings, string CASE and the string functions (substring,
  upper, trim, replace, length, concat, ...) are host work over the
  dictionary, once at bind time; the device only gathers a lookup table
  by code.
- User-defined scalar functions (`register_udf`) are Python functions of
  torch tensors.
"""

from __future__ import annotations

import calendar
import dataclasses
import datetime
import re
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .schema import (BOOL, DATE32, DataType, Field, FLOAT32, FLOAT64, INT32,
                     INT64, Schema, STRING, TypeKind, decimal)
from .batch import Batch, Column, _sorted_distinct

# ---------------------------------------------------------------------------
# AST nodes (logical expressions — used by the SQL frontend & DataFrame API)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Expr:
    def __str__(self):
        return expr_name(self)

    # -- DataFrame-API operator sugar (DataFusion python-binding style).
    # NOTE: __eq__ stays structural (dataclass) so exprs work in dicts/sets;
    # use .eq()/.neq() to build equality predicates.
    def _bin(self, op, other, swap=False):
        other = other if isinstance(other, Expr) else Lit(other)
        return BinOp(op, other, self) if swap else BinOp(op, self, other)

    def __gt__(self, o):
        return self._bin(">", o)

    def __ge__(self, o):
        return self._bin(">=", o)

    def __lt__(self, o):
        return self._bin("<", o)

    def __le__(self, o):
        return self._bin("<=", o)

    def __add__(self, o):
        return self._bin("+", o)

    def __radd__(self, o):
        return self._bin("+", o, swap=True)

    def __sub__(self, o):
        return self._bin("-", o)

    def __rsub__(self, o):
        return self._bin("-", o, swap=True)

    def __mul__(self, o):
        return self._bin("*", o)

    def __rmul__(self, o):
        return self._bin("*", o, swap=True)

    def __truediv__(self, o):
        return self._bin("/", o)

    def __rtruediv__(self, o):
        return self._bin("/", o, swap=True)

    def __and__(self, o):
        return self._bin("and", o)

    def __or__(self, o):
        return self._bin("or", o)

    def __invert__(self):
        return Not(self)

    def __neg__(self):
        return Neg(self)

    def eq(self, o):
        return self._bin("=", o)

    def neq(self, o):
        return self._bin("!=", o)

    def is_null(self):
        return IsNull(self)

    def is_not_null(self):
        return IsNull(self, negated=True)

    def alias(self, name):
        return Alias(self, name)


@dataclasses.dataclass(frozen=True)
class Col(Expr):
    name: str


@dataclasses.dataclass(frozen=True)
class Lit(Expr):
    value: Any
    dtype: Optional[DataType] = None  # inferred if None


@dataclasses.dataclass(frozen=True)
class IntervalLit(Expr):
    """SQL INTERVAL literal; only exists pre-folding (date +/- interval)."""
    months: int = 0
    days: int = 0


@dataclasses.dataclass(frozen=True)
class BinOp(Expr):
    op: str  # + - * / and or = != < <= > >=
    left: Expr
    right: Expr


@dataclasses.dataclass(frozen=True)
class Not(Expr):
    child: Expr


@dataclasses.dataclass(frozen=True)
class Neg(Expr):
    child: Expr


@dataclasses.dataclass(frozen=True)
class IsNull(Expr):
    child: Expr
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Cast(Expr):
    child: Expr
    dtype: DataType


@dataclasses.dataclass(frozen=True)
class Case(Expr):
    # CASE WHEN c1 THEN v1 ... ELSE e END  (searched form)
    whens: Tuple[Tuple[Expr, Expr], ...]
    otherwise: Optional[Expr] = None


@dataclasses.dataclass(frozen=True)
class InList(Expr):
    child: Expr
    values: Tuple[Expr, ...]
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Like(Expr):
    child: Expr
    pattern: str
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Between(Expr):
    child: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Alias(Expr):
    child: Expr
    name: str


@dataclasses.dataclass(frozen=True)
class ScalarFn(Expr):
    name: str  # extract_year, abs, coalesce, ...
    args: Tuple[Expr, ...]


def expr_name(e: Expr) -> str:
    """Display/output name of an expression (column header)."""
    if isinstance(e, Alias):
        return e.name
    if isinstance(e, Col):
        return e.name
    if isinstance(e, Lit):
        return str(e.value)
    if isinstance(e, BinOp):
        return f"{expr_name(e.left)} {e.op} {expr_name(e.right)}"
    if isinstance(e, Cast):
        return expr_name(e.child)
    if isinstance(e, Case):
        return "case"
    if isinstance(e, ScalarFn):
        return f"{e.name}({', '.join(expr_name(a) for a in e.args)})"
    if isinstance(e, Like):
        return f"{expr_name(e.child)} LIKE {e.pattern!r}"
    if isinstance(e, IsNull):
        return f"{expr_name(e.child)} IS {'NOT ' if e.negated else ''}NULL"
    if isinstance(e, Not):
        return f"NOT {expr_name(e.child)}"
    if isinstance(e, Neg):
        return f"-{expr_name(e.child)}"
    if isinstance(e, InList):
        return f"{expr_name(e.child)} IN (...)"
    if isinstance(e, Between):
        return f"{expr_name(e.child)} BETWEEN"
    # SQL-layer nodes (e.g. AggCall) duck-type through kind/arg
    kind = getattr(e, "kind", None)
    if kind is not None:
        if kind == "count_star":
            return "count(*)"
        arg = getattr(e, "arg", None)
        return f"{kind}({expr_name(arg) if arg is not None else '*'})"
    return type(e).__name__.lower()


def expr_columns(e: Expr) -> set:
    """Set of column names referenced by an expression."""
    out = set()

    def walk(x):
        if isinstance(x, Col):
            out.add(x.name)
        for f in dataclasses.fields(x):
            v = getattr(x, f.name)
            if isinstance(v, Expr):
                walk(v)
            elif isinstance(v, tuple):
                for item in v:
                    if isinstance(item, Expr):
                        walk(item)
                    elif isinstance(item, tuple):
                        for sub in item:
                            if isinstance(sub, Expr):
                                walk(sub)
    walk(e)
    return out


# ---------------------------------------------------------------------------
# Literal inference & date helpers
# ---------------------------------------------------------------------------

EPOCH = datetime.date(1970, 1, 1)


def parse_date(s: str) -> int:
    d = datetime.date.fromisoformat(s)
    return (d - EPOCH).days


def add_months(days: int, months: int) -> int:
    """Days since the epoch, `months` calendar months later; the day of
    the month is clipped to the target month's length (Jan 31 + 1 month
    is Feb 28/29)."""
    d = EPOCH + datetime.timedelta(days=days)
    y = d.year + (d.month - 1 + months) // 12
    m = (d.month - 1 + months) % 12 + 1
    day = min(d.day, calendar.monthrange(y, m)[1])
    return (datetime.date(y, m, day) - EPOCH).days


def infer_lit_dtype(value: Any) -> DataType:
    if isinstance(value, bool):
        return BOOL
    if isinstance(value, int):
        return INT64
    if isinstance(value, float):
        return FLOAT64
    if isinstance(value, datetime.date):
        return DATE32
    if isinstance(value, str):
        return STRING
    raise TypeError(f"cannot infer literal type for {value!r}")


# ---------------------------------------------------------------------------
# Bound expressions — evaluators over torch batches
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Bound:
    dtype: DataType
    nullable: bool
    # fn(batch) -> Column; closure over column indices / folded constants
    fn: Callable[[Batch], Column]
    # for string columns: the dictionary the codes index into (sorted,
    # unless dict_sorted is False)
    dictionary: Optional[np.ndarray] = None
    # static exclusive upper bound on the value domain when known
    # (dictionary size, 2 for bool) — lets the aggregate planner use
    # direct composite group slots instead of a hash table
    code_bound: Optional[int] = None
    # ingest-time (lo, hi) value bounds for integer/date/decimal columns
    int_bound: Optional[tuple] = None
    # static bound on the number of distinct values, where tighter than
    # code_bound or the int_bound width (date_trunc('year') over 7 years
    # of dates: 7); feeds the aggregate's group-count bound
    ndv_bound: Optional[int] = None
    # False for a RAW string column: `dictionary` is the column verbatim
    # (duplicates; code == row index). LUT predicates work on it; code
    # order and code equality do not (`sorted_recode` restores both)
    dict_sorted: bool = True


def _const_column(value, dtype: DataType, valid: bool = True):
    """A literal as a capacity-long column: a 0-d tensor expanded to the
    batch's capacity (a view, so no capacity-sized fill or allocation)."""
    def fn(batch: Batch) -> Column:
        cap, dev = batch.capacity, batch.device
        data = torch.full((), value, dtype=dtype.torch_dtype, device=dev)
        validity = torch.full((), valid, dtype=torch.bool, device=dev)
        return Column(data.expand(cap), validity.expand(cap))
    return fn


def _i64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64)


def _decimal_rescale(data, from_scale: int, to_scale: int):
    if to_scale == from_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    # scale down with round-half away from zero (SQL decimal rounding)
    return _div_round_half(data, 10 ** (from_scale - to_scale))


def _div_round_half(num, den):
    """Integer division rounding half away from zero (SQL decimal rounding).
    `den` is a tensor or a Python int."""
    num = _i64(num)
    den = torch.as_tensor(den, dtype=torch.int64, device=num.device)
    neg = (num < 0) != (den < 0)
    anum = num.abs()
    aden = den.abs()
    q = torch.div(anum + torch.div(aden, 2, rounding_mode="floor"),
                  aden.clamp(min=1), rounding_mode="floor")
    return torch.where(neg, -q, q)


_POW10 = np.array([10 ** i for i in range(19)], dtype=np.int64)


def _div_scaled(a, b, m: int):
    """round(a * 10^m / b) for int64 mantissas without overflowing int64.

    Exact path (denominators < ~9.2e17, i.e. everything but near-int64-max
    sums): base-10 long division — q/r of a by b, then m shift-remainder
    steps, so a*10^m is never materialized. Huge denominators fall back to
    rounding low digits off the denominator, keeping ~15 significant
    digits. Same arithmetic as ballista_tpu/exprs.py _div_scaled."""
    a = _i64(a)
    b = _i64(b)
    if m == 0:
        return _div_round_half(a, b)
    pow10 = torch.as_tensor(_POW10, device=a.device)
    neg = (a < 0) != (b < 0)
    aa = a.abs()
    ab = b.abs().clamp(min=1)

    # exact long division (valid while r*10 can't overflow: ab <= ~9.2e17)
    q = torch.div(aa, ab, rounding_mode="floor")
    r = aa - q * ab
    for _ in range(m):
        r10 = r * 10
        d = torch.div(r10, ab, rounding_mode="floor")
        q = q * 10 + d
        r = r10 - d * ab
    q_exact = q + (2 * r >= ab).to(torch.int64)

    # approximate fallback for huge denominators
    digits = (aa.unsqueeze(-1) >= pow10[1:]).sum(dim=-1)
    k1 = (18 - digits).clamp(0, m)
    a1 = aa * pow10[k1]
    bden = pow10[(m - k1).clamp(0, 18)]
    b1 = torch.div(ab + torch.div(bden, 2, rounding_mode="floor"), bden,
                   rounding_mode="floor").clamp(min=1)
    q_approx = torch.div(a1 + torch.div(b1, 2, rounding_mode="floor"), b1,
                         rounding_mode="floor")

    q = torch.where(ab <= 9 * 10 ** 17, q_exact, q_approx)
    return torch.where(neg, -q, q)


def _is_float(dt: DataType) -> bool:
    return dt.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64)


def _coerce_numeric(l: Bound, r: Bound):
    """Promote two numeric bound exprs to a common dtype; returns (dtype, fl, fr)
    where fl/fr map raw Columns to promoted data tensors."""
    lt, rt = l.dtype, r.dtype
    if lt.kind is TypeKind.DECIMAL or rt.kind is TypeKind.DECIMAL:
        # ints coerce to decimal scale 0; floats force the float path,
        # and decimal x float is FLOAT32 (the reference's coercion)
        if _is_float(lt) or _is_float(rt):
            def to_float(b: Bound):
                s = b.dtype.scale if b.dtype.kind is TypeKind.DECIMAL else 0
                div = float(10 ** s)
                return lambda c: c.data.to(torch.float32) / div
            return FLOAT32, to_float(l), to_float(r)
        ls = lt.scale if lt.kind is TypeKind.DECIMAL else 0
        rs = rt.scale if rt.kind is TypeKind.DECIMAL else 0
        target = max(ls, rs)
        return (decimal(18, target),
                lambda c: _decimal_rescale(_i64(c.data), ls, target),
                lambda c: _decimal_rescale(_i64(c.data), rs, target))
    for kind, out in ((TypeKind.FLOAT64, FLOAT64), (TypeKind.FLOAT32, FLOAT32),
                      (TypeKind.INT64, INT64)):
        if lt.kind is kind or rt.kind is kind:
            td = out.torch_dtype
            return out, (lambda c: c.data.to(td)), (lambda c: c.data.to(td))
    return (INT32, (lambda c: c.data.to(torch.int32)),
            (lambda c: c.data.to(torch.int32)))


def _trunc_div(a, b):
    """SQL integer division: truncates toward zero (b must be nonzero)."""
    return torch.div(a, b, rounding_mode="trunc")


def _scaled_bound(b: Optional[tuple], k: int) -> Optional[tuple]:
    """Value bounds of a scaled integer multiplied by 10^k (k >= 0), or
    divided by 10^-k with rounding (k < 0: widened by one)."""
    if b is None:
        return None
    if k >= 0:
        return (b[0] * 10 ** k, b[1] * 10 ** k)
    return (b[0] // 10 ** -k - 1, b[1] // 10 ** -k + 1)


def _arith_bound(op: str, lb: Optional[tuple],
                 rb: Optional[tuple]) -> Optional[tuple]:
    """Interval arithmetic: the bounds of l op r for + - *."""
    if lb is None or rb is None:
        return None
    if op == "+":
        return (lb[0] + rb[0], lb[1] + rb[1])
    if op == "-":
        return (lb[0] - rb[1], lb[1] - rb[0])
    ends = [x * y for x in lb for y in rb]
    return (min(ends), max(ends))


def _bound_at(b: Bound, out: DataType) -> Optional[tuple]:
    """The value bounds of an integer or decimal `b` at `out`'s scale."""
    if b.dtype.kind is not TypeKind.DECIMAL and not b.dtype.is_integer:
        return None
    return _scaled_bound(b.int_bound, out.scale - b.dtype.scale)


def _hull(bounds) -> Optional[tuple]:
    if any(b is None for b in bounds) or not bounds:
        return None
    return (min(b[0] for b in bounds), max(b[1] for b in bounds))


def _bind_arith(op: str, l: Bound, r: Bound) -> Bound:
    lt, rt = l.dtype, r.dtype
    dec = lt.kind is TypeKind.DECIMAL or rt.kind is TypeKind.DECIMAL
    if dec and not (_is_float(lt) or _is_float(rt)):
        ls = lt.scale if lt.kind is TypeKind.DECIMAL else 0
        rs = rt.scale if rt.kind is TypeKind.DECIMAL else 0
        if op in ("+", "-"):
            ts = max(ls, rs)
            ib = _arith_bound(op, _scaled_bound(l.int_bound, ts - ls),
                              _scaled_bound(r.int_bound, ts - rs))

            def fn(batch):
                lc, rc = l.fn(batch), r.fn(batch)
                a = _decimal_rescale(_i64(lc.data), ls, ts)
                b = _decimal_rescale(_i64(rc.data), rs, ts)
                return Column(a + b if op == "+" else a - b,
                              lc.validity & rc.validity)
            return Bound(decimal(18, ts), l.nullable or r.nullable, fn,
                         int_bound=ib)
        if op == "*":
            def fn(batch):
                lc, rc = l.fn(batch), r.fn(batch)
                return Column(_i64(lc.data) * _i64(rc.data),
                              lc.validity & rc.validity)
            return Bound(decimal(18, ls + rs), l.nullable or r.nullable, fn,
                         int_bound=_arith_bound("*", l.int_bound,
                                                r.int_bound))
        if op == "/":
            # result scale: keep 4 extra digits beyond the wider input scale
            ts = min(max(ls, rs) + 4, 12)
            m = ts - ls + rs  # result = a * 10^m / b

            def fn(batch):
                lc, rc = l.fn(batch), r.fn(batch)
                den = _i64(rc.data)
                return Column(_div_scaled(lc.data, den, m),
                              lc.validity & rc.validity & (den != 0))
            return Bound(decimal(18, ts), True, fn)
        if op == "%":
            # remainder at the wider scale; sign follows the dividend
            ts = max(ls, rs)

            def fn(batch):
                lc, rc = l.fn(batch), r.fn(batch)
                a = _decimal_rescale(_i64(lc.data), ls, ts)
                b = _decimal_rescale(_i64(rc.data), rs, ts)
                bs = torch.where(b == 0, torch.ones_like(b), b)
                return Column(a - _trunc_div(a, bs) * bs,
                              lc.validity & rc.validity & (b != 0))
            return Bound(decimal(18, ts), True, fn)
        raise ValueError(f"unsupported decimal op {op}")
    out, fl, fr = _coerce_numeric(l, r)

    def fn(batch):
        lc, rc = l.fn(batch), r.fn(batch)
        a, b = fl(lc), fr(rc)
        v = lc.validity & rc.validity
        if op == "+":
            d = a + b
        elif op == "-":
            d = a - b
        elif op == "*":
            d = a * b
        elif op in ("/", "%"):
            bs = torch.where(b == 0, torch.ones_like(b), b)
            if out.is_integer:
                # SQL semantics: / truncates toward zero and % takes the
                # dividend's sign (not Python floor division)
                q = _trunc_div(a, bs)
                d = q if op == "/" else a - q * bs
            else:
                d = a / bs if op == "/" else torch.fmod(a, bs)
            v = v & (b != 0)
        else:
            raise ValueError(op)
        return Column(d.to(out.torch_dtype), v)
    return Bound(out, l.nullable or r.nullable or op in ("/", "%"), fn)


_COMPARE = {"=": torch.eq, "!=": torch.ne, "<>": torch.ne, "<": torch.lt,
            "<=": torch.le, ">": torch.gt, ">=": torch.ge}


def _bind_compare(op: str, l: Bound, r: Bound) -> Bound:
    lt, rt = l.dtype, r.dtype
    if lt.kind is TypeKind.STRING and rt.kind is TypeKind.STRING:
        if not (l.dict_sorted and r.dict_sorted):
            # raw codes are row indices, not value identities
            raise NotImplementedError(
                "comparison between high-cardinality raw string columns "
                "(raise BALLISTA_RAW_DICT_MAX to dictionary-encode)")
        # both already in code space (literal translated by bind_expr)
        fl = fr = lambda c: c.data
    elif lt.kind is TypeKind.DATE32 or rt.kind is TypeKind.DATE32:
        fl = fr = lambda c: c.data.to(torch.int32)
    else:
        _, fl, fr = _coerce_numeric(l, r)
    cmp = _COMPARE[op]

    def fn(batch):
        lc, rc = l.fn(batch), r.fn(batch)
        return Column(cmp(fl(lc), fr(rc)), lc.validity & rc.validity)
    return Bound(BOOL, l.nullable or r.nullable, fn)


def _bind_bool(op: str, l: Bound, r: Bound) -> Bound:
    """Kleene three-valued AND/OR."""
    def fn(batch):
        lc, rc = l.fn(batch), r.fn(batch)
        lv, rv = lc.validity, rc.validity
        lval = lc.data.to(torch.bool)
        rval = rc.data.to(torch.bool)
        if op == "and":
            # false if either is definitely false; null if unknown
            valid = (lv & rv) | (lv & ~lval) | (rv & ~rval)
            return Column(lval & rval & valid, valid)
        valid = (lv & rv) | (lv & lval) | (rv & rval)
        return Column((lval & lv) | (rval & rv), valid)
    return Bound(BOOL, l.nullable or r.nullable, fn)


def _string_lit_to_code(value: str, dictionary: Optional[np.ndarray]):
    """(searchsorted position, exact match) of a string literal in a sorted
    dictionary: code-space equivalents of comparisons with the literal."""
    if dictionary is None or len(dictionary) == 0:
        return -1, False
    d = dict_str(dictionary)
    pos = int(np.searchsorted(d, value))
    return pos, pos < len(d) and d[pos] == value


def _bind_lit(e: Lit) -> Bound:
    dtype = e.dtype or infer_lit_dtype(e.value)
    v = e.value
    if v is None:
        return Bound(dtype, True, _const_column(0, dtype, valid=False))
    if dtype.kind is TypeKind.STRING and isinstance(v, str):
        # standalone string literal: a one-entry dictionary, code 0
        return Bound(STRING, False, _const_column(0, INT32),
                     dictionary=np.array([v], dtype=object), code_bound=1)
    if dtype.kind is TypeKind.DATE32 and isinstance(v, str):
        v = parse_date(v)
    elif dtype.kind is TypeKind.DATE32 and isinstance(v, datetime.date):
        v = (v - EPOCH).days
    elif dtype.kind is TypeKind.DECIMAL:
        from decimal import Decimal
        v = int(Decimal(str(v)).scaleb(dtype.scale).to_integral_value())
        # strip trailing zeros (100.00 -> 100 scale 0): keeps downstream
        # arithmetic scales — and int64 headroom — as small as possible
        scale = dtype.scale
        while scale > 0 and v % 10 == 0:
            v //= 10
            scale -= 1
        dtype = decimal(dtype.precision, scale)
    ib = (int(v), int(v)) if dtype.kind in (
        TypeKind.DECIMAL, TypeKind.INT32, TypeKind.INT64) else None
    return Bound(dtype, False, _const_column(v, dtype), int_bound=ib)


def _bind_cast(c: Bound, dst: DataType) -> Bound:
    src = c.dtype

    def fn(batch):
        col = c.fn(batch)
        if src.kind is TypeKind.DECIMAL and dst.kind is TypeKind.DECIMAL:
            data = _decimal_rescale(col.data, src.scale, dst.scale)
        elif src.kind is TypeKind.DECIMAL and _is_float(dst):
            data = col.data.to(dst.torch_dtype) / (10 ** src.scale)
        elif dst.kind is TypeKind.DECIMAL and src.is_integer:
            data = _i64(col.data) * (10 ** dst.scale)
        elif dst.kind is TypeKind.DECIMAL and _is_float(src):
            data = torch.round(col.data * (10 ** dst.scale)).to(torch.int64)
        else:
            data = col.data.to(dst.torch_dtype)
        return Column(data, col.validity)
    ib = None
    if dst.kind is TypeKind.DECIMAL and (src.kind is TypeKind.DECIMAL
                                         or src.is_integer):
        ib = _scaled_bound(c.int_bound, dst.scale - (
            src.scale if src.kind is TypeKind.DECIMAL else 0))
    return Bound(dst, c.nullable, fn, int_bound=ib)


def _operands(e: Expr):
    """The expressions `e` reads directly (aliases looked through)."""
    out = []

    def take(v):
        if isinstance(v, Alias):
            take(v.child)
        elif isinstance(v, Expr):
            out.append(v)
        elif isinstance(v, (tuple, list)):
            for x in v:
                take(x)
    for f in dataclasses.fields(e):
        take(getattr(e, f.name))
    return out


def bind_expr(e: Expr, schema: Schema) -> Bound:
    """Bind a logical expression against a schema, producing an evaluator.

    Columns, literals, aliases, casts, arithmetic, comparisons, Kleene
    AND/OR, NOT, negation, IS [NOT] NULL, BETWEEN, IN, LIKE, CASE,
    literal date +/- interval and the scalar functions of
    `_bind_scalar_fn`. Every other node raises NotImplementedError
    naming it."""
    if isinstance(e, Alias):
        return bind_expr(e.child, schema)

    if not isinstance(e, (Col, IsNull)):
        for child in _operands(e):
            if (isinstance(child, Col) and child.name in schema
                    and schema.field(child.name).dtype.is_wide):
                # the lowering narrows every wide SUM an operator reads
                # (`planner.optimizer.mark_carried`): reaching here is a
                # planner fault, not a user error
                raise AssertionError(
                    f"{expr_name(e)} reads the wide decimal {child.name}, "
                    "which the planner should have narrowed")

    if isinstance(e, Col):
        idx = schema.index_of(e.name)
        f = schema.field(e.name)
        bound = None
        dic = schema.dictionary(e.name)
        if f.dtype.kind is TypeKind.STRING and dic is not None:
            bound = max(len(dic), 1)
        elif f.dtype.kind is TypeKind.BOOL:
            bound = 2
        srt = schema.is_sorted_dict(e.name)
        return Bound(f.dtype, f.nullable, lambda batch: batch.columns[idx],
                     dictionary=dic, code_bound=bound if srt else None,
                     int_bound=schema.int_bound(e.name), dict_sorted=srt)

    if isinstance(e, Lit):
        return _bind_lit(e)

    if isinstance(e, Cast):
        return _bind_cast(bind_expr(e.child, schema), e.dtype)

    if isinstance(e, BinOp):
        if isinstance(e.right, IntervalLit) and e.op in ("+", "-"):
            # constant-fold literal date +/- interval on the host
            if not isinstance(e.left, Lit):
                raise NotImplementedError(
                    "interval arithmetic on non-literal dates")
            sign = 1 if e.op == "+" else -1
            day0 = e.left.value
            if isinstance(day0, str):
                day0 = parse_date(day0)
            folded = add_months(day0, sign * e.right.months) \
                + sign * e.right.days
            return Bound(DATE32, False, _const_column(folded, DATE32))
        if isinstance(e.right, IntervalLit) or isinstance(e.left, IntervalLit):
            raise NotImplementedError(
                f"interval arithmetic {expr_name(e)!r}: only literal date "
                "+/- interval is supported")
        l = bind_expr(e.left, schema)
        r = bind_expr(e.right, schema)
        # string vs literal: translate the literal into code space
        if l.dtype.kind is TypeKind.STRING and isinstance(e.right, Lit):
            if not l.dict_sorted:
                # RAW: equality through a boolean LUT over the values; a
                # range compare re-encodes, then takes the sorted logic
                if e.op in ("=", "!=", "<>"):
                    value, eq = str(e.right.value), e.op == "="
                    return _bool_lut(l, dict_cached(
                        l.dictionary, ("eq" if eq else "ne", value),
                        lambda: (dict_str(l.dictionary) == value) == eq))
                l = sorted_recode(l)
            pos, exact = _string_lit_to_code(str(e.right.value), l.dictionary)
            if e.op == "=" and not exact:
                return Bound(BOOL, False, _const_column(False, BOOL))
            if e.op in ("!=", "<>") and not exact:
                return Bound(BOOL, False, _const_column(True, BOOL))
            # on a sorted dictionary:
            #   col < lit  <=>  code < pos       (strings >= lit start at pos)
            #   col <= lit <=>  code <= pos-1+exact
            code = pos if e.op in ("<", ">=", "=", "!=", "<>") \
                else pos - 1 + (1 if exact else 0)
            r = Bound(STRING, False, _const_column(code, STRING))
        if r.dtype.kind is TypeKind.STRING and isinstance(e.left, Lit):
            # mirror: lit OP col -> col flipped-OP lit
            flip = {"<": ">", "<=": ">=", ">": "<", ">=": "<=", "=": "=",
                    "!=": "!=", "<>": "<>"}
            return bind_expr(BinOp(flip[e.op], e.right, e.left), schema)
        # date vs string literal
        if l.dtype.kind is TypeKind.DATE32 and r.dtype.kind is TypeKind.STRING \
                and isinstance(e.right, Lit):
            r = _bind_lit(Lit(parse_date(str(e.right.value)), DATE32))
        if e.op in ("+", "-", "*", "/", "%"):
            return _bind_arith(e.op, l, r)
        if e.op in _COMPARE:
            return _bind_compare(e.op, l, r)
        if e.op in ("and", "or"):
            return _bind_bool(e.op, l, r)
        raise ValueError(f"unknown op {e.op}")

    if isinstance(e, Not):
        c = bind_expr(e.child, schema)

        def fn(batch):
            col = c.fn(batch)
            # NOT NULL is NULL: the child's validity is kept
            return Column(~col.data.to(torch.bool) & col.validity,
                          col.validity)
        return Bound(BOOL, c.nullable, fn)

    if isinstance(e, Neg):
        c = bind_expr(e.child, schema)

        def fn(batch):
            col = c.fn(batch)
            return Column(-col.data, col.validity)
        ib = None if c.int_bound is None or c.dtype.kind is not \
            TypeKind.DECIMAL else (-c.int_bound[1], -c.int_bound[0])
        return Bound(c.dtype, c.nullable, fn, int_bound=ib)

    if isinstance(e, IsNull):
        c = bind_expr(e.child, schema)
        neg = e.negated

        def fn(batch):
            col = c.fn(batch)
            # IS [NOT] NULL is never NULL itself
            return Column(col.validity if neg else ~col.validity,
                          torch.ones_like(col.validity))
        return Bound(BOOL, False, fn)

    if isinstance(e, Between):
        both = BinOp("and", BinOp(">=", e.child, e.low),
                     BinOp("<=", e.child, e.high))
        return bind_expr(Not(both) if e.negated else both, schema)

    if isinstance(e, InList):
        return _bind_in_list(e, schema)

    if isinstance(e, Like):
        c = bind_expr(e.child, schema)
        if c.dtype.kind is not TypeKind.STRING:
            raise TypeError("LIKE on non-string")
        lut = like_lut(c.dictionary, e.pattern)
        return _bool_lut(c, _negated(lut) if e.negated else lut)

    if isinstance(e, Case):
        return _bind_case(e, schema)

    if isinstance(e, ScalarFn):
        return _bind_scalar_fn(e, schema)

    raise NotImplementedError(f"{type(e).__name__} is not ported yet")


def gather_lut(lut: np.ndarray, col: Column) -> torch.Tensor:
    """lut[code] for every row, on the column's device (codes clamped so
    padding rows never index out of range; an empty LUT reads as one 0)."""
    if not len(lut):
        lut = np.zeros(1, dtype=lut.dtype)
    lut_dev = _device_lut(lut, col.data.device)
    idx = col.data.to(torch.int64).clamp(0, lut_dev.shape[0] - 1)
    return lut_dev.index_select(0, idx)


# device copies of large host LUTs, per (LUT object, device): a RAW
# column's recode LUT is as long as its column, and a plan is evaluated
# anew on every collect. An entry holds its LUT, so the id cannot be
# reused while the entry lives. At most _LUT_CACHE_BYTES of device memory;
# the least recently used go first. The memory router takes what the
# cache holds off a plan's budget (`device_lut_bytes`); `drop_device_luts`
# frees it, for every context of the process.
_LUT_CACHE: dict = {}
_LUT_CACHE_BYTES = 512 << 20
_LUT_CACHED_FROM = 1 << 20     # bytes: a smaller LUT is uploaded each time


def _device_lut(lut: np.ndarray, device: torch.device) -> torch.Tensor:
    if device.type == "cpu" or lut.nbytes < _LUT_CACHED_FROM:
        return torch.from_numpy(lut).to(device)
    key = (id(lut), str(device))
    hit = _LUT_CACHE.pop(key, None)
    if hit is None or hit[0] is not lut:
        hit = (lut, torch.from_numpy(lut).to(device))
    _LUT_CACHE[key] = hit
    held = sum(t.nbytes for _, t in _LUT_CACHE.values())
    while held > _LUT_CACHE_BYTES and len(_LUT_CACHE) > 1:
        held -= _LUT_CACHE.pop(next(iter(_LUT_CACHE)))[1].nbytes
    return hit[1]


def device_lut_bytes(device) -> int:
    """Device bytes the LUT cache holds on `device`."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return sum(t.nbytes for (_, d), (_, t) in _LUT_CACHE.items()
               if d == str(device))


def drop_device_luts() -> None:
    """Free the device copies of LUTs (`SessionContext.evict_device`)."""
    _LUT_CACHE.clear()


def sorted_recode(b: Bound) -> Bound:
    """A RAW string Bound re-encoded onto its sorted distinct values (the
    reference's "re-encode on demand"): RAW codes are row indices, so
    neither code equality nor code order says anything of the values. A
    dense-rank LUT, made once per dictionary (`recode_tables`), maps each
    code to the rank of its value; the result is a sorted Bound whose
    code bound and distinct bound are the number of distinct values. Any
    other Bound comes back as it is."""
    if b.dictionary is None or b.dict_sorted:
        return b
    uniq, lut = recode_tables(b.dictionary)
    inner = b.fn

    def fn(batch):
        col = inner(batch)
        return Column(gather_lut(lut, col), col.validity)
    n = max(len(uniq), 1)
    return Bound(b.dtype, b.nullable, fn, dictionary=uniq, code_bound=n,
                 ndv_bound=n)


def recode_tables(dictionary: np.ndarray):
    """(sorted distinct values as objects, int32 dense rank of each entry)
    of a dictionary, in code-point order, made once per dictionary (the
    reference's `pc.rank(..., tiebreaker="dense") - 1` and its sorted
    `pc.unique`, without pyarrow). The empty dictionary gives ([], [0])."""
    def make():
        if not len(dictionary):
            return np.empty(0, dtype=object), np.zeros(1, dtype=np.int32)
        uniq, inv = _sorted_distinct(dict_str(dictionary))
        return uniq.astype(object), inv.astype(np.int32)
    return dict_cached(dictionary, ("recode",), make)


def dict_str(dictionary: np.ndarray) -> np.ndarray:
    """The dictionary as a fixed-width str array, made once per
    dictionary: a RAW dictionary is as long as its column, and converting
    10^7 Python strings takes seconds."""
    return dict_cached(dictionary, ("str",), lambda: dictionary.astype(str))


def value_hash_lut(dictionary: Optional[np.ndarray]) -> np.ndarray:
    """An int64 hash of each dictionary entry's value, made once per
    dictionary: a polynomial over the code points, so equal strings hash
    alike in any dictionary (what an exchange hashes for a RAW key). The
    empty dictionary gives [0]."""
    if dictionary is None or not len(dictionary):
        return np.zeros(1, dtype=np.int64)

    def make():
        strs = dict_str(dictionary)
        points = np.ascontiguousarray(strs).view(np.uint32).reshape(
            len(strs), -1).astype(np.uint64)
        h = np.zeros(len(strs), dtype=np.uint64)
        weight = 1
        for j in range(points.shape[1]):
            # sum of point_j * B^j mod 2^64: the padding points are 0, so a
            # string hashes alike at any width
            h += points[:, j] * np.uint64(weight)
            weight = weight * 1000003 % (1 << 64)
        return h.view(np.int64)
    return dict_cached(dictionary, ("value_hash",), make)


def _negated(lut: np.ndarray) -> np.ndarray:
    """~lut, made once per LUT object: a new array on every bind would be
    copied to the device, and held by the device LUT cache, anew on every
    collect (NOT LIKE over a RAW column's LUT, as long as its column)."""
    return dict_cached(lut, ("not",), lambda: ~lut)


def _bool_lut(c: Bound, lut: np.ndarray) -> Bound:
    """A string predicate as a host boolean LUT over the dictionary,
    gathered by code on the device; NULL in, NULL out."""
    lut = np.asarray(lut, dtype=bool)

    def fn(batch):
        col = c.fn(batch)
        return Column(gather_lut(lut, col) & col.validity, col.validity)
    return Bound(BOOL, c.nullable, fn)


# host tables derived from a dictionary, kept per (dictionary object,
# what was derived): a query is bound again on every collect, and a LIKE
# or a substring over a 200,000-entry dictionary is a Python loop over
# it. An entry holds its dictionary, so the id in the key cannot be
# reused by another array while the entry lives. The least recently used
# entries go first.
_DICT_CACHE: dict = {}
_DICT_CACHE_MAX = 64


def dict_cached(dictionary: np.ndarray, what: tuple, make):
    """`make()`, computed once per (`dictionary` object, `what`). The
    value is shared between binds: treat it as read-only."""
    key = (id(dictionary), what)
    hit = _DICT_CACHE.get(key)
    if hit is not None and hit[0] is dictionary:
        _DICT_CACHE[key] = _DICT_CACHE.pop(key)     # the most recent now
        return hit[1]
    value = make()
    if len(_DICT_CACHE) >= _DICT_CACHE_MAX:
        _DICT_CACHE.pop(next(iter(_DICT_CACHE)))
    _DICT_CACHE[key] = (dictionary, value)
    return value


def like_lut(dictionary: Optional[np.ndarray], pattern: str) -> np.ndarray:
    """SQL LIKE over every dictionary entry, as a bool array: `%` matches
    any run of characters, `_` any one character, and the whole entry must
    match (pyarrow.compute.match_like's semantics, without pyarrow). A
    pattern without `_` is matched by numpy's vectorised string functions
    (a RAW dictionary is as long as its column); any other by a regular
    expression per entry."""
    if dictionary is None or not len(dictionary):
        return np.zeros(0, dtype=bool)

    def make():
        strs = dict_str(dictionary)
        if "_" not in pattern and hasattr(np, "strings"):
            return _like_pieces(strs, pattern.split("%"))
        rx = re.compile("".join(".*" if ch == "%" else "." if ch == "_"
                                else re.escape(ch) for ch in pattern), re.S)
        return np.fromiter((rx.fullmatch(s) is not None for s in strs),
                           dtype=bool, count=len(strs))
    return dict_cached(dictionary, ("like", pattern), make)


def _like_pieces(strs: np.ndarray, pieces) -> np.ndarray:
    """LIKE of a pattern of literal pieces joined by `%`: the first piece
    is a prefix, each middle piece is found at its leftmost place after
    the one before (the leftmost is never worse), and the last is a
    suffix that starts after them."""
    if len(pieces) == 1:
        return strs == pieces[0]
    first, last = pieces[0], pieces[-1]
    ok = (np.strings.startswith(strs, first) if first
          else np.ones(len(strs), dtype=bool))
    pos = np.full(len(strs), len(first), dtype=np.int64)
    for piece in pieces[1:-1]:
        if piece:
            at = np.strings.find(strs, piece, pos)
            ok &= at >= 0
            pos = np.where(at >= 0, at + len(piece), pos)
    if last:
        ok &= np.strings.endswith(strs, last) & (
            np.strings.str_len(strs) - len(last) >= pos)
    return ok


def _bind_in_list(e: InList, schema: Schema) -> Bound:
    c = bind_expr(e.child, schema)
    if not all(isinstance(v, Lit) for v in e.values):
        raise NotImplementedError("IN list of non-literal values")
    if c.dtype.kind is TypeKind.STRING:
        dic = c.dictionary
        if not c.dict_sorted:
            # RAW: membership over the values
            values = tuple(sorted({str(v.value) for v in e.values}))
            lut = dict_cached(dic, ("in", values),
                              lambda: np.isin(dict_str(dic), values))
            return _bool_lut(c, _negated(lut) if e.negated else lut)
        lut = np.zeros(len(dic) if dic is not None else 0, dtype=bool)
        for v in e.values:
            pos, exact = _string_lit_to_code(str(v.value), dic)
            if exact:
                lut[pos] = True
        return _bool_lut(c, ~lut if e.negated else lut)
    vals = []
    for v in e.values:
        x = v.value
        if isinstance(x, str):
            x = parse_date(x)
        elif isinstance(x, datetime.date):
            x = (x - EPOCH).days
        vals.append(x)
    arr = torch.from_numpy(np.array(vals))
    neg = e.negated

    def fn(batch):
        col = c.fn(batch)
        d = torch.isin(col.data, arr.to(col.data.device))
        d = ~d if neg else d
        return Column(d & col.validity, col.validity)
    return Bound(BOOL, c.nullable, fn)


def _common_dtype(dtypes):
    out = dtypes[0]
    for d in dtypes[1:]:
        if d == out:
            continue
        if d.kind is TypeKind.DECIMAL and out.kind is TypeKind.DECIMAL:
            out = decimal(18, max(d.scale, out.scale))
        elif d.kind is TypeKind.DECIMAL and out.is_integer:
            out = d
        elif out.kind is TypeKind.DECIMAL and d.is_integer:
            pass
        elif d.kind is TypeKind.FLOAT64 or out.kind is TypeKind.FLOAT64:
            out = FLOAT64
        elif d.kind is TypeKind.FLOAT32 or out.kind is TypeKind.FLOAT32:
            out = FLOAT32
        elif d.kind is TypeKind.INT64 or out.kind is TypeKind.INT64:
            out = INT64
    return out


def _cast_col(col: Column, src: DataType, dst: DataType) -> Column:
    if src == dst:
        return col
    if src.kind is TypeKind.DECIMAL and dst.kind is TypeKind.DECIMAL:
        return Column(_decimal_rescale(col.data, src.scale, dst.scale),
                      col.validity)
    if src.is_integer and dst.kind is TypeKind.DECIMAL:
        return Column(_i64(col.data) * (10 ** dst.scale), col.validity)
    return Column(col.data.to(dst.torch_dtype), col.validity)


def _bind_case(e: Case, schema: Schema) -> Bound:
    """Searched CASE: the first true WHEN's value, else ELSE (NULL when
    absent). A NULL condition counts as false."""
    whens = [(bind_expr(c, schema), bind_expr(v, schema)) for c, v in e.whens]
    otherwise = (bind_expr(e.otherwise, schema)
                 if e.otherwise is not None else None)
    branches = [v for _, v in whens] + ([otherwise] if otherwise else [])
    out = _common_dtype([b.dtype for b in branches])

    if out.kind is TypeKind.STRING:
        # string branches carry codes of DIFFERENT dictionaries: remap each
        # into the sorted union dictionary before selecting
        dics = [b.dictionary for b in branches]
        if any(d is None for d in dics):
            raise TypeError("CASE string branches must be "
                            "dictionary-encoded or literals")
        union = np.unique(np.concatenate(
            [d.astype(str) for d in dics if len(d)])).astype(object)
        luts = [np.searchsorted(union.astype(str), d.astype(str)
                                ).astype(np.int32) for d in dics]

        def value(i, batch):
            col = branches[i].fn(batch)
            return Column(gather_lut(luts[i], col), col.validity)
        dictionary, code_bound = union, max(len(union), 1)
    else:
        def value(i, batch):
            b = branches[i]
            return _cast_col(b.fn(batch), b.dtype, out)
        dictionary = code_bound = None
    ib = None
    if out.kind is TypeKind.DECIMAL:
        ib = _hull([_bound_at(b, out) for b in branches]
                   + ([] if otherwise is not None else [(0, 0)]))

    def fn(batch):
        if otherwise is not None:
            oc = value(len(whens), batch)
            data, valid = oc.data, oc.validity
        else:
            fc = value(0, batch)
            data = torch.zeros_like(fc.data)
            valid = torch.zeros_like(fc.validity)
        for i in range(len(whens) - 1, -1, -1):
            cc = whens[i][0].fn(batch)
            vc = value(i, batch)
            take = cc.data.to(torch.bool) & cc.validity
            data = torch.where(take, vc.data, data)
            valid = torch.where(take, vc.validity, valid)
        return Column(data, valid)
    return Bound(out, True, fn, dictionary=dictionary, code_bound=code_bound,
                 int_bound=ib)


# user-defined scalar functions: name -> (fn, out_dtype, propagate_nulls)
_UDF_REGISTRY: dict = {}


def register_udf(name: str, fn, out_dtype: DataType,
                 propagate_nulls: bool = True) -> None:
    """Register a scalar function for SQL and expressions: fn(*data
    tensors) -> data tensor, on the batch's device. With propagate_nulls
    a row is NULL where any argument is, else never NULL."""
    _UDF_REGISTRY[name.lower()] = (fn, out_dtype, propagate_nulls)


def _civil_from_days(days: torch.Tensor):
    """Days since 1970-01-01 -> (year, month, day) int32 tensors (Howard
    Hinnant's civil_from_days, vectorised; floor divisions throughout)."""
    z = days.to(torch.int32) + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    return torch.where(m <= 2, y + 1, y), m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(year, month) int32 tensors -> days since 1970-01-01 of the month's
    first day (Hinnant's days_from_civil, vectorised)."""
    yy = y - (m <= 2).to(y.dtype)
    era = torch.where(yy >= 0, yy, yy - 399) // 400
    yoe = yy - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _dict_fn_bound(c: Bound, what: tuple, xform, code_bound: bool) -> Bound:
    """The string function `xform` (named by `what`) over c's dictionary,
    its tables made once per dictionary (`dict_cached`)."""
    return _dict_lut_bound(c, dict_cached(
        c.dictionary, what, lambda: _dict_tables(
            [xform(s) for s in dict_str(c.dictionary)])), code_bound)


def _dict_tables(values: list):
    """(new sorted dictionary, int32 code map) of per-code results."""
    vals = np.array(values, dtype=str) if values else np.zeros(0, dtype=str)
    new_dict, lut = np.unique(vals, return_inverse=True)
    return new_dict.astype(object), lut.astype(np.int32).reshape(-1)


def _dict_lut_bound(c: Bound, tables, code_bound: bool) -> Bound:
    """A string function as a host map over c's dictionary: `tables` is
    `_dict_tables` of the per-code results. They form a new sorted
    dictionary (whose size is the code bound, where `code_bound`); the
    device gathers the code map."""
    new_dict, lut = tables

    def fn(batch):
        col = c.fn(batch)
        return Column(gather_lut(lut, col), col.validity)
    return Bound(STRING, c.nullable, fn, dictionary=new_dict,
                 code_bound=max(len(new_dict), 1) if code_bound else None)


_DICT_STR_FNS = {"upper": str.upper, "lower": str.lower, "trim": str.strip,
                 "ltrim": str.lstrip, "rtrim": str.rstrip,
                 "reverse": lambda s: s[::-1]}


def _string_arg(e: ScalarFn, schema: Schema) -> Bound:
    c = bind_expr(e.args[0], schema)
    if c.dtype.kind is not TypeKind.STRING:
        raise TypeError(f"{e.name} on non-string")
    if c.dictionary is None:
        raise TypeError(f"{e.name} requires a dictionary-encoded column")
    return c


# the built-in scalar functions: what `_bind_scalar_fn` takes besides the
# registered UDFs (`functions.list_functions` lists these)
SCALAR_FN_NAMES = (
    "extract_year", "extract_month", "extract_day", "date_trunc",
    "floor", "ceil", "ceiling", "round", "sqrt", "abs", "substring",
    "upper", "lower", "trim", "ltrim", "rtrim", "reverse", "replace",
    "length", "char_length", "character_length", "octet_length",
    "concat", "coalesce")


def _bind_scalar_fn(e: ScalarFn, schema: Schema) -> Bound:
    """Registered UDFs and the functions of SCALAR_FN_NAMES; any other
    name raises NotImplementedError naming it."""
    name = e.name.lower()
    if name not in _UDF_REGISTRY and name not in SCALAR_FN_NAMES:
        raise NotImplementedError(f"scalar function {e.name}")
    if name in _UDF_REGISTRY:
        fn_impl, out_dtype, prop = _UDF_REGISTRY[name]
        parts = [bind_expr(a, schema) for a in e.args]

        def fn(batch):
            cols = [p.fn(batch) for p in parts]
            data = fn_impl(*[c.data for c in cols]).to(out_dtype.torch_dtype)
            if prop and cols:
                valid = cols[0].validity
                for c in cols[1:]:
                    valid = valid & c.validity
            else:
                valid = torch.ones(batch.capacity, dtype=torch.bool,
                                   device=batch.device)
            return Column(data, valid)
        return Bound(out_dtype, True, fn)
    if name in ("extract_year", "extract_month", "extract_day"):
        c = bind_expr(e.args[0], schema)
        part = ("year", "month", "day").index(name.split("_")[1])

        def fn(batch):
            col = c.fn(batch)
            return Column(_civil_from_days(col.data)[part].to(torch.int32),
                          col.validity)
        # derived value bounds feed key packing and the aggregate's
        # group-count bound (TPC-H order years span 1992-1998)
        ib = None
        if part == 1:
            ib = (1, 12)
        elif part == 2:
            ib = (1, 31)
        elif c.int_bound is not None:
            lo, hi = c.int_bound
            ib = ((EPOCH + datetime.timedelta(days=int(lo))).year,
                  (EPOCH + datetime.timedelta(days=int(hi))).year)
        return Bound(INT32, c.nullable, fn, int_bound=ib)
    if name == "date_trunc":
        unit = e.args[0].value.lower() if isinstance(e.args[0], Lit) else None
        if unit not in ("year", "month"):
            raise NotImplementedError(f"date_trunc unit {unit!r}")
        c = bind_expr(e.args[1], schema)

        def fn(batch):
            col = c.fn(batch)
            y, m, _ = _civil_from_days(col.data)
            if unit == "year":
                m = torch.ones_like(m)
            return Column(_days_from_civil(y, m).to(torch.int32),
                          col.validity)
        # truncation keeps values in [trunc(lo), hi]; the distinct count
        # is the number of year or month starts in that range
        ib = ndv = None
        if c.int_bound is not None:
            lo, hi = c.int_bound
            dlo = EPOCH + datetime.timedelta(days=int(lo))
            dhi = EPOCH + datetime.timedelta(days=int(hi))
            tlo = (datetime.date(dlo.year, 1, 1) if unit == "year"
                   else datetime.date(dlo.year, dlo.month, 1))
            ib = ((tlo - EPOCH).days, int(hi))
            ndv = (dhi.year - dlo.year + 1 if unit == "year"
                   else (dhi.year - dlo.year) * 12 + dhi.month - dlo.month + 1)
        return Bound(c.dtype, c.nullable, fn, int_bound=ib, ndv_bound=ndv)
    if name in ("floor", "ceil", "ceiling", "round", "sqrt"):
        c = bind_expr(e.args[0], schema)
        # torch.round, like jnp.round, rounds halves to even
        op = {"floor": torch.floor, "ceil": torch.ceil,
              "ceiling": torch.ceil, "round": torch.round,
              "sqrt": torch.sqrt}[name]
        if c.dtype.kind is TypeKind.DECIMAL:
            scale = 10.0 ** c.dtype.scale

            def fn(batch):
                col = c.fn(batch)
                return Column(op(col.data.to(torch.float64) / scale),
                              col.validity)
            return Bound(FLOAT64, c.nullable, fn)
        out = FLOAT64 if name == "sqrt" or not c.dtype.is_integer else c.dtype

        def fn(batch):
            col = c.fn(batch)
            if name == "sqrt":
                v = torch.sqrt(col.data.to(torch.float64))
            elif c.dtype.is_integer:
                v = col.data   # floor/ceil/round of an integer: itself
            else:
                v = op(col.data)
            return Column(v.to(out.torch_dtype), col.validity)
        return Bound(out, c.nullable, fn)
    if name == "abs":
        c = bind_expr(e.args[0], schema)

        def fn(batch):
            col = c.fn(batch)
            return Column(col.data.abs(), col.validity)
        return Bound(c.dtype, c.nullable, fn,
                     int_bound=_abs_bound(c.int_bound))
    if name == "substring":
        c = _string_arg(e, schema)
        start = e.args[1].value - 1   # SQL positions are 1-based
        length = e.args[2].value
        stop = None if length < 0 else start + length
        return _dict_fn_bound(c, ("substring", start, stop),
                              lambda s: s[start:stop], code_bound=False)
    if name in _DICT_STR_FNS or (
            name == "replace" and len(e.args) == 3
            and all(isinstance(a, Lit) for a in e.args[1:])):
        c = _string_arg(e, schema)
        if name == "replace":
            old, new = e.args[1].value, e.args[2].value
            what = ("replace", old, new)
            xform = lambda s: s.replace(old, new)  # noqa: E731
        else:
            what, xform = (name,), _DICT_STR_FNS[name]
        return _dict_fn_bound(c, what, xform, code_bound=True)
    if name in ("length", "char_length", "character_length",
                "octet_length"):
        c = _string_arg(e, schema)
        octets = name == "octet_length"
        lens = dict_cached(
            c.dictionary, ("octet_length" if octets else "length",),
            lambda: np.fromiter(
                ((len(s.encode()) if octets else len(s))
                 for s in dict_str(c.dictionary)),
                dtype=np.int32, count=len(c.dictionary)))

        def fn(batch):
            col = c.fn(batch)
            return Column(gather_lut(lens, col), col.validity)
        return Bound(INT32, c.nullable, fn)
    if name == "concat":
        return _bind_concat(e, schema)
    if name == "coalesce":
        parts = [bind_expr(a, schema) for a in e.args]
        out = _common_dtype([p.dtype for p in parts])

        def fn(batch):
            cols = [_cast_col(p.fn(batch), p.dtype, out) for p in parts]
            data, valid = cols[-1].data, cols[-1].validity
            for col in reversed(cols[:-1]):
                data = torch.where(col.validity, col.data, data)
                valid = valid | col.validity
            return Column(data, valid)
        ib = (_hull([_bound_at(p, out) for p in parts])
              if out.kind is TypeKind.DECIMAL or out.is_integer else None)
        return Bound(out, all(p.nullable for p in parts), fn, int_bound=ib)
    raise NotImplementedError(f"scalar function {e.name}")


def _abs_bound(b: Optional[tuple]) -> Optional[tuple]:
    """The bounds of |x| for x within `b`."""
    if b is None:
        return None
    lo, hi = abs(int(b[0])), abs(int(b[1]))
    if b[0] <= 0 <= b[1]:
        return (0, max(lo, hi))
    return (min(lo, hi), max(lo, hi))


def _bind_concat(e: ScalarFn, schema: Schema) -> Bound:
    """concat over literals and one or two dictionary-coded string
    columns: the result dictionary is rendered on the host over the
    columns' dictionaries (their product, at most a million entries for
    two); the device gathers by code (c1 * |d2| + c2). NULL if a column
    is NULL."""
    parts = []
    for a in e.args:
        if isinstance(a, Lit):
            parts.append(str(a.value))
            continue
        c = bind_expr(a, schema)
        if c.dtype.kind is not TypeKind.STRING or c.dictionary is None:
            raise TypeError("concat requires dictionary-encoded string "
                            "columns or literals")
        parts.append(c)
    cols = [p for p in parts if isinstance(p, Bound)]
    if not cols or len(cols) > 2:
        raise NotImplementedError("concat supports 1-2 string columns")
    dicts = [c.dictionary.astype(str) for c in cols]
    if len(cols) == 2 and len(dicts[0]) * len(dicts[1]) > 1_000_000:
        raise NotImplementedError("concat dictionary product too large")

    def render(values):
        it = iter(values)
        return "".join(p if isinstance(p, str) else next(it) for p in parts)

    if len(cols) == 1:
        vals = [render((v,)) for v in dicts[0]]
        code = cols[0].fn
    else:
        vals = [render((v1, v2)) for v1 in dicts[0] for v2 in dicts[1]]
        m = len(dicts[1])

        def code(batch):
            a1, a2 = cols[0].fn(batch), cols[1].fn(batch)
            return Column(a1.data.to(torch.int64) * m + a2.data,
                          a1.validity & a2.validity)
    return _dict_lut_bound(Bound(STRING, True, code), _dict_tables(vals),
                           code_bound=True)


def propagate_bounds(exprs, names, in_schema: Schema) -> dict:
    """{out_name: (lo, hi)} for passthrough (possibly aliased) columns —
    the int-bounds analog of per-site dictionary propagation — and for
    decimal expressions, whose bounds interval arithmetic gives (what
    decides whether a SUM over them is wide)."""
    out = {}
    for e, n in zip(exprs, names):
        base = e.child if isinstance(e, Alias) else e
        if isinstance(base, Col):
            b = in_schema.int_bound(base.name)
            if b is not None:
                out[n] = b
        elif not isinstance(base, (Lit, IntervalLit)):
            b = bind_expr(base, in_schema)
            if b.dtype.kind is TypeKind.DECIMAL and b.int_bound is not None:
                out[n] = b.int_bound
    return out


def output_field(e: Expr, schema: Schema) -> Field:
    b = bind_expr(e, schema)
    return Field(expr_name(e), b.dtype, b.nullable)
