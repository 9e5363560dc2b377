"""Aggregate expression machinery (port of ballista_tpu/exec/aggregate.py;
two-phase, DataFusion Partial/Final parity).

Each AggExpr binds to partial state columns (computed over a layout), a
merge step (states of several partial aggregates re-aggregated on the group
keys) and a finalize step (e.g. avg = sum / count in exact decimal math).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..batch import Batch, Column
from ..exprs import Bound, Expr, _div_scaled, bind_expr, expr_name
from ..schema import (MAX_WIDE, DataType, Field, FLOAT32, FLOAT64, INT64,
                      Schema, TypeKind, decimal, join_wide, split_wide,
                      wide_decimal)

INT64_MAX = (1 << 63) - 1


@dataclasses.dataclass(frozen=True)
class AggExpr:
    kind: str                 # sum | count | count_star | min | max | avg |
                              # carry | var_samp | var_pop | stddev_samp |
                              # stddev_pop | corr | median | percentile
    arg: Optional[Expr] = None
    alias: Optional[str] = None
    distinct: bool = False
    arg2: Optional[Expr] = None     # corr's second argument
    frac: Optional[float] = None    # percentile fraction (median = 0.5)
    # a decimal SUM whose exact total may pass int64 (`wide_sum`): its
    # state is a wide decimal. Set when a plan is lowered
    # (`planner.logical.Aggregate.sized_aggs`), never by the SQL planner
    wide: bool = False
    # a SUM whose output no operator above reads as a value, only carries
    # (`planner.optimizer.mark_carried`, at lowering): a wide one returns
    # its wide state. A wide SUM that is read is narrowed at the
    # aggregate's output to `_sum_dtype` (`narrows`)
    carried: bool = False
    # the name a query gives a SUM that is read (its alias above, where it
    # has one): what the error of a value past int64 names
    shown: Optional[str] = None

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if self.kind == "count_star":
            return "count(*)"
        if self.kind == "corr":
            return f"corr({expr_name(self.arg)}, {expr_name(self.arg2)})"
        return f"{self.kind}({expr_name(self.arg)})"


# kinds whose state cannot be merged across partial aggregates: a planner
# that splits an aggregate must hand these the raw rows, grouped, once
NON_DECOMPOSABLE = ("median", "percentile")
MOMENT_KINDS = ("var_samp", "var_pop", "stddev_samp", "stddev_pop")


def _sum_dtype(dt: DataType) -> DataType:
    if dt.kind is TypeKind.DECIMAL:
        return decimal(18, dt.scale)
    if dt.is_integer:
        return INT64
    return dt


def wide_sum(arg_dtype: DataType, arg_bound: Optional[tuple],
             rows: Optional[int]) -> bool:
    """Whether a SUM over a decimal argument is wide: `rows` (the most
    rows it may add; None when unknown) times the largest magnitude of
    the argument's bound can pass 2^63 - 1, or either is unknown. Integer
    sums stay int64 (as in the reference and DataFusion)."""
    if arg_dtype.kind is not TypeKind.DECIMAL or arg_dtype.is_wide:
        return False
    if rows == 0:
        return False
    if rows is None or arg_bound is None:
        return True
    return rows * max(abs(int(arg_bound[0])), abs(int(arg_bound[1]))) \
        > INT64_MAX


def _wide_sum_dtype(dt: DataType) -> DataType:
    """DataFusion's type of sum(decimal(p, s)): decimal(min(38, p + 10),
    s), here in two words (at least 19 digits)."""
    return wide_decimal(min(MAX_WIDE, max(dt.precision + 10, 19)), dt.scale)


def narrows(spec: AggExpr, state: DataType) -> bool:
    """Whether an aggregate with this first state type returns its wide
    sum narrowed to int64 (`schema.narrow_wide`): it is read above."""
    return spec.kind == "sum" and state.is_wide and not spec.carried


def _out_sum_dtype(spec: AggExpr, state: DataType) -> DataType:
    """A SUM's output type: its state's, or the JAX package's
    decimal(18, s) where a wide state is narrowed."""
    return decimal(18, state.scale) if narrows(spec, state) else state


def _avg_dtype(dt: DataType) -> DataType:
    if dt.kind is TypeKind.DECIMAL:
        return decimal(18, min(dt.scale + 4, 12))
    return FLOAT32 if dt.kind is TypeKind.FLOAT32 else FLOAT64


def _ones(c: Column) -> Column:
    return Column(c.data, torch.ones_like(c.validity))


class BoundAgg:
    """One aggregate bound against the input schema."""

    def __init__(self, spec: AggExpr, in_schema: Schema):
        self.spec = spec
        self.arg: Optional[Bound] = (
            bind_expr(spec.arg, in_schema) if spec.arg is not None else None)
        k = spec.kind
        if k == "count_star" or k == "count":
            self.state_dtypes = [INT64]
            self.out_field = Field(spec.name, INT64, nullable=False)
        elif k == "sum":
            st = (_wide_sum_dtype(self.arg.dtype) if spec.wide
                  else _sum_dtype(self.arg.dtype))
            self.state_dtypes = [st]
            self.out_field = Field(spec.name, _out_sum_dtype(spec, st),
                                   nullable=True)
        elif k in ("min", "max", "carry"):
            self.state_dtypes = [self.arg.dtype]
            self.out_field = Field(spec.name, self.arg.dtype, nullable=True)
        elif k == "avg":
            st = _sum_dtype(self.arg.dtype)
            self.state_dtypes = [st, INT64]
            self.out_field = Field(spec.name, _avg_dtype(self.arg.dtype), nullable=True)
        elif k in MOMENT_KINDS:
            # one-pass moments: [sum(x), sum(x^2), n] in f64
            self.state_dtypes = [FLOAT64, FLOAT64, INT64]
            self.out_field = Field(spec.name, FLOAT64, nullable=True)
        elif k == "corr":
            self.arg2 = bind_expr(spec.arg2, in_schema)
            self.state_dtypes = [FLOAT64, FLOAT64, FLOAT64, FLOAT64,
                                 FLOAT64, INT64]
            self.out_field = Field(spec.name, FLOAT64, nullable=True)
        elif k in NON_DECOMPOSABLE:
            self.state_dtypes = [FLOAT64]
            self.out_field = Field(spec.name, FLOAT64, nullable=True)
        else:
            raise NotImplementedError(f"aggregate {k}")

    def state_fields(self) -> List[Field]:
        return [Field(f"{self.spec.name}#s{i}", dt, True)
                for i, dt in enumerate(self.state_dtypes)]

    @property
    def exact_sums(self) -> bool:
        """True when every state is an int64 sum or count: the aggregate
        rides the one fused masked_slot_sums_rows launch."""
        k = self.spec.kind
        return k in ("count", "count_star") or (
            k in ("sum", "avg") and self.state_dtypes[0].kind in (
                TypeKind.DECIMAL, TypeKind.INT64))

    def _arg_data(self, batch: Batch, keep_int32: bool = False):
        """The argument's (data, validity), an exact sum's data widened to
        its int64 state; with `keep_int32` an int32 column stays as it is
        (the fused kernel widens it in registers)."""
        col = self.arg.fn(batch)
        data = col.data
        if self.spec.kind in ("sum", "avg") and self.state_dtypes[0].kind in (
                TypeKind.DECIMAL, TypeKind.INT64) and not (
                    keep_int32 and data.dtype == torch.int32):
            data = data.to(torch.int64)
        return data, col.validity

    @property
    def wide(self) -> bool:
        """A sum whose state is a wide decimal (two words)."""
        return self.state_dtypes[0].is_wide

    @property
    def narrow(self) -> bool:
        """A wide sum whose output is narrowed to int64 (`narrows`)."""
        return narrows(self.spec, self.state_dtypes[0])

    def fused_requests(self, batch: Batch):
        """(reqs, tags, assemble) for an aggregate with `exact_sums`: reqs
        is a list of (kind, data, validity, half) with kind 'sum' or
        'count' ('count' with data=None counts live rows) and half the
        kernel's read mode of `data` (`masked_sums.WHOLE`, `HI`, `LO`: a
        wide sum adds its argument's two halves apart); tags[i] names the
        column request i reads (its argument), so requests of several
        aggregates over one column share a row; assemble maps the
        per-request output Columns to this aggregate's state columns, with
        the values and validities partial() gives."""
        from ..ops.masked_sums import HI, LO, WHOLE
        k = self.spec.kind
        if k == "count_star":
            return [("count", None, None, WHOLE)], [None], list
        data, validity = self._arg_data(batch, keep_int32=True)
        tag = self.spec.arg
        if k == "count":
            return [(k, data, validity, WHOLE)], [tag], list
        if k == "sum" and self.wide:
            return ([("sum", data, validity, HI), ("sum", data, validity, LO)],
                    [tag, tag], _assemble_wide)
        if k == "sum":
            return [(k, data, validity, WHOLE)], [tag], list
        # avg
        return ([("sum", data, validity, WHOLE),
                 ("count", data, validity, WHOLE)], [tag, tag],
                lambda outs: [outs[0], _ones(outs[1])])

    def fused_merge_requests(self, state_cols: List[Column], state_idx):
        """fused_requests for the final mode of an aggregate with
        `exact_sums`: every state is an int64 sum or count (a wide sum's
        state, two words), and merging it is a sum over the partial
        states. Kind 'sum' is NULL where no state of the group is valid;
        'total' (a merged count) is always valid. The tags are the state
        columns' indices in the child (and a word's index)."""
        from ..ops.masked_sums import WHOLE
        k = self.spec.kind
        s = state_cols[0]
        if k in ("count", "count_star"):
            return [("total", s.data, s.validity, WHOLE)], state_idx, list
        if k == "sum" and self.wide:
            return ([("sum", s.data[:, w], s.validity, WHOLE)
                     for w in (0, 1)],
                    [(state_idx[0], w) for w in (0, 1)], _assemble_wide)
        if k == "sum":
            return [("sum", s.data, s.validity, WHOLE)], state_idx, list
        c = state_cols[1]   # avg
        return ([("sum", s.data, s.validity, WHOLE),
                 ("total", c.data, c.validity, WHOLE)], state_idx, list)

    def partial(self, batch: Batch, layout) -> List[Column]:
        """Raw rows -> per-group states over a layout (ops.segagg)."""
        k = self.spec.kind
        if k == "count_star":
            return [Column(*layout.count_star())]
        data, validity = self._arg_data(batch)
        if k == "count":
            return [Column(*layout.count(data, validity))]
        if k == "sum" and self.wide:
            hi, lo = split_wide(data)
            (s_hi, v), (s_lo, _) = (layout.sum(hi, validity),
                                    layout.sum(lo, validity))
            return [Column(join_wide(s_hi, s_lo), v)]
        if k in ("sum", "min", "max", "carry"):
            return [Column(*getattr(layout, k)(data, validity))]
        if k == "avg":
            s, sv = layout.sum(data, validity)
            c, _ = layout.count(data, validity)
            return [Column(s, sv), Column(c, torch.ones_like(sv))]
        col = Column(data, validity)
        x = _as_f64(self.arg, col)
        if k in MOMENT_KINDS:
            s1, v = layout.sum(x, validity)
            s2, _ = layout.sum(x * x, validity)
            n, _ = layout.count(x, validity)
            ones = torch.ones_like(v)
            return [Column(s1, ones), Column(s2, ones), Column(n, ones)]
        if k == "corr":
            col2 = self.arg2.fn(batch)
            both = validity & col2.validity
            y = _as_f64(self.arg2, col2)
            sums = [layout.sum(d, both)[0]
                    for d in (x, y, x * x, y * y, x * y)]
            n, v = layout.count(x, both)
            ones = torch.ones_like(v)
            return [Column(s, ones) for s in sums] + [Column(n, ones)]
        # median / percentile
        frac = 0.5 if k == "median" else float(self.spec.frac)
        return [Column(*layout.percentile(x, validity, frac))]

    def merge(self, state_cols: List[Column], layout) -> List[Column]:
        """States of several partial aggregates -> merged states, over a
        layout of the state rows' group keys."""
        k = self.spec.kind
        if k in NON_DECOMPOSABLE:
            raise NotImplementedError(
                f"{k} state cannot be merged; the planner must aggregate "
                "the raw rows once (NON_DECOMPOSABLE)")
        if k in ("min", "max", "carry"):
            s = state_cols[0]
            return [Column(*getattr(layout, k)(s.data, s.validity))]
        if k == "sum" and self.wide:
            s = state_cols[0]
            (s_hi, v), (s_lo, _) = (layout.sum(s.data[:, w].contiguous(),
                                               s.validity) for w in (0, 1))
            return [Column(join_wide(s_hi, s_lo), v)]
        merged = [layout.sum(sc.data, sc.validity) for sc in state_cols]
        if k == "sum":
            return [Column(*merged[0])]
        ones = torch.ones_like(merged[0][1])
        if k == "avg":
            return [Column(*merged[0]), Column(merged[1][0], ones)]
        # counts, moments and corr: every merged state is valid
        return [Column(s, ones) for s, _ in merged]

    def finalize(self, state_cols: List[Column]) -> Column:
        """States -> output column."""
        k = self.spec.kind
        if k in MOMENT_KINDS:
            return _finalize_moment(k, *(c.data for c in state_cols))
        if k == "corr":
            return _finalize_corr(*(c.data for c in state_cols))
        if k != "avg":
            return state_cols[0]
        s, c = state_cols
        out = self.out_field.dtype
        if out.kind is TypeKind.DECIMAL:
            in_scale = self.state_dtypes[0].scale
            q = _div_scaled(s.data, c.data.clamp(min=1), out.scale - in_scale)
            return Column(q, s.validity & (c.data > 0))
        td = out.torch_dtype
        d = s.data.to(td) / c.data.clamp(min=1).to(td)
        return Column(d, s.validity & (c.data > 0))


def _assemble_wide(outs: List[Column]) -> List[Column]:
    """A wide sum's state from its two word sums (hi, lo)."""
    return [Column(join_wide(outs[0].data, outs[1].data), outs[0].validity)]


def _finalize_moment(k: str, s1, s2, nn) -> Column:
    """Variance or standard deviation from [sum(x), sum(x^2), n]: NULL for
    n = 0 (population) or n <= 1 (sample); f64 cancellation noise below 0
    is clamped."""
    n = nn.clamp(min=1).to(torch.float64)
    if k.endswith("_pop"):
        var = s2 / n - (s1 / n) ** 2
        valid = nn > 0
    else:
        var = torch.where(nn > 1, (s2 - s1 * s1 / n) / (n - 1.0).clamp(min=1.0),
                          torch.zeros_like(s2))
        valid = nn > 1
    var = var.clamp(min=0.0)
    out = var.sqrt() if k.startswith("stddev") else var
    return Column(torch.where(valid, out, torch.zeros_like(out)), valid)


def _finalize_corr(sx, sy, sxx, syy, sxy, nn) -> Column:
    """Pearson correlation from the five sums and n: NULL where n <= 1 or
    either argument is constant (a zero denominator)."""
    n = nn.to(torch.float64)
    cov = n * sxy - sx * sy
    dx = n * sxx - sx * sx
    dy = n * syy - sy * sy
    denom = (dx.clamp(min=0.0) * dy.clamp(min=0.0)).sqrt()
    valid = (nn > 1) & (denom > 0)
    out = cov / denom.clamp(min=1e-300)
    return Column(torch.where(valid, out, torch.zeros_like(out)), valid)


def _as_f64(bound: Bound, col: Column) -> torch.Tensor:
    d = col.data.to(torch.float64)
    if bound.dtype.kind is TypeKind.DECIMAL:
        return d / (10.0 ** bound.dtype.scale)
    return d
