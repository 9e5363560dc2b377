"""Aggregate expression machinery (port of ballista_tpu/exec/aggregate.py).

Each AggExpr binds to per-group state columns (computed over a layout)
and a finalize step (e.g. avg = sum / count in exact decimal math). The
port carries sum, count, count_star, avg, min, max and carry.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from ..batch import Batch, Column
from ..exprs import Bound, Expr, _div_scaled, bind_expr, expr_name
from ..schema import DataType, Field, FLOAT32, FLOAT64, INT64, Schema, TypeKind, decimal


@dataclasses.dataclass(frozen=True)
class AggExpr:
    kind: str                 # sum | count | count_star | min | max | avg |
                              # carry (and, in the SQL frontend, the kinds
                              # not ported yet: var_*, stddev_*, corr,
                              # median, percentile)
    arg: Optional[Expr] = None
    alias: Optional[str] = None
    distinct: bool = False
    arg2: Optional[Expr] = None     # corr's second argument
    frac: Optional[float] = None    # percentile fraction (median = 0.5)

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        if self.kind == "count_star":
            return "count(*)"
        if self.kind == "corr":
            return f"corr({expr_name(self.arg)}, {expr_name(self.arg2)})"
        return f"{self.kind}({expr_name(self.arg)})"


def _sum_dtype(dt: DataType) -> DataType:
    if dt.kind is TypeKind.DECIMAL:
        return decimal(18, dt.scale)
    if dt.is_integer:
        return INT64
    return dt


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
            st = _sum_dtype(self.arg.dtype)
            self.state_dtypes = [st]
            self.out_field = Field(spec.name, st, nullable=True)
        elif k in ("min", "max", "carry"):
            self.state_dtypes = [self.arg.dtype]
            self.out_field = Field(spec.name, self.arg.dtype, nullable=True)
        elif k == "avg":
            st = _sum_dtype(self.arg.dtype)
            self.state_dtypes = [st, INT64]
            self.out_field = Field(spec.name, _avg_dtype(self.arg.dtype), nullable=True)
        else:
            raise NotImplementedError(f"aggregate {k} is not ported yet")

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

    def fused_requests(self, batch: Batch):
        """(reqs, assemble) for an aggregate with `exact_sums`: reqs is a
        list of (kind, data, validity) with kind 'sum' or 'count' ('count'
        with data=None counts live rows); assemble maps the per-request
        output Columns to this aggregate's state columns, with the values
        and validities partial() gives."""
        k = self.spec.kind
        if k == "count_star":
            return [("count", None, None)], list
        data, validity = self._arg_data(batch, keep_int32=True)
        if k in ("count", "sum"):
            return [(k, data, validity)], list
        # avg
        return ([("sum", data, validity), ("count", data, validity)],
                lambda outs: [outs[0], _ones(outs[1])])

    def partial(self, batch: Batch, layout) -> List[Column]:
        """Raw rows -> per-group states over a layout (ops.segagg)."""
        k = self.spec.kind
        if k == "count_star":
            return [Column(*layout.count_star())]
        data, validity = self._arg_data(batch)
        if k == "count":
            return [Column(*layout.count(data, validity))]
        if k in ("sum", "min", "max", "carry"):
            return [Column(*getattr(layout, k)(data, validity))]
        s, sv = layout.sum(data, validity)
        c, _ = layout.count(data, validity)
        return [Column(s, sv), Column(c, torch.ones_like(sv))]

    def finalize(self, state_cols: List[Column]) -> Column:
        """States -> output column."""
        if self.spec.kind != "avg":
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
