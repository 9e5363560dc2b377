"""Logical plan nodes.

Reference parity: DataFusion's LogicalPlan, which Ballista serializes to the
scheduler (`execute_query`, grpc.rs:400-420). Ours is a small dataclass tree;
the SQL frontend and DataFrame API both produce it, and
`planner.physical.create_physical_plan` lowers it to ExecNodes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..exprs import Expr, bind_expr, expr_name
from ..schema import Field, Schema
from ..exec.aggregate import AggExpr, BoundAgg, wide_sum


class LogicalPlan:
    def schema(self) -> Schema:
        raise NotImplementedError

    def children(self) -> Tuple["LogicalPlan", ...]:
        return ()

    def display(self, indent: int = 0) -> str:
        s = "  " * indent + self._label() + "\n"
        for c in self.children():
            s += c.display(indent + 1)
        return s

    def _label(self) -> str:
        return type(self).__name__


@dataclasses.dataclass
class TableScan(LogicalPlan):
    table_name: str
    table_schema: Schema
    projection: Optional[Tuple[str, ...]] = None
    # unique column sets (declared PK or inferred) — feeds functional-
    # dependency reasoning (optimizer.reduce_group_keys)
    unique_cols: Tuple[Tuple[str, ...], ...] = ()

    def schema(self) -> Schema:
        if self.projection is None:
            return self.table_schema
        return self.table_schema.select(self.projection)

    def _label(self):
        proj = list(self.projection) if self.projection else "*"
        return f"TableScan({self.table_name}, projection={proj})"


@dataclasses.dataclass
class OneRow(LogicalPlan):
    """FROM-less SELECT source: exactly one row with a hidden all-zero
    column (DataFusion EmptyRelation{produce_one_row: true} parity)."""

    def schema(self) -> Schema:
        from ..schema import INT64, Field
        return Schema((Field("__one", INT64, nullable=False),), {})

    def _label(self):
        return "OneRow"


@dataclasses.dataclass
class Filter(LogicalPlan):
    input: LogicalPlan
    predicate: Expr

    def schema(self):
        return self.input.schema()

    def children(self):
        return (self.input,)

    def _label(self):
        return f"Filter({self.predicate})"


@dataclasses.dataclass
class Projection(LogicalPlan):
    input: LogicalPlan
    exprs: Tuple[Expr, ...]
    names: Optional[Tuple[str, ...]] = None

    def schema(self) -> Schema:
        in_schema = self.input.schema()
        names = self.names or tuple(expr_name(e) for e in self.exprs)
        fields = []
        dicts = {}
        unsorted = set()
        from ..exprs import Alias, Col
        for n, e in zip(names, self.exprs):
            b = bind_expr(e, in_schema)
            fields.append(Field(n, b.dtype, b.nullable))
            if b.dictionary is not None:
                dicts[n] = b.dictionary
                if not b.dict_sorted:
                    unsorted.add(n)
                continue
            base = e.child if isinstance(e, Alias) else e
            if isinstance(base, Col) and in_schema.dictionary(base.name) is not None:
                dicts[n] = in_schema.dictionary(base.name)
                if not in_schema.is_sorted_dict(base.name):
                    unsorted.add(n)
        from ..exprs import propagate_bounds
        bounds = propagate_bounds(self.exprs, names, in_schema)
        return Schema(tuple(fields), dicts, bounds, unsorted)

    def children(self):
        return (self.input,)

    def _label(self):
        return f"Projection({', '.join(map(str, self.exprs))})"


@dataclasses.dataclass
class Aggregate(LogicalPlan):
    input: LogicalPlan
    group_exprs: Tuple[Expr, ...]
    aggs: Tuple[AggExpr, ...]
    group_names: Optional[Tuple[str, ...]] = None

    def schema(self) -> Schema:
        in_schema = self.input.schema()
        names = self.group_names or tuple(expr_name(e) for e in self.group_exprs)
        fields = []
        dicts = {}
        unsorted = set()
        from ..exprs import Alias, Col, sorted_recode
        for n, e in zip(names, self.group_exprs):
            # a RAW key groups by its re-encoded (sorted) codes, as
            # HashAggregateExec does
            b = sorted_recode(bind_expr(e, in_schema))
            fields.append(Field(n, b.dtype, b.nullable))
            if b.dictionary is not None:
                dicts[n] = b.dictionary
                continue
            base = e.child if isinstance(e, Alias) else e
            if isinstance(base, Col) and in_schema.dictionary(base.name) is not None:
                dicts[n] = in_schema.dictionary(base.name)
        from ..exprs import propagate_bounds
        bounds = propagate_bounds(self.group_exprs, names, in_schema)
        rows = None if _pending(self.input) else row_bound(self.input)
        for a in self.sized_aggs():
            ba = BoundAgg(a, in_schema)
            fields.append(ba.out_field)
            ib = _agg_bound(ba, rows)
            if ib is not None:
                bounds[ba.out_field.name] = ib
            # min/max over a dictionary-coded column stay in code space
            # (sorted dictionaries make code-extrema exact): keep the dict
            if a.kind in ("min", "max", "carry") and a.arg is not None:
                base = a.arg.child if isinstance(a.arg, Alias) else a.arg
                if (isinstance(base, Col)
                        and in_schema.dictionary(base.name) is not None):
                    dicts[ba.out_field.name] = in_schema.dictionary(base.name)
                    if not in_schema.is_sorted_dict(base.name):
                        unsorted.add(ba.out_field.name)
        return Schema(tuple(fields), dicts, bounds, unsorted)

    def sized_aggs(self) -> Tuple[AggExpr, ...]:
        """`aggs` with each decimal SUM marked wide where its exact total
        may pass int64 (`exec.aggregate.wide_sum`): the rows it may add are
        `row_bound(input)`, its argument's bound comes from the input's
        schema. Every lowering of the plan (in-core, serial, distributed,
        an executor's) decides alike from the same tables, after
        `rebind_scans` has read the metadata of the columns the pruned plan
        scans; before that (a scan below has pending metadata) the sums
        are left as they are."""
        if not any(a.kind == "sum" for a in self.aggs) or _pending(
                self.input):
            return self.aggs
        in_schema = self.input.schema()
        rows = row_bound(self.input)
        out = []
        for a in self.aggs:
            if a.kind == "sum" and a.arg is not None:
                b = bind_expr(a.arg, in_schema)
                a = dataclasses.replace(
                    a, wide=wide_sum(b.dtype, b.int_bound, rows))
            out.append(a)
        return tuple(out)

    def children(self):
        return (self.input,)

    def _label(self):
        return (f"Aggregate(keys={[str(e) for e in self.group_exprs]}, "
                f"aggs={[a.name for a in self.aggs]})")


@dataclasses.dataclass
class Sort(LogicalPlan):
    input: LogicalPlan
    keys: Tuple[Tuple[Expr, bool, Optional[bool]], ...]  # (expr, asc, nulls_first)

    def schema(self):
        return self.input.schema()

    def children(self):
        return (self.input,)

    def _label(self):
        return f"Sort({[(str(e), asc) for e, asc, _ in self.keys]})"


@dataclasses.dataclass
class Limit(LogicalPlan):
    input: LogicalPlan
    n: int
    offset: int = 0

    def schema(self):
        return self.input.schema()

    def children(self):
        return (self.input,)

    def _label(self):
        off = f", offset={self.offset}" if self.offset else ""
        return f"Limit({self.n}{off})"


@dataclasses.dataclass
class Join(LogicalPlan):
    left: LogicalPlan
    right: LogicalPlan
    on: Tuple[Tuple[str, str], ...]
    how: str = "inner"  # inner | left_outer | full_outer | semi | anti | cross
    unique_build: bool = True  # left side has unique join keys

    def schema(self) -> Schema:
        if self.how in ("semi", "anti"):
            return self.right.schema()  # probe side survives
        ls, rs = self.left.schema(), self.right.schema()
        fields = ls.fields + rs.fields
        if self.how == "full_outer":
            fields = tuple(Field(f.name, f.dtype, True) for f in fields)
        dicts = dict(ls.dictionaries)
        dicts.update(rs.dictionaries)
        bounds = dict(ls.int_bounds)
        bounds.update(rs.int_bounds)
        return Schema(fields, dicts, bounds, ls.unsorted | rs.unsorted)

    def children(self):
        return (self.left, self.right)

    def _label(self):
        return f"Join[{self.how}](on={list(self.on)})"


@dataclasses.dataclass
class Window(LogicalPlan):
    """Window functions: positional — input rows + one column per spec.

    Reference parity: DataFusion WindowAggExec; note the reference's
    DistributedPlanner rejects window plans (`planner.rs:155`), while ours
    distributes them by shuffling on PARTITION BY keys."""
    input: LogicalPlan
    specs: Tuple  # Tuple[exec.window.WindowFnSpec, ...]

    def schema(self) -> Schema:
        from ..exec.window import _out_field
        in_schema = self.input.schema()
        fields = in_schema.fields + tuple(
            _out_field(s, in_schema) for s in self.specs)
        return Schema(fields, dict(in_schema.dictionaries),
                      in_schema.int_bounds, in_schema.unsorted)

    def children(self):
        return (self.input,)

    def _label(self):
        return f"Window({[s.name for s in self.specs]})"


@dataclasses.dataclass
class Distinct(LogicalPlan):
    input: LogicalPlan

    def schema(self):
        return self.input.schema()

    def children(self):
        return (self.input,)


def _agg_bound(ba: BoundAgg, rows: Optional[int]) -> Optional[tuple]:
    """An aggregate output's value bounds: an extremum's or a carry's are
    its argument's; a SUM that is not wide adds at most `rows` values of
    its argument, so +-rows x its largest magnitude (what `wide_sum`
    checked against int64). A wide SUM's output has none."""
    k = ba.spec.kind
    b = ba.arg.int_bound if ba.arg is not None else None
    if b is None:
        return None
    if k in ("min", "max", "carry"):
        return b
    if k == "sum" and rows is not None and not ba.wide:
        m = rows * max(abs(int(b[0])), abs(int(b[1])))
        return (-m, m)
    return None


def _pending(p: LogicalPlan) -> bool:
    """Whether a scan in `p` reads a column whose metadata is pending, or
    is bound to no table yet (no row count: a plan decoded from the wire
    before `rebind_scans`)."""
    if isinstance(p, TableScan):
        return bool(p.schema().pending) or p.table_schema.rows is None
    return any(_pending(c) for c in p.children())


def row_bound(p: LogicalPlan) -> Optional[int]:
    """The most rows `p` may produce, from its tables' row counts (None
    where a table's is unknown): a filter, projection, sort or aggregate
    keeps its input's; a join on a unique build side (or a semi / anti
    join) its probe side's, plus the build side's for an outer join; any
    other join the product."""
    if isinstance(p, TableScan):
        return p.table_schema.rows
    if isinstance(p, OneRow):
        return 1
    kids = [row_bound(c) for c in p.children()]
    if any(k is None for k in kids):
        return None
    if isinstance(p, Union):
        return sum(kids)
    if isinstance(p, Join):
        left, right = kids
        if p.how in ("semi", "anti"):
            return right
        if p.how != "cross" and p.unique_build:
            return right + (left if p.how in ("left_outer", "full_outer")
                            else 0)
        return left * right
    if isinstance(p, Limit):
        return min(kids[0], p.n)
    return kids[0]


@dataclasses.dataclass
class Union(LogicalPlan):
    """UNION ALL of schema-compatible inputs (bag semantics; wrap in
    Distinct for UNION)."""
    inputs: Tuple[LogicalPlan, ...]

    def schema(self):
        return self.inputs[0].schema()

    def children(self):
        return tuple(self.inputs)

    def _label(self):
        return f"Union(n={len(self.inputs)})"
