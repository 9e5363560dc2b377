"""DataFrame API over logical plans (port of
ballista_tpu/client/dataframe.py).

Reference parity: `BallistaContext`'s DataFrame surface (delegating to
DataFusion DataFrame, `ballista/client/src/context.rs:80-420`): filter,
select, aggregate, sort, limit, join, collect.
"""

from __future__ import annotations

from typing import Sequence

from .. import batch as B
from ..exec.aggregate import AggExpr
from ..exprs import Col, Expr, Lit
from ..planner import logical as L


def col(name: str) -> Col:
    return Col(name)


def lit(value) -> Lit:
    return Lit(value)


class DataFrame:
    def __init__(self, ctx, plan: L.LogicalPlan):
        self._ctx = ctx
        self.plan = plan

    def schema(self):
        return self.plan.schema()

    def filter(self, predicate: Expr) -> "DataFrame":
        return DataFrame(self._ctx, L.Filter(self.plan, predicate))

    def select(self, *exprs: Expr) -> "DataFrame":
        return DataFrame(self._ctx, L.Projection(self.plan, tuple(exprs)))

    def select_columns(self, *names: str) -> "DataFrame":
        return self.select(*(Col(n) for n in names))

    def aggregate(self, group_exprs: Sequence[Expr],
                  aggs: Sequence[AggExpr]) -> "DataFrame":
        return DataFrame(self._ctx, L.Aggregate(self.plan, tuple(group_exprs),
                                                tuple(aggs)))

    def sort(self, *keys) -> "DataFrame":
        """keys: Expr (asc) or (Expr, ascending[, nulls_first]) tuples."""
        norm = []
        for k in keys:
            if isinstance(k, Expr):
                norm.append((k, True, None))
            elif len(k) == 2:
                norm.append((k[0], k[1], None))
            else:
                norm.append(tuple(k))
        return DataFrame(self._ctx, L.Sort(self.plan, tuple(norm)))

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(self._ctx, L.Limit(self.plan, n))

    def join(self, right: "DataFrame", on, how: str = "inner") -> "DataFrame":
        if isinstance(on, str):
            on = [(on, on)]
        elif on and isinstance(on[0], str):
            on = [(n, n) for n in on]
        return DataFrame(self._ctx, L.Join(self.plan, right.plan, tuple(on), how))

    def distinct(self) -> "DataFrame":
        return DataFrame(self._ctx, L.Distinct(self.plan))

    def explain(self) -> str:
        return self.plan.display()

    def collect(self):
        """Execute and return (Batch, Schema)."""
        return self._ctx.collect(self.plan)

    def converge(self, max_retries: int = 5):
        """(exec_plan, inputs, out): the physical plan that ran without
        overflow, for re-running with `run_plan(exec_plan, inputs)`
        (`SessionContext.converge`)."""
        return self._ctx.converge(self.plan, max_retries)

    def to_numpy(self) -> dict:
        """Live rows host-side: name -> (values, validity) numpy arrays;
        strings decoded, decimals as scaled int64."""
        return B.to_numpy(*self.collect())

    def to_pandas(self):
        return B.to_pandas(*self.collect())

    def to_arrow(self):
        return B.to_arrow(*self.collect())
