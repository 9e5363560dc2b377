"""DataFrame over a logical plan (port of ballista_tpu/client/dataframe.py)."""

from __future__ import annotations

from ..batch import to_numpy
from ..planner import logical as L


class DataFrame:
    def __init__(self, ctx, plan: L.LogicalPlan):
        self._ctx = ctx
        self.plan = plan

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
        return to_numpy(*self.collect())
