"""Lower a LogicalPlan to an ExecNode tree (port of
ballista_tpu/planner/physical.py).

Ported: Scan, Projection, Filter, Aggregate and Distinct (with a WHERE
fused into the aggregate's live mask), non-cross Join (with the filters
directly under each side fused into the join's live masks, except where
an outer join needs them as FilterExecs), Sort, Limit and OneRow. Cross
joins, and every other logical node, raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..batch import round_capacity
from ..exec.plan import (ExecNode, FilterExec, HashAggregateExec, HashJoinExec,
                         InputLeaf, LimitExec, OneRowExec, ProjectExec,
                         SortExec, _next_pow2)
from ..exprs import BinOp, Col
from . import logical as L


@dataclasses.dataclass
class PhysicalOptions:
    # cap on sorted-layout group slots (power of two); more groups than
    # the table holds trip the overflow flag, and the client retries with
    # 4x the cap. (The reference's group_table_hint sizes the distributed
    # runtime's tables: not ported.)
    max_group_table: int = 1 << 21
    # expanding-join output capacity = factor * (build_cap + probe_cap);
    # an overflow retries with 4x the factor
    join_out_factor: float = 1.0


def _strip_filters(p: L.LogicalPlan):
    """Peel Filter nodes off a plan; returns (inner, conjoined predicate).
    Used to fuse filtering into aggregation and join live masks."""
    preds = []
    while isinstance(p, L.Filter):
        preds.append(p.predicate)
        p = p.input
    if not preds:
        return p, None
    out = preds[0]
    for q in preds[1:]:
        out = BinOp("and", out, q)
    return p, out


def _is_cross(p: L.LogicalPlan) -> bool:
    return isinstance(p, L.Join) and p.how == "cross"


def create_physical_plan(plan: L.LogicalPlan, capacities: Dict[str, int],
                         options: Optional[PhysicalOptions] = None,
                         device="cpu") -> ExecNode:
    """capacities: table_name -> row capacity of its (single) partition;
    `device` is where FROM-less rows are made (scans bring their own)."""
    from .optimizer import prune_columns, reduce_group_keys
    opts = options or PhysicalOptions()
    plan = prune_columns(reduce_group_keys(plan))

    def table_size(child: ExecNode) -> int:
        return min(_next_pow2(max(2 * child.capacity, 16)),
                   opts.max_group_table)

    def lower(p: L.LogicalPlan) -> ExecNode:
        if isinstance(p, L.OneRow):
            return OneRowExec(device)
        if isinstance(p, L.TableScan):
            cap = capacities[p.table_name]
            if p.projection is not None:
                # column-scoped input id: only the projected columns are
                # bound (SessionContext.bind_inputs), so unused table
                # columns never reach device memory
                iid = p.table_name + "::" + ",".join(p.projection)
                return InputLeaf(iid, p.table_schema.select(p.projection), cap)
            return InputLeaf(p.table_name, p.table_schema, cap)
        if isinstance(p, L.Filter):
            if _is_cross(p.input):
                raise NotImplementedError(
                    "NestedLoopJoinExec / CrossJoinExec (a filtered cross "
                    "join) is not ported yet")
            return FilterExec(lower(p.input), p.predicate)
        if isinstance(p, L.Projection):
            return ProjectExec(lower(p.input), list(p.exprs),
                               names=list(p.names) if p.names else None)
        if isinstance(p, L.Aggregate):
            inp, pred = _strip_filters(p.input)
            if pred is not None and _is_cross(inp):
                raise NotImplementedError(
                    "NestedLoopJoinExec / CrossJoinExec (a filtered cross "
                    "join) is not ported yet")
            child = lower(inp)
            return HashAggregateExec(
                child, list(p.group_exprs), list(p.aggs), mode="single",
                table_size=table_size(child),
                group_names=list(p.group_names) if p.group_names else None,
                pre_filter=pred)
        if isinstance(p, L.Distinct):
            child = lower(p.input)
            return HashAggregateExec(
                child, [Col(f.name) for f in child.schema.fields], [],
                mode="single", table_size=table_size(child))
        if isinstance(p, L.Sort):
            return SortExec(lower(p.input), list(p.keys))
        if isinstance(p, L.Limit):
            return LimitExec(lower(p.input), p.n, getattr(p, "offset", 0))
        if isinstance(p, L.Join):
            if p.how == "cross":
                raise NotImplementedError("CrossJoinExec is not ported yet")
            # an outer join must not fuse a filter into a live mask where
            # the dropped rows would come back NULL-extended: a full outer
            # join keeps its build side's filters as FilterExecs, and the
            # unique-build outer path, which keeps probe rows in place,
            # its probe side's
            if p.how == "full_outer":
                binner, bpred = p.left, None
            else:
                binner, bpred = _strip_filters(p.left)
            if p.how in ("left_outer", "full_outer") and p.unique_build:
                pinner, ppred = p.right, None
            else:
                pinner, ppred = _strip_filters(p.right)
            build, probe = lower(binner), lower(pinner)
            out_cap = None
            if not p.unique_build and p.how not in ("semi", "anti"):
                out_cap = round_capacity(int(
                    opts.join_out_factor * (build.capacity + probe.capacity)))
            return HashJoinExec(build, probe, list(p.on), p.how,
                                unique_build=p.unique_build,
                                out_capacity=out_cap,
                                build_pre_filter=bpred,
                                probe_pre_filter=ppred)
        raise NotImplementedError(
            f"{type(p).__name__} is not ported yet")

    return lower(plan)
