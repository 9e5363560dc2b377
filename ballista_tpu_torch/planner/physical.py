"""Lower a LogicalPlan to an ExecNode tree (port of
ballista_tpu/planner/physical.py).

Ported: Scan, Projection, Filter, Aggregate and Distinct (with a WHERE
fused into the aggregate's live mask), Join (with the filters directly
under each side fused into the join's live masks, except where an outer
join needs them as FilterExecs; a filtered cross join becomes a
NestedLoopJoinExec when its product is too large to materialize), Union,
Sort, Limit, Window and OneRow. The lowered tree goes through
`exec.plan.plan_sparse_flow`, which marks the filters and joins that may
hand their keep mask on instead of compacting, and then through
`exec.cse.cse_tree`, which shares structurally identical subtrees.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from ..batch import round_capacity
from ..exec.cse import cse_tree
from ..exec.plan import (CoalesceExec, CrossJoinExec, DictRemapExec, ExecNode,
                         FilterExec, HashAggregateExec, HashJoinExec,
                         InputLeaf, LimitExec, NestedLoopJoinExec, OneRowExec,
                         ProjectExec, SortExec, _next_pow2, _static_one_row,
                         plan_sparse_flow)
from ..exec.window import WindowExec
from ..exprs import BinOp, Col
from ..schema import TypeKind
from . import logical as L


@dataclasses.dataclass
class PhysicalOptions:
    # cap on sorted-layout group slots (power of two); more groups than
    # the table holds trip the overflow flag, and the retry grows the cap
    # to a power of two at or above the need the run counted, by at least
    # 4x (`scheduler.runtime.grow_capacities`). (The reference's
    # group_table_hint sizes the distributed runtime's tables: not ported.)
    max_group_table: int = 1 << 21
    # expanding-join output capacity = factor * (build_cap + probe_cap);
    # an overflow grows the factor the same way
    join_out_factor: float = 1.0


def align_union_inputs(kids: List[ExecNode]) -> List[ExecNode]:
    """Rename every input's columns to the first input's names, and
    re-encode string columns into union dictionaries where the inputs'
    dictionaries differ, so that codes agree across inputs."""
    names = [f.name for f in kids[0].schema.fields]
    renamed = [kids[0]] + [
        ProjectExec(k, [Col(f.name) for f in k.schema.fields], names=names)
        for k in kids[1:]]
    # a string column needs a shared dictionary when the inputs' differ,
    # or when some input has none (a typed NULL column: all codes invalid,
    # but the union's schema must still carry the dictionary)
    union_dicts = {}
    for i, f in enumerate(renamed[0].schema.fields):
        if f.dtype.kind is not TypeKind.STRING:
            continue
        dicts = [r.schema.dictionary(names[i]) for r in renamed]
        present = [d for d in dicts if d is not None]
        if not present:
            continue
        same = all(len(d) == len(present[0])
                   and (d.astype(str) == present[0].astype(str)).all()
                   for d in present[1:])
        if same and len(present) == len(dicts):
            continue
        union = np.unique(np.concatenate([d.astype(str) for d in present]))
        union_dicts[names[i]] = union.astype(object)
    if not union_dicts:
        return renamed
    out = []
    for r in renamed:
        luts = {}
        for n, u in union_dicts.items():
            d = r.schema.dictionary(n)
            if d is None:   # all NULL in this input: nothing to remap
                continue
            if len(d) == len(u) and (d.astype(str) == u.astype(str)).all():
                continue
            luts[n] = np.searchsorted(u.astype(str), d.astype(str))
        out.append(DictRemapExec(r, luts, union_dicts))
    return out


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


def filtered_cross(build: ExecNode, probe: ExecNode, predicate,
                   opts) -> ExecNode:
    """A predicate over a cross join of two lowered sides: a chunked
    NestedLoopJoinExec where the product passes CrossJoinExec.MAX_CELLS
    and neither side is statically one row, else a FilterExec over the
    CrossJoinExec. `opts.join_out_factor` sizes the nested loop's output."""
    if (build.capacity * probe.capacity > CrossJoinExec.MAX_CELLS
            and not _static_one_row(build) and not _static_one_row(probe)):
        return NestedLoopJoinExec(build, probe, predicate, opts)
    return FilterExec(CrossJoinExec(build, probe), predicate)


def create_physical_plan(plan: L.LogicalPlan, capacities: Dict[str, int],
                         options: Optional[PhysicalOptions],
                         device) -> ExecNode:
    """capacities: table_name -> row capacity of its (single) partition;
    `device` is where FROM-less rows are made (scans bring their own)."""
    from .optimizer import mark_carried, prune_columns, reduce_group_keys
    opts = options or PhysicalOptions()
    plan = mark_carried(prune_columns(reduce_group_keys(plan)))

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
                return lower_filtered_cross(p.input, p.predicate)
            return FilterExec(lower(p.input), p.predicate)
        if isinstance(p, L.Projection):
            return ProjectExec(lower(p.input), list(p.exprs),
                               names=list(p.names) if p.names else None)
        if isinstance(p, L.Aggregate):
            inp, pred = _strip_filters(p.input)
            if pred is not None and _is_cross(inp):
                # the stripped WHERE is the cross join's theta predicate:
                # the same lowering as a Filter over it
                child = lower_filtered_cross(inp, pred)
                pred = None
            else:
                child = lower(inp)
            return HashAggregateExec(
                child, list(p.group_exprs), list(p.sized_aggs()),
                mode="single",
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
                return CrossJoinExec(lower(p.left), lower(p.right))
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
        if isinstance(p, L.Window):
            return WindowExec(lower(p.input), p.specs)
        if isinstance(p, L.Union):
            return CoalesceExec(align_union_inputs([lower(c)
                                                    for c in p.inputs]))
        raise NotImplementedError(type(p).__name__)

    def lower_filtered_cross(join: L.Join, predicate) -> ExecNode:
        return filtered_cross(lower(join.left), lower(join.right), predicate,
                              opts)

    return cse_tree(plan_sparse_flow(lower(plan)))
