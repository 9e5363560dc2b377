"""Physical operator tree, run eagerly on torch tensors (port of
ballista_tpu/exec/plan.py).

Each node's `evaluate` maps a `Run` (the bound inputs, plus the overflow
flags nodes raise) to its output Batch on the inputs' device; `run_plan`
evaluates a whole tree (the JAX package compiled it into one XLA program
with `compile_stage` instead). Nodes: InputLeaf, OneRowExec, FilterExec,
ProjectExec, HashAggregateExec (`single`, `partial` and `final` modes,
direct-slot and sorted layouts), HashJoinExec (inner, left and full outer,
semi and anti, on a unique or a duplicate-key build), CrossJoinExec,
NestedLoopJoinExec, DictRemapExec, CoalesceExec, SortExec and LimitExec;
WindowExec lives in exec/window.py. A node reads a child through
`run.eval(child)`, so a subtree that `exec.cse.cse_tree` shares between
several parents is evaluated once per run.
"""

from __future__ import annotations

import os
import sys
import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..batch import LANE, Batch, Column, round_capacity, row_mask
from ..exprs import (Alias, Col, Expr, bind_expr, dict_cached, expr_name,
                     gather_lut, recode_tables, sorted_recode)
from ..ops import segagg
from ..ops.compact import compaction_perm, filter_batch, gather_batch
from ..ops.expand_join import expand_join
from ..ops.gather import gather_columns
from ..ops.hash import _norm_keys, pack_key_columns, plan_key_packing
from ..ops.masked_sums import WHOLE, masked_slot_sums_rows
from ..ops.merge_join import merge_full_unique, probe_unique
from ..ops.sort import SortKeySpec, sort_batch
from ..ops.vsort import compact_batch, sort_batch_columns
from ..schema import (FLOAT64, INT64, Field, Schema, narrow_wide,
                      wide_read_error)
from ..tracing import exec_span, span
from .aggregate import AggExpr, BoundAgg, _avg_dtype, _out_sum_dtype

# sorted-layout sentinel: dead rows sort behind every normalised key
DEAD = 2 ** 62


# what a capacity retry grows, in the order of Run.growth's entries
GROWTH_KINDS = ("group", "join")

# HashJoinExec's counts in this process: evaluations by mode ("unique",
# "expanding") and union-dictionary lookup tables built ("key_remap",
# `join_key_luts`); a host counter, read by difference around the calls
# of interest
JOIN_COUNTS: Counter = Counter()


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Run:
    """One evaluation of a plan: its bound inputs, the rows each node that
    can outgrow its static capacity needed beside that capacity (its
    overflow flag; the growth a retry needs), where each wide SUM narrowed
    to int64 passed it (`flag_wide`), and the outputs of the nodes that
    several parents share. The flags are read once, at the end
    (`verdict`).

    The serial and partitioned runtimes run a stage once per partition:
    `partition` is that partition's id (PartitionPruneExec reads it; None
    outside them) and `device` its device, where a node with no input
    makes its rows (None: the node's own); a run made with `trace=True`
    keeps each filter's, aggregate's and join's output row count in
    `op_rows` as (label, 0-d tensor), which the runtime sums into
    StageMetrics.operator_rows (the reference's `_TraceCtx.record_rows`).
    An untraced run keeps none. `kept` maps id(node) to an output already
    computed for that node: `eval` returns it instead of evaluating the
    node (the per-piece profiler runs a piece alone on its cut
    descendants' outputs that way)."""

    def __init__(self, inputs: Dict[str, Batch],
                 partition: Optional[int] = None, trace: bool = False,
                 device: Optional[torch.device] = None):
        self.inputs = inputs
        self.partition = partition
        self.device = device
        self.op_rows: Optional[List[tuple]] = [] if trace else None
        # (rows needed, rows held, index in GROWTH_KINDS) of each
        # operator that can overflow
        self.needs: List[Tuple[torch.Tensor, int, int]] = []
        # (passed, column) of each wide SUM narrowed to int64
        self.narrowed: List[Tuple[torch.Tensor, str]] = []
        self.evaluated = 0      # evaluate() calls made in this run
        # id(node) -> [output, parents that have not read it yet]
        self._shared: Dict[int, list] = {}
        self.kept: Dict[int, Batch] = {}

    def flag_overflow(self, need: torch.Tensor, have: int,
                      kind: str) -> None:
        """An operator whose static capacity holds `have` rows needed
        `need` (a 0-d tensor): the run overflowed where need > have.
        `kind` is what a retry grows for it: "group" (a group table,
        max_group_table) or "join" (a join output, join_out_factor)."""
        self.needs.append((need, have, GROWTH_KINDS.index(kind)))

    @property
    def flags(self) -> List[torch.Tensor]:
        """Each such operator's overflow flag (0-d bool tensors)."""
        return [need > have for need, have, _ in self.needs]

    def flag_wide(self, passed: torch.Tensor, column: str) -> None:
        """A wide SUM read above was narrowed to int64 as `column`;
        `passed` (a 0-d bool tensor) is true where a live value of it
        passed int64. Such a run fails (`overflowed`), unless an operator
        also overflowed: its retry comes first."""
        self.narrowed.append((passed, column))

    def wide_code(self) -> Optional[torch.Tensor]:
        """A 0-d int64 tensor: 1 + the index of the last narrowing whose
        value passed int64, 0 where none did; None without narrowings."""
        if not self.narrowed:
            return None
        passed = torch.stack([p for p, _ in self.narrowed])
        order = torch.arange(1, len(self.narrowed) + 1, device=passed.device)
        return (passed * order).max()

    def verdict(self) -> Optional[torch.Tensor]:
        """All the run's flags as one 0-d int64 tensor on the device, for
        one read: 0 where the output stands, -1 where an operator
        outgrew its capacity, else `wide_code`. None where the plan can
        do neither."""
        flags, code = self.flags, self.wide_code()
        if not flags and code is None:
            return None
        if code is None:
            code = torch.zeros((), dtype=torch.int64,
                               device=flags[0].device)
        for flag in flags:
            code = torch.where(flag.to(code.device), -1, code)
        return code

    def overflowed(self, verdict: int) -> bool:
        """Whether a run whose `verdict` was read on the host overflowed
        (a retry with larger capacities follows); raises the wide-decimal
        error where a narrowed value passed int64."""
        if verdict > 0:
            raise wide_read_error(self.narrowed[verdict - 1][1])
        return verdict < 0

    def growth(self) -> Optional[torch.Tensor]:
        """(len(GROWTH_KINDS),) int64: for each kind, how many times its
        capacity the neediest operator of that kind wanted, rounded up
        and at least 2 where one overflowed (1 where none did); None when
        no operator of the plan can overflow."""
        if not self.needs:
            return None
        dev = self.needs[0][0].device
        out = torch.ones(len(GROWTH_KINDS), dtype=torch.int64, device=dev)
        for need, have, kind in self.needs:
            need = need.to(dev, torch.int64)
            g = torch.where(need > have,
                            (-(-need // max(have, 1))).clamp(min=2), 1)
            out[kind] = torch.maximum(out[kind], g)
        return out

    def _evaluate(self, node: "ExecNode") -> Batch:
        self.evaluated += 1
        with exec_span(node):
            out = node.evaluate(self)
        if self.op_rows is not None and isinstance(node, _ROW_RECORDED):
            self.op_rows.append((node._label(), out.num_rows))
        return out

    def eval(self, node: "ExecNode") -> Batch:
        """`node`'s output in this run. A node with several parents
        (`n_parents`, set by exec.cse.cse_tree) is evaluated for the first
        of them, so it raises its overflow flag once, and its output is
        dropped when the last parent has read it. A node in `kept` is not
        evaluated."""
        out = self.kept.get(id(node))
        if out is not None:
            return out
        if node.n_parents <= 1:
            return self._evaluate(node)
        entry = self._shared.get(id(node))
        if entry is None:
            entry = self._shared[id(node)] = [self._evaluate(node),
                                              node.n_parents]
        entry[1] -= 1
        if entry[1] == 0:
            del self._shared[id(node)]
        return entry[0]


class ExecNode:
    """Base physical operator. Subclasses set .schema and .capacity at
    construction (host planning time) and implement .evaluate."""

    schema: Schema
    capacity: int
    children: Tuple["ExecNode", ...] = ()
    n_parents: int = 1   # parent edges after exec.cse.cse_tree

    def evaluate(self, run: Run) -> Batch:
        raise NotImplementedError

    def leaves(self) -> List["InputLeaf"]:
        if isinstance(self, InputLeaf):
            return [self]
        out = []
        for c in self.children:
            out.extend(c.leaves())
        return out

    def display(self, indent: int = 0) -> str:
        s = "  " * indent + self._label() + "\n"
        for c in self.children:
            s += c.display(indent + 1)
        return s

    def _label(self) -> str:
        return type(self).__name__


def _live_where(b: Batch, pred) -> torch.Tensor:
    """Live rows of `b` where the bound predicate is true and valid."""
    live = row_mask(b)
    if pred is not None:
        c = pred.fn(b)
        live = live & c.data.to(torch.bool) & c.validity
    return live


class InputLeaf(ExecNode):
    """Plan input: a table's columns, bound at run time. `one_row` marks a
    stage input that holds exactly one live row, at position 0."""

    one_row = False

    def __init__(self, input_id: str, schema: Schema, capacity: int):
        self.input_id = input_id
        self.schema = schema
        self.capacity = capacity
        self.children = ()

    def evaluate(self, run):
        return run.inputs[self.input_id]

    def _label(self):
        return f"InputLeaf({self.input_id}, cap={self.capacity})"


class OneRowExec(ExecNode):
    """A single constant row — FROM-less SELECT (`select 1+1`); the
    projection above evaluates literal expressions against it."""

    def __init__(self, device):
        self.children = ()
        self.capacity = LANE
        self.device = torch.device(device)
        self.schema = Schema((Field("__one", INT64, nullable=False),), {})

    def evaluate(self, run):
        device = run.device if run.device is not None else self.device
        live = torch.arange(self.capacity, device=device) < 1
        data = torch.zeros(self.capacity, dtype=torch.int64, device=device)
        return Batch((Column(data, live),),
                     torch.ones((), dtype=torch.int32, device=device))

    def _label(self):
        return "OneRowExec"


def _sparse(columns, keep: torch.Tensor) -> Batch:
    """The rows of `columns` where `keep`, left where they are: a sparse
    batch (its row count stays on the device)."""
    return Batch(tuple(columns), keep.sum().to(torch.int32), keep)


class FilterExec(ExecNode):
    """WHERE without an aggregate or join above to fuse it into: the kept
    rows are compacted to the front, or, with `emit_sparse` (set by
    `plan_sparse_flow` where the parent reads liveness through `row_mask`
    alone), left in place under the keep mask as `Batch.live`."""

    def __init__(self, child: ExecNode, predicate: Expr):
        self.children = (child,)
        self.predicate = predicate
        self.schema = child.schema
        self.capacity = child.capacity
        self._bound = bind_expr(predicate, child.schema)
        self.emit_sparse = False

    def evaluate(self, run):
        b = run.eval(self.children[0])
        if self.emit_sparse:
            return _sparse(b.columns, _live_where(b, self._bound))
        return filter_batch(b, self._bound.fn(b))

    def _label(self):
        return (f"FilterExec({self.predicate})"
                + (" sparse" if self.emit_sparse else ""))


class ProjectExec(ExecNode):
    def __init__(self, child: ExecNode, exprs: Sequence[Expr],
                 names: Optional[Sequence[str]] = None):
        self.children = (child,)
        self.exprs = tuple(exprs)
        self._bounds = [bind_expr(e, child.schema) for e in exprs]
        names = list(names) if names else [expr_name(e) for e in exprs]
        fields = tuple(Field(n, b.dtype, b.nullable)
                       for n, b in zip(names, self._bounds))
        # propagate dictionaries of passthrough columns, RAW ones as RAW
        dicts = {}
        unsorted = set()
        for n, e, b in zip(names, exprs, self._bounds):
            if b.dictionary is not None:
                dicts[n] = b.dictionary
                if not b.dict_sorted:
                    unsorted.add(n)
                continue
            base = e.child if isinstance(e, Alias) else e
            if isinstance(base, Col) and child.schema.dictionary(base.name) is not None:
                dicts[n] = child.schema.dictionary(base.name)
                if not child.schema.is_sorted_dict(base.name):
                    unsorted.add(n)
        bounds = {n: b.int_bound
                  for n, b in zip(names, self._bounds) if b.int_bound}
        self.schema = Schema(fields, dicts, bounds, unsorted)
        self.capacity = child.capacity

    def evaluate(self, run):
        b = run.eval(self.children[0])
        live = row_mask(b)
        cols = []
        for bound in self._bounds:
            c = bound.fn(b)
            cols.append(Column(c.data, c.validity & live))
        return b.replace_columns(cols)

    def _label(self):
        return f"ProjectExec({', '.join(map(str, self.exprs))})"


class HashAggregateExec(ExecNode):
    """GROUP BY. mode 'single' maps rows to output; 'partial' maps rows to
    state columns `name#s{i}` and 'final' merges the state rows of several
    partial aggregates (under a CoalesceExec, or an exchange) into the
    output. The WHERE clause may ride along as `pre_filter`, fused into
    the aggregate's live mask.

    Keys whose static code bounds multiply to at most MASKED_MAX direct
    slots (and no keys at all) take the masked layout: every int64 sum and
    count of every aggregate goes through ONE `masked_slot_sums_rows` launch;
    min, max and float sums use the plain MaskedLayout methods. Any other
    GROUP BY sorts the batch by its keys (direct slots up to DIRECT_MAX,
    else packed or normalised keys) and reduces runs with SortedLayout
    into `table_size` groups; more groups than that raise the run's
    overflow flag instead of clipping the answer."""

    def __init__(self, child: ExecNode, group_exprs: Sequence[Expr],
                 aggs: Sequence[AggExpr], mode: str = "single",
                 table_size: Optional[int] = None,
                 group_names: Optional[Sequence[str]] = None,
                 pre_filter: Optional[Expr] = None):
        if mode not in ("partial", "final", "single"):
            raise ValueError(f"HashAggregateExec: unknown mode {mode!r}")
        self.children = (child,)
        self.mode = mode
        self.group_exprs = tuple(group_exprs)
        self.aggs = tuple(aggs)
        self.pre_filter = pre_filter
        self._pre_bound = (bind_expr(pre_filter, child.schema)
                           if pre_filter is not None else None)
        in_schema = child.schema
        # RAW string keys group by their re-encoded codes: a RAW code is a
        # row index, so equal values have different codes. A `carry`
        # keeps its RAW codes (any code of an all-equal group decodes to
        # the value)
        self._group_bounds = [sorted_recode(bind_expr(e, in_schema))
                              for e in group_exprs]
        self._group_names = (list(group_names) if group_names
                             else [expr_name(e) for e in group_exprs])
        self._key_nullables = [b.nullable for b in self._group_bounds]
        self._code_bounds = [b.code_bound for b in self._group_bounds]
        if table_size is None:
            table_size = min(_next_pow2(max(child.capacity, 16)), 1 << 16)
        self.table_size = table_size
        # static grouping-strategy choice: the composite direct-slot count
        # when every key has a code bound and the product is small enough
        self._static_direct_T = None
        if group_exprs and all(b is not None for b in self._code_bounds):
            prod = 1
            for b, nu in zip(self._code_bounds, self._key_nullables):
                prod *= b + (1 if nu else 0)
            if prod <= segagg.DIRECT_MAX:
                self._static_direct_T = prod
        self._masked = (not group_exprs or (
            self._static_direct_T is not None
            and self._static_direct_T <= segagg.MASKED_MAX))
        if not group_exprs:
            self.T = 1
            self.capacity = LANE
        elif self._static_direct_T is not None:
            self.T = self._static_direct_T if self._masked else table_size
            self.capacity = max(LANE, round_capacity(self._static_direct_T))
        else:
            # group-count bound from key metadata: distinct group tuples
            # <= prod over keys of min(dictionary size, int-bound range
            # width, expression ndv bound) — hard bounds that shrink the
            # table and the output the operators above carry
            G = 1
            cap_now = min(table_size, child.capacity)
            for gb, nu in zip(self._group_bounds, self._key_nullables):
                k = gb.code_bound
                if gb.int_bound is not None:
                    lo, hi = gb.int_bound
                    width = int(hi) - int(lo) + 1
                    k = width if k is None else min(k, width)
                if gb.ndv_bound is not None:
                    k = gb.ndv_bound if k is None else min(k, gb.ndv_bound)
                if k is None or k <= 0:
                    G = None
                    break
                G *= k + (1 if nu else 0)
                if G >= cap_now:  # bound no tighter than existing sizing
                    G = None
                    break
            if G is not None:
                table_size = min(table_size, _next_pow2(max(G, 16)))
                self.table_size = table_size
            self.T = table_size
            self.capacity = max(LANE, min(table_size, child.capacity))
            if G is not None:
                self.capacity = min(self.capacity,
                                    max(LANE, round_capacity(G)))

        key_fields = tuple(Field(n, b.dtype, b.nullable)
                           for n, b in zip(self._group_names, self._group_bounds))
        dicts = {}
        for n, e, b in zip(self._group_names, group_exprs, self._group_bounds):
            if b.dictionary is not None:
                dicts[n] = b.dictionary
                continue
            base = e.child if isinstance(e, Alias) else e
            if isinstance(base, Col) and in_schema.dictionary(base.name) is not None:
                dicts[n] = in_schema.dictionary(base.name)
        bounds = {n: b.int_bound
                  for n, b in zip(self._group_names, self._group_bounds)
                  if b.int_bound}
        # where a min/max/carry keeps its dictionary and int bounds: under
        # the first state column between the two phases
        suffix = "#s0" if mode == "partial" else ""
        unsorted = set()
        if mode == "final":
            # the child emits key columns + state columns
            self._bound_aggs = [_final_agg(a, in_schema) for a in aggs]
            self._state_idx = [
                [i for i, f in enumerate(in_schema.fields)
                 if f.name.startswith(f"{a.name}#s")] for a in aggs]
            for a in aggs:
                if a.kind in ("min", "max", "carry"):
                    if in_schema.dictionary(f"{a.name}#s0") is not None:
                        dicts[a.name] = in_schema.dictionary(f"{a.name}#s0")
                        if not in_schema.is_sorted_dict(f"{a.name}#s0"):
                            unsorted.add(a.name)
                    if in_schema.int_bound(f"{a.name}#s0") is not None:
                        bounds[a.name] = in_schema.int_bound(f"{a.name}#s0")
        else:
            self._bound_aggs = [BoundAgg(a, in_schema) for a in aggs]
            for ba in self._bound_aggs:
                # dict-coded min/max stay in code space (sorted
                # dictionaries make code extrema exact; a RAW argument is
                # re-encoded first)
                a = ba.spec
                if a.kind not in ("min", "max", "carry"):
                    continue
                if a.kind != "carry":
                    ba.arg = sorted_recode(ba.arg)
                if ba.arg.dictionary is not None:
                    dicts[a.name + suffix] = ba.arg.dictionary
                    if not ba.arg.dict_sorted:
                        unsorted.add(a.name + suffix)
                base = a.arg.child if isinstance(a.arg, Alias) else a.arg
                if isinstance(base, Col) and in_schema.int_bound(base.name):
                    bounds[a.name + suffix] = in_schema.int_bound(base.name)
        if mode == "partial":
            agg_fields = tuple(f for ba in self._bound_aggs
                               for f in ba.state_fields())
        else:
            agg_fields = tuple(ba.out_field for ba in self._bound_aggs)
        # (output column, name shown) of the wide sums narrowed to int64
        self._narrow = [] if mode == "partial" else [
            (len(key_fields) + j,
             ba.spec.shown or f"sum({expr_name(ba.spec.arg)})")
            for j, ba in enumerate(self._bound_aggs) if ba.narrow]
        self.schema = Schema(key_fields + agg_fields, dicts, bounds, unsorted)

    def _child_states(self, b: Batch, i: int) -> List[Column]:
        """final mode: the child's state columns of aggregate i."""
        return [b.columns[j] for j in self._state_idx[i]]

    def _states(self, b: Batch, i: int, layout) -> List[Column]:
        """Aggregate i's per-group states over a layout: merged from the
        child's state rows in final mode, else computed from its rows."""
        ba = self._bound_aggs[i]
        if self.mode == "final":
            return ba.merge(self._child_states(b, i), layout)
        return ba.partial(b, layout)

    def _emit(self, ba: BoundAgg, states: List[Column]) -> List[Column]:
        """An aggregate's output columns from its (merged) states."""
        return states if self.mode == "partial" else [ba.finalize(states)]

    def evaluate(self, run):
        b = run.eval(self.children[0])
        live = _live_where(b, self._pre_bound)
        key_cols = [g.fn(b) for g in self._group_bounds]
        if not self._masked:
            return self._evaluate_sorted(run, b, live, key_cols)
        if key_cols:
            slot, T = segagg.direct_slots(key_cols, self._code_bounds, live,
                                          self._key_nullables)
        else:
            slot, T = torch.where(live, 0, 1).to(torch.int32), 1
        layout = segagg.MaskedLayout(slot, live, T)
        count_star, states = self._aggregate(b, layout)

        key_out: List[Column] = []
        if key_cols:
            used = count_star > 0
            n_groups = used.sum().to(torch.int32)
            slot_ids = torch.arange(T, dtype=torch.int32, device=b.device)
            for col in segagg.decode_direct_slot(slot_ids, key_cols,
                                                 self._code_bounds,
                                                 self._key_nullables):
                key_out.append(Column(col.data, col.validity & used))
        else:
            used = None
            n_groups = torch.ones((), dtype=torch.int32, device=b.device)
        out_cols = key_out + [c for ba, st in zip(self._bound_aggs, states)
                              for c in self._emit(ba, st)]
        return self._finish(run, out_cols, T, n_groups, used)

    def _evaluate_sorted(self, run, b: Batch, live, key_cols):
        """Sort the whole batch by the group keys (dead rows last), then
        reduce the runs of equal keys."""
        if self._static_direct_T is not None:
            slot, _ = segagg.direct_slots(key_cols, self._code_bounds, live,
                                          self._key_nullables)
            norm = [slot.to(torch.int64)]
        else:
            # pack bounded keys into shared limbs: fewer sort keys
            kb = [gb.int_bound
                  or ((0, gb.code_bound - 1) if gb.code_bound else None)
                  for gb in self._group_bounds]
            grp, unp = plan_key_packing(kb, null_slots=True)
            kcols = key_cols
            if len(grp) + len(unp) < len(key_cols):
                kcols = pack_key_columns(key_cols, grp, unp, True)
            norm = _norm_keys([c.data for c in kcols],
                              [c.validity for c in kcols])
        skeys = [torch.where(live, k, DEAD) for k in norm]
        b, (live,), s_sorted = sort_batch_columns(skeys, b, extra=(live,))
        # key columns re-evaluated on the sorted batch
        key_cols = [g.fn(b) for g in self._group_bounds]
        layout = segagg.layout_from_sorted_keys(s_sorted, live,
                                                self.table_size)
        T_used = layout.T  # clamped to row capacity
        run.flag_overflow(layout.n_groups, T_used, "group")
        n_groups = layout.n_groups.clamp(max=T_used).to(torch.int32)
        gvalid = torch.arange(T_used, device=b.device) < n_groups
        src = layout.run_start
        out_cols = [Column(kc.data.index_select(0, src),
                           kc.validity.index_select(0, src) & gvalid)
                    for kc in key_cols]
        for i, ba in enumerate(self._bound_aggs):
            out_cols += self._emit(ba, self._states(b, i, layout))
        return self._finish(run, out_cols, T_used, n_groups, None)

    def _aggregate(self, b: Batch, layout: segagg.MaskedLayout):
        """(per-slot count(*), per-aggregate state columns).

        The int64 sums and counts of all aggregates become the described
        rows (data column, validity column) of one masked_slot_sums_rows
        call, which reads the columns themselves: no contribution matrix
        is written. In `single` and `partial` mode rows are keyed by
        (kind, argument), so sum(x) and avg(x) share a sum row and every
        count over x shares a count row; in `final` mode the rows are the
        child's int64 state columns, each summed once. Dead rows carry
        slot T, so a row only needs its argument's validity applied."""
        count_star = ("count", None)
        rows = {count_star: (None, None)}   # key -> (data, validity[, half])
        plans = []
        for i, ba in enumerate(self._bound_aggs):
            if not ba.exact_sums:
                plans.append((ba, None, None))
                continue
            if self.mode == "final":
                reqs, tags, assemble = ba.fused_merge_requests(
                    self._child_states(b, i), self._state_idx[i])
            else:
                reqs, tags, assemble = ba.fused_requests(b)
            # per request: (the row that holds its value, the count row
            # that says where it is valid, or None for everywhere)
            keys = []
            for (kind, data, validity, half), tag in zip(reqs, tags):
                count, total = ("count", tag), ("sum", tag, half)
                if kind != "total":
                    rows.setdefault(count, (None, validity))
                if kind != "count":
                    rows.setdefault(total, (data, validity) if half == WHOLE
                                    else (data, validity, half))
                keys.append({"count": (count, None), "sum": (total, count),
                             "total": (total, None)}[kind])
            plans.append((ba, keys, assemble))

        sums = masked_slot_sums_rows(layout.row_slot, list(rows.values()),
                                     layout.T)
        per_slot = {key: sums[:, i] for i, key in enumerate(rows)}

        ones = torch.ones(layout.T, dtype=torch.bool, device=b.device)
        states = []
        for i, (ba, keys, assemble) in enumerate(plans):
            if keys is None:
                states.append(self._states(b, i, layout))
                continue
            outs = [Column(per_slot[value],
                           ones if valid is None else per_slot[valid] > 0)
                    for value, valid in keys]
            states.append(assemble(outs))
        return per_slot[count_star], states

    def _finish(self, run, out_cols, T: int, n_groups, used):
        """Compact the used slots to the front (masked layout), fit the
        T group rows to the output capacity (n_groups <= capacity) and
        narrow the wide sums read above, flagging the run where a live
        value passes int64."""
        if used is not None:
            perm, _ = compaction_perm(used)
            out_cols = list(gather_batch(Batch(tuple(out_cols), n_groups),
                                         perm, n_groups).columns)
        cap = self.capacity
        live = torch.arange(cap, dtype=torch.int32,
                            device=n_groups.device) < n_groups
        cols = []
        for c in out_cols:
            data, valid = c.data[:cap], c.validity[:cap]
            if T < cap:
                data = torch.cat([data, data.new_zeros(
                    (cap - T,) + tuple(data.shape[1:]))])
                valid = torch.cat([valid, valid.new_zeros(cap - T)])
            cols.append(Column(data, valid & live))
        for i, shown in self._narrow:
            data, passed = narrow_wide(cols[i].data)
            run.flag_wide((passed & cols[i].validity).any(), shown)
            cols[i] = Column(data, cols[i].validity)
        return Batch(tuple(cols), n_groups)

    def _label(self):
        return (f"HashAggregateExec[{self.mode}](keys={self._group_names}, "
                f"aggs={[a.name for a in self.aggs]}, T={self.T})")


class HashJoinExec(ExecNode):
    """Build on the left child, probe with the right (DataFusion
    convention). join_type 'inner' keeps matched pairs with the build
    row's columns in front; 'left_outer' keeps every live probe row, the
    build columns NULL where it has no match; 'semi' and 'anti' keep the
    probe rows with and without a match (probe columns only).

    A unique build (each key at most once among live build rows) keeps
    the probe's capacity: inner, semi and anti compact the kept rows to
    the front in probe order, or with `emit_sparse` (`plan_sparse_flow`)
    leave them in place under the keep mask as `Batch.live`; left_outer
    keeps the probe batch's rows in place, so its probe side must come
    unfiltered (the planner keeps a FilterExec there; where that filter
    hands over a sparse batch, the joined rows are compacted). A duplicate-key build takes the expanding path
    (ops.expand_join, inner or left_outer): pairs in probe-row order, then
    build-row order, in a batch of `out_capacity` rows; a larger total
    raises the run's overflow flag, and the client retries with a larger
    capacity. 'full_outer' is left_outer followed by the live build rows
    that matched no probe row, with NULL probe columns; every output field
    is nullable and the capacity grows by the build's."""

    def __init__(self, build: ExecNode, probe: ExecNode,
                 on: Sequence[Tuple[str, str]], join_type: str = "inner",
                 unique_build: bool = True,
                 out_capacity: Optional[int] = None,
                 build_pre_filter: Optional[Expr] = None,
                 probe_pre_filter: Optional[Expr] = None):
        if join_type not in ("inner", "semi", "anti", "left_outer",
                             "full_outer"):
            raise ValueError(f"HashJoinExec: unknown join type {join_type!r}")
        self.children = (build, probe)
        self.on = tuple(on)
        self.join_type = join_type
        # fused predicates: filtering through the join's live masks
        self.build_pre_filter = build_pre_filter
        self.probe_pre_filter = probe_pre_filter
        self._build_pre = (bind_expr(build_pre_filter, build.schema)
                           if build_pre_filter is not None else None)
        self._probe_pre = (bind_expr(probe_pre_filter, probe.schema)
                           if probe_pre_filter is not None else None)
        # semi/anti only test existence: a duplicate build key is harmless
        self.unique_build = unique_build or join_type in ("semi", "anti")
        self.emit_sparse = False
        if self.unique_build:
            self.capacity = probe.capacity
        else:
            self.out_capacity = out_capacity or round_capacity(
                build.capacity + probe.capacity)
            self.capacity = self.out_capacity
        if join_type == "full_outer":
            # room for the appended unmatched build rows
            self.capacity = round_capacity(self.capacity + build.capacity)
        self._build_idx = [build.schema.index_of(a) for a, _ in on]
        self._probe_idx = [probe.schema.index_of(b) for _, b in on]
        # dictionary-coded join keys: codes from DIFFERENT dictionaries are
        # not comparable — remap both sides into the sorted union
        # dictionary (host-built lookup tables). Shared or remapped
        # dictionary keys also gain a packing bound of the dictionary size.
        self._key_luts: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        dict_bounds: Dict[int, tuple] = {}
        for ki, (a, bn) in enumerate(self.on):
            da = build.schema.dictionary(a)
            db = probe.schema.dictionary(bn)
            if da is None and db is None:
                continue
            if da is None or db is None:
                raise ValueError(
                    f"join key {a}={bn}: string/non-string mismatch")
            sa, sb = (build.schema.is_sorted_dict(a),
                      probe.schema.is_sorted_dict(bn))
            if sa and sb and da is db:
                dict_bounds[ki] = (0, max(len(da) - 1, 0))
                continue
            with span("ballista.join.key_remap"):
                luts, n_union = join_key_luts(da, sa, db, sb)
            if luts is not None:
                self._key_luts[ki] = luts
            dict_bounds[ki] = (0, max(n_union - 1, 0))

        # multi-key joins: pack bounded keys into shared limbs (both sides
        # use the merged bounds so equality is preserved)
        self._key_pack = None
        if len(on) > 1:
            merged = []
            for ki, (a, b) in enumerate(on):
                if ki in dict_bounds:
                    merged.append(dict_bounds[ki])
                    continue
                ba = build.schema.int_bound(a)
                pb = probe.schema.int_bound(b)
                merged.append(None if ba is None or pb is None
                              else (min(ba[0], pb[0]), max(ba[1], pb[1])))
            grp, unp = plan_key_packing(merged, null_slots=False)
            if len(grp) + len(unp) < len(on):
                self._key_pack = (grp, unp)
        if join_type in ("semi", "anti"):
            self.schema = probe.schema
        else:
            self.schema = _joined_schema(build.schema, probe.schema,
                                         nullable=join_type == "full_outer")

    def _keys(self, batch: Batch, idx, side: int) -> List[Column]:
        keys = [batch.columns[i] for i in idx]
        for ki, luts in self._key_luts.items():
            c = keys[ki]
            keys[ki] = Column(gather_lut(luts[side], c), c.validity)
        if self._key_pack is not None:
            keys = pack_key_columns(keys, *self._key_pack, False)
        return keys

    def evaluate(self, run):
        build_b = run.eval(self.children[0])
        probe_b = run.eval(self.children[1])
        blive = _live_where(build_b, self._build_pre)
        plive = _live_where(probe_b, self._probe_pre)
        bkeys = self._keys(build_b, self._build_idx, 0)
        pkeys = self._keys(probe_b, self._probe_idx, 1)
        if not self.unique_build:
            JOIN_COUNTS["expanding"] += 1
            return self._evaluate_expanding(run, build_b, probe_b, bkeys,
                                            pkeys, blive, plive)
        JOIN_COUNTS["unique"] += 1
        args = ([c.data for c in bkeys], [c.validity for c in bkeys], blive,
                [c.data for c in pkeys], [c.validity for c in pkeys], plive)
        with span("ballista.join.probe"):
            if self.join_type == "full_outer":
                match, build_matched = merge_full_unique(*args)
            else:
                match = probe_unique(*args)
        matched = match >= 0
        if self.join_type in ("semi", "anti"):
            keep = (matched if self.join_type == "semi" else ~matched) & plive
            if self.emit_sparse:
                return _sparse(probe_b.columns, keep)
            return compact_batch(probe_b, keep)

        # build KEY columns need no gather: the equality join makes their
        # matched values identical to the probe key's (same-dictionary and
        # non-dictionary keys only)
        synth = {}
        for ki, (bi, pi) in enumerate(zip(self._build_idx, self._probe_idx)):
            if ki not in self._key_luts:
                bdt = build_b.columns[bi].data.dtype
                synth[bi] = Column(probe_b.columns[pi].data.to(bdt), matched)
        gidx = [i for i in range(len(build_b.columns)) if i not in synth]
        gathered = iter(gather_columns([build_b.columns[i] for i in gidx],
                                       match.clamp(min=0), valid_and=matched))
        build_cols = tuple(synth[i] if i in synth else next(gathered)
                           for i in range(len(build_b.columns)))
        if self.join_type in ("left_outer", "full_outer"):
            build_cols = _zero_unmatched(build_cols, matched)
        joined = Batch(build_cols + probe_b.columns, probe_b.num_rows,
                       probe_b.live)
        if self.join_type == "left_outer":
            # every probe row survives in place; build columns are
            # already NULL where it found no match. The probe is dense
            # here (`plan_sparse_flow`), so the output is too
            return joined
        if self.join_type == "full_outer":
            return self._append_unmatched_build(joined, build_b,
                                                blive & ~build_matched)
        if self.emit_sparse:
            return _sparse(joined.columns, matched & plive)
        return compact_batch(joined, matched & plive)

    def _append_unmatched_build(self, joined: Batch, build_b: Batch,
                                keep: torch.Tensor) -> Batch:
        """FULL OUTER tail: the unmatched live build rows, compacted, with
        NULL probe columns, after the probe-positional (or expanded)
        rows."""
        extra_build = compact_batch(build_b, keep)
        cap_b = build_b.capacity
        null_probe = tuple(
            Column(c.data.new_zeros(cap_b),
                   torch.zeros(cap_b, dtype=torch.bool, device=c.data.device))
            for c in joined.columns[len(build_b.columns):])
        extra = Batch(extra_build.columns + null_probe, extra_build.num_rows)
        return concat_batches([joined, extra], self.capacity)

    def _evaluate_expanding(self, run, build_b, probe_b, bkeys, pkeys,
                            blive, plive):
        """Duplicate-key build: output slot j holds (probe row, k-th
        matching build row) from ops.expand_join."""
        outer = self.join_type in ("left_outer", "full_outer")
        with span("ballista.join.probe"):
            em = expand_join(
                [c.data for c in bkeys], [c.validity for c in bkeys], blive,
                [c.data for c in pkeys], [c.validity for c in pkeys], plive,
                self.out_capacity, left_outer=outer)
        run.flag_overflow(em.need, self.out_capacity, "join")
        matched = em.build_row >= 0
        build_cols = gather_columns(build_b.columns,
                                    em.build_row.clamp(min=0),
                                    valid_and=matched)
        if outer:
            build_cols = _zero_unmatched(build_cols, matched)
        cols = (tuple(build_cols)
                + tuple(gather_columns(probe_b.columns,
                                       em.probe_row.clamp(min=0),
                                       valid_and=em.valid)))
        out = Batch(tuple(cols), em.total)
        if self.join_type == "full_outer":
            out = self._append_unmatched_build(out, build_b,
                                               blive & ~em.build_matched)
        return out

    def _label(self):
        mode = "unique" if self.unique_build else "expanding"
        return (f"HashJoinExec[{self.join_type},{mode}](on={list(self.on)})"
                + (" sparse" if self.emit_sparse else ""))


def join_key_luts(da: np.ndarray, a_sorted: bool, db: np.ndarray,
                  b_sorted: bool
                  ) -> Tuple[Optional[Tuple[np.ndarray, np.ndarray]], int]:
    """The lookup tables that put the codes of two dictionaries of one join
    key into their sorted union (each side's distinct values, a RAW side's
    through its dense-rank tables; a RAW dictionary repeats values under
    different codes, so even one shared RAW dictionary needs them), and
    the union's size; no tables (None) for two equal sorted dictionaries.
    Made once per pair of dictionary objects (`dict_cached`; the entry
    holds both, so neither id is reused while it lives): a plan is built
    anew on every collect. Each build counts in JOIN_COUNTS
    ("key_remap")."""
    def make():
        if a_sorted and b_sorted and len(da) == len(db) and \
                bool((da == db).all()):
            return db, None, len(da)
        JOIN_COUNTS["key_remap"] += 1
        sides = [(d, np.arange(max(len(d), 1))) if srt else recode_tables(d)
                 for d, srt in ((da, a_sorted), (db, b_sorted))]
        union = np.unique(np.concatenate([u.astype(str) for u, _ in sides]))

        def lut(uniq, rank):
            if not len(uniq):
                return np.zeros(1, np.int64)
            return np.searchsorted(union, uniq.astype(str)).astype(
                np.int64)[rank]
        return db, (lut(*sides[0]), lut(*sides[1])), len(union)
    _, luts, n_union = dict_cached(da, ("join_key_luts", id(db), a_sorted,
                                        b_sorted), make)
    return luts, n_union


def _zero_unmatched(cols: Sequence[Column],
                    matched: torch.Tensor) -> Tuple[Column, ...]:
    """The NULL-extended build cells of an outer join hold 0 (code 0 of a
    string column), as the NULL probe cells of a full outer join do: the
    answer's bytes do not depend on the build row a miss was gathered
    from."""
    out = []
    for c in cols:
        m = matched.view(-1, *([1] * (c.data.dim() - 1)))
        out.append(Column(torch.where(m, c.data, c.data.new_zeros(())),
                          c.validity))
    return tuple(out)


def _final_agg(a: AggExpr, in_schema: Schema) -> BoundAgg:
    """The BoundAgg of a `final` aggregate: its argument is gone, its
    state dtypes are those of the child's `name#s{i}` fields."""
    ba = BoundAgg.__new__(BoundAgg)
    ba.spec = a
    ba.arg = None
    ba.state_dtypes = [f.dtype for f in in_schema.fields
                       if f.name.startswith(f"{a.name}#s")]
    if not ba.state_dtypes:
        raise ValueError(f"final aggregate {a.name}: no state columns in "
                         f"{in_schema}")
    k = a.kind
    if k in ("count", "count_star"):
        ba.out_field = Field(a.name, INT64, nullable=False)
    elif k == "sum":
        ba.out_field = Field(a.name, _out_sum_dtype(a, ba.state_dtypes[0]),
                             nullable=True)
    elif k in ("min", "max", "carry"):
        ba.out_field = Field(a.name, ba.state_dtypes[0], nullable=True)
    elif k == "avg":
        ba.out_field = Field(a.name, _avg_dtype(ba.state_dtypes[0]),
                             nullable=True)
    else:   # moments and corr finalize to f64
        ba.out_field = Field(a.name, FLOAT64, nullable=True)
    return ba


def _joined_schema(build: Schema, probe: Schema,
                   nullable: bool = False) -> Schema:
    """Build columns, then probe columns (every field nullable when
    `nullable`); names must not repeat."""
    fields = build.fields + probe.fields
    if nullable:
        fields = tuple(Field(f.name, f.dtype, True) for f in fields)
    names = [f.name for f in fields]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate column names in join output: {names}")
    dicts = dict(build.dictionaries)
    dicts.update(probe.dictionaries)
    bounds = dict(build.int_bounds)
    bounds.update(probe.int_bounds)
    return Schema(fields, dicts, bounds, build.unsorted | probe.unsorted)


def _static_one_row(node: ExecNode) -> bool:
    """Nodes that always produce exactly one live row, at position 0: a
    no-key aggregate (one row even over an empty input), OneRowExec and
    the stage input that gathers such a row (`InputLeaf.one_row`, set by
    the stage planner), seen through the positional wrappers above them."""
    while isinstance(node, (ProjectExec, DictRemapExec)):
        node = node.children[0]
    if isinstance(node, HashAggregateExec):
        return not node.group_exprs
    return isinstance(node, OneRowExec) or (isinstance(node, InputLeaf)
                                            and node.one_row)


def _fit(b: Batch, capacity: int) -> Batch:
    """`b` cut or zero-padded to `capacity` rows, rows from num_rows on
    dead. (The reference tiles with jnp.resize; only dead rows land past
    num_rows, so padding gives the same batch.)"""
    n = b.capacity
    live = torch.arange(capacity, dtype=torch.int32,
                        device=b.device) < b.num_rows
    cols = []
    for c in b.columns:
        data, valid = c.data[:capacity], c.validity[:capacity]
        if n < capacity:
            data = torch.cat([data, data.new_zeros(capacity - n)])
            valid = torch.cat([valid, valid.new_zeros(capacity - n)])
        cols.append(Column(data, valid & live))
    return Batch(tuple(cols), b.num_rows)


class CrossJoinExec(ExecNode):
    """Cartesian product: output row j is (build row j // probe capacity,
    probe row j % probe capacity), compacted. A side that statically holds
    one row (a no-key aggregate: the three-valued NOT IN count of Q16)
    broadcasts instead, and the output keeps the other side's capacity.
    Any other product is bounded by MAX_CELLS; the planner sends a
    filtered product above it to NestedLoopJoinExec."""

    MAX_CELLS = 1 << 24

    def __init__(self, build: ExecNode, probe: ExecNode):
        self.children = (build, probe)
        self._bcast = None
        if _static_one_row(build):
            self._bcast = "build"
            self.capacity = probe.capacity
        elif _static_one_row(probe):
            self._bcast = "probe"
            self.capacity = build.capacity
        else:
            cells = build.capacity * probe.capacity
            if cells > self.MAX_CELLS:
                raise NotImplementedError(
                    f"cross join of {build.capacity}x{probe.capacity} rows "
                    f"exceeds the {self.MAX_CELLS} cell bound")
            self.capacity = round_capacity(cells)
        self.schema = _joined_schema(build.schema, probe.schema)

    def evaluate(self, run):
        build_b = run.eval(self.children[0])
        probe_b = run.eval(self.children[1])
        total = (build_b.num_rows * probe_b.num_rows).to(torch.int32)
        if self._bcast is not None:
            one, many = ((build_b, probe_b) if self._bcast == "build"
                         else (probe_b, build_b))
            # the one-row side has its row unless its input was empty
            # (OneRowExec); many's rows stay dense in place
            live = row_mask(many) & (one.num_rows > 0)
            cap = many.capacity
            ones = tuple(Column(c.data[:1].expand(cap),
                                c.validity[:1].expand(cap) & live)
                         for c in one.columns)
            manys = tuple(Column(c.data, c.validity & live)
                          for c in many.columns)
            cols = ones + manys if self._bcast == "build" else manys + ones
            return Batch(cols, total)
        nb_cap, np_cap = build_b.capacity, probe_b.capacity
        j = torch.arange(nb_cap * np_cap, dtype=torch.int64,
                         device=build_b.device)
        bi, pi = j // np_cap, j % np_cap
        valid = (bi < build_b.num_rows) & (pi < probe_b.num_rows)
        cols = (gather_columns(build_b.columns, bi, valid_and=valid)
                + gather_columns(probe_b.columns, pi, valid_and=valid))
        out = compact_batch(Batch(tuple(cols), total), valid)
        return _fit(out, self.capacity)

    def _label(self):
        return "CrossJoinExec" + (f"[broadcast {self._bcast}]"
                                  if self._bcast else "")


class NestedLoopJoinExec(ExecNode):
    """Chunked theta join: a predicate over a cross product too large to
    materialize. The build side is taken in chunks of `chunk_b` rows, so
    one chunk's pairs stay within CrossJoinExec.MAX_CELLS; each chunk
    evaluates the predicate over its pairs and writes the kept ones, in
    order (chunk by chunk, build-row major), to the next free output rows.
    The output offset stays a device tensor, so the chunk loop never waits
    for the device. The capacity follows join_out_factor; a larger total
    raises the run's overflow flag, and the retry grows the factor to the
    total counted (`Run.growth`)."""

    def __init__(self, build: ExecNode, probe: ExecNode, predicate: Expr,
                 opts):
        self.children = (build, probe)
        self.predicate = predicate
        self.schema = _joined_schema(build.schema, probe.schema)
        self._bound = bind_expr(predicate, self.schema)
        cells = build.capacity * probe.capacity
        self.capacity = round_capacity(int(min(cells, max(
            opts.join_out_factor * (build.capacity + probe.capacity), 128))))
        self.chunk_b = max(1, CrossJoinExec.MAX_CELLS // probe.capacity)
        self.n_chunks = -(-build.capacity // self.chunk_b)

    def evaluate(self, run):
        build_b = run.eval(self.children[0])
        probe_b = run.eval(self.children[1])
        dev = build_b.device
        bcap, pcap = build_b.capacity, probe_b.capacity
        cb, out_cap = self.chunk_b, self.capacity
        b_live, p_live = row_mask(build_b), row_mask(probe_b)
        j = torch.arange(cb * pcap, dtype=torch.int64, device=dev)
        row_in_chunk, q = j // pcap, j % pcap
        q_live = p_live.index_select(0, q)
        probe_cols = gather_columns(probe_b.columns, q)
        # every pair of a chunk is written: a kept pair that fits to its
        # output row, any other pair j to the spare row out_cap + j, so no
        # two writes meet; the spare rows are dropped at the end
        all_cols = build_b.columns + probe_b.columns
        out_data = [c.data.new_zeros(out_cap + j.shape[0]) for c in all_cols]
        out_valid = [torch.zeros(out_cap + j.shape[0], dtype=torch.bool,
                                 device=dev) for _ in all_cols]
        offset = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(self.n_chunks):
            r = i * cb + row_in_chunk
            rc = r.clamp(max=bcap - 1)
            live = (r < bcap) & b_live.index_select(0, rc) & q_live
            pair_cols = tuple(
                gather_columns(build_b.columns, rc, valid_and=live)
                + [Column(c.data, c.validity & live) for c in probe_cols])
            pair = Batch(pair_cols, live.sum().to(torch.int32))
            pred = self._bound.fn(pair)
            keep = pred.data.to(torch.bool) & pred.validity & live
            pos = offset + torch.cumsum(keep, 0) - 1
            dest = torch.where(keep & (pos < out_cap), pos, out_cap + j)
            for od, ov, c in zip(out_data, out_valid, pair_cols):
                od.index_copy_(0, dest, c.data)
                ov.index_copy_(0, dest, c.validity)
            offset = offset + keep.sum()
        run.flag_overflow(offset, out_cap, "join")
        num_rows = offset.clamp(max=out_cap).to(torch.int32)
        live = torch.arange(out_cap, dtype=torch.int32, device=dev) < num_rows
        return Batch(tuple(Column(d[:out_cap], v[:out_cap] & live)
                           for d, v in zip(out_data, out_valid)), num_rows)

    def _label(self):
        return (f"NestedLoopJoinExec({self.predicate}, "
                f"chunks={self.n_chunks})")


class DictRemapExec(ExecNode):
    """Re-encode dictionary-coded string columns into new (union)
    dictionaries through host-built lookup tables: UNION branches whose
    string columns carry different dictionaries."""

    def __init__(self, child: ExecNode, luts: Dict[str, np.ndarray],
                 new_dicts: Dict[str, np.ndarray]):
        self.children = (child,)
        self.capacity = child.capacity
        self._luts = {child.schema.index_of(n): np.asarray(l, dtype=np.int32)
                      for n, l in luts.items()}
        dicts = dict(child.schema.dictionaries)
        dicts.update(new_dicts)
        # remapped columns land in sorted union dictionaries
        self.schema = Schema(child.schema.fields, dicts,
                             child.schema.int_bounds,
                             child.schema.unsorted - set(new_dicts))

    def evaluate(self, run):
        b = run.eval(self.children[0])
        cols = list(b.columns)
        for idx, lut in self._luts.items():
            c = cols[idx]
            cols[idx] = Column(gather_lut(lut, c), c.validity)
        return b.replace_columns(cols)

    def _label(self):
        return f"DictRemapExec(cols={sorted(self._luts)})"


class CoalesceExec(ExecNode):
    """The live rows of several inputs in one batch, in input order
    (UNION ALL)."""

    def __init__(self, children: Sequence[ExecNode]):
        self.children = tuple(children)
        self.schema = children[0].schema
        self.capacity = sum(c.capacity for c in children)

    def evaluate(self, run):
        return concat_batches([run.eval(c) for c in self.children],
                              self.capacity)

    def _label(self):
        return f"CoalesceExec(n={len(self.children)})"


def concat_batches(batches: Sequence[Batch], capacity: int) -> Batch:
    """The live rows of `batches`, in order, in one batch of `capacity`
    rows; more live rows than that are cut off (num_rows is clamped)."""
    keep = torch.cat([row_mask(b) for b in batches])
    total = batches[0].num_rows
    for b in batches[1:]:
        total = total + b.num_rows
    cols = []
    for ci in range(len(batches[0].columns)):
        data = torch.cat([b.columns[ci].data for b in batches])
        valid = torch.cat([b.columns[ci].validity for b in batches])
        cols.append(Column(data, valid & keep))
    big = compact_batch(Batch(tuple(cols), total.to(torch.int32)), keep)
    if big.capacity == capacity:
        return big
    return _fit(Batch(big.columns, big.num_rows.clamp(max=capacity)),
                capacity)


class SortExec(ExecNode):
    """keys: list of (expr, ascending, nulls_first|None)."""

    def __init__(self, child: ExecNode,
                 keys: Sequence[Tuple[Expr, bool, Optional[bool]]]):
        self.children = (child,)
        self.keys = tuple(keys)
        self.schema = child.schema
        self.capacity = child.capacity
        # RAW string sort keys sort by their re-encoded codes; the
        # columns themselves keep their RAW codes
        self._key_bounds = [(sorted_recode(bind_expr(e, child.schema)), asc,
                             nf) for e, asc, nf in keys]

    def evaluate(self, run):
        b = run.eval(self.children[0])
        # materialize key columns alongside, sort, drop keys
        ncols = len(b.columns)
        key_cols = tuple(kb.fn(b) for kb, _, _ in self._key_bounds)
        tmp = Batch(b.columns + key_cols, b.num_rows, b.live)
        specs = [SortKeySpec(ncols + i, asc, nf)
                 for i, (_, asc, nf) in enumerate(self._key_bounds)]
        out = sort_batch(tmp, specs)
        return Batch(out.columns[:ncols], out.num_rows)

    def _label(self):
        return f"SortExec({[(str(e), asc) for e, asc, _ in self.keys]})"


class LimitExec(ExecNode):
    """Rows [offset, offset + n) of the child's dense prefix: a static
    slice, so everything above a LIMIT carries an n-row batch."""

    def __init__(self, child: ExecNode, n: int, offset: int = 0):
        self.children = (child,)
        self.n = n
        self.offset = offset
        self.schema = child.schema
        self.capacity = max(1, min(child.capacity - offset, n))

    def evaluate(self, run):
        b = run.eval(self.children[0])
        cap = self.capacity
        # clamp so the slice always yields `cap` rows even when offset
        # exceeds the child's capacity (the result is all-dead then)
        lo = min(self.offset, self.children[0].capacity - cap)
        new_rows = (b.num_rows - self.offset).clamp(0, self.n).to(torch.int32)
        live = torch.arange(cap, dtype=torch.int32, device=b.device) < new_rows
        return Batch(tuple(Column(c.data[lo:lo + cap],
                                  c.validity[lo:lo + cap] & live)
                           for c in b.columns), new_rows)

    def _label(self):
        off = f", offset={self.offset}" if self.offset else ""
        return f"LimitExec({self.n}{off})"


# the operators whose output rows a traced Run records (the reference's
# record_rows sites)
_ROW_RECORDED = (FilterExec, HashAggregateExec, HashJoinExec, CrossJoinExec,
                 NestedLoopJoinExec)


def plan_sparse_flow(root: ExecNode) -> ExecNode:
    """Static routing of sparse batches: a filter, or an inner, semi or
    anti join on a unique build, whose parent reads liveness through
    `row_mask` alone leaves out its output compaction (a stable sort of
    the keep mask and a gather of every column) and hands its keep mask
    over as `Batch.live`. Such parents are the aggregate, the sort, the
    filter and both inputs of a hash join; a projection and a dictionary
    remap work row by row and pass the mask on. Everything else (limit,
    coalesce, cross and nested-loop join, window, the root's caller)
    needs dense input, so its children keep compacting. So does the probe
    of a left or full outer join on a unique build: its output is the
    probe's rows in place and is no sparse producer, so the probe's own
    filter packs the probe columns alone (the reference hands the probe's
    mask on through that join instead). Run before
    `cse_tree`, which keeps a subtree wanted sparse by one parent and
    dense by another apart (`emit_sparse` is part of its node key)."""
    consumers = (HashAggregateExec, SortExec, FilterExec, HashJoinExec)
    transparent = (ProjectExec, DictRemapExec)

    def walk(node: ExecNode, parent_accepts: bool) -> None:
        if parent_accepts:
            if isinstance(node, FilterExec):
                node.emit_sparse = True
            elif (isinstance(node, HashJoinExec) and node.unique_build
                  and node.join_type in ("inner", "semi", "anti")):
                node.emit_sparse = True
        if isinstance(node, consumers):
            child_accepts = True
        elif isinstance(node, transparent):
            child_accepts = parent_accepts
        else:
            child_accepts = False
        for i, c in enumerate(node.children):
            walk(c, child_accepts and not (
                i == 1 and isinstance(node, HashJoinExec)
                and node.unique_build
                and node.join_type in ("left_outer", "full_outer")))

    walk(root, False)
    return root


# The per-piece profiler (BALLISTA_PIECE_TIMING=1) cuts a plan at these
# operators' outputs, where the JAX package cuts its programs: each holds a
# sort or a scatter over a whole batch and writes a dense batch.
_CUT_NODE_NAMES = frozenset(
    {"HashJoinExec", "CrossJoinExec", "HashAggregateExec", "WindowExec"})
# Nodes that make a plan heavy enough to cut.
_HEAVY_NODE_NAMES = _CUT_NODE_NAMES | {"SortExec"}
# timed evaluations of each piece after its real one
PIECE_REPEATS = 5
# HBM rate the roofline share is taken against: the H100 SXM's 3.35 TB/s
# (NVIDIA's data sheet, at the 700 W limit); BALLISTA_HBM_GBPS overrides
HBM_GBPS = 3350.0


def hbm_bytes_per_s() -> float:
    return float(os.environ.get("BALLISTA_HBM_GBPS", HBM_GBPS)) * 1e9


def plan_pieces(root: ExecNode) -> List[Tuple[str, str, ExecNode]]:
    """(key, label, node) of each piece the profiler times, in post order:
    `__piece{k}` for every join, aggregate and window output below the
    root, visited once by identity (a subtree that several parents share
    is one piece), then ("__root", "root", root). A plan with fewer than
    two heavy operators, or nothing to cut below its root, is one piece,
    ("__whole", its root's class name, root)."""
    order, seen = [], set()

    def post(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            post(c)
        order.append(n)

    post(root)
    heavy = [n for n in order if type(n).__name__ in _HEAVY_NODE_NAMES]
    cuts = [n for n in order
            if type(n).__name__ in _CUT_NODE_NAMES and n is not root]
    if len(heavy) < 2 or not cuts:
        return [("__whole", type(root).__name__, root)]
    return [(f"__piece{k}", type(n).__name__, n)
            for k, n in enumerate(cuts)] + [("__root", "root", root)]


def _piece_reads(node: ExecNode, cut: set) -> Tuple[list, list]:
    """(the cut nodes, the input leaves) a piece rooted at `node` reads,
    not descending past a cut node."""
    seen, cuts, leaves = set(), [], []

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if n is not node and id(n) in cut:
            cuts.append(n)
        elif isinstance(n, InputLeaf):
            leaves.append(n)
        else:
            for c in n.children:
                walk(c)

    walk(node)
    return cuts, leaves


def piece_bytes(inputs: Sequence[Batch], out: Batch) -> Tuple[int, int]:
    """(floor, capacity) bytes of work that reads the `inputs` Batches and
    writes `out`, each distinct tensor counted once. The floor counts each
    column's data and validity at the rows its batch holds live
    (`num_rows`, which is `live.sum()` for a sparse batch), a sparse
    batch's `live` mask whole (liveness is known only by reading it) and
    the row counts: what these inputs need. The capacity figure counts
    every tensor whole, as the JAX package's profiler does."""
    floor: Dict[tuple, int] = {}
    cap: Dict[tuple, int] = {}

    def add(t: torch.Tensor, rows: Optional[int]) -> None:
        key = (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())
        if t.dim() and t.stride(0) == 0:
            # a broadcast view holds one row
            whole = 1
        else:
            whole = t.shape[0] if t.dim() else 1
        per_row = t.element_size() * (t[:1].numel() if t.dim() else 1)
        live = whole if rows is None else min(rows, whole)
        floor[key] = max(floor.get(key, 0), live * per_row)
        cap[key] = whole * per_row

    for b in list(inputs) + [out]:
        rows = int(b.num_rows)
        add(b.num_rows, None)
        if b.live is not None:
            add(b.live, None)
        for c in b.columns:
            add(c.data, rows)
            add(c.validity, rows)
    return sum(floor.values()), sum(cap.values())


def _timed_pieces(run: Run, root: ExecNode) -> Batch:
    """Evaluate `root` in `run` piece by piece (`plan_pieces`), timing
    each. A piece is evaluated once in `run`, on its cut descendants'
    outputs (kept in `run.kept` until its last reader has run), so the
    output, the flags and `run.evaluated` are those of `run.eval(root)`;
    then `PIECE_REPEATS` more times, each in a throwaway Run on the same
    kept outputs, ending in a synchronize on CUDA: the piece's ms is the
    wall time over the repeats. Prints one line per piece to stderr in
    the JAX package's format, with the live-row byte floor (`piece_bytes`)
    and its share of the HBM rate (`hbm_bytes_per_s`), and the capacity
    bytes after it."""
    pieces = plan_pieces(root)
    cut = {id(node) for _, _, node in pieces}
    reads = [_piece_reads(node, cut) for _, _, node in pieces]
    last_read = {}
    for pos, (cuts, _) in enumerate(reads):
        for n in cuts:
            last_read[id(n)] = pos
    for pos, (key, label, node) in enumerate(pieces):
        cuts, leaves = reads[pos]
        out = run._evaluate(node)
        kept = {id(n): run.kept[id(n)] for n in cuts}
        cuda = out.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(PIECE_REPEATS):
            again = Run(run.inputs, partition=run.partition,
                        device=run.device)
            again.kept = kept
            again._evaluate(node)
        if cuda:
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / PIECE_REPEATS * 1e3
        del again
        inputs = list(kept.values()) + list(
            {leaf.input_id: run.inputs[leaf.input_id]
             for leaf in leaves}.values())
        nbytes, cap = piece_bytes(inputs, out)
        per_s = nbytes / (ms / 1e3) if ms > 0 else 0.0
        print(f"# piece {key:10s} {label:20s} {ms:9.2f} ms  "
              f"({int(out.num_rows)} rows, {nbytes / 2 ** 20:8.1f} MiB, "
              f"{per_s / 2 ** 30:7.1f} GiB/s, "
              f"{100 * per_s / hbm_bytes_per_s():5.1f}% roofline) "
              f"cap {cap / 2 ** 20:.1f} MiB", file=sys.stderr, flush=True)
        for n in cuts:
            if last_read[id(n)] == pos:
                del run.kept[id(n)]
        if node is not root:
            run.kept[id(node)] = out
    return out


def eval_plan(run: Run, root: ExecNode) -> Batch:
    """`run.eval(root)`; piece by piece and timed (`_timed_pieces`) where
    BALLISTA_PIECE_TIMING is "1" at the call."""
    if os.environ.get("BALLISTA_PIECE_TIMING") == "1":
        return _timed_pieces(run, root)
    return run.eval(root)


def run_plan(root: ExecNode, inputs: Dict[str, Batch]):
    """Evaluate a plan over {input_id: Batch} (the port's compile_stage:
    eager torch needs no compilation step). Returns (Batch, verdict):
    the run's `Run.verdict()`, nonzero where a node overflowed or a
    narrowed SUM passed int64, or None when the plan can do neither."""
    run = Run(inputs)
    out = eval_plan(run, root)
    return out, run.verdict()
