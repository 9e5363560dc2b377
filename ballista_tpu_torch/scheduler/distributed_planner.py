"""DistributedPlanner: split a logical plan into a DAG of stages (port of
ballista_tpu/scheduler/distributed_planner.py).

Reference parity: `ballista/scheduler/src/planner.rs:44-310` walks the
physical plan and cuts stages at repartition boundaries (RepartitionExec
(Hash) -> shuffle stage, CoalescePartitionsExec / SortPreservingMergeExec
-> merge stage). Here the cut is made while lowering the logical plan:

  Aggregate  -> partial agg | shuffle(group keys) | final agg
             -> (global agg) partial | gather | final (pruned to shard 0)
  Join       -> shuffle both sides on the join keys | local join
             -> (small build) gather (broadcast) the build | local join in
                the probe's stage (DataFusion's CollectLeft)
  Sort/Limit -> local sort[+limit] | gather | final merge sort[+limit]

Each stage's root is an ExchangeExec or a GatherExec (`exec/distributed.py`)
except the last stage's; the serial runtime runs a stage's body once per
partition. Inside a stage the operators are those `create_physical_plan`
chooses (`_strip_filters`, `align_union_inputs`, the cross / theta-join
choice of `filtered_cross`), and each stage goes through
`plan_sparse_flow` and `cse_tree` on its own, its root kept dense.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..batch import round_capacity
from ..exec.aggregate import NON_DECOMPOSABLE
from ..exec.cse import cse_tree
from ..exec.distributed import ExchangeExec, GatherExec, PartitionPruneExec
from ..exec.plan import (CoalesceExec, CrossJoinExec, ExecNode, FilterExec,
                         HashAggregateExec, HashJoinExec, InputLeaf, LimitExec,
                         OneRowExec, ProjectExec, SortExec, _next_pow2,
                         _static_one_row, plan_sparse_flow)
from ..exec.window import WindowExec
from ..exprs import Col
from ..planner import logical as L
from ..planner.optimizer import mark_carried
from ..planner.physical import (_is_cross, _strip_filters, align_union_inputs,
                                filtered_cross)


@dataclasses.dataclass
class Source:
    kind: str          # 'table' | 'stage'
    name: str          # table name or producer stage id
    columns: Optional[Tuple[str, ...]] = None  # pruned scan column subset


@dataclasses.dataclass
class Stage:
    stage_id: int
    root: ExecNode
    sources: Dict[str, Source]

    def display(self) -> str:
        hdr = f"Stage {self.stage_id} (inputs: " + ", ".join(
            f"{k}<-{v.kind}:{v.name}" for k, v in self.sources.items()) + ")\n"
        return hdr + self.root.display(1)


@dataclasses.dataclass
class DistributedPlan:
    stages: List[Stage]
    final_stage: int

    @property
    def final_schema(self):
        return self.stages[-1].root.schema

    def display(self) -> str:
        return "\n".join(s.display() for s in self.stages)


@dataclasses.dataclass
class DistOptions:
    n_partitions: int = 8
    broadcast_threshold: int = 1 << 17   # build rows below this: broadcast join
    min_quota: int = 256
    quota_headroom: float = 2.0          # x average rows/dest
    # group tables sized 2x input capacity never overflow (load <= 0.5);
    # the cap bounds memory — overflow past it triggers a retry
    max_group_table: int = 1 << 21
    # skewed-key splitting for shuffle joins: each key spreads over
    # join_salt destinations (probe rows spread, build rows replicated);
    # escalated by the overflow retry when quota bumps don't clear
    join_salt: int = 1
    # expanding-join and theta-join output capacity, as PhysicalOptions'
    # (the reference sizes these from quotas alone, so a theta join over a
    # broadcast side could never grow on a retry)
    join_out_factor: float = 1.0


class DistributedPlanner:
    """Lowers a logical plan to stages. `leaf_capacity(stage_id, root)`,
    where given, sizes the input leaf that reads a stage's output (else
    the root's planned capacity): the serial runtime re-plans with the rows
    each finished stage actually sent, so the capacities after it fit the
    data instead of compounding (see `scheduler/serial.py`). `replay`, an
    earlier planner of the same plan, gives every join its broadcast or
    shuffle choice, every one-row cross-join side its broadcast of the row
    and every exchange its quota, in lowering order, so a re-planning keeps
    that planning's stages and overflow limits (`self.broadcasts`,
    `self.one_rows` and `self.quotas` record them). With
    `replay_quotas=False` the re-planning keeps the stages alone and sizes
    each quota from its sender's capacity anew: the partitioned runtime,
    whose receive buffers are P x quota rows, re-plans so (see
    `scheduler/runtime.py`)."""

    def __init__(self, ctx, options: DistOptions, leaf_capacity=None,
                 replay: Optional["DistributedPlanner"] = None,
                 replay_quotas: bool = True):
        self.ctx = ctx
        self.opts = options
        self._stages: List[Stage] = []
        self._sources: Dict[str, Source] = {}
        self._next_stage = 0
        self._leaf_capacity = leaf_capacity
        self._replay = replay
        self._replay_quotas = replay_quotas
        self.broadcasts: List[bool] = []
        self.quotas: List[int] = []
        self.one_rows: List[bool] = []

    # -- stage cutting --
    def _close_stage(self, root: ExecNode) -> int:
        # a stage root stays dense: the walk starts with parent_accepts
        # False, and the cut nodes are no consumers of sparse batches
        root = cse_tree(plan_sparse_flow(root))
        sid = self._next_stage
        self._next_stage += 1
        sources = {leaf.input_id: self._sources[leaf.input_id]
                   for leaf in root.leaves()}
        self._stages.append(Stage(sid, root, sources))
        return sid

    def _cut(self, root: ExecNode) -> InputLeaf:
        sid = self._close_stage(root)
        leaf_id = f"stage_{sid}"
        cap = (root.capacity if self._leaf_capacity is None
               else self._leaf_capacity(sid, root))
        leaf = InputLeaf(leaf_id, root.schema, cap)
        self._sources[leaf_id] = Source("stage", str(sid))
        return leaf

    def _cut_shuffle(self, root: ExecNode, key_names, expected_rows: int,
                     salt: int = 1, salt_mode: str | None = None,
                     salt_kind: str | None = None,
                     value_hash=None) -> InputLeaf:
        P = self.opts.n_partitions
        # quota is per (sender, destination) cell. `expected_rows` is the
        # per-shard estimate (callers pass the sharded child's capacity),
        # so a cell carries ~expected_rows / P and the receive buffer
        # P * quota ~ headroom * expected_rows. (The reference once
        # divided by P^2, reading expected_rows as the whole relation: it
        # under-sized cells by P and q12 on 4 devices overflowed.)
        quota = max(self.opts.min_quota,
                    round_capacity(int(self.opts.quota_headroom
                                       * expected_rows / P)))
        if self._replay is not None and self._replay_quotas:
            quota = self._replay.quotas[len(self.quotas)]
        self.quotas.append(quota)
        return self._cut(ExchangeExec(root, key_names, P, quota,
                                      salt=salt, salt_mode=salt_mode,
                                      salt_kind=salt_kind,
                                      value_hash=value_hash))

    def _cut_gather(self, root: ExecNode) -> InputLeaf:
        return self._cut(GatherExec(root, self.opts.n_partitions))

    # -- lowering --
    def plan(self, plan: L.LogicalPlan) -> DistributedPlan:
        root = self._lower(mark_carried(plan))
        final = self._close_stage(root)
        return DistributedPlan(self._stages, final)

    def _agg_table(self, child_cap: int) -> int:
        return min(_next_pow2(max(2 * child_cap, 16)), self.opts.max_group_table)

    def _cross_sides(self, join: L.Join):
        """A cross join's gathered (broadcast) build side and its probe.

        A one-row build (a global aggregate, pruned to shard 0) gathers
        to that row at position 0 on every partition. Where its P x 128
        gathered slots times the probe's capacity pass
        CrossJoinExec.MAX_CELLS (the reference raises there), the leaf is
        marked `one_row`, and the join broadcasts the row instead of
        forming every cell; below that bound the plan is the
        reference's."""
        build = self._lower(join.left)
        bleaf = self._cut_gather(build)
        probe = self._lower(join.right)
        one_row = (_static_one_row(_unpruned(build)) and bleaf.capacity
                   * probe.capacity > CrossJoinExec.MAX_CELLS)
        if self._replay is not None:
            # a re-planning with smaller capacities keeps the broadcast: the
            # product it would form instead is up to MAX_CELLS rows per
            # partition, and the aggregates above it are sized from that
            one_row = self._replay.one_rows[len(self.one_rows)]
        self.one_rows.append(one_row)
        if one_row:
            bleaf.one_row = True
        return bleaf, probe

    def _filtered_cross(self, join: L.Join, predicate) -> ExecNode:
        """A predicate over a cross join: the build side broadcast, then
        `create_physical_plan`'s choice of a nested loop or a filter."""
        return filtered_cross(*self._cross_sides(join), predicate, self.opts)

    def _lower(self, p: L.LogicalPlan) -> ExecNode:
        if isinstance(p, L.OneRow):
            # one row on shard 0 only (every shard runs the same stage)
            return PartitionPruneExec(OneRowExec(self.ctx.device))
        if isinstance(p, L.TableScan):
            return self._lower_scan(p)
        if isinstance(p, L.Filter):
            if _is_cross(p.input):
                return self._filtered_cross(p.input, p.predicate)
            return FilterExec(self._lower(p.input), p.predicate)
        if isinstance(p, L.Projection):
            return ProjectExec(self._lower(p.input), list(p.exprs),
                               names=list(p.names) if p.names else None)
        if isinstance(p, (L.Aggregate, L.Distinct)):
            return self._lower_aggregate(p)
        if isinstance(p, L.Join):
            return self._lower_join(p)
        if isinstance(p, L.Sort):
            if _single_partition(p.input):
                return SortExec(self._lower(p.input), list(p.keys))
            local = SortExec(self._lower(p.input), list(p.keys))
            leaf = self._cut_gather(local)
            return PartitionPruneExec(SortExec(leaf, list(p.keys)))
        if isinstance(p, L.Limit):
            return self._lower_limit(p)
        if isinstance(p, L.Window):
            # Ballista's planner rejects window plans (planner.rs:155).
            # With one PARTITION BY column list shared by every spec, rows
            # shuffle onto those keys and the window runs per shard;
            # otherwise they gather to one shard
            child = self._lower(p.input)
            pkeys = _common_partition_cols(p.specs)
            if pkeys and not _single_partition(p.input):
                leaf = self._cut_shuffle(child, pkeys,
                                         expected_rows=child.capacity)
                return WindowExec(leaf, p.specs)
            if not _single_partition(p.input):
                leaf = self._cut_gather(child)
                return PartitionPruneExec(WindowExec(leaf, p.specs))
            return WindowExec(child, p.specs)
        if isinstance(p, L.Union):
            return CoalesceExec(align_union_inputs(
                [self._lower(c) for c in p.inputs]))
        raise NotImplementedError(type(p).__name__)

    def _lower_scan(self, p: L.TableScan) -> InputLeaf:
        tp = self.ctx.tables[p.table_name]
        names = list(p.projection or [f.name for f in tp.fields])
        if hasattr(tp, "ensure_meta"):
            # a parquet dataset reads the scanned columns' dictionaries
            # and bounds on demand
            tp.ensure_meta(names)
        per_shard = round_capacity(-(-tp.capacity // self.opts.n_partitions))
        if p.projection is not None:
            # the port's column-scoped input id (SessionContext.bind_inputs)
            leaf_id = p.table_name + "::" + ",".join(p.projection)
            self._sources[leaf_id] = Source("table", p.table_name,
                                            columns=tuple(p.projection))
            return InputLeaf(leaf_id, tp.schema.select(p.projection),
                             per_shard)
        self._sources[p.table_name] = Source("table", p.table_name)
        return InputLeaf(p.table_name, tp.schema, per_shard)

    def _lower_aggregate(self, p) -> ExecNode:
        P = self.opts.n_partitions
        if isinstance(p, L.Distinct):
            child = self._lower(p.input)
            pred = None
            group_exprs = [Col(f.name) for f in child.schema.fields]
            aggs = []
            group_names = [f.name for f in child.schema.fields]
        else:
            inp, pred = _strip_filters(p.input)
            if pred is not None and _is_cross(inp):
                # the stripped WHERE is the cross join's theta predicate
                child, pred = self._filtered_cross(inp, pred), None
            else:
                child = self._lower(inp)
            group_exprs = list(p.group_exprs)
            aggs = list(p.sized_aggs())
            group_names = list(p.group_names) if p.group_names else None
        T = self._agg_table(child.capacity)
        if any(a.kind in NON_DECOMPOSABLE for a in aggs):
            # median / percentile states do not merge: shuffle the raw rows
            # on the group keys and aggregate once per shard (DataFusion
            # treats Median so); other group expressions gather to shard 0
            if pred is not None:
                child = FilterExec(child, pred)
            if group_exprs and all(isinstance(g, Col) for g in group_exprs):
                leaf = self._cut_shuffle(child, [g.name for g in group_exprs],
                                         expected_rows=child.capacity * P)
                return HashAggregateExec(leaf, group_exprs, aggs,
                                         mode="single", table_size=T,
                                         group_names=group_names)
            leaf = self._cut_gather(child)
            return PartitionPruneExec(HashAggregateExec(
                leaf, group_exprs, aggs, mode="single",
                table_size=self._agg_table(leaf.capacity),
                group_names=group_names))
        partial = HashAggregateExec(child, group_exprs, aggs, mode="partial",
                                    table_size=T, group_names=group_names,
                                    pre_filter=pred)
        if group_exprs:
            key_names = [f.name for f in
                         partial.schema.fields[:len(group_exprs)]]
            # the state exchange is sized by the partial aggregate's
            # refined output bound (dictionary and int-bound key analysis
            # shrinks partial.capacity), not by the group table: q12's
            # 7-value key once got a 1M-slot exchange
            leaf = self._cut_shuffle(partial, key_names,
                                     expected_rows=partial.capacity)
            Tf = min(_next_pow2(max(2 * leaf.capacity, 16)),
                     self.opts.max_group_table * P)
            return HashAggregateExec(leaf, [Col(k) for k in key_names], aggs,
                                     mode="final", table_size=Tf,
                                     group_names=key_names)
        # global aggregate: the states are one row per shard -> gather and
        # a final aggregate on shard 0
        leaf = self._cut_gather(partial)
        return PartitionPruneExec(HashAggregateExec(leaf, [], aggs,
                                                    mode="final",
                                                    table_size=16))

    def _lower_join(self, p: L.Join) -> ExecNode:
        opts = self.opts
        P = opts.n_partitions
        if p.how == "cross":
            # broadcast the build side; the probe stays sharded
            return CrossJoinExec(*self._cross_sides(p))
        build = self._lower(p.left)
        on = list(p.on)
        out_cap = None
        # a full outer join needs key-colocated shards: a replicated build
        # would append its unmatched rows once per partition
        broadcast = (p.how != "full_outer" and build.capacity
                     <= opts.broadcast_threshold // max(P, 1))
        if self._replay is not None:
            broadcast = self._replay.broadcasts[len(self.broadcasts)]
        self.broadcasts.append(broadcast)
        if broadcast:
            # broadcast: the probe stays in this stage, so its filters fuse
            # into the join's live mask; the build is cut and gathered
            if p.how == "left_outer" and p.unique_build:
                pinner, ppred = p.right, None
            else:
                pinner, ppred = _strip_filters(p.right)
            probe = self._lower(pinner)
            bleaf = self._cut_gather(build)
            if not p.unique_build and p.how not in ("semi", "anti"):
                out_cap = self._join_out(bleaf, probe)
            return HashJoinExec(bleaf, probe, on, p.how,
                                unique_build=p.unique_build,
                                out_capacity=out_cap, probe_pre_filter=ppred)
        probe = self._lower(p.right)
        # salted joins (skew splitting): probe rows of one key spread over
        # S shards, build rows replicated to all S; the S replicas land on
        # S consecutive shards mod P, so each shard's build keys stay
        # unique. Not for full outer joins (replicated builds would
        # re-append their unmatched rows)
        S = min(opts.join_salt, P) if p.how != "full_outer" else 1
        saltable = p.how != "full_outer"
        # a key pair with a RAW side is hashed by value on both sides, so
        # that equal values meet whatever their codes
        by_value = [(a, b) for a, b in on
                    if not (build.schema.is_sorted_dict(a)
                            and probe.schema.is_sorted_dict(b))]
        bleaf = self._cut_shuffle(
            build, [a for a, _ in on], expected_rows=build.capacity * S,
            salt=S, salt_mode="replicate" if S > 1 else None,
            salt_kind="replicate" if saltable else None,
            value_hash=[a for a, _ in by_value])
        pleaf = self._cut_shuffle(
            probe, [b for _, b in on], expected_rows=probe.capacity,
            salt=S, salt_mode="spread" if S > 1 else None,
            salt_kind="spread" if saltable else None,
            value_hash=[b for _, b in by_value])
        if not p.unique_build and p.how not in ("semi", "anti"):
            out_cap = self._join_out(bleaf, pleaf)
        return HashJoinExec(bleaf, pleaf, on, p.how,
                            unique_build=p.unique_build, out_capacity=out_cap)

    def _join_out(self, build: ExecNode, probe: ExecNode) -> int:
        return round_capacity(int(self.opts.join_out_factor
                                  * (build.capacity + probe.capacity)))

    def _lower_limit(self, p: L.Limit) -> ExecNode:
        # every shard keeps its first offset + n rows; the merge stage
        # skips `offset` of them
        keep = p.n + p.offset
        if isinstance(p.input, L.Sort) and not _single_partition(p.input.input):
            # top-k: local sort + limit, gather, merge sort + limit
            keys = list(p.input.keys)
            local = LimitExec(SortExec(self._lower(p.input.input), keys), keep)
            leaf = self._cut_gather(local)
            return PartitionPruneExec(LimitExec(SortExec(leaf, keys), p.n,
                                                p.offset))
        child = self._lower(p.input)
        if _single_partition(p.input):
            return LimitExec(child, p.n, p.offset)
        leaf = self._cut_gather(LimitExec(child, keep))
        return PartitionPruneExec(LimitExec(leaf, p.n, p.offset))


def _unpruned(node: ExecNode) -> ExecNode:
    return (node.children[0] if isinstance(node, PartitionPruneExec)
            else node)


def _single_partition(p: L.LogicalPlan) -> bool:
    """True if the plan's distributed output already lies on one shard
    (pruned to shard 0), so no merge stage is needed."""
    if isinstance(p, (L.Sort, L.Limit)):
        return _single_partition(p.input)
    if isinstance(p, L.Window):
        # shuffled windows stay sharded; gathered ones end up pruned
        return (_single_partition(p.input)
                or _common_partition_cols(p.specs) is None)
    if isinstance(p, L.Aggregate):
        return not p.group_exprs
    if isinstance(p, (L.Projection, L.Filter)):
        return _single_partition(p.input)
    return False


def _common_partition_cols(specs) -> Optional[List[str]]:
    """The PARTITION BY column names every spec shares, as plain columns
    (the shuffle key of a distributed window); else None."""
    first = None
    for s in specs:
        if not s.partition_by or not all(isinstance(e, Col)
                                         for e in s.partition_by):
            return None
        names = sorted(e.name for e in s.partition_by)
        if first is None:
            first = names
        elif names != first:
            return None
    return first
