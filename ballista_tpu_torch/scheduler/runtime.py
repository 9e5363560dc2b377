"""The partitioned runtime, its stage metrics, the shuffle-overflow error
and its retry escalation (port of ballista_tpu/scheduler/runtime.py
`DistributedRuntime`, `StageMetrics`, `ShuffleOverflowError`,
`escalate_overflow_opts` and `execute_distributed`).

Reference parity: the executor data plane (`Executor::execute_query_stage`,
executor.rs:184), single controller as in the JAX package: one process
runs every stage over every partition of the mesh, stage outputs stay on
the partitions' devices (no shuffle files, no Flight), and the host only
orders the stages, retries overflows and gathers the result. The JAX
package runs a stage as one program over the mesh; here the stage body is
evaluated once per partition, on the partition's device, and the stage
root's collective (`ExchangeExec.exchange`, `GatherExec.gather`) then moves
rows between the P outputs.

The stage loop is `standalone.JobContext`, which both the scheduler and
`execute_distributed` drive: each stage's counts are read when it is done
(one host sync per stage) and the plan is lowered again with the rows each
finished stage sent. The reference issues the whole DAG of its static stage
plan and syncs once (`drain`); that plan sizes every exchange from its
sender's capacity, which doubles at each shuffle join, and at TPC-H SF1 on
P = 8 partitions of one card Q21 ran out of the card's 80 GB with it.

Over a mesh that spans processes (`parallel.multihost.GlobalMesh`) every
process runs the same job and evaluates the stage body for its own
partitions only; `StageRun.read` sums the run's counts over the processes
before any of them is read, so each process lowers, trims and escalates
alike.

Not ported: the reference's piece splitting and ahead-of-time compilation
of stage programs and BALLISTA_STAGE_SYNC, which answer TPU compile
times; eager torch compiles nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch


class StageMetrics:
    """Per-stage execution metrics (the reference's OperatorMetricsSet,
    shipped to the scheduler in TaskStatus). The serial runtime adds the
    bytes it moved between host and device; the partitioned runtime the
    bytes its stage root's collective copied into receive buffers. `run_s`
    of the partitioned runtime is the host's time from issuing the stage
    to its counts read."""

    def __init__(self):
        self.run_s = 0.0
        self.output_rows = 0
        self.retries = 0
        self.operator_rows = {}   # per-operator output rows across shards
        self.partitions = 0
        self.bytes_to_device = 0
        self.bytes_to_host = 0
        self.bytes_exchanged = 0

    def as_dict(self):
        return {"run_s": round(self.run_s, 4),
                "output_rows": int(self.output_rows),
                "retries": self.retries,
                "operator_rows": self.operator_rows,
                "partitions": self.partitions,
                "bytes_to_device": self.bytes_to_device,
                "bytes_to_host": self.bytes_to_host,
                "bytes_exchanged": self.bytes_exchanged}


class ShuffleOverflowError(RuntimeError):
    """A shuffle exchange (or group table) outgrew its fixed quota. When the
    runtime saw the shuffle-write stats it attaches them as `stats`: a list
    of per-exchange dicts {"quota": int, "salt_kind": str or None,
    "counts": (shards, P) array} of pre-clamp destination row counts (the
    reference's PartitionStats, serde/scheduler/mod.rs:33-100)."""


class CapacityOverflowError(ShuffleOverflowError):
    """An operator outgrew its static capacity (a group table, an
    expanding join's output) while every exchange kept to its quota: the
    retry grows group tables and join outputs, as the in-core path does,
    and leaves the quotas (`grow_capacities`). `growth` is, for each of
    GROWTH_KINDS (group tables, join outputs), how many times its capacity
    the neediest operator of that kind wanted, where the run counted it."""
    growth = (4, 4)


def _growth_factor(growth: int) -> int:
    """The power of two at or above `growth`, and at least 4."""
    return max(4, 1 << (max(int(growth), 1) - 1).bit_length())


def grow_capacities(opts, growth=(4, 4)):
    """The DistOptions of the retry after a CapacityOverflowError: group
    tables grown by the group tables' growth and expanding-join outputs
    by the join outputs' (`CapacityOverflowError.growth`), each to a
    power of two and by at least 4x. The need is what the overflowing run
    counted; an operator fed by one that was clipped counts low, and the
    next attempt grows again."""
    group, join = growth
    return dataclasses.replace(
        opts, max_group_table=opts.max_group_table * _growth_factor(group),
        join_out_factor=opts.join_out_factor * _growth_factor(join))


def escalate_overflow_opts(opts, err, attempt: int):
    """The DistOptions of the retry after a quota overflow.

    With shuffle-write stats: the worst observed per-(shard, destination)
    count against its quota sets the headroom, and a max / median ratio of
    4 or more on a saltable (join) exchange is hot-key skew, which gets the
    key split over `join_salt` destinations instead. Without stats (a
    group table or an expanding join that outgrew its capacity) the first
    retry bumps quotas and later retries add salt. Every retry also gives
    group tables and expanding joins 4x the room."""
    ratio = 0.0      # worst observed need/quota over exchanges
    skew = 1.0       # worst max/median on a saltable exchange
    flat = hot = 0.0  # flat vs hot-key components of the skewed need
    quota_of_skewed = 1.0
    salt = opts.join_salt
    for s in getattr(err, "stats", None) or ():
        c = np.asarray(s["counts"], np.float64).reshape(-1, opts.n_partitions)
        need = float(c.max())
        q = max(1.0, float(s["quota"]))
        if need <= q:
            continue
        ratio = max(ratio, need / q)
        if s["salt_kind"] is not None:
            pos = c[c > 0]
            med = float(np.median(pos)) if pos.size else 1.0
            sk = need / max(1.0, med)
            if sk > skew:
                skew, quota_of_skewed = sk, q
                # salting spreads only the hot key's rows over more
                # destinations; the flat component stays put
                flat, hot = med, need - med
    if ratio > 0.0:
        if skew >= 4.0:
            salt = int(min(opts.n_partitions,
                           max(2 * opts.join_salt,
                               1 << int(np.ceil(np.log2(
                                   min(skew, opts.n_partitions)))))))
            projected = flat + hot * opts.join_salt / salt
            headroom = opts.quota_headroom * max(
                1.2, 1.5 * projected / quota_of_skewed)
        else:
            # 2x the worst observed need: the stats come from the first
            # overflowing shard only, and its siblings are often worse
            headroom = opts.quota_headroom * 2.0 * ratio
        return dataclasses.replace(grow_capacities(opts),
                                   quota_headroom=headroom, join_salt=salt)
    salt = opts.join_salt if attempt == 0 else max(
        2, min(opts.join_salt * 4, opts.n_partitions))
    return dataclasses.replace(grow_capacities(opts),
                               quota_headroom=opts.quota_headroom * 4,
                               join_salt=salt)


class StageRun(NamedTuple):
    """One run of a stage over every partition, before its counts reach
    the host. `out` is the stage output; the tensors live on the first
    partition's device: per partition and kind how many times its
    capacity the neediest operator wanted (`Run.growth`; above 1 where an
    operator overflowed), the exchange's overflow flag per sender (None without
    one), its pre-clamp counts (senders, P), each recorded operator's
    output rows per partition (partitions, operators)."""
    out: object                       # PartitionedBatch
    growth: torch.Tensor              # (P, len(GROWTH_KINDS)) int64
    ex_overflow: Optional[torch.Tensor]
    counts: Optional[torch.Tensor]    # (P, P) int32
    op_rows: torch.Tensor             # (P, n_ops) int64
    labels: List[str]
    quota: int
    salt_kind: Optional[str]
    # the counts are summed over the processes of a mesh that spans them
    # (each process fills its own partitions' entries, zeros elsewhere)
    across_processes: bool = False

    def summary(self) -> torch.Tensor:
        """Every count of the run as one int64 vector (`read` splits it
        again)."""
        P = self.growth.shape[0]
        dev = self.growth.device
        parts = [self.growth.reshape(-1),
                 (self.ex_overflow.to(torch.int64)
                  if self.ex_overflow is not None
                  else torch.zeros(P, dtype=torch.int64, device=dev)),
                 (self.counts.to(torch.int64).reshape(-1)
                  if self.counts is not None
                  else torch.zeros(P * P, dtype=torch.int64, device=dev)),
                 self.op_rows.reshape(-1),
                 self.out.num_rows.to(dev, torch.int64)]
        return torch.cat(parts)

    def read(self) -> "StageCounts":
        """The run's counts on the host, in one device-to-host copy (and,
        across processes, one all-reduce: the same counts everywhere)."""
        vector = self.summary()
        if self.across_processes:
            from ..parallel.multihost import all_reduce_sum
            vector = all_reduce_sum(vector.cpu())
        vector = vector.cpu().numpy()
        (P, g), k = self.growth.shape, len(self.labels)
        growth = vector[:P * g].reshape(P, g)
        vector = vector[P * g:]
        ex_ov = vector[:P] != 0
        counts = vector[P:P + P * P].reshape(P, P)
        rows = vector[P + P * P:P + P * P + P * k].reshape(P, k)
        num_rows = vector[P + P * P + P * k:]
        return StageCounts(self, bool((growth > 1).any()),
                           self.ex_overflow is not None and bool(ex_ov.any()),
                           counts, rows, num_rows,
                           tuple(int(x) for x in growth.max(axis=0)))


class StageCounts(NamedTuple):
    run: StageRun
    op_overflow: bool
    ex_overflow: bool
    counts: np.ndarray        # (senders, P) pre-clamp rows per destination
    op_rows: np.ndarray       # (P, n_ops)
    num_rows: np.ndarray      # (P,) output rows per partition
    growth: tuple             # per kind, the most an operator outgrew its
                              # capacity

    @property
    def overflow(self) -> bool:
        return self.op_overflow or self.ex_overflow

    @property
    def leaf_capacity(self) -> int:
        """The capacity of the leaf that reads this output when the plan
        is lowered again with the rows sent: the most rows a partition
        holds (every row, after a gather), lane-rounded, and no more than
        the output's capacity."""
        from ..batch import round_capacity
        return min(round_capacity(int(self.num_rows.max())),
                   self.run.out.capacity)

    def operator_rows(self) -> Dict[str, int]:
        """Output rows per operator label, summed over the partitions (a
        label that two operators share keeps the later one's, as the
        reference's dict does)."""
        totals = self.op_rows.sum(axis=0)
        return {lbl: int(v) for lbl, v in zip(self.run.labels, totals)}

    def error(self, stage_id: int) -> ShuffleOverflowError:
        """The error of an overflowing stage: a ShuffleOverflowError with
        the exchange's shuffle-write stats where the exchange dropped rows
        (the reference's escalation reads them), else a
        CapacityOverflowError (an operator outgrew its capacity)."""
        if self.ex_overflow:
            err = ShuffleOverflowError(
                f"stage {stage_id}: shuffle quota exceeded (retry with "
                "larger quota_headroom)")
            err.stats = [{"quota": self.run.quota,
                          "salt_kind": self.run.salt_kind,
                          "counts": self.counts}]
            return err
        err = CapacityOverflowError(
            f"stage {stage_id}: a group table or join output outgrew its "
            f"capacity (group tables {self.growth[0]}x, join outputs "
            f"{self.growth[1]}x)")
        err.growth = self.growth
        return err


def _row_bytes(batch) -> int:
    return sum(c.data.element_size() + 1 for c in batch.columns)


class DistributedRuntime:
    """Runs stages over the partitions of a mesh (`parallel.mesh`): one
    partition per mesh entry, partition p on `mesh[p]`. `opts` are the
    options a job starts from."""

    def __init__(self, ctx, mesh=None, options=None):
        from ..parallel.mesh import context_mesh
        from .distributed_planner import DistOptions
        self.ctx = ctx
        self.mesh = mesh if mesh is not None else context_mesh(ctx.device)
        n = len(self.mesh)
        self.opts = options or DistOptions(n_partitions=n)
        if self.opts.n_partitions != n:
            raise ValueError(f"DistOptions.n_partitions "
                             f"{self.opts.n_partitions} on a mesh of {n}: "
                             "one partition per mesh entry")
        self._table_cache: Dict[tuple, tuple] = {}

    # -- table partitioning (scan side) --
    def table_partitions(self, name: str, columns=None,
                         capacity: Optional[int] = None):
        """(PartitionedBatch, Schema) of a table's scanned columns, kept
        for later stages and queries (`drop_tables` frees them)."""
        from ..parallel.partitioned import partition_table
        key = (name, tuple(columns) if columns else None)
        hit = self._table_cache.get(key)
        if hit is None or (capacity is not None
                           and hit[0].capacity != capacity):
            hit = partition_table(self.ctx.tables[name], self.mesh, columns,
                                  capacity)
            self._table_cache[key] = hit
        return hit

    def drop_tables(self) -> None:
        self._table_cache.clear()

    @property
    def table_bytes(self) -> int:
        """Device bytes of the partitioned tables held."""
        return sum(pb.nbytes for pb, _ in self._table_cache.values())

    # -- stage execution --
    def stage_inputs(self, stage, outputs: Dict[str, object]) -> dict:
        """A stage's inputs: table partitions, and the outputs of the
        stages it reads (a KeyError names a lost one)."""
        leaf_caps = {leaf.input_id: leaf.capacity
                     for leaf in stage.root.leaves()}
        inputs = {}
        for lid, cap in leaf_caps.items():
            src = stage.sources[lid]
            if src.kind == "table":
                inputs[lid], _ = self.table_partitions(src.name, src.columns,
                                                       cap)
            else:
                inputs[lid] = outputs[src.name]
        return inputs

    def run_stage(self, stage, inputs: dict) -> StageRun:
        """Run the stage body once per partition, then the root's
        collective across the P outputs. Reads nothing on the host in one
        process. Over a mesh that spans processes only this process's
        partitions run; the others' counts stay 0 here (their growth too)
        until `StageRun.read` sums them."""
        from ..exec.distributed import ExchangeExec, GatherExec
        from ..exec.plan import GROWTH_KINDS, Run
        from ..parallel.multihost import spans_processes
        from ..parallel.partitioned import PartitionedBatch
        root = stage.root
        body = (root.children[0] if isinstance(root, (ExchangeExec, GatherExec))
                else root)
        P = len(self.mesh)
        dev0 = self.mesh[0]
        local = getattr(self.mesh, "is_local", lambda p: True)
        outs, growths, rows, labels = [], [], [], None
        for p in range(P):
            if not local(p):
                outs.append(None)
                growths.append(torch.zeros(len(GROWTH_KINDS),
                                           dtype=torch.int64, device=dev0))
                rows.append(None)
                continue
            run = Run({lid: pb.batches[p] for lid, pb in inputs.items()},
                      partition=p, trace=True, device=self.mesh[p])
            outs.append(run.eval(body))
            g = run.growth()
            growths.append(torch.ones(len(GROWTH_KINDS), dtype=torch.int64,
                                      device=dev0)
                           if g is None else g.to(dev0))
            if labels is None:
                labels = [lbl for lbl, _ in run.op_rows]
            rows.append([n.to(dev0, torch.int64) for _, n in run.op_rows])
        ex_overflow = counts = None
        quota, salt_kind = 0, None
        if isinstance(root, ExchangeExec):
            outs, ovs, cnts = root.exchange(outs, self.mesh)
            ex_overflow = torch.stack([
                torch.zeros((), dtype=torch.bool, device=dev0) if o is None
                else o.to(dev0) for o in ovs])
            counts = torch.stack([
                torch.zeros(P, dtype=torch.int32, device=dev0) if c is None
                else c.to(dev0) for c in cnts])
            quota, salt_kind = root.quota, root.salt_kind
        elif isinstance(root, GatherExec):
            outs = root.gather(outs, self.mesh)
        zero = torch.zeros(len(labels or ()), dtype=torch.int64, device=dev0)
        op_rows = (torch.stack([zero if r is None else torch.stack(r)
                                for r in rows]) if labels
                   else torch.zeros((P, 0), dtype=torch.int64, device=dev0))
        return StageRun(PartitionedBatch(tuple(outs)), torch.stack(growths),
                        ex_overflow, counts, op_rows, labels or [], quota,
                        salt_kind, spans_processes(self.mesh))

    @staticmethod
    def trim(pb, capacity: int):
        """A stage output cut to `capacity` rows per partition (its live
        rows come first), copied so that the receive buffers are freed; a
        batch that several partitions share stays shared."""
        from ..batch import Batch, Column
        from ..parallel.partitioned import PartitionedBatch
        if pb.capacity <= capacity:
            return pb
        made = {id(None): None}
        for b in pb.batches:
            if id(b) not in made:
                made[id(b)] = Batch(tuple(
                    Column(c.data[:capacity].clone(),
                           c.validity[:capacity].clone())
                    for c in b.columns), b.num_rows)
        return PartitionedBatch(tuple(made[id(b)] for b in pb.batches))

    @staticmethod
    def stale(stage, observed: Dict[int, int]) -> bool:
        """Whether a stage reads a finished stage through a leaf not sized
        by the rows that stage sent."""
        return any(stage.sources[leaf.input_id].kind == "stage"
                   and int(stage.sources[leaf.input_id].name) in observed
                   and leaf.capacity
                   != observed[int(stage.sources[leaf.input_id].name)]
                   for leaf in stage.root.leaves())

    def relower(self, plan, observed: Dict[int, int], first):
        """The plan lowered again with the rows each finished stage sent
        as the capacity of the leaf that reads it (the serial runtime's
        re-lowering): `first`'s stages and broadcast choices, each quota
        sized anew from its sender's capacity, so that neither capacities
        nor receive buffers double at every shuffle join. The options are
        `first`'s."""
        from .distributed_planner import DistributedPlanner
        return DistributedPlanner(
            self.ctx, first.opts,
            lambda i, root: observed.get(i, root.capacity), first,
            replay_quotas=False).plan(plan)

    @staticmethod
    def stage_metrics(stage, counts: StageCounts, run_s: float
                      ) -> StageMetrics:
        """A finished stage's StageMetrics. `bytes_exchanged` counts what
        the root's collective copied into receive buffers (a gather onto
        one device is made once)."""
        from ..exec.distributed import ExchangeExec, GatherExec
        out = counts.run.out
        m = StageMetrics()
        m.run_s = run_s
        m.partitions = out.n_partitions
        m.operator_rows = counts.operator_rows()
        m.output_rows = int(counts.num_rows.sum())
        if isinstance(stage.root, ExchangeExec):
            m.bytes_exchanged = out.n_partitions * out.capacity * _row_bytes(
                out.first)
        elif isinstance(stage.root, GatherExec):
            m.bytes_exchanged = out.nbytes
        return m


def execute_distributed(ctx, plan, mesh=None, options=None,
                        max_retries: int = 4):
    """Plan and run over the mesh without the scheduler: one job
    (`standalone.JobContext`) whose stages run in order, with its overflow
    retry (at most `max_retries` attempts; a quota overflow escalates the
    options from its shuffle-write stats, the reference's sequence: quota,
    then salt; an operator that outgrew its capacity grows capacities
    alone). Returns (Batch, Schema); the run's StageMetrics are left in
    `ctx.dist_metrics` (a list by stage id) and the options of every
    attempt in `ctx.dist_attempts`.

    Without explicit `options` the options that converged are kept per
    (plan display, partition count) on the context, so a repeated query
    starts from them."""
    from ..client.context import rebind_scans
    from ..planner.optimizer import prune_columns, reduce_group_keys
    from .distributed_planner import DistributedPlanner
    from .standalone import JobContext

    plan = prune_columns(reduce_group_keys(rebind_scans(plan, ctx)))
    rt = DistributedRuntime(ctx, mesh, options)
    memo_key = None
    if options is None:
        memo = getattr(ctx, "_dist_opts_memo", None)
        if memo is None:
            memo = ctx._dist_opts_memo = {}
        memo_key = (plan.display(), len(rt.mesh))
        rt.opts = memo.get(memo_key, rt.opts)
    jc = JobContext("local", rt, ctx, plan, DistributedPlanner(ctx, rt.opts),
                    max_retries)
    out = jc.run()
    if memo_key is not None:
        ctx._dist_opts_memo[memo_key] = jc.planner.opts
    ctx.dist_metrics = [jc.stage_metrics[k] for k in sorted(jc.stage_metrics)]
    ctx.dist_attempts = jc.attempts
    return out
