"""Serial (out-of-core) runtime: one stage x partition at a time on ONE
device, the shuffle in host memory (port of ballista_tpu/scheduler/serial.py).

Reference parity: this is Ballista's executor model. A task runs one stage
x partition at a time and shuffle data is materialized off the device
between stages (`ShuffleWriterExec::execute_shuffle_write`,
shuffle_writer.rs:234, writes per-destination files; ShuffleReaderExec
fetches them). Each ExchangeExec's send buffer is copied to host RAM and
each partition of the next stage is assembled from its slices, so the
device holds one partition of one stage: a dataset larger than the device
runs by choosing the partition count so that each shard fits.

A stage is made once and run P times: eager torch has no compile step,
so `_compile_stage` returns the stage body as a function of (partition id,
inputs). Before it is made, the plan is lowered again with the rows the
finished stages sent (`SerialRuntime.execute`), so that capacities do not
compound from one shuffle join to the next. A table shard is uploaded from the table's host columns (a row
range); it never goes through `TableProvider.column_batch`, which keeps
the whole column on the device.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..batch import LANE, Batch, round_capacity, upload_parts
from ..exec import memory
from ..exec.distributed import ExchangeExec, GatherExec, PartitionPruneExec
from ..exec.plan import Run, _static_one_row
from ..parallel.partitioned import partition_rows
from ..parallel.shuffle import exchange_send_rows
from .distributed_planner import DistOptions, DistributedPlanner, Stage
from .runtime import (CapacityOverflowError, ShuffleOverflowError,
                      StageMetrics, escalate_overflow_opts, grow_capacities)

log = logging.getLogger("ballista_tpu_torch.serial")


def _live_bytes(batch: Batch) -> int:
    """Bytes of a batch's live rows: what an upload moved."""
    return int(batch.num_rows) * sum(c.data[:1].nbytes + 1
                                     for c in batch.columns)


class _HostShard:
    """One partition's stage output on the host: per column (data,
    validity) numpy arrays of its live rows. An exchange's rows are
    grouped by destination: destination d's are [offsets[d],
    offsets[d + 1])."""

    def __init__(self, datas, valids, offsets=None):
        self.datas = datas
        self.valids = valids
        self.num_rows = len(datas[0]) if datas else 0
        self.offsets = offsets

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.datas + self.valids)


class _StageOutput:
    def __init__(self, kind: str):
        self.kind = kind            # 'exchange' | 'gather' | 'plain'
        self.shards: Dict[int, _HostShard] = {}   # partition -> output


def _fetch_shard(batch: Batch, send_counts=None) -> _HostShard:
    """Device -> host, the live rows only (a batch's first num_rows rows;
    an exchange's rows come grouped by destination, send_counts[d] rows
    for destination d)."""
    n = int(batch.num_rows)
    offsets = (None if send_counts is None else
               np.concatenate([[0], np.cumsum(send_counts)]).astype(np.int64))
    return _HostShard([c.data[:n].cpu().numpy() for c in batch.columns],
                      [c.validity[:n].cpu().numpy() for c in batch.columns],
                      offsets)


class SerialRuntime:
    """Runs a logical plan's stages on the context's device, partition
    by partition. `metrics` holds the last `execute`'s StageMetrics by stage
    id."""

    def __init__(self, ctx, options: DistOptions):
        self.ctx = ctx
        self.opts = options
        self.device = ctx.device
        self.metrics: Dict[int, StageMetrics] = {}
        self.plannings = 0      # lowerings of the plan in the last execute

    # -- table partition ingest (one shard at a time, from the host) --

    def _table_shard(self, name: str, columns, pid: int, cap: int) -> Batch:
        tp = self.ctx.tables[name]
        names = list(columns) if columns else [f.name for f in tp.fields]
        lo, hi = partition_rows(tp.num_rows, self.opts.n_partitions, pid)
        return tp.range_batch(names, lo, hi, cap, self.device)

    # -- host-side exchange assembly (the ShuffleReaderExec analog) --

    def _exchange_input(self, out: _StageOutput, pid: int, cap: int) -> Batch:
        """Partition pid's rows: every sender's rows for pid, in sender
        order."""
        pieces = [(sh, sh.offsets[pid], sh.offsets[pid + 1])
                  for _, sh in sorted(out.shards.items())]
        return self._assemble(out, pieces, cap)

    def _gather_input(self, out: _StageOutput, cap: int) -> Batch:
        pieces = [(sh, 0, sh.num_rows) for _, sh in sorted(out.shards.items())]
        return self._assemble(out, pieces, cap)

    def _assemble(self, out: _StageOutput, pieces, cap: int) -> Batch:
        pieces = [p for p in pieces if p[2] > p[1]] or pieces[:1]
        ref = out.shards[min(out.shards)]
        parts = [([sh.datas[i][lo:hi] for sh, lo, hi in pieces],
                  [sh.valids[i][lo:hi] for sh, lo, hi in pieces], d.dtype)
                 for i, d in enumerate(ref.datas)]
        return upload_parts(parts, cap, self.device)

    # -- the stage body --

    def _compile_stage(self, stage: Stage):
        """(run(pid, inputs), leaf ids, kind): the stage's body, run once
        per partition. run returns (output batch, send counts, the
        exchange's overflow flag, pre-clamp counts, the partition's Run,
        whose flags and row counts the caller reads); an exchange's three
        are None in a stage that is no exchange."""
        root = stage.root
        if isinstance(root, ExchangeExec):
            kind, body = "exchange", root.children[0]
        elif isinstance(root, GatherExec):
            kind, body = "gather", root.children[0]
        else:
            kind, body = "plain", root
        leaf_ids = sorted({leaf.input_id for leaf in root.leaves()})

        def run(pid: int, inputs: Dict[str, Batch]):
            r = Run(inputs, partition=pid, trace=True)
            out = r.eval(body)
            counts = raw = exchange_overflow = None
            if kind == "exchange":
                out, counts, exchange_overflow, raw = exchange_send_rows(
                    *root.hash_input(out), root.n_parts, root.quota,
                    root.salt, root.salt_mode)
                out = root.drop_hash_columns(out)
            return out, counts, exchange_overflow, raw, r

        return run, leaf_ids, kind

    # -- execution --

    def execute(self, plan):
        """Run a pruned and rebound logical plan stage by stage.

        Before a stage runs, the plan is lowered again with the rows each
        finished stage sent as the capacity of the leaf that reads it,
        replaying the first lowering's broadcast choices and quotas (so
        the stages and their overflow limits stay those of the first
        lowering): a stage's inputs, and what it computes over them, fit
        the data, where the static plan doubles the capacities at every
        shuffle join. The stage is then made once (`_compile_stage`) and
        run once per partition."""
        P = self.opts.n_partitions
        first = DistributedPlanner(self.ctx, self.opts)
        dplan = first.plan(plan)
        observed: Dict[int, int] = {}
        outputs: Dict[str, _StageOutput] = {}
        self.metrics = {}
        self.plannings = 1
        # a stage's host output is dropped after the last stage reading it
        last_read = {src.name: stage.stage_id for stage in dplan.stages
                     for src in stage.sources.values() if src.kind == "stage"}
        for sid in range(len(dplan.stages)):
            if self._stale(dplan.stages[sid], observed):
                dplan = DistributedPlanner(
                    self.ctx, self.opts,
                    lambda i, root: observed.get(i, root.capacity),
                    first).plan(plan)
                self.plannings += 1
            stage = dplan.stages[sid]
            m = StageMetrics()
            self.metrics[stage.stage_id] = m
            t0 = time.perf_counter()
            fn, leaf_ids, kind = self._compile_stage(stage)
            leaf_caps = {leaf.input_id: leaf.capacity
                         for leaf in stage.root.leaves()}
            quota = stage.root.quota if kind == "exchange" else 0
            sout = _StageOutput(kind)

            # a stage whose root prunes to shard 0 makes rows on pid 0
            # only: where every input is replicated (gathered), the other
            # partitions are provably empty and skipped
            pids = range(P)
            if self._prunes_to_shard0(stage) and all(
                    self._replicated(stage, outputs, lid) for lid in leaf_ids):
                pids = [0]

            op_totals: Dict[str, int] = {}
            for pid in pids:
                inputs = {}
                for lid in leaf_ids:
                    cap = leaf_caps[lid]
                    src = stage.sources[lid]
                    if src.kind == "table":
                        inputs[lid] = self._table_shard(src.name, src.columns,
                                                        pid, cap)
                    else:
                        prod = outputs[src.name]
                        inputs[lid] = (self._exchange_input(prod, pid, cap)
                                       if prod.kind == "exchange"
                                       else self._gather_input(prod, cap))
                    m.bytes_to_device += _live_bytes(inputs[lid])
                out, counts, exchange_overflow, raw, run = fn(pid, inputs)
                del inputs
                if exchange_overflow is not None and bool(exchange_overflow):
                    err = ShuffleOverflowError(
                        f"stage {stage.stage_id} partition {pid}: shuffle "
                        "quota exceeded (retry with larger quota_headroom)")
                    # shuffle-write stats of the overflowing shard
                    # (PartitionStats, serde/scheduler/mod.rs:33-100)
                    err.stats = [{"quota": quota,
                                  "salt_kind": stage.root.salt_kind,
                                  "counts": raw.cpu().numpy()[None, :]}]
                    raise err
                verdict = run.verdict()
                if verdict is not None and run.overflowed(int(verdict)):
                    err = CapacityOverflowError(
                        f"stage {stage.stage_id} partition {pid}: a group "
                        "table or join output outgrew its capacity")
                    err.growth = tuple(run.growth().tolist())
                    raise err
                sout.shards[pid] = _fetch_shard(
                    out, counts.cpu().numpy() if kind == "exchange" else None)
                m.bytes_to_host += sout.shards[pid].nbytes
                if run.op_rows:
                    rows = torch.stack([r.to(torch.int64) for _, r in
                                        run.op_rows]).cpu().tolist()
                    for (label, _), v in zip(run.op_rows, rows):
                        op_totals[label] = op_totals.get(label, 0) + v
                m.partitions += 1
            m.operator_rows = op_totals
            m.run_s = time.perf_counter() - t0
            m.output_rows = sum(sh.num_rows for sh in sout.shards.values())
            observed[stage.stage_id] = self._leaf_capacity(sout)
            outputs[str(stage.stage_id)] = sout
            for name in [n for n in outputs
                         if last_read.get(n) == stage.stage_id]:
                del outputs[name]
            log.debug("serial stage %d done: %s", stage.stage_id, m.as_dict())

        final = outputs[str(dplan.final_stage)]
        total = sum(sh.num_rows for sh in final.shards.values())
        self.metrics[dplan.final_stage].bytes_to_device += sum(
            sh.nbytes for sh in final.shards.values())
        return (self._gather_input(final, round_capacity(max(total, 1))),
                dplan.final_schema)

    @staticmethod
    def _stale(stage: Stage, observed: Dict[int, int]) -> bool:
        """Whether a stage reads a finished stage through a leaf not sized
        by the rows that stage sent."""
        return any(stage.sources[leaf.input_id].kind == "stage"
                   and leaf.capacity
                   != observed[int(stage.sources[leaf.input_id].name)]
                   for leaf in stage.root.leaves())

    @staticmethod
    def _leaf_capacity(out: _StageOutput) -> int:
        """The capacity of the leaf that reads a stage's output: the most
        rows one partition receives from an exchange, every row of a
        gather."""
        if out.kind == "exchange":
            received = sum(np.diff(sh.offsets) for sh in out.shards.values())
            return round_capacity(int(np.max(received)))
        return round_capacity(sum(sh.num_rows for sh in out.shards.values()))

    def _prunes_to_shard0(self, stage: Stage) -> bool:
        node = stage.root
        while True:
            if isinstance(node, PartitionPruneExec):
                return True
            if len(node.children) != 1:
                return False
            node = node.children[0]

    def _replicated(self, stage: Stage, outputs, lid: str) -> bool:
        src = stage.sources[lid]
        return src.kind == "stage" and outputs[src.name].kind == "gather"


def execute_serial(ctx, plan, n_partitions: int,
                   options: Optional[DistOptions] = None,
                   max_retries: int = 4):
    """Plan and run out-of-core on the context's device, with the mesh
    path's quota-overflow and skew retry (escalate_overflow_opts; an
    operator that outgrew its capacity grows capacities alone). Returns
    (Batch on the device, Schema); the runs' StageMetrics are left in
    `ctx.serial_metrics` (a list by stage id, of the run that answered)."""
    from ..client.context import rebind_scans
    from ..planner.optimizer import prune_columns, reduce_group_keys

    plan = prune_columns(reduce_group_keys(rebind_scans(plan, ctx)))
    opts = options or ctx_dist_options(ctx, n_partitions)
    opts = dataclasses.replace(opts, n_partitions=n_partitions)
    for attempt in range(max_retries):
        rt = SerialRuntime(ctx, opts)
        try:
            out = rt.execute(plan)
        except ShuffleOverflowError as e:
            if attempt == max_retries - 1:
                raise
            if isinstance(e, CapacityOverflowError):
                opts = grow_capacities(opts, e.growth)
            else:
                opts = escalate_overflow_opts(opts, e, attempt)
            log.warning("serial overflow (%s); retrying with headroom %.1f, "
                        "join salt %d, max group table %d", e,
                        opts.quota_headroom, opts.join_salt,
                        opts.max_group_table)
            continue
        for m in rt.metrics.values():
            m.retries = attempt
        ctx.serial_metrics = [rt.metrics[k] for k in sorted(rt.metrics)]
        return out


def estimate_serial_hbm(ctx, plan, n_partitions: int) -> int:
    """The estimated peak of a serial run at n_partitions: the largest
    stage's (exec.memory.estimate_stage_hbm).

    A partition's working set does not shrink as a shard does: each
    exchange is sized by the capacity of the stage that sends it, twice
    the rows it expects per partition, and a join keeps its probe's
    capacity, so every shuffle join doubles the capacities after it (as
    in the reference)."""
    from ..client.context import rebind_scans
    from ..planner.optimizer import prune_columns, reduce_group_keys

    plan = prune_columns(reduce_group_keys(rebind_scans(plan, ctx)))
    opts = dataclasses.replace(ctx_dist_options(ctx, n_partitions),
                               n_partitions=n_partitions)
    def sent(_, root):
        # the runtime sizes a stage's inputs by the rows sent to it: an
        # exchange spreads its sender's capacity evenly; a gathered global
        # aggregate is one row
        if isinstance(root, ExchangeExec):
            return root.children[0].capacity
        if _static_one_row(root.children[0].children[0]
                           if isinstance(root.children[0], PartitionPruneExec)
                           else root.children[0]):
            return LANE
        return root.capacity

    dplan = DistributedPlanner(ctx, opts, sent).plan(plan)
    return max(memory.estimate_stage_hbm(s.root) for s in dplan.stages)


def fit_partitions(ctx, plan, n_partitions: int, budget: int,
                   max_parts: int = 64) -> int:
    """The partition count for a plan sent out-of-core: from n_partitions
    up, doubling to max_parts, the first at which `estimate_serial_hbm` is
    at most half the budget times the route factor (the model's estimate
    over its measured peak)."""
    n = n_partitions
    while n < max_parts and estimate_serial_hbm(ctx, plan, n) > \
            budget * 0.5 * memory.ROUTE_FACTOR:
        n *= 2
    return n


def ctx_dist_options(ctx, n_partitions: int) -> DistOptions:
    cfg = getattr(ctx, "config", None)
    if cfg is not None:
        return cfg.to_dist_options(n_partitions)
    return DistOptions(n_partitions=n_partitions)
