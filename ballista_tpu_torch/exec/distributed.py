"""Stage-boundary operators (port of ballista_tpu/exec/distributed.py).

Reference parity: Ballista's ShuffleWriterExec -> ExchangeExec (hash
repartition at a producer stage's root), CoalescePartitionsExec ->
GatherExec (every partition's rows to every partition), and the final
merge stage's single output partition -> PartitionPruneExec. The stage
planner (`scheduler/distributed_planner.py`) puts an ExchangeExec or a
GatherExec at the root of every stage but the last, and nowhere else.

The JAX package evaluates them inside one program over the mesh, as
collectives. The port's runtimes run a stage's body once per partition and
then apply the root across the P outputs: the partitioned runtime
(`scheduler/runtime.py`) through `ExchangeExec.exchange` and
`GatherExec.gather` (`parallel/shuffle.py`, on the devices), the serial
runtime (`scheduler/serial.py`) on the host. Evaluated for one partition,
below a stage root, they raise.

The reference keeps the partition id and the per-operator row counts in
class globals (`_PartitionCtx`, `_TraceCtx`); here they live on the
`Run` (`exec/plan.py`): `run.partition`, `run.op_rows`, and the overflow
flags in `run.flags`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import Batch, Column
from ..exprs import gather_lut, value_hash_lut
from ..parallel.shuffle import all_gather_batch, hash_partition_exchange
from ..schema import TypeKind
from .plan import ExecNode

_AT_ROOT = ("runs at a stage root across the partitions' outputs, where the "
            "multi-device runtime (DistributedRuntime.run_stage) and the "
            "serial runtime apply it; evaluating it for one partition is "
            "not implemented")


class ExchangeExec(ExecNode):
    """Hash-repartition the child's rows over `n_parts` partitions, at most
    `quota` rows from one sender to one destination (ShuffleWriterExec's
    hash path, `shuffle_writer.rs:328-449`). The receiving side sees
    P * quota rows of capacity.

    The string keys named in `value_hash` (by default the child's RAW
    ones) are hashed by a hash of their values, not by their codes: a RAW
    code is a row index, so equal values would go to different
    partitions. Both sides of a shuffle join hash a key pair alike (the
    stage planner names it on both when either side is RAW)."""

    def __init__(self, child: ExecNode, key_names: Sequence[str],
                 n_parts: int, quota: int, salt: int = 1,
                 salt_mode: str | None = None, salt_kind: str | None = None,
                 value_hash: Sequence[str] | None = None):
        self.children = (child,)
        self.key_names = tuple(key_names)
        if value_hash is None:
            value_hash = [k for k in key_names
                          if not child.schema.is_sorted_dict(k)]
        self.value_hash = tuple(k for k in key_names if k in set(value_hash))
        self.n_parts = n_parts
        self.quota = quota
        # skewed-key splitting: salt > 1 spreads each key over `salt`
        # destinations ('spread' on a join's probe side, 'replicate' on
        # its build side)
        self.salt = salt
        self.salt_mode = salt_mode
        # what salting a retry would apply here ('spread' / 'replicate'
        # for join sides, None for plain repartitions): the overflow
        # stats handler picks salt or quota from it
        self.salt_kind = salt_kind if salt_kind is not None else salt_mode
        self.schema = child.schema
        self.capacity = n_parts * quota
        self._key_idx = [child.schema.index_of(k) for k in key_names]
        self._value_luts = []     # (key position, code -> value hash)
        for j, k in enumerate(self.key_names):
            if k in self.value_hash:
                if child.schema.field(k).dtype.kind is not TypeKind.STRING:
                    raise ValueError(f"ExchangeExec: value hash of the "
                                     f"non-string key {k!r}")
                self._value_luts.append(
                    (j, value_hash_lut(child.schema.dictionary(k))))

    def evaluate(self, run):
        raise NotImplementedError(f"ExchangeExec {_AT_ROOT}")

    def hash_input(self, batch: Batch):
        """(batch, key column indices) for the destination hash: with
        each value-hashed key's value hashes appended as columns (strip
        them with `drop_hash_columns`)."""
        if not self._value_luts:
            return batch, self._key_idx
        n = len(batch.columns)
        idx, extra = list(self._key_idx), []
        for j, lut in self._value_luts:
            c = batch.columns[idx[j]]
            extra.append(Column(gather_lut(lut, c), c.validity))
            idx[j] = n + len(extra) - 1
        return batch.replace_columns(batch.columns + tuple(extra)), idx

    def drop_hash_columns(self, batch: Batch) -> Batch:
        """A batch made from `hash_input`'s, without its appended columns."""
        if not self._value_luts:
            return batch
        return batch.replace_columns(
            batch.columns[:len(batch.columns) - len(self._value_luts)])

    def exchange(self, batches: Sequence[Batch], devices=None):
        """The P partitions' outputs of the stage body -> (received
        batches, per-sender overflow flags, per-sender pre-clamp counts)
        (`parallel.shuffle.hash_partition_exchange`)."""
        keyed = [self.hash_input(b) for b in batches]
        outs, ovs, counts = hash_partition_exchange(
            [b for b, _ in keyed], keyed[0][1] if keyed else self._key_idx,
            self.n_parts, self.quota, devices, self.salt, self.salt_mode)
        return [self.drop_hash_columns(b) for b in outs], ovs, counts

    def _label(self):
        s = f", salt={self.salt}:{self.salt_mode}" if self.salt > 1 else ""
        if self.value_hash:
            s += f", value_hash={list(self.value_hash)}"
        return (f"ExchangeExec(keys={list(self.key_names)}, "
                f"P={self.n_parts}, q={self.quota}{s})")


class GatherExec(ExecNode):
    """Every partition's rows onto every partition (CoalescePartitionsExec,
    the broadcast side of a join); capacity P x the child's."""

    def __init__(self, child: ExecNode, n_parts: int):
        self.children = (child,)
        self.n_parts = n_parts
        self.schema = child.schema
        self.capacity = n_parts * child.capacity

    def evaluate(self, run):
        raise NotImplementedError(f"GatherExec {_AT_ROOT}")

    def gather(self, batches: Sequence[Batch], devices=None):
        """The P partitions' outputs of the stage body -> every partition's
        rows on every partition (`parallel.shuffle.all_gather_batch`)."""
        return all_gather_batch(batches, self.n_parts, devices)

    def _label(self):
        return f"GatherExec(P={self.n_parts})"


class PartitionPruneExec(ExecNode):
    """Keep the rows on partition 0 only: after a gather every partition
    holds the same rows, and a final stage has one output partition, as
    Ballista's final merge stage does. Reads `run.partition`."""

    def __init__(self, child: ExecNode):
        self.children = (child,)
        self.schema = child.schema
        self.capacity = child.capacity

    def evaluate(self, run):
        b = run.eval(self.children[0])
        if run.partition is None:
            raise RuntimeError("PartitionPruneExec needs the partition id of "
                               "a runtime's run (Run.partition)")
        if run.partition == 0:
            return b
        return Batch(tuple(Column(c.data, torch.zeros_like(c.validity))
                           for c in b.columns),
                     torch.zeros((), dtype=torch.int32, device=b.device))

    def _label(self):
        return "PartitionPruneExec(shard0)"
