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
from ..parallel.shuffle import all_gather_batch, hash_partition_exchange
from .plan import ExecNode

_AT_ROOT = ("runs at a stage root across the partitions' outputs, where the "
            "multi-device runtime (DistributedRuntime.run_stage) and the "
            "serial runtime apply it; evaluating it for one partition is "
            "not implemented")


class ExchangeExec(ExecNode):
    """Hash-repartition the child's rows over `n_parts` partitions, at most
    `quota` rows from one sender to one destination (ShuffleWriterExec's
    hash path, `shuffle_writer.rs:328-449`). The receiving side sees
    P * quota rows of capacity."""

    def __init__(self, child: ExecNode, key_names: Sequence[str],
                 n_parts: int, quota: int, salt: int = 1,
                 salt_mode: str | None = None, salt_kind: str | None = None):
        self.children = (child,)
        self.key_names = tuple(key_names)
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

    def evaluate(self, run):
        raise NotImplementedError(f"ExchangeExec {_AT_ROOT}")

    def exchange(self, batches: Sequence[Batch], devices=None):
        """The P partitions' outputs of the stage body -> (received
        batches, per-sender overflow flags, per-sender pre-clamp counts)
        (`parallel.shuffle.hash_partition_exchange`)."""
        return hash_partition_exchange(batches, self._key_idx, self.n_parts,
                                       self.quota, devices, self.salt,
                                       self.salt_mode)

    def _label(self):
        s = f", salt={self.salt}:{self.salt_mode}" if self.salt > 1 else ""
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
