"""Partitioned batches (port of ballista_tpu/parallel/partitioned.py).

Reference parity: a Ballista table scan's partitions (one file partition
per task). The JAX package holds a partitioned table as (P, capacity)
arrays sharded over the mesh; the port holds P `Batch`es of one capacity,
batch p on its partition's device. Partitioning reads the table's host
columns, whose strings are codes into one table-wide dictionary, so every
partition's codes agree.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..batch import Batch, round_capacity
from ..schema import Schema


class PartitionedBatch(NamedTuple):
    """batches[p]: partition p's rows, on its device; one capacity."""
    batches: Tuple[Batch, ...]

    @property
    def n_partitions(self) -> int:
        return len(self.batches)

    @property
    def capacity(self) -> int:
        return self.batches[0].capacity

    @property
    def num_rows(self) -> torch.Tensor:
        """(P,) int32 on the first partition's device."""
        dev = self.batches[0].device
        return torch.stack([b.num_rows.to(dev) for b in self.batches])

    @property
    def nbytes(self) -> int:
        """Device bytes of the partitions' columns (a batch that several
        partitions share counts once)."""
        seen, total = set(), 0
        for b in self.batches:
            for c in b.columns:
                for t in (c.data, c.validity):
                    if t.data_ptr() not in seen:
                        seen.add(t.data_ptr())
                        total += t.numel() * t.element_size()
        return total


def partition_rows(n_rows: int, n_partitions: int, p: int) -> Tuple[int, int]:
    """The row range [lo, hi) of partition p: shard p gets rows
    [p * per, (p + 1) * per) with per = ceil(n / P), as Ballista's CSV
    partition splits do."""
    per = -(-n_rows // n_partitions)
    return min(p * per, n_rows), min((p + 1) * per, n_rows)


def partition_table(tp, devices: Sequence, columns: Optional[Sequence[str]]
                    = None, capacity: Optional[int] = None
                    ) -> Tuple[PartitionedBatch, Schema]:
    """Split a registered table row-wise over the partitions of `devices`
    (one per partition) -> (PartitionedBatch, Schema) (the JAX package's
    `partition_arrow`, over the host columns and `range_batch` rather than
    an arrow table). `capacity` defaults to the lane-rounded rows of one
    partition."""
    names = list(columns) if columns else [f.name for f in tp.fields]
    P = len(devices)
    if capacity is None:
        capacity = round_capacity(max(-(-tp.num_rows // P), 1))
    batches = []
    for p, dev in enumerate(devices):
        lo, hi = partition_rows(tp.num_rows, P, p)
        batches.append(tp.range_batch(names, lo, hi, capacity, dev))
    schema = tp.schema.select(names) if columns else tp.schema
    return PartitionedBatch(tuple(batches)), schema


def gather_partitions(pb: PartitionedBatch, schema: Schema,
                      device=None) -> Batch:
    """Every partition's live rows in partition order, as one batch of P x
    the capacity on `device` (the first partition's by default): the
    result egress, the client fetching the final partitions."""
    from .shuffle import all_gather_batch
    device = device if device is not None else pb.batches[0].device
    return all_gather_batch(pb.batches, pb.n_partitions,
                            [device] * pb.n_partitions)[0]
