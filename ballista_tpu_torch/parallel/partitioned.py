"""Partitioned batches (port of ballista_tpu/parallel/partitioned.py).

Reference parity: a Ballista table scan's partitions (one file partition
per task). The JAX package holds a partitioned table as (P, capacity)
arrays sharded over the mesh; the port holds P `Batch`es of one capacity,
batch p on its partition's device. Partitioning reads the table's host
columns, whose strings are codes into one table-wide dictionary, so every
partition's codes agree.

Over a mesh that spans processes (`multihost.GlobalMesh`) a process builds
and holds its own partitions only: the other entries of `batches` are
None.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..batch import Batch, round_capacity
from ..schema import Schema


class PartitionedBatch(NamedTuple):
    """batches[p]: partition p's rows, on its device (None for a partition
    another process holds); one capacity."""
    batches: Tuple[Optional[Batch], ...]

    @property
    def n_partitions(self) -> int:
        return len(self.batches)

    @property
    def first(self) -> Batch:
        """The first partition this process holds."""
        return next(b for b in self.batches if b is not None)

    @property
    def capacity(self) -> int:
        return self.first.capacity

    @property
    def num_rows(self) -> torch.Tensor:
        """(P,) int32 on the first held partition's device (0 for a
        partition another process holds)."""
        dev = self.first.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return torch.stack([zero if b is None else b.num_rows.to(dev)
                            for b in self.batches])

    @property
    def nbytes(self) -> int:
        """Device bytes of the partitions' columns this process holds (a
        batch that several partitions share counts once)."""
        seen, total = set(), 0
        for b in self.batches:
            if b is None:
                continue
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
    partition. Over a mesh that spans processes only this process's
    partitions are made."""
    names = list(columns) if columns else [f.name for f in tp.fields]
    P = len(devices)
    if capacity is None:
        capacity = round_capacity(max(-(-tp.num_rows // P), 1))
    local = getattr(devices, "is_local", lambda p: True)
    batches = []
    for p, dev in enumerate(devices):
        lo, hi = partition_rows(tp.num_rows, P, p)
        batches.append(tp.range_batch(names, lo, hi, capacity, dev)
                       if local(p) else None)
    schema = tp.schema.select(names) if columns else tp.schema
    return PartitionedBatch(tuple(batches)), schema


def gather_partitions(pb: PartitionedBatch, schema: Schema,
                      device=None, mesh=None) -> Batch:
    """Every partition's live rows in partition order, as one batch of P x
    the capacity on `device` (the first partition's by default): the
    result egress, the client fetching the final partitions. Over a mesh
    that spans processes (`mesh`) every process gets every row, on the
    device of its first partition."""
    from .shuffle import all_gather_batch
    from .multihost import spans_processes
    if spans_processes(mesh):
        return all_gather_batch(pb.batches, pb.n_partitions, mesh)[
            mesh.local_partitions[0]]
    device = device if device is not None else pb.first.device
    return all_gather_batch(pb.batches, pb.n_partitions,
                            [device] * pb.n_partitions)[0]
