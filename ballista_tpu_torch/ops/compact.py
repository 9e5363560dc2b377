"""Row compaction / gather primitives (port of ballista_tpu/ops/compact.py)."""

from __future__ import annotations

import torch

from ..batch import Batch, Column, row_mask
from .gather import gather_columns


def compaction_perm(keep: torch.Tensor):
    """Stable permutation putting keep=True rows first; returns (perm, count)."""
    perm = torch.sort((~keep).to(torch.uint8), stable=True).indices
    return perm, keep.sum().to(torch.int32)


def gather_batch(batch: Batch, perm: torch.Tensor,
                 num_rows: torch.Tensor) -> Batch:
    """Reorder every column (data and validity) by `perm`."""
    return Batch(tuple(gather_columns(batch.columns, perm)),
                 num_rows.to(torch.int32))


def filter_batch(batch: Batch, mask_col: Column) -> Batch:
    """Apply a boolean predicate column: keep rows where it is true and
    valid (SQL WHERE drops NULL predicates), compacted to the front."""
    from .vsort import compact_batch
    keep = mask_col.data.to(torch.bool) & mask_col.validity & row_mask(batch)
    return compact_batch(batch, keep)


def limit_batch(batch: Batch, n: int) -> Batch:
    """The first `n` live rows; the capacity stays."""
    new_rows = torch.clamp(batch.num_rows, max=n).to(torch.int32)
    live = torch.arange(batch.capacity, dtype=torch.int32,
                        device=batch.device) < new_rows
    return Batch(tuple(Column(c.data, c.validity & live)
                       for c in batch.columns), new_rows)
