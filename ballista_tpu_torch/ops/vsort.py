"""Sort-driven data movement (port of ballista_tpu/ops/vsort.py
`sort_batch_columns`, `first_positions` and `compact_batch`).

The reference rides payload columns on one variadic XLA sort, because a
TPU gather through a permutation is slow; it also packs sort operands to
cut XLA compile time. Neither holds on the GPU: here a sort yields a
permutation (chained stable sorts for several keys, as in ops/sort.py)
and every column is gathered through it with `index_select`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..batch import Batch, Column
from .compact import compaction_perm, gather_batch


def lex_perm(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stable permutation sorting rows by `keys`, most significant first."""
    perm = None
    for k in reversed(list(keys)):
        if perm is None:
            perm = torch.sort(k, stable=True).indices
        else:
            perm = perm.index_select(
                0, torch.sort(k.index_select(0, perm), stable=True).indices)
    return perm


def sort_batch_columns(keys: Sequence[torch.Tensor], batch: Batch,
                       extra: Sequence[torch.Tensor] = ()):
    """Sort the batch's columns (and `extra` tensors) by `keys`, stably.

    Returns (sorted Batch with the original num_rows, sorted extras tuple,
    sorted keys tuple). Keys must already encode direction, NULL placement
    and liveness (dead rows to the back) as the caller requires."""
    perm = lex_perm(keys)
    out = gather_batch(batch, perm, batch.num_rows)
    return (out, tuple(e.index_select(0, perm) for e in extra),
            tuple(k.index_select(0, perm) for k in keys))


def first_positions(first: torch.Tensor, T: int) -> torch.Tensor:
    """Positions (int64) of the g-th True in `first`, for g < T (garbage
    past the count: callers mask). T must not exceed len(first)."""
    return compaction_perm(first)[0][:T]


def compact_batch(batch: Batch, keep: torch.Tensor) -> Batch:
    """keep=True rows to the front (stable), num_rows = count, validity
    masked past the count."""
    perm, count = compaction_perm(keep)
    out = gather_batch(batch, perm, count)
    live = torch.arange(batch.capacity, dtype=torch.int32,
                        device=keep.device) < count
    return Batch(tuple(Column(c.data, c.validity & live) for c in out.columns),
                 count)


def rank_in_sorted(csum: torch.Tensor, M: int) -> torch.Tensor:
    """i[j] = #{k: csum[k] <= j} for j = 0..M-1, csum non-decreasing (int64).

    The reference merges csum with 0..M-1 in two sorts, because XLA's
    searchsorted is slow on the TPU; on the GPU it is one binary search."""
    j = torch.arange(M, dtype=csum.dtype, device=csum.device)
    return torch.searchsorted(csum, j, right=True)
