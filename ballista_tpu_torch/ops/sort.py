"""Multi-key sort over fixed-capacity batches (port of
ballista_tpu/ops/sort.py).

Torch has no lexsort, so a multi-key sort is a chain of stable sorts from
the least- to the most-significant key, with liveness as the most
significant key so dead rows sink to the back.

Null ordering follows DataFusion defaults: ASC -> NULLS LAST,
DESC -> NULLS FIRST (so nulls are always "largest").
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from ..batch import Batch, row_mask
from .compact import gather_batch
from .vsort import lex_perm


class SortKeySpec(NamedTuple):
    col_index: int
    ascending: bool = True
    nulls_first: bool | None = None  # None -> DataFusion default


def _rankable(data: torch.Tensor, valid: torch.Tensor,
              spec: SortKeySpec) -> torch.Tensor:
    """Map a column to a sortable tensor honoring direction + null placement."""
    nulls_first = spec.nulls_first
    if nulls_first is None:
        nulls_first = not spec.ascending  # DataFusion default
    if data.dtype.is_floating_point:
        d = torch.where(torch.isnan(data), float("inf"), data)  # NaN greatest
        d = d if spec.ascending else -d
        null_val = float("-inf") if nulls_first else float("inf")
        return torch.where(valid, d, null_val)
    d = data.to(torch.int64)
    d = d if spec.ascending else -d
    big = 2 ** 62
    return torch.where(valid, d, -big if nulls_first else big)


def sort_perm(batch: Batch, keys: Sequence[SortKeySpec]) -> torch.Tensor:
    """Permutation sorting live rows by keys; dead rows go last."""
    ranks = [_rankable(batch.columns[s.col_index].data,
                       batch.columns[s.col_index].validity, s) for s in keys]
    return lex_perm([(~row_mask(batch)).to(torch.uint8)] + ranks)


def sort_batch(batch: Batch, keys: Sequence[SortKeySpec]) -> Batch:
    return gather_batch(batch, sort_perm(batch, keys), batch.num_rows)
