"""Row gather of many columns through one index vector (port of
ballista_tpu/ops/gather.py `gather_columns`).

On the TPU the reference packs columns into per-width matrices and chunks
the gather around an output-layout hazard; on the GPU a per-column
`index_select` is the plain form and moves the same bytes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from ..batch import Column


def gather_columns(cols: Sequence[Column], idx: torch.Tensor,
                   valid_and: Optional[torch.Tensor] = None) -> List[Column]:
    """Rows `idx` (int64, in range) of every column. `valid_and` (same
    shape as idx) is ANDed into every output validity (the caller's
    matched/live mask)."""
    out = []
    for c in cols:
        valid = c.validity.index_select(0, idx)
        if valid_and is not None:
            valid = valid & valid_and
        out.append(Column(c.data.index_select(0, idx), valid))
    return out
