"""Expanding equality join: duplicate build keys, each probe row fanning
out to every build row with its key (port of
ballista_tpu/ops/expand_join.py `expand_join`).

The reference co-sorts build and probe keys and forward-fills run heads
with a cummax, because searches and scatters are slow on the TPU. On the
GPU the plain form is: sort the ok build keys once, find each probe key's
run of equal build keys with two `searchsorted` calls (its first position
and its match count), prefix-sum the counts into output slots, and map
each slot back to its (probe row, k-th match) with `rank_in_sorted`.

The output has a static capacity. A larger total is clipped, never
silently: `need` keeps the unclipped total, and the caller re-runs with a
larger capacity.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .merge_join import _MAX, single_key
from .vsort import rank_in_sorted


class ExpandedMatch(NamedTuple):
    probe_row: torch.Tensor      # (out_capacity,) int64 probe row, -1 past total
    build_row: torch.Tensor      # (out_capacity,) int64 build row, -1 for an
                                 # outer miss and past total
    valid: torch.Tensor          # (out_capacity,) bool live output slot
    total: torch.Tensor          # () int32 output rows (clipped to capacity)
    need: torch.Tensor           # () int64 output rows before the clip
    build_matched: torch.Tensor  # (nb,) bool build row matched >= 1 probe


def expand_join(build_keys: Sequence[torch.Tensor],
                build_valids: Sequence[torch.Tensor],
                build_live: torch.Tensor,
                probe_keys: Sequence[torch.Tensor],
                probe_valids: Sequence[torch.Tensor],
                probe_live: torch.Tensor,
                out_capacity: int, left_outer: bool = False) -> ExpandedMatch:
    """Every (probe row, build row) pair with equal keys, in probe-row
    order and, within a probe row, in build-row order. NULL keys never
    match and dead rows take no part. With `left_outer`, a live probe row
    without a match gets one slot with build_row -1. Both sides hold at
    least one row (a batch's capacity is never 0)."""
    dev = probe_live.device
    nb, np_ = build_live.shape[0], probe_live.shape[0]
    b, b_ok, p, p_ok = single_key(build_keys, build_valids, build_live,
                                  probe_keys, probe_valids, probe_live)
    vals, order = torch.sort(torch.where(b_ok, b, _MAX), stable=True)
    n_ok = b_ok.sum()
    first = torch.searchsorted(vals, p).clamp(max=n_ok)
    end = torch.searchsorted(vals, p, right=True).clamp(max=n_ok)
    n_match = torch.where(p_ok, end - first, 0)
    cnt = n_match
    if left_outer:
        cnt = torch.where(probe_live, n_match.clamp(min=1), 0)

    # slot j belongs to probe row i = #{rows whose slots end at or before j}
    csum = torch.cumsum(cnt, 0)
    total = csum[-1]
    i = rank_in_sorted(csum, out_capacity).clamp(max=np_ - 1)
    j = torch.arange(out_capacity, dtype=torch.int64, device=dev)
    k = j - (csum - cnt).index_select(0, i)   # i's k-th slot
    valid = (j < total) & (k >= 0) & (k < cnt.index_select(0, i))
    matched = valid & (n_match.index_select(0, i) > 0)
    src = (first.index_select(0, i) + k).clamp(0, nb - 1)
    build_row = torch.where(matched, order.index_select(0, src), -1)

    # a build row matched iff its sorted position lies inside some matched
    # probe row's run [first, end): mark the runs with +1/-1 and prefix-sum
    has = (n_match > 0).to(torch.int32)
    cover = torch.zeros(nb + 1, dtype=torch.int32, device=dev)
    cover.index_add_(0, first, has)
    cover.index_add_(0, end, -has)
    covered = torch.cumsum(cover[:nb], 0) > 0
    build_matched = torch.zeros(nb, dtype=torch.bool, device=dev)
    build_matched[order] = covered
    return ExpandedMatch(torch.where(valid, i, -1), build_row, valid,
                         total.clamp(max=out_capacity).to(torch.int32),
                         total.to(torch.int64), build_matched)
