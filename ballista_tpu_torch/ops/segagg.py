"""Group aggregation layouts (port of ballista_tpu/ops/segagg.py).

When every group key has a small static code bound (dictionary size, 2 for
bool), the group slot is a direct composite of the key codes: no hash
table, no sort. `MaskedLayout` then reduces each aggregate into T slots.
Integer sums and counts go through `masked_slot_sums_rows` (the
hand-written kernel on the card, which reads the value and validity columns
themselves); min, max and float sums stay plain torch.

Any other GROUP BY sorts the batch by its keys first: equal keys form
adjacent runs, and `SortedLayout` reduces each run (sums and counts as
differences of running sums at run ends, extrema by a scatter-reduce over
the run id, which the GPU does cheaply where the TPU needed binary
lifting). Percentiles sort (group, value) once more and read two
neighbours per group. The reference's `fused_sorted_aggregate` is not
ported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..batch import Column, row_index
from .masked_sums import masked_slot_sums_rows

# slot counts up to this use the masked layout
MASKED_MAX = 64
# direct composite slots are used when the static product of key bounds fits
DIRECT_MAX = 1 << 20


def _slot_index(row_slot: torch.Tensor, T: int) -> torch.Tensor:
    """int64 scatter index: the slot, or T (a spill row) for dead rows."""
    return torch.where((row_slot >= 0) & (row_slot < T), row_slot,
                       T).to(torch.int64)


# cells a laned reduction may spread its T + 1 slots over
_LANE_CELLS = 1 << 20


def _slot_reduce(index: torch.Tensor, values: torch.Tensor, T: int,
                 how: str, init=0) -> torch.Tensor:
    """`values` reduced into T cells by `index` (int64 in [0, T]; T is the
    spill cell, whose rows are dropped), each cell starting from `init`:
    (T,) sums (`how` = "sum"), minima ("amin") or maxima ("amax"). Each
    cell takes only its own rows, so a float sum's rounding is that of its
    own values. The card reduces with atomics, and rows that share a cell
    queue up behind each other (neighbouring rows do, on the sorted layout
    and on a layout of few slots): each cell is spread over up to 128
    lanes by row position, so a warp's rows go to different addresses, and
    the lanes are reduced afterwards. Where the cells are too many for
    two lanes each they are reduced into as they are."""
    lanes = 1
    while lanes < 128 and (T + 1) * lanes * 2 <= _LANE_CELLS:
        lanes *= 2
    if lanes > 1:
        pos = row_index(values.shape[0], values.device)
        index = index * lanes + (pos & (lanes - 1))
    out = values.new_full(((T + 1) * lanes,), init)
    if how == "sum":
        out.index_add_(0, index, values)
    else:
        out.scatter_reduce_(0, index, values, how)
    if lanes == 1:
        return out[:T]
    out = out.view(T + 1, lanes)
    return (out.sum(1) if how == "sum" else getattr(out, how)(1))[:T]


class MaskedLayout(NamedTuple):
    row_slot: torch.Tensor   # (n,) int32 in [0, T); dead rows -> T
    live: torch.Tensor       # (n,) bool
    T: int

    def sum(self, values, validity):
        """(per-slot sum over live valid rows, per-slot count > 0)."""
        active = self.live & validity
        if values.dtype.is_floating_point:
            v = torch.where(active, values, torch.zeros((), dtype=values.dtype,
                                                        device=values.device))
            out = _slot_reduce(_slot_index(self.row_slot, self.T), v, self.T,
                               "sum")
            cnt = self.count(values, validity)[0]
            return out, cnt > 0
        data = values if values.dtype in (torch.int32, torch.int64) \
            else values.to(torch.int64)
        s = masked_slot_sums_rows(self.row_slot, [(data, active),
                                                  (None, active)], self.T)
        return s[:, 0].to(values.dtype), s[:, 1] > 0

    def _count_mask(self, mask):
        out = masked_slot_sums_rows(self.row_slot, [(None, mask)], self.T)
        return out[:, 0], torch.ones(self.T, dtype=torch.bool,
                                     device=mask.device)

    def count(self, values, validity):
        return self._count_mask(self.live & validity)

    def count_star(self):
        return self._count_mask(self.live)

    def _extreme(self, values, validity, is_min):
        active = self.live & validity
        if values.dtype.is_floating_point:
            sent = float("inf") if is_min else float("-inf")
        else:
            info = torch.iinfo(values.dtype)
            sent = info.max if is_min else info.min
        sent_t = torch.full((), sent, dtype=values.dtype, device=values.device)
        v = torch.where(active, values, sent_t)
        out = _slot_reduce(_slot_index(self.row_slot, self.T), v, self.T,
                           "amin" if is_min else "amax", sent)
        cnt = self.count(values, validity)[0]
        ok = cnt > 0
        return torch.where(ok, out, torch.zeros_like(sent_t)), ok

    def min(self, values, validity):
        return self._extreme(values, validity, True)

    def max(self, values, validity):
        return self._extreme(values, validity, False)

    def carry(self, values, validity):
        """Any value of the group (all equal by construction — the
        functional-dependency group-key demotion, optimizer.py)."""
        return self._extreme(values, validity, False)

    def percentile(self, values, validity, frac: float):
        cnt, gvalid = self.count(values, validity)
        return _group_percentile(self.row_slot, self.live & validity, values,
                                 frac, cnt, gvalid, self.T)


def _group_percentile(gid, ok, values, frac: float, counts, gvalid, T: int):
    """Exact linear-interpolated percentile per group (percentile_cont).

    Sorting by (group, value) packs each group's valid values into one
    ascending run that starts at the exclusive running sum of the counts;
    the percentile interpolates between two reads of that run. NaN sorts
    behind every number, -0.0 beside 0.0."""
    from .vsort import lex_perm
    n = values.shape[0]
    key = torch.where(ok, gid.to(torch.int64), T)
    s_val = values.index_select(0, lex_perm([key, values]))
    cnt = counts.to(torch.int64)
    vstart = torch.cumsum(cnt, 0) - cnt          # exclusive prefix
    pos = vstart.to(torch.float64) + (cnt - 1).to(torch.float64) * frac
    lo = pos.floor().to(torch.int64).clamp(0, n - 1)
    hi = pos.ceil().to(torch.int64).clamp(0, n - 1)
    w = pos - pos.floor()
    a = s_val.index_select(0, lo).to(torch.float64)
    b = s_val.index_select(0, hi).to(torch.float64)
    valid = gvalid & (cnt > 0)
    out = a * (1.0 - w) + b * w
    return torch.where(valid, out, torch.zeros_like(out)), valid


def direct_slots(key_cols: Sequence[Column], bounds: Sequence[int],
                 live: torch.Tensor,
                 nullables: Optional[Sequence[bool]] = None
                 ) -> Tuple[torch.Tensor, int]:
    """Composite group slot from statically-bounded key codes.

    A nullable key contributes (bound + 1) values (the +1 encodes NULL);
    a non-nullable key contributes exactly `bound`. slot = sum(code_i *
    stride_i); dead rows get slot T."""
    if nullables is None:
        nullables = [True] * len(bounds)
    T = 1
    for b, nu in zip(bounds, nullables):
        T *= b + (1 if nu else 0)
    slot = torch.zeros(live.shape[0], dtype=torch.int32, device=live.device)
    stride = 1
    for col, b, nu in zip(key_cols, bounds, nullables):
        code = col.data.to(torch.int32).clamp(0, b - 1)
        if nu:
            code = torch.where(col.validity, code, b)
        slot = slot + code * stride
        stride *= b + (1 if nu else 0)
    return torch.where(live, slot, T).to(torch.int32), T


def decode_direct_slot(slot_ids: torch.Tensor, key_cols: Sequence[Column],
                       bounds: Sequence[int],
                       nullables: Optional[Sequence[bool]] = None
                       ) -> List[Column]:
    """Reconstruct key columns from composite slot ids (arithmetic only)."""
    if nullables is None:
        nullables = [True] * len(bounds)
    out = []
    stride = 1
    for col, b, nu in zip(key_cols, bounds, nullables):
        width = b + (1 if nu else 0)
        code = torch.div(slot_ids, stride, rounding_mode="floor") % width
        valid = code < b if nu else torch.ones_like(code, dtype=torch.bool)
        out.append(Column(code.to(col.data.dtype), valid))
        stride *= width
    return out


class SortedLayout(NamedTuple):
    """Runs of equal keys over a batch already sorted by them, dead rows
    at the back. Group g is the g-th run; T is the static output size."""
    run_id: torch.Tensor       # (n,) int64 group per sorted row; dead -> n
    run_start: torch.Tensor    # (T,) int64 first sorted row of each run
    run_end: torch.Tensor      # (T,) int64 last sorted row of each run
    n_groups: torch.Tensor     # () int64, may exceed T (overflow)
    live_sorted: torch.Tensor  # (n,) bool
    T: int

    def _valid(self):
        return torch.arange(self.T, device=self.run_end.device) < self.n_groups

    def _per_run(self, values):
        """Per-run sums of `values` (zero on dead rows). Integers:
        differences of the running sum at run ends. Runs are adjacent, so
        the previous run's end is this run's start - 1. int64 wraps mod
        2^64, which is exact for the signed total."""
        valid = self._valid()
        if values.dtype.is_floating_point:
            # a float difference of running sums carries the rounding of
            # the whole prefix (eps x the running total: at 10^7 rows it
            # passes 1e-9 of a one-row group's value), so float runs are
            # summed each into its own cell; rows past the last run that
            # fits (dead rows, groups beyond T) go to the spill cell
            out = _slot_reduce(self.run_id.clamp(max=self.T), values, self.T,
                               "sum")
            return torch.where(valid, out, torch.zeros_like(out)), valid
        csum = torch.cumsum(values, 0, dtype=values.dtype)
        end = csum.index_select(0, self.run_end)
        prev = torch.cat([end.new_zeros(1), end[:-1]])
        return torch.where(valid, end - prev, torch.zeros_like(end)), valid

    def _count_ok(self, ok):
        return self._per_run(ok.to(torch.int64))

    def sum(self, values, validity):
        ok = validity & self.live_sorted
        s, valid = self._per_run(torch.where(ok, values,
                                             torch.zeros_like(values)))
        cnt, _ = self._count_ok(ok)
        return s, valid & (cnt > 0)

    def count(self, values, validity):
        return self._count_ok(validity & self.live_sorted)

    def count_star(self):
        return self._count_ok(self.live_sorted)

    def _extreme(self, values, validity, is_min):
        ok = validity & self.live_sorted
        if values.dtype.is_floating_point:
            sent = float("inf") if is_min else float("-inf")
        else:
            info = torch.iinfo(values.dtype)
            sent = info.max if is_min else info.min
        out = _slot_reduce(self.run_id.clamp(max=self.T),
                           torch.where(ok, values, sent), self.T,
                           "amin" if is_min else "amax", sent)
        cnt, valid = self._count_ok(ok)
        valid = valid & (cnt > 0)
        return torch.where(valid, out, torch.zeros_like(out[:1])), valid

    def min(self, values, validity):
        return self._extreme(values, validity, True)

    def max(self, values, validity):
        return self._extreme(values, validity, False)

    def carry(self, values, validity):
        """Any value of the group (all equal by construction — the
        functional-dependency group-key demotion): the run end's."""
        ok = (validity & self.live_sorted).index_select(0, self.run_end)
        valid = self._valid() & ok
        out = values.index_select(0, self.run_end)
        return torch.where(valid, out, torch.zeros_like(out)), valid

    def percentile(self, values, validity, frac: float):
        ok = validity & self.live_sorted
        cnt, gvalid = self._count_ok(ok)
        return _group_percentile(self.run_id.clamp(max=self.T), ok, values,
                                 frac, cnt, gvalid, self.T)


def layout_from_sorted_keys(s_keys: Sequence[torch.Tensor],
                            live_sorted: torch.Tensor, T: int) -> SortedLayout:
    """SortedLayout over already-sorted key limbs (dead rows sentineled to
    the back); aggregate inputs must arrive sorted the same way."""
    n = s_keys[0].shape[0]
    return _run_layout(list(s_keys), live_sorted, n, min(T, n))


def _run_layout(s_keys, live_sorted, n: int, T: int) -> SortedLayout:
    from .vsort import first_positions
    dev = live_sorted.device
    pos = torch.arange(n, device=dev)
    prev_same = torch.ones(n, dtype=torch.bool, device=dev)
    for k in s_keys:
        rolled = torch.cat([k[:1], k[:-1]])
        prev_same = prev_same & (k == rolled)
    first = live_sorted & (~prev_same | (pos == 0))
    firsts_csum = torch.cumsum(first.to(torch.int64), 0)
    run_id = torch.where(live_sorted, firsts_csum - 1, n)
    n_groups = firsts_csum[-1]
    run_start = first_positions(first, T).clamp(0, n - 1)
    next_start = torch.cat([run_start[1:], run_start.new_full((1,), n)])
    total_live = live_sorted.sum()
    gid = torch.arange(T, device=dev)
    run_end = torch.where(gid + 1 < n_groups, next_start - 1,
                          total_live - 1).clamp(0, n - 1)
    return SortedLayout(run_id, run_start, run_end, n_groups, live_sorted, T)
