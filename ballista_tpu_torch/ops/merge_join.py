"""Unique-build join probe: one function in place of
ballista_tpu/ops/merge_join.py `tiny_probe_unique`,
`merge_probe_unique_packed` and `merge_probe_unique`, with their results,
and `merge_full_unique`, which also flags the build rows that matched.

For each probe row the probe returns the index of the build row with an
equal key, or -1. NULL keys never match (on either side), and neither do
dead rows. The build keys are taken to be unique among live valid rows;
if they are not, the lowest-indexed build row of the key wins, as it does
in the reference's stable co-sort.

The reference co-sorts build and probe keys, forward-fills run heads with
a cummax and routes the result back with a second sort, because scatters
and searches are slow on the TPU. On the GPU the plain form is: sort the
live valid build keys once, binary-search the probe keys with
`torch.searchsorted`, and check equality at the found position. Several
keys are first reduced to one by dense codes (a key's code is the sorted
position of its first occurrence among the build keys), so any number of
unbounded keys probes as one int64.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .hash import _norm_keys

_MAX = torch.iinfo(torch.int64).max


def _all(masks: Sequence[torch.Tensor], base: torch.Tensor) -> torch.Tensor:
    out = base
    for m in masks:
        out = out & m
    return out


def _search(b: torch.Tensor, b_ok: torch.Tensor, p: torch.Tensor):
    """Sort the ok build keys (the rest sink past `n_ok` as _MAX) and find
    each probe key: (sorted keys, their build indices, probe position,
    probe hit). A miss never reads past the sorted build."""
    vals, order = torch.sort(torch.where(b_ok, b, _MAX), stable=True)
    pos = torch.searchsorted(vals, p)
    at = pos.clamp(max=b.shape[0] - 1)
    hit = (pos < b_ok.sum()) & (vals.index_select(0, at) == p)
    return vals, order, at, hit


def single_key(build_keys: Sequence[torch.Tensor],
               build_valids: Sequence[torch.Tensor],
               build_live: torch.Tensor,
               probe_keys: Sequence[torch.Tensor],
               probe_valids: Sequence[torch.Tensor],
               probe_live: torch.Tensor):
    """Reduce equality keys to one int64 key per side: (build key, build
    ok, probe key, probe ok), where ok rows are live with no NULL key part
    and two ok rows have equal keys iff every key part is equal. A probe
    row whose key part occurs in no ok build row is no longer ok."""
    b_ok = _all(build_valids, build_live)
    p_ok = _all(probe_valids, probe_live)
    b_norm = _norm_keys(build_keys, build_valids)
    p_norm = _norm_keys(probe_keys, probe_valids)
    nb = b_norm[0].shape[0]
    b, p = b_norm[0], p_norm[0]
    for bk, pk in zip(b_norm[1:], p_norm[1:]):
        # fold the next key in: (code so far, code of this key) -> one code
        # in [0, nb^2), then back to [0, nb) so the next fold cannot overflow
        codes = []
        for key_b, key_p in ((b, p), (bk, pk)):
            vals, _, at, hit = _search(key_b, b_ok, key_p)
            p_ok = p_ok & hit
            codes.append((torch.searchsorted(vals, key_b), at))
        b = codes[0][0] * nb + codes[1][0]
        p = codes[0][1] * nb + codes[1][1]
    return b, b_ok, p, p_ok


def probe_unique(build_keys: Sequence[torch.Tensor],
                 build_valids: Sequence[torch.Tensor],
                 build_live: torch.Tensor,
                 probe_keys: Sequence[torch.Tensor],
                 probe_valids: Sequence[torch.Tensor],
                 probe_live: torch.Tensor) -> torch.Tensor:
    """int64 match per probe row: the matching build row, or -1."""
    b, b_ok, p, p_ok = single_key(build_keys, build_valids, build_live,
                                  probe_keys, probe_valids, probe_live)
    _, order, at, hit = _search(b, b_ok, p)
    return torch.where(p_ok & hit, order.index_select(0, at), -1)


def merge_full_unique(build_keys: Sequence[torch.Tensor],
                      build_valids: Sequence[torch.Tensor],
                      build_live: torch.Tensor,
                      probe_keys: Sequence[torch.Tensor],
                      probe_valids: Sequence[torch.Tensor],
                      probe_live: torch.Tensor):
    """FULL OUTER variant of `probe_unique`: (int64 match per probe row or
    -1, bool per build row: live, no NULL key part, matched by some probe
    row). The reference reads the matched flags off its co-sort's runs;
    here each probe match marks its build row."""
    b, b_ok, p, p_ok = single_key(build_keys, build_valids, build_live,
                                  probe_keys, probe_valids, probe_live)
    _, order, at, hit = _search(b, b_ok, p)
    match = torch.where(p_ok & hit, order.index_select(0, at), -1)
    nb, np_ = b.shape[0], p.shape[0]
    # probe row i that misses marks the spare slot nb + i (no two misses
    # write one slot); the spare slots are dropped
    spare = nb + torch.arange(np_, dtype=torch.int64, device=b.device)
    marked = torch.zeros(nb + np_, dtype=torch.bool, device=b.device)
    marked.index_fill_(0, torch.where(match >= 0, match, spare), True)
    return match, marked[:nb] & b_ok
