"""Key hashing, equality-key normalisation and packing (port of
ballista_tpu/ops/hash.py: `hash_columns`, `_norm_keys`, `plan_key_packing`,
`pack_key_columns`).

`hash_columns` picks the shuffle destination of every row, so it must give
the reference's uint32 hash bit for bit. A sorted GROUP BY and a multi-key
join compare keys for equality. Keys with known value bounds pack into
shared int64 limbs, so a two-key join probes one key and a multi-key GROUP
BY sorts one key. The open-addressing group and join tables of that module
are not ported: nothing in the engine calls them.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..batch import Column

NULL_KEY = -(2 ** 62)
MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the constant is split in
    16-bit halves, so no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def hash_columns(key_datas: Sequence[torch.Tensor],
                 key_valids: Sequence[torch.Tensor],
                 seed: int = 0x9E3779B9) -> torch.Tensor:
    """Combine key columns into a uint32 hash (murmur3-style finalizer),
    held in int64 (torch has no uint32 arithmetic on the card).

    NULLs hash as a distinct value, so validity participates in the hash.
    `seed` decorrelates different uses of the same keys. Every step is
    masked to 32 bits, so the result equals the reference's uint32 hash."""
    h = torch.full(key_datas[0].shape, seed, dtype=torch.int64,
                   device=key_datas[0].device)
    for data, valid in zip(key_datas, key_valids):
        d = data.to(torch.int64)
        for part in (d & MASK32, (d >> 32) & MASK32, valid.to(torch.int64)):
            k = _mul32(part, 0xCC9E2D51)
            k = _rotl32(k, 15)
            k = _mul32(k, 0x1B873593)
            h = h ^ k
            h = _rotl32(h, 13)
            h = (h * 5 + 0xE6546B64) & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _norm_keys(key_datas: Sequence[torch.Tensor],
               key_valids: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Canonicalize keys for equality compare: int64, invalid -> a fixed
    sentinel."""
    return [torch.where(valid, data.to(torch.int64), NULL_KEY)
            for data, valid in zip(key_datas, key_valids)]


def plan_key_packing(bounds, null_slots: bool, max_bits: int = 62):
    """Static packing plan for equality keys with known value bounds.

    bounds: per key, (lo, hi) or None. Keys with bounds pack into shared
    <= 62-bit int64 limbs (an equality-preserving bijection).
    null_slots=True reserves field value 0 for NULL, so NULL forms its own
    group (grouping semantics); False leaves NULL to the packed column's
    validity (join semantics: null keys never match). Field widths round
    up to 4-bit multiples, as in the reference. Returns (groups, unpacked):
    groups = lists of (key_index, lo, bits); unpacked = key indices kept as
    their own column."""
    fields = []
    for b in bounds:
        if b is None:
            fields.append(None)
            continue
        lo, hi = int(b[0]), int(b[1])
        need = (hi - lo + (2 if null_slots else 1)).bit_length()
        bits = max(((need + 3) // 4) * 4, 4)
        fields.append((lo, bits) if bits <= max_bits else None)
    groups, cur, cur_bits, unpacked = [], [], 0, []
    for i, f in enumerate(fields):
        if f is None:
            unpacked.append(i)
            continue
        lo, bits = f
        if cur and cur_bits + bits > max_bits:
            groups.append(cur)
            cur, cur_bits = [], 0
        cur.append((i, lo, bits))
        cur_bits += bits
    if cur:
        groups.append(cur)
    return groups, unpacked


def pack_key_columns(cols: Sequence[Column], groups, unpacked,
                     null_slots: bool) -> List[Column]:
    """Apply a plan_key_packing plan to a list of Columns; returns the
    reduced column list (packed limbs first, then unpacked keys)."""
    out = []
    for g in groups:
        v = None
        valid_all = None
        for i, lo, bits in g:
            c = cols[i]
            d = c.data.to(torch.int64) - lo
            if null_slots:
                fv = torch.where(c.validity, d + 1, 0)
            else:
                fv = torch.where(c.validity, d, 0)
                valid_all = (c.validity if valid_all is None
                             else valid_all & c.validity)
            v = fv if v is None else ((v << bits) | fv)
        validity = (torch.ones_like(v, dtype=torch.bool) if null_slots
                    else valid_all)
        out.append(Column(v, validity))
    out.extend(cols[i] for i in unpacked)
    return out
