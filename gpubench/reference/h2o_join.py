"""The five h2o db-benchmark join questions (`gpubench/queries/h2o_join.json`)
in plain torch over the generated tables.

Each join sorts the right table's key and searches it for the left
table's keys, a block of left rows at a time (`equi_join`: every match,
so a key the right table repeats is joined to each of its rows; a LEFT
join keeps an unmatched row once, with the right table's columns NULL).
A string key joins by string: each table's dictionary mapped into the
sorted union of both. The columns are copied: ids as int64, id4 and id5
as codes into their table's own dictionary, id6 as codes into the
sorted distinct strings of the two tables' id6 spans (packed into 64-bit
words and sorted on the device, `text_codes`), v1 and v2 as they are. A
NULL cell holds 0 (code 0 of its column's dictionary). The control
(`control=True`) carries v1 and v2 in float32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..answer import Answer, RCol
from ..tables import Col, Tables
from .ops import Data

BLOCK = 1 << 24         # left rows searched at a time
WORD = 8                # bytes a packed word holds
_SIGN = -(1 << 63)      # flipped in each word: signed order is byte order


def equi_join(right: torch.Tensor, left: torch.Tensor, keep_left: bool = False,
              block: int = BLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """(left row, right row) of every pair whose keys are equal, in left row
    order; with `keep_left`, a left row with no match once more with right
    row -1."""
    order = torch.argsort(right, stable=True)
    keys = right[order]
    lrows, rrows = [], []
    for lo in range(0, len(left), block):
        k = left[lo:lo + block]
        first = torch.searchsorted(keys, k, side="left")
        count = torch.searchsorted(keys, k, side="right") - first
        take = count.clamp(min=1) if keep_left else count
        rows = torch.arange(lo, lo + len(k), device=left.device)
        lr = torch.repeat_interleave(rows, take)
        start = torch.repeat_interleave(torch.cumsum(take, 0) - take, take)
        at = torch.repeat_interleave(first, take) + (
            torch.arange(len(lr), device=left.device) - start)
        rr = order[at.clamp(max=max(len(keys) - 1, 0))]
        if keep_left:
            rr = torch.where(torch.repeat_interleave(count > 0, take), rr, -1)
        lrows.append(lr)
        rrows.append(rr)
    if not lrows:
        none = torch.zeros(0, dtype=torch.int64, device=left.device)
        return none, none
    return torch.cat(lrows), torch.cat(rrows)


def _words(data: torch.Tensor, starts: torch.Tensor, ends: torch.Tensor,
           width: int) -> List[torch.Tensor]:
    """Each span's bytes packed into `width` big-endian words, zero-padded,
    the sign bit flipped: the words order as the strings do."""
    lens = ends - starts
    out = []
    for w in range(width):
        word = torch.zeros(len(starts), dtype=torch.int64, device=data.device)
        for b in range(WORD):
            j = WORD * w + b
            byte = data[(starts + j).clamp(max=len(data) - 1)].to(torch.int64)
            word |= torch.where(lens > j, byte, 0) << (56 - 8 * b)
        out.append(word ^ _SIGN)
    return out


def text_codes(cols: List[Col], device) -> Tuple[List[torch.Tensor],
                                                 np.ndarray]:
    """Codes of several text columns (spans into one byte buffer) into the
    sorted distinct strings of all their rows, and those strings (a 'U'
    array). The strings hold no NUL byte."""
    data = torch.as_tensor(cols[0].dictionary, device=device)
    if any(c.dictionary is not cols[0].dictionary for c in cols):
        raise ValueError("text columns over different byte buffers")
    starts = torch.cat([torch.as_tensor(c.values, device=device)
                        for c in cols])
    ends = torch.cat([torch.as_tensor(c.ends, device=device) for c in cols])
    top = int((ends - starts).max()) if len(starts) else 1
    width = max(1, -(-top // WORD))
    words = _words(data, starts, ends, width)
    perm = torch.arange(len(starts), device=device)
    for w in reversed(words):
        perm = perm[torch.sort(w[perm], stable=True).indices]
    new = torch.ones(len(perm), dtype=torch.bool, device=device)
    for w in words:
        s = w[perm]
        new[1:] &= s[1:] == s[:-1]
    new = ~new
    new[:1] = True
    rank = torch.cumsum(new.to(torch.int64), 0) - 1
    codes = torch.empty_like(rank)
    codes[perm] = rank
    first = perm[new]
    packed = torch.stack([w[first] ^ _SIGN for w in words], 1).cpu().numpy()
    raw = packed.astype(">i8").view(np.uint8).reshape(len(first), -1)[:, :top]
    names = raw.astype(np.uint32).view(f"U{max(top, 1)}").ravel()
    out, lo = [], 0
    for c in cols:
        out.append(codes[lo:lo + len(c.values)])
        lo += len(c.values)
    return out, names


class Reference:
    def __init__(self, tables: Tables, device="cpu", control: bool = False):
        self.t = tables
        self.d = Data(tables, device)
        self.device = torch.device(device)
        self.fdt = torch.float32 if control else torch.float64
        self._id6: Optional[Dict[str, torch.Tensor]] = None
        self._id6_names: Optional[np.ndarray] = None

    def answer(self, qid: str) -> Answer:
        return getattr(self, qid)()

    def id6(self, table: str):
        """(codes of table's id6 rows, the sorted strings of x's and
        large's id6), made once."""
        if self._id6 is None:
            names = [t for t in ("x", "large") if "id6" in self.t[t]]
            codes, self._id6_names = text_codes(
                [self.t[t]["id6"] for t in names], self.device)
            self._id6 = dict(zip(names, codes))
        return self._id6[table], self._id6_names

    def string_key(self, left: str, right: str, name: str):
        """The string column `name` of both tables as codes into the sorted
        union of their dictionaries."""
        dl, dr = (self.d.dictionary(t, name) for t in (left, right))
        union = np.unique(np.concatenate([dl.astype(str), dr.astype(str)]))
        lut = [torch.as_tensor(np.searchsorted(union, d.astype(str)),
                               device=self.device) for d in (dl, dr)]
        return lut[0][self.d(left, name)], lut[1][self.d(right, name)]

    def column(self, table: str, name: str, rows: torch.Tensor,
               valid: Optional[torch.Tensor] = None) -> RCol:
        """Column `name` of `table` at `rows` (-1 where `valid` is false:
        a NULL cell, holding 0)."""
        kind = self.t[table][name].dtype
        at = rows if valid is None else rows.clamp(min=0)
        if kind == "text":
            codes, names = self.id6(table)
            v, dictionary = codes[at], names
        else:
            v, dictionary = self.d(table, name)[at], None
            if kind == "string":
                dictionary = self.d.dictionary(table, name)
        if kind == "float64":
            v = v.to(self.fdt).to(torch.float64)
        if valid is not None:
            v = torch.where(valid, v, torch.zeros_like(v))
        rkind = ("float" if kind == "float64" else
                 "string" if dictionary is not None else "int")
        return RCol(rkind, v, dictionary, valid=valid)

    def join(self, right: str, on: str, select, keep_left: bool = False,
             key=None) -> Answer:
        """x joined to `right` on `on` (or the codes `key` of both sides),
        with the columns `select`: (name, table, column)."""
        lk, rk = key if key is not None else (self.d("x", on),
                                              self.d(right, on))
        lrows, rrows = equi_join(rk, lk, keep_left)
        valid = (rrows >= 0) if keep_left else None
        cols = [self.column(t, c, lrows if t == "x" else rrows,
                            None if t == "x" else valid)
                for _, t, c in select]
        return Answer([n for n, _, _ in select], cols)

    def q1(self):
        return self.join("small", "id1", [
            ("id1", "x", "id1"), ("id2", "x", "id2"), ("id3", "x", "id3"),
            ("xid4", "x", "id4"), ("smallid4", "small", "id4"),
            ("id5", "x", "id5"), ("id6", "x", "id6"), ("v1", "x", "v1"),
            ("v2", "small", "v2")])

    MEDIUM = [("xid1", "x", "id1"), ("mediumid1", "medium", "id1"),
              ("id2", "x", "id2"), ("id3", "x", "id3"), ("xid4", "x", "id4"),
              ("mediumid4", "medium", "id4"), ("xid5", "x", "id5"),
              ("mediumid5", "medium", "id5"), ("id6", "x", "id6"),
              ("v1", "x", "v1"), ("v2", "medium", "v2")]

    def q2(self):
        return self.join("medium", "id2", self.MEDIUM)

    def q3(self):
        return self.join("medium", "id2", self.MEDIUM, keep_left=True)

    def q4(self):
        return self.join("medium", "id5", self.MEDIUM,
                         key=self.string_key("x", "medium", "id5"))

    def q5(self):
        return self.join("large", "id3", [
            ("xid1", "x", "id1"), ("largeid1", "large", "id1"),
            ("xid2", "x", "id2"), ("largeid2", "large", "id2"),
            ("id3", "x", "id3"), ("xid4", "x", "id4"),
            ("largeid4", "large", "id4"), ("xid5", "x", "id5"),
            ("largeid5", "large", "id5"), ("xid6", "x", "id6"),
            ("largeid6", "large", "id6"), ("v1", "x", "v1"),
            ("v2", "large", "v2")])
