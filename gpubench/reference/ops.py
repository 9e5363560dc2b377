"""Plain torch building blocks of the references: lookups by key, groups,
sums, and predicates over string dictionaries. Device-agnostic, and
nothing of the program.

`Kernel` holds the precision of the sums: the reference proper keeps
decimals in exact int64 and floats in float64. Its control
(`control=True`) is the reference computed one step lower, the step a
later change could be tempted to take: decimal sums accumulated in
float64 and rounded at the end, float aggregates in float32.
"""

from __future__ import annotations

import datetime
import re
from typing import Callable, Sequence, Tuple

import numpy as np
import torch

from ..tables import Col, Tables, text_bytes

EPOCH = datetime.date(1970, 1, 1)


def days(y: int, m: int, d: int) -> int:
    return (datetime.date(y, m, d) - EPOCH).days


def like(pattern: str) -> Callable[[str], bool]:
    """SQL LIKE as a predicate on one string (% and _; no escapes)."""
    rx = re.compile("".join(".*" if ch == "%" else "." if ch == "_"
                            else re.escape(ch) for ch in pattern), re.S)
    pred = lambda s: rx.fullmatch(s) is not None  # noqa: E731
    pred.pattern = pattern
    return pred


class Data:
    """The tables as device tensors, made on first use."""

    def __init__(self, tables: Tables, device):
        self.tables, self.device = tables, torch.device(device)
        self._cache = {}

    def __call__(self, table: str, name: str) -> torch.Tensor:
        key = (table, name)
        if key not in self._cache:
            c: Col = self.tables[table][name]
            if c.dtype == "text":
                raise TypeError(f"{name} is text: read it through `where` "
                                "or `strings`")
            t = torch.from_numpy(np.ascontiguousarray(c.values))
            if t.dtype in (torch.int32, torch.int16, torch.int8):
                t = t.to(torch.int64)
            self._cache[key] = t.to(self.device)
        return self._cache[key]

    def dictionary(self, table: str, name: str) -> np.ndarray:
        return self.tables[table][name].dictionary

    def code(self, table: str, name: str, value: str) -> int:
        d = self.dictionary(table, name)
        i = int(np.searchsorted(d, value))
        return i if i < len(d) and d[i] == value else -1

    def strings(self, table: str, name: str, rows: torch.Tensor):
        """(codes, sorted distinct dictionary) of a string or text column
        at `rows`: a text column's strings are gathered and sorted here."""
        c: Col = self.tables[table][name]
        if c.dtype != "text":
            uniq, inv = torch.unique(self(table, name)[rows],
                                     return_inverse=True)
            return inv, c.dictionary[uniq.cpu().numpy()]
        uniq, inv = np.unique(text_bytes(c, rows.cpu().numpy()),
                              return_inverse=True)
        return (torch.as_tensor(inv.reshape(-1), device=self.device),
                np.char.decode(uniq, "ascii").astype(object))

    def where(self, table: str, name: str, pred) -> torch.Tensor:
        """Rows whose string satisfies pred (a `like`): over the spans of a
        text column (`spans_match`, for a pattern `%a%b...%`), else
        through a table over the dictionary."""
        c: Col = self.tables[table][name]
        if c.dtype == "text":
            pieces = pred.pattern.split("%")
            if len(pieces) < 3 or pieces[0] or pieces[-1] \
                    or "_" in pred.pattern:
                raise NotImplementedError(
                    f"LIKE {pred.pattern!r} over text: only %a%b...% is read")
            return spans_match(c, [p.encode() for p in pieces[1:-1] if p],
                               self.device)
        d = self.dictionary(table, name)
        lut = torch.tensor([bool(pred(s)) for s in d.tolist()],
                           dtype=torch.bool, device=self.device)
        return lut[self(table, name)]

    def rows(self, table: str) -> int:
        return len(next(iter(self.tables[table].values())).values)


def spans_match(c: Col, pieces, device) -> torch.Tensor:
    """Rows of text column `c` that hold `pieces` in order, apart (LIKE
    '%a%b%'), found in its byte buffer: every place of each piece in the
    buffer, then per row the first place of the first piece at or after
    the row's start, the first place of the next piece after that one,
    and so on; the row matches where the last ends by the row's end (the
    first place is never worse than a later one)."""
    data = torch.as_tensor(c.dictionary, device=device)
    pos = torch.as_tensor(c.values, device=device)
    ends = torch.as_tensor(c.ends, device=device)
    ok = torch.ones(len(pos), dtype=torch.bool, device=device)
    for piece in pieces:
        k = len(piece)
        at = torch.nonzero(data[:len(data) - k + 1] == piece[0]).flatten()
        for j in range(1, k):
            at = at[data[at + j] == piece[j]]
        if not len(at):
            return torch.zeros(len(pos), dtype=torch.bool, device=device)
        i = torch.searchsorted(at, pos).clamp(max=len(at) - 1)
        first = at[i]
        ok &= first >= pos
        pos = first + k
        ok &= pos <= ends
    return ok


def lookup(build: torch.Tensor, probe: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(row of build holding each probe key, whether it is there); the
    build keys are unique."""
    order = torch.argsort(build)
    sk = build[order]
    pos = torch.searchsorted(sk, probe).clamp(max=max(len(sk) - 1, 0))
    found = sk[pos] == probe if len(sk) else torch.zeros_like(probe,
                                                              dtype=torch.bool)
    return order[pos], found


def pack(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """One int64 per row that orders as the tuple of keys does."""
    out = None
    for k in keys:
        lo = int(k.min()) if len(k) else 0
        span = (int(k.max()) - lo + 1) if len(k) else 1
        v = k - lo
        if out is None:
            out, total = v, span
        else:
            total *= span
            if total >= 1 << 62:
                raise OverflowError("group key too wide to pack")
            out = out * span + v
    return out


def group(keys: Sequence[torch.Tensor]):
    """(group of each row, number of groups, one row of each group), the
    groups in the order of the packed keys."""
    packed = pack(keys)
    uniq, inv = torch.unique(packed, return_inverse=True)
    G = len(uniq)
    n = len(packed)
    first = torch.full((G,), n, dtype=torch.int64, device=packed.device)
    first.scatter_reduce_(0, inv, torch.arange(n, device=packed.device),
                          "amin")
    return inv, G, first


def count(inv: torch.Tensor, G: int) -> torch.Tensor:
    return torch.bincount(inv, minlength=G)


class Kernel:
    """Sums and float aggregates at the reference's precision, or at the
    control's one step below."""

    def __init__(self, control: bool = False):
        self.control = control
        self.fdt = torch.float32 if control else torch.float64

    def dsum(self, v: torch.Tensor, inv: torch.Tensor, G: int) -> torch.Tensor:
        """Exact int64 sums of decimal (or integer) values by group; in the
        control, accumulated in float64 and rounded."""
        if self.control:
            acc = torch.zeros(G, dtype=torch.float64, device=v.device)
            return acc.index_add_(0, inv, v.to(torch.float64)).round().to(
                torch.int64)
        acc = torch.zeros(G, dtype=torch.int64, device=v.device)
        return acc.index_add_(0, inv, v.to(torch.int64))

    def total(self, v: torch.Tensor) -> int:
        return int(self.dsum(v, torch.zeros(len(v), dtype=torch.int64,
                                            device=v.device), 1)[0])

    def isum(self, v: torch.Tensor, inv: torch.Tensor, G: int) -> torch.Tensor:
        """Integer sums of h2o's values: exact; in the control, float32."""
        if self.control:
            acc = torch.zeros(G, dtype=torch.float32, device=v.device)
            return acc.index_add_(0, inv, v.to(torch.float32)).round().to(
                torch.int64)
        acc = torch.zeros(G, dtype=torch.int64, device=v.device)
        return acc.index_add_(0, inv, v.to(torch.int64))

    def fsum(self, v: torch.Tensor, inv: torch.Tensor, G: int) -> torch.Tensor:
        acc = torch.zeros(G, dtype=self.fdt, device=v.device)
        return acc.index_add_(0, inv, v.to(self.fdt)).to(torch.float64)
