"""An answer as the plain reference states it (`Answer`), and the
comparison that decides whether an answer of the program is that answer
(`compare`). Plain numpy and torch; nothing of the program.

Each column of an `Answer` is one of:

- "int": int64 values (integers and dates);
- "string": int64 codes into a sorted, distinct dictionary of str, so
  that code order is string order;
- "decimal": int64 values at `scale`, exact (sums, products, keys);
- "ratio": the exact value of each row as a `fractions.Fraction`, to be
  given at `scale` places, rounded half away from zero (an average or a
  quotient of decimals); an exact midpoint matches either neighbour;
- "float": float64 values.

The comparison takes the program's columns as `port.answer_to_host` gives
them (a validity of None: every row valid). A string column is put in the
reference's codes through its dictionary: each entry's UTF-8 bytes packed
into big-endian 64-bit words, matched to the reference's entries by a sort
over those words on the comparison's device (`string_lut`); `DictMaps`
keeps the packed form of each program dictionary and the mapping of each
pair of dictionaries for the answers of one judging. It aligns the rows:
where the query has an ORDER BY, the program's rows must come in the
reference's order of the ordering keys, and rows tied on those keys are
matched as a multiset (a LIMIT that cuts a run of ties may keep any of
them); without one, both sides are sorted by every exact column. Then it
counts:

- `wrong_cells`: cells of exact columns (int, string, decimal, ratio at
  its scale) that differ, plus every cell of a column of the wrong type or
  scale, plus every cell of an answer of the wrong shape;
- `float_err`: the largest gap of a float cell, |program - reference|
  over the larger of |reference| and the median |reference| of its
  column (a sum of values near zero is judged against its column's
  size).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch


class RCol(NamedTuple):
    kind: str
    values: object                  # tensor, or a list of Fraction (ratio)
    dictionary: Optional[np.ndarray] = None
    scale: int = 0
    valid: Optional[torch.Tensor] = None   # None: every row valid


class Answer(NamedTuple):
    names: List[str]
    cols: List[RCol]
    order: List[Tuple[int, bool]] = []     # (column, descending)
    limit: Optional[int] = None

    @property
    def rows(self) -> int:
        c = self.cols[0].values
        return len(c)


class Verdict(NamedTuple):
    wrong_cells: int
    float_err: float
    note: str


EXACT = ("int", "string", "decimal")


def _lexsort(keys: Sequence[torch.Tensor], desc: Sequence[bool]) -> torch.Tensor:
    """Permutation sorting rows by keys[0], then keys[1], ... (stable)."""
    n = len(keys[0]) if keys else 0
    dev = keys[0].device if keys else "cpu"
    perm = torch.arange(n, device=dev)
    for k, d in reversed(list(zip(keys, desc))):
        v = k[perm]
        perm = perm[torch.sort(v, stable=True, descending=d).indices]
    return perm


# A dictionary entry is packed into at most MAX_WORDS 64-bit words of its
# UTF-8 bytes, first byte most significant, zero-padded, its byte length
# beside them: equal keys are equal strings. Entries that are longer or
# hold a NUL ("odd" ones) are matched by a Python dict instead; they are
# few in any answer here.
MAX_WORDS = 16
_SIGN = -(1 << 63)      # flipped in each word: signed order is byte order
# an answer that uses fewer than one in FEW of its dictionary's entries has
# those alone mapped (where no mapping of the whole is kept)
FEW = 8


class Packed(NamedTuple):
    words: List[torch.Tensor]   # word w of every entry (odd ones: zeros)
    lens: torch.Tensor          # byte length of every entry (odd ones: -1)
    odd: Dict[int, str]         # position -> entry


def _ends(entries: list, device):
    """The entries' UTF-8 bytes, each ended by a NUL, on `device`, and the
    places of the NULs."""
    buf = bytearray("\x00".join(entries) + "\x00", "utf-8")
    blob = torch.frombuffer(buf, dtype=torch.uint8).to(device)
    return blob, torch.nonzero(blob == 0).flatten()


def _pack(d: np.ndarray, device) -> Packed:
    """The packed keys of a dictionary's entries (see MAX_WORDS); an entry
    that is no str is taken as numpy makes it one."""
    entries, odd = d.tolist(), {}
    n = len(entries)
    if n == 0:
        none = torch.zeros(0, dtype=torch.int64, device=device)
        return Packed([none], none, odd)
    try:
        blob, ends = _ends(entries, device)
    except TypeError:
        bad = [i for i, s in enumerate(entries) if not isinstance(s, str)]
        for i, s in zip(bad, d[bad].astype(str).tolist()):
            entries[i] = s
        blob, ends = _ends(entries, device)
    if len(ends) != n:
        # entries that hold a NUL
        for i, s in enumerate(entries):
            if "\x00" in s:
                odd[i], entries[i] = s, ""
        blob, ends = _ends(entries, device)
    starts = torch.zeros_like(ends)
    starts[1:] = ends[:-1] + 1
    lens = ends - starts
    for i in torch.nonzero(lens > 8 * MAX_WORDS).flatten().tolist():
        odd[i] = entries[i]
    if odd:
        lens[torch.as_tensor(sorted(odd), device=lens.device)] = -1
    top = int(lens.max())
    words = []
    for w in range(max(1, -(-top // 8))):
        word = torch.zeros(n, dtype=torch.int64, device=lens.device)
        for k in range(8):
            j = 8 * w + k
            byte = blob[(starts + j).clamp_(max=len(blob) - 1)]
            word |= torch.where(lens > j, byte.to(torch.int64), 0) \
                << (56 - 8 * k)
        words.append(word ^ _SIGN)
    return Packed(words, lens, odd)


def _match(port: Packed, ref: Packed) -> torch.Tensor:
    """The reference position of each program entry (the last, where the
    reference repeats it), or -2 - its own position where the reference
    lacks it: both sets sorted together by their keys, each program entry
    matched to the nearest reference entry before it."""
    n_port, n_ref = len(port.lens), len(ref.lens)
    dev = port.lens.device
    lut = torch.empty(n_port, dtype=torch.int64, device=dev)
    if n_port == 0:
        return lut

    def word(p: Packed, w: int) -> torch.Tensor:
        return p.words[w] if w < len(p.words) else torch.full_like(
            p.lens, _SIGN)
    width = max(len(port.words), len(ref.words))
    keys = [torch.cat([word(ref, w), word(port, w)]) for w in range(width)]
    # an odd reference entry matches nothing here: -2 is no length
    keys.append(torch.cat([torch.where(ref.lens < 0, -2, ref.lens),
                           port.lens]))
    perm = _lexsort(keys, [False] * len(keys))
    pos = torch.arange(len(perm), device=dev)
    last = torch.where(perm < n_ref, pos, -1).cummax(0).values
    cand = perm[last.clamp(min=0)]
    same = last >= 0
    for k in keys:
        same &= k[perm] == k[cand]
    mine = perm >= n_ref
    at = perm[mine] - n_ref
    lut[at] = torch.where(same[mine], cand[mine], -2 - at)
    if port.odd:
        index = {s: i for i, s in ref.odd.items()}
        for i, s in port.odd.items():
            lut[i] = index.get(s, -2 - i)
    return lut


def string_lut(port_dict: np.ndarray, ref_dict: np.ndarray,
               device="cpu") -> torch.Tensor:
    """The reference code of each program dictionary entry (a string the
    reference does not know gets a code below -1, unique to it)."""
    return _match(_pack(np.asarray(port_dict), device),
                  _pack(np.asarray(ref_dict), device))


class DictMaps:
    """The mappings of one judging: each program dictionary packed once,
    each pair of a program and a reference dictionary mapped once (by
    object identity; the objects are held, so no id is reused)."""

    def __init__(self):
        self._packed, self._luts = {}, {}

    def has(self, port_dict, ref_dict) -> bool:
        return (id(port_dict), id(ref_dict)) in self._luts

    def lut(self, port_dict: np.ndarray, ref_dict: np.ndarray,
            device) -> torch.Tensor:
        key = (id(port_dict), id(ref_dict))
        if key not in self._luts:
            if id(port_dict) not in self._packed:
                self._packed[id(port_dict)] = (port_dict,
                                               _pack(port_dict, device))
            port = self._packed[id(port_dict)][1]
            ref = _pack(np.asarray(ref_dict), port.lens.device)
            self._luts[key] = (port_dict, ref_dict, _match(port, ref))
        return self._luts[key][2].to(device)


def _port_col(entry: dict, ref: RCol, device,
              maps: DictMaps) -> Tuple[object, Optional[str]]:
    """The program's column in the reference's terms, or (None, why)."""
    kind = entry["kind"]
    values = entry["values"]
    if ref.kind == "string":
        if kind != "string":
            return None, f"type {kind}, want string"
        port_dict = np.asarray(entry["dictionary"])
        codes = torch.as_tensor(np.asarray(values)).to(device, torch.int64)
        if len(port_dict) == 0:
            return torch.full((len(codes),), -1, dtype=torch.int64,
                              device=device), None
        codes = codes.clamp(0, len(port_dict) - 1)
        if FEW * len(codes) < len(port_dict) and \
                not maps.has(port_dict, ref.dictionary):
            # the entries the answer uses, not the whole dictionary
            used, codes = torch.unique(codes, return_inverse=True)
            lut = string_lut(port_dict[used.cpu().numpy()], ref.dictionary,
                             device)
        else:
            lut = maps.lut(port_dict, ref.dictionary, device)
        return lut[codes], None
    if ref.kind in ("decimal", "ratio"):
        if kind == "wide":
            values = np.array([int(v) for v in values], dtype=object)
        elif kind != "decimal":
            return None, f"type {kind}, want decimal"
        if entry["scale"] != ref.scale:
            return None, f"scale {entry['scale']}, want {ref.scale}"
        if ref.kind == "ratio":
            return [int(v) for v in values], None
        return torch.as_tensor(np.asarray(values, dtype=np.int64),
                               device=device), None
    if ref.kind == "int":
        if kind != "int":
            return None, f"type {kind}, want int"
        return torch.as_tensor(values, dtype=torch.int64, device=device), None
    if kind != "float":
        return None, f"type {kind}, want float"
    return torch.as_tensor(values, dtype=torch.float64, device=device), None


def _ratio_wrong(got: List[int], want: List[Fraction], scale: int) -> int:
    wrong = 0
    for v, r in zip(got, want):
        gap = abs(Fraction(v) - r * 10**scale)
        if gap > Fraction(1, 2):
            wrong += 1
    return wrong


def compare(port_cols: List[dict], ref: Answer, device=None,
            maps: Optional[DictMaps] = None) -> Verdict:
    """How far the program's answer is from the reference's (see the
    module's docstring). `maps` keeps the dictionaries' mappings for the
    next answer of the same judging."""
    maps = DictMaps() if maps is None else maps
    device = device or (ref.cols[0].values.device
                        if isinstance(ref.cols[0].values, torch.Tensor)
                        else "cpu")
    n_ref = ref.rows
    want_rows = n_ref if ref.limit is None else min(ref.limit, n_ref)
    n_cols = len(ref.cols)
    if len(port_cols) != n_cols:
        return Verdict(max(want_rows, 1) * n_cols, 0.0,
                       f"{len(port_cols)} columns, want {n_cols}")
    n_port = len(port_cols[0]["values"]) if port_cols else 0
    if n_port != want_rows:
        return Verdict(max(n_port, want_rows, 1) * n_cols, 0.0,
                       f"{n_port} rows, want {want_rows}")
    got, notes, wrong = [], [], 0
    for i, (entry, rc) in enumerate(zip(port_cols, ref.cols)):
        col, why = _port_col(entry, rc, device, maps)
        if why:
            notes.append(f"{ref.names[i]}: {why}")
            wrong += n_port
        got.append(col)
        valid = (torch.ones(n_port, dtype=torch.bool, device=device)
                 if entry["valid"] is None
                 else torch.as_tensor(entry["valid"], device=device))
        want_valid = (torch.ones(n_ref, dtype=torch.bool, device=device)
                      if rc.valid is None else rc.valid.to(device))
        got[-1] = (col, valid, want_valid)
    if n_port == 0:
        return Verdict(wrong, 0.0, "; ".join(notes))

    exact = [i for i, rc in enumerate(ref.cols)
             if rc.kind in EXACT and got[i][0] is not None]
    # rows are put in order by the exact columns, then the float ones (two
    # rows of h2o's q8 differ only in v3, which it selects, not computes)
    by = exact + [i for i, rc in enumerate(ref.cols)
                  if rc.kind == "float" and got[i][0] is not None]
    ref_exact = [ref.cols[i].values.to(device) for i in by]
    port_exact = [got[i][0] for i in by]
    # ordering keys are exact columns in every query here
    okeys = [c for c, _ in ref.order if ref.cols[c].kind in EXACT]
    odesc = [d for c, d in ref.order if ref.cols[c].kind in EXACT]

    # the reference's rows in its canonical order: ORDER BY keys, then the
    # exact columns; the program's rows in their own order, ties sorted
    # the same way
    ref_keys = [ref.cols[c].values.to(device) for c in okeys]
    rperm = _lexsort(ref_keys + ref_exact, odesc + [False] * len(ref_exact))
    if okeys:
        # the program's ordering keys must equal the reference's, row by row
        key_wrong = 0
        for c, rk in zip(okeys, ref_keys):
            pk = got[c][0]
            if pk is None:
                continue
            key_wrong += int((pk != rk[rperm][:n_port]).sum())
        if key_wrong:
            return Verdict(wrong + key_wrong * n_cols, 0.0,
                           "; ".join(notes + [f"{key_wrong} rows out of "
                                              "order or with other keys"]))
        # runs of tied keys: sort the program's rows inside each run
        run = torch.zeros(n_port, dtype=torch.int64, device=device)
        if ref_keys and n_port > 1:
            same = torch.ones(n_port - 1, dtype=torch.bool, device=device)
            for rk in ref_keys:
                k = rk[rperm][:n_port]
                same &= k[1:] == k[:-1]
            run[1:] = torch.cumsum((~same).to(torch.int64), 0)
        pperm = _lexsort([run] + port_exact, [False] * (1 + len(port_exact)))
    else:
        pperm = _lexsort(port_exact, [False] * len(port_exact))
    rsel = rperm[:n_port]

    # a LIMIT that cuts a run of ties: the program may keep any rows of it
    cut = None
    if okeys and ref_keys and n_port < n_ref:
        last = [rk[rperm] for rk in ref_keys]
        tied = torch.ones(n_ref, dtype=torch.bool, device=device)
        for k in last:
            tied &= k == k[n_port - 1]
        if bool(tied[n_port:].any()):
            cut = torch.nonzero(tied).flatten()

    float_err = 0.0
    if cut is not None:
        lo = int(cut[0])
        head = _count_wrong(got, ref, exact, pperm[:lo], rsel[:lo], device)
        wrong += head[0]
        float_err = max(float_err, head[1])
        # each kept tied row must be one of the reference's tied rows
        pool = {tuple(int(ref.cols[i].values[j]) for i in exact): int(j)
                for j in rperm[cut].tolist()}
        for p in pperm[lo:].tolist():
            key = tuple(int(got[i][0][p]) for i in exact)
            j = pool.pop(key, None)
            if j is None:
                wrong += n_cols
                continue
            w, e = _count_wrong(got, ref, exact,
                                torch.tensor([p], device=device),
                                torch.tensor([j], device=device), device)
            wrong += w
            float_err = max(float_err, e)
    else:
        w, e = _count_wrong(got, ref, exact, pperm, rsel, device)
        wrong += w
        float_err = max(float_err, e)
    return Verdict(wrong, float_err, "; ".join(notes))


def _count_wrong(got, ref: Answer, exact, pidx, ridx, device):
    """(wrong cells, float gap) of the program's rows pidx against the
    reference's rows ridx, position by position."""
    wrong, err = 0, 0.0
    for i, rc in enumerate(ref.cols):
        col, valid, want_valid = got[i]
        if col is None:
            continue
        pv, rv = valid[pidx], want_valid[ridx]
        wrong += int((pv != rv).sum())
        both = pv & rv
        if rc.kind == "ratio":
            p = [col[j] for j in pidx.tolist()]
            r = [rc.values[j] for j in ridx.tolist()]
            keep = both.tolist()
            wrong += _ratio_wrong([a for a, k in zip(p, keep) if k],
                                  [b for b, k in zip(r, keep) if k], rc.scale)
            continue
        rvals = rc.values.to(device)[ridx]
        if rc.kind in EXACT:
            wrong += int(((col[pidx] != rvals) & both).sum())
            continue
        a, b = col[pidx][both], rvals[both]
        if len(b) == 0:
            continue
        scale = torch.maximum(b.abs(), b.abs().median())
        gap = (a - b).abs() / scale.clamp(min=torch.finfo(torch.float64).tiny)
        nan = torch.isnan(a) != torch.isnan(b)
        wrong += int(nan.sum())
        gap = torch.where(torch.isnan(gap), torch.zeros_like(gap), gap)
        err = max(err, float(gap.max()))
    return wrong, err


def _round_half_away(x: Fraction) -> int:
    q, r = divmod(abs(x.numerator), x.denominator)
    q += 2 * r >= x.denominator
    return q if x >= 0 else -q


def as_program_cols(ans: Answer) -> List[dict]:
    """An answer in the form `port.answer_to_host` gives the program's, in
    its ORDER BY and cut at its LIMIT: what stands in the program's place
    when the control is judged."""
    keys = [(ans.cols[c].values, d) for c, d in ans.order
            if ans.cols[c].kind in EXACT]
    perm = (_lexsort([k for k, _ in keys], [d for _, d in keys]) if keys
            else torch.arange(ans.rows))
    if ans.limit is not None:
        perm = perm[:ans.limit]
    out = []
    for name, c in zip(ans.names, ans.cols):
        if c.kind == "ratio":
            c = c._replace(values=[c.values[i] for i in perm.tolist()])
        else:
            c = c._replace(values=c.values[perm.to(c.values.device)])
        if c.valid is not None:
            c = c._replace(valid=c.valid[perm.to(c.valid.device)])
        n = len(c.values)
        valid = (np.ones(n, dtype=bool) if c.valid is None
                 else c.valid.cpu().numpy())
        entry = {"name": name, "valid": valid}
        if c.kind == "ratio":
            entry.update(kind="decimal", scale=c.scale, values=np.array(
                [_round_half_away(v * 10**c.scale) for v in c.values],
                dtype=np.int64))
        elif c.kind == "string":
            entry.update(kind="string", values=c.values.cpu().numpy(),
                         dictionary=c.dictionary)
        elif c.kind == "decimal":
            entry.update(kind="decimal", scale=c.scale,
                         values=c.values.cpu().numpy())
        else:
            entry.update(kind=c.kind, values=c.values.cpu().numpy())
        out.append(entry)
    return out
