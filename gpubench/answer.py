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
them. It aligns the rows: where the query has an ORDER BY, the program's
rows must come in the reference's order of the ordering keys, and rows
tied on those keys are matched as a multiset (a LIMIT that cuts a run of
ties may keep any of them); without one, both sides are sorted by every
exact column. Then it counts:

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
from typing import List, NamedTuple, Optional, Sequence, Tuple

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


def _string_lut(port_dict: np.ndarray, ref_dict: np.ndarray) -> np.ndarray:
    """The reference code of each program dictionary entry (a string the
    reference does not know gets a code below -1, unique to it)."""
    index = {s: i for i, s in enumerate(ref_dict.tolist())}
    return np.array([index.get(s, -2 - i) for i, s in
                     enumerate(np.asarray(port_dict).astype(str).tolist())],
                    dtype=np.int64)


def _port_col(entry: dict, ref: RCol, device) -> Tuple[object, Optional[str]]:
    """The program's column in the reference's terms, or (None, why)."""
    kind = entry["kind"]
    values = entry["values"]
    if ref.kind == "string":
        if kind != "string":
            return None, f"type {kind}, want string"
        port_dict = np.asarray(entry["dictionary"])
        codes = np.asarray(values, dtype=np.int64)
        if len(port_dict) == 0:
            return torch.full((len(codes),), -1, dtype=torch.int64,
                              device=device), None
        codes = np.clip(codes, 0, len(port_dict) - 1)
        if len(codes) < len(port_dict):
            # the entries the answer uses, not the whole dictionary
            used, codes = np.unique(codes, return_inverse=True)
            port_dict = port_dict[used]
        lut = _string_lut(port_dict, ref.dictionary)
        return torch.as_tensor(lut[codes.reshape(-1)], device=device), None
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


def compare(port_cols: List[dict], ref: Answer, device=None) -> Verdict:
    """How far the program's answer is from the reference's (see the
    module's docstring)."""
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
        col, why = _port_col(entry, rc, device)
        if why:
            notes.append(f"{ref.names[i]}: {why}")
            wrong += n_port
        got.append(col)
        valid = torch.as_tensor(entry["valid"], device=device)
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
