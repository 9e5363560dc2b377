"""Helpers of the tests: the program's generated SF1 tables in the
reference's terms, and the rendering of an `Answer` as the rows of
`answers/sf1/answers/q<N>.out`."""

from __future__ import annotations

import datetime
from fractions import Fraction

import numpy as np

from gpubench.tables import Col


def from_program(generated) -> dict:
    """`ballista_tpu_torch.datagen.tpch.generate_tpch` output as Tables."""
    out = {}
    for name, (fields, cols) in generated.items():
        t = {}
        for f in fields:
            h = cols[f.name]
            dtype = str(f.dtype)
            t[f.name] = Col(h.values, dtype.replace(" ", ""),
                            None if h.dictionary is None
                            else np.asarray(h.dictionary, dtype=object))
        out[name] = t
    return out


def _round(x: Fraction, places: int):
    """Both neighbours where x is a midpoint at `places`, else the one
    nearest."""
    y = x * 10**places
    lo = y.numerator // y.denominator
    if y - lo == Fraction(1, 2):
        return {lo, lo + 1}
    return {lo + 1 if y - lo > Fraction(1, 2) else lo}


def _fmt(units: int, places: int) -> str:
    sign = "-" if units < 0 else ""
    units = abs(units)
    if places == 0:
        return f"{sign}{units}"
    return f"{sign}{units // 10**places}.{units % 10**places:0{places}d}"


def rows_match(answer, lines) -> str:
    """'' where the answer's rows, limited, equal the file's (ties in any
    order), else the first difference."""
    header = lines[0].split("|")
    want = [line.split("|") for line in lines[1:] if line]
    n = answer.rows if answer.limit is None else min(answer.limit, answer.rows)
    if len(header) != len(answer.cols):
        return f"{len(answer.cols)} columns, file {len(header)}"
    if n != len(want):
        return f"{n} rows, file {len(want)}"
    places = []
    for ci in range(len(header)):
        cell = next((r[ci] for r in want if r[ci]), "")
        places.append(len(cell.split(".")[1]) if "." in cell else 0)
    from gpubench.answer import EXACT, _lexsort
    keys = [(answer.cols[c].values, d) for c, d in answer.order
            if answer.cols[c].kind in EXACT]
    perm = (_lexsort([k for k, _ in keys], [d for _, d in keys]).tolist()
            if keys else list(range(answer.rows)))
    got = []
    for i in perm[:n]:
        row = []
        for name, c, p in zip(answer.names, answer.cols, places):
            if c.kind == "string":
                row.append({str(c.dictionary[int(c.values[i])])})
            elif c.kind == "int" and name.endswith("date"):
                day = datetime.date(1970, 1, 1) + datetime.timedelta(
                    days=int(c.values[i]))
                row.append({f"{day.isoformat()} 00:00:00"})
            elif c.kind == "int":
                row.append({str(int(c.values[i]))})
            else:
                x = (c.values[i] if c.kind == "ratio"
                     else Fraction(int(c.values[i]), 10**c.scale))
                row.append({_fmt(u, p) for u in _round(x, p)})
        got.append(row)
    # the first n rows in the answer's ORDER BY, matched to the file's as
    # a multiset (ties may come in any order)
    pool = [tuple(r) for r in want]
    for row in got:
        hit = next((w for w in pool if all(w[j] in row[j]
                                           for j in range(len(row)))), None)
        if hit is not None:
            pool.remove(hit)
    if pool:
        return f"file rows unmatched: {pool[:2]}"
    return ""
