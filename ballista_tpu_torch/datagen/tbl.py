"""dbgen-format interop: `.tbl` ingest and egress, and the exact diff
against answer files (port of ballista_tpu/datagen/tbl.py).

Reference parity: `tpch.rs convert-tpch` consumes dbgen's `.tbl`
('|'-delimited, a trailing '|', no header; benchmarks/src/bin/tpch.rs:731)
and `--expected-results` diffs query output against `answers/q{n}.out`
files, '|'-delimited with a header (tpch.rs:421-422,1027-1044).

No pyarrow and no pandas: `read_tbl` parses the file's bytes with numpy
(the separators are found once, then each column is parsed from its
fields' spans), `write_tbl` formats host columns the same way, and
`diff_expected` renders the engine's result cell by cell. The semantics
are the JAX package's pyarrow reader's: an empty numeric or date field is
NULL, an empty string field is "", the field after the trailing '|' is
dropped, and empty lines are skipped.
"""

from __future__ import annotations

import datetime
import decimal
import os
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import batch as B
from ..schema import Field, TypeKind
from .tpch import TPCH_TABLES

_PIPE, _NL, _DOT, _MINUS, _PLUS, _ZERO = (ord(c) for c in "|\n.-+0")
# days of each month (index 1-12) in a common year
_MONTH_DAYS = np.array([0, 31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31])
# rows formatted per block by write_tbl (bounds its temporaries)
_WRITE_ROWS = 1 << 20


def tpch_schema(name: str) -> Tuple[Field, ...]:
    """The fields of a TPC-H table, as the port's generator makes them."""
    return TPCH_TABLES[name][2]


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

def _field_spans(buf: np.ndarray, n_fields: int, path: str):
    """(buf, starts, ends), starts and ends int64 arrays of shape (rows,
    n_fields): the byte span of every field (`_separators`)."""
    buf, line_start, ends = _separators(buf, n_fields, path)
    starts = np.concatenate((line_start[:, None], ends[:, :-1] + 1), axis=1)
    return buf, starts, ends


def _separators(buf: np.ndarray, n_fields: int, path: str):
    """(buf, line starts (rows,), ends (rows, n_fields)) int64: field j of
    a row spans [ends[:, j - 1] + 1, ends[:, j]), field 0 starts at its
    line's start. Each non-empty line holds n_fields fields, each followed
    by '|'; what follows the last '|' is dropped."""
    if len(buf) and buf[-1] != _NL:
        buf = np.append(buf, np.uint8(_NL))
    t = torch.from_numpy(buf)     # torch's scan runs on every host core
    sep = torch.nonzero((t == _PIPE) | (t == _NL)).squeeze(1).numpy()
    is_nl = buf[sep] == _NL
    kept = None
    nl_at = sep[is_nl]
    if len(nl_at) and (nl_at[0] == 0 or (np.diff(nl_at) == 1).any()):
        # an empty line: a newline at the file's start or right after
        # another; its newline is dropped
        empty = is_nl & (sep == np.concatenate(([-1], sep[:-1])) + 1) \
            & np.concatenate(([True], is_nl[:-1]))
        kept = np.flatnonzero(~empty)
        every, sep, is_nl = sep, sep[kept], is_nl[kept]
    n_rows = int(is_nl.sum())
    per_row = np.diff(np.concatenate(([-1], np.flatnonzero(is_nl))))
    bad = np.flatnonzero(per_row != n_fields + 1)
    if len(bad):
        raise ValueError(f"{path}: row {int(bad[0]) + 1} has "
                         f"{int(per_row[bad[0]]) - 1} fields, expected "
                         f"{n_fields} each followed by '|'")
    sep = sep.reshape(n_rows, n_fields + 1)
    if kept is None:
        line_start = np.concatenate(([0], sep[:-1, n_fields] + 1))
    else:
        # a line starts after the newline before its first separator
        # (which may end an empty line)
        before = kept.reshape(n_rows, n_fields + 1)[:, 0] - 1
        line_start = np.where(before >= 0, every[np.maximum(before, 0)] + 1,
                              0)
    return buf, line_start, sep[:, :n_fields]


def _field_bytes(buf: np.ndarray, start: np.ndarray, end: np.ndarray):
    """(bytes (n, width) uint8, zero past each field's end; lengths;
    the mask of bytes inside the field). Rows are gathered as windows of
    the buffer, one index per row; `buf` ends in at least `width` bytes
    of padding."""
    lens = end - start
    width = max(int(lens.max(initial=0)), 1)
    mat = np.lib.stride_tricks.sliding_window_view(buf, width)[start]
    inside = np.arange(width)[None, :] < lens[:, None]
    np.multiply(mat, inside, out=mat)
    return mat, lens, inside


def _parse_fixed(mat, lens, inside, scale: int, what: str):
    """Signed decimal text (at most one '.') -> (int64 scaled by 10^scale,
    validity); an empty field is NULL. An integer column is scale 0 with
    no '.' allowed."""
    valid = lens > 0
    signed = (mat[:, 0] == _MINUS) | (mat[:, 0] == _PLUS)
    neg = mat[:, 0] == _MINUS
    body = inside.copy()
    body[:, 0] &= ~signed
    dots = body & (mat == _DOT)
    n_dots = dots.sum(axis=1)
    digits = mat - np.uint8(_ZERO)     # wraps: a non-digit is above 9
    is_digit = body & ~dots & (digits <= 9)
    odd = (body & ~dots & ~is_digit).any(axis=1) | (n_dots > 1) \
        | (valid & ~is_digit.any(axis=1))
    if scale == 0:
        odd |= n_dots > 0
    if odd.any():
        i = int(np.flatnonzero(odd)[0])
        raise ValueError(f"{what}: row {i + 1}: "
                         f"{bytes(mat[i, :lens[i]]).decode()!r} is not a "
                         f"number of scale {scale}")
    acc = np.zeros(len(lens), dtype=np.int64)
    frac = np.zeros(len(lens), dtype=np.int64)
    after = np.zeros(len(lens), dtype=bool)
    for k in range(mat.shape[1]):
        d = is_digit[:, k]
        acc = np.where(d, acc * 10 + digits[:, k].astype(np.int64), acc)
        frac += d & after
        after |= dots[:, k]
    if (frac > scale).any():
        # more places than the scale: exact only when the extra digits are 0
        cut = np.power(10, np.maximum(frac - scale, 0))
        lossy = acc % cut != 0
        if lossy.any():
            i = int(np.flatnonzero(lossy)[0])
            raise ValueError(f"{what}: row {i + 1}: "
                             f"{bytes(mat[i, :lens[i]]).decode()!r} has more "
                             f"than {scale} decimal places")
        acc //= cut
        frac = np.minimum(frac, scale)
    acc *= np.power(10, scale - frac)
    return np.where(neg, -acc, acc), valid


def _parse_dates(mat, lens, what: str):
    """'YYYY-MM-DD' -> (int32 days since the epoch, validity), by Howard
    Hinnant's days_from_civil."""
    valid = lens > 0
    ok = lens == 10
    y = m = d = np.ones(len(lens), dtype=np.int64)
    if mat.shape[1] >= 10:
        digits = mat[:, :10] - np.uint8(_ZERO)
        ok &= (mat[:, 4] == _MINUS) & (mat[:, 7] == _MINUS) \
            & (digits[:, [0, 1, 2, 3, 5, 6, 8, 9]] <= 9).all(axis=1)
        digits = digits.astype(np.int64)
        y = digits[:, 0] * 1000 + digits[:, 1] * 100 + digits[:, 2] * 10 \
            + digits[:, 3]
        m = digits[:, 5] * 10 + digits[:, 6]
        d = digits[:, 8] * 10 + digits[:, 9]
    leap = (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0))
    month_days = _MONTH_DAYS[np.clip(m, 1, 12)] + (leap & (m == 2))
    ok &= (m >= 1) & (m <= 12) & (d >= 1) & (d <= month_days)
    bad = valid & ~ok
    if bad.any():
        i = int(np.flatnonzero(bad)[0])
        raise ValueError(f"{what}: row {i + 1}: "
                         f"{bytes(mat[i, :lens[i]]).decode()!r} is not a "
                         "YYYY-MM-DD date")
    yy = y - (m <= 2)
    era = yy // 400
    yoe = yy - era * 400
    doy = (153 * ((m + 9) % 12) + 2) // 5 + d - 1
    days = era * 146097 + yoe * 365 + yoe // 4 - yoe // 100 + doy - 719468
    return np.where(valid, days, 0).astype(np.int32), valid


def _bounded(values: np.ndarray, valid: np.ndarray) -> B.HostColumn:
    vv = values[valid]
    bounds = (int(vv.min()), int(vv.max())) if len(vv) else None
    return B.HostColumn(np.ascontiguousarray(values), valid, None, bounds)


def _parse_column(buf, start, end, field: Field, what: str,
                  raw_max: Optional[int] = None) -> B.HostColumn:
    """One column from its fields' spans. A string column goes through
    the native encoder (`batch.ingest_string_buffers`): RAW where its
    estimated distinct count exceeds `raw_max`, else sorted (`raw_max`
    None: always sorted)."""
    kind = field.dtype.kind
    if kind is TypeKind.STRING:
        return B.ingest_string_buffers(
            buf, start, ends=end,
            raw_max=np.iinfo(np.int64).max if raw_max is None else raw_max)
    mat, lens, inside = _field_bytes(buf, start, end)
    if kind is TypeKind.DATE32:
        return _bounded(*_parse_dates(mat, lens, what))
    if kind in (TypeKind.INT32, TypeKind.INT64, TypeKind.DECIMAL):
        scale = field.dtype.scale if kind is TypeKind.DECIMAL else 0
        values, valid = _parse_fixed(mat, lens, inside, scale, what)
        # (an int64 column is not range-checked: no TPC-H key nears 2^63)
        top = {TypeKind.INT32: 2 ** 31 - 1,
               TypeKind.DECIMAL: 10 ** field.dtype.precision - 1}.get(kind)
        if top and ((values > top) | (values < -top - (
                kind is TypeKind.INT32))).any():
            raise ValueError(f"{what}: a value does not fit {field.dtype}")
        values = np.where(valid, values, 0).astype(field.dtype.np_dtype)
        return _bounded(values, valid)
    raise TypeError(f"{what}: no .tbl parse for {field.dtype}")


class TblFile:
    """A dbgen `.tbl` file of TPC-H table `name` whose separators were
    found once (`_separators`); a column is parsed from its fields' spans
    when asked for (`column`). `seconds` is the time spent finding the
    separators, `parse_seconds` each parsed column's."""

    def __init__(self, path: str, name: str):
        t0 = time.perf_counter()
        self.path = path
        self.fields = tpch_schema(name)
        buf, self.line_start, self.ends = _separators(
            np.fromfile(path, dtype=np.uint8), len(self.fields), path)
        self.num_rows = len(self.line_start)
        width = self.ends - np.concatenate(
            (self.line_start[:, None], self.ends[:, :-1] + 1), axis=1)
        pad = max(int(width.max(initial=0)), 1)
        # the windows of `_field_bytes` read up to `pad` bytes past a field
        self.buf = np.concatenate((buf, np.zeros(pad, dtype=np.uint8)))
        self.seconds = time.perf_counter() - t0
        self.parse_seconds: Dict[str, float] = {}

    def column(self, j: int, raw_max: Optional[int] = None) -> B.HostColumn:
        """Column j parsed (`_parse_column`; `raw_max` as there)."""
        t0 = time.perf_counter()
        start = (self.line_start if j == 0 else self.ends[:, j - 1] + 1)
        f = self.fields[j]
        col = _parse_column(self.buf, start, self.ends[:, j], f,
                            f"{self.path} column {f.name}", raw_max)
        self.parse_seconds[f.name] = time.perf_counter() - t0
        return col

    def lazy_columns(self, raw_max: int) -> dict:
        """{name: LazyColumn} parsing each column at first use, each
        string column RAW where ingest would make it so."""
        from ..client.context import LazyColumn
        return {f.name: LazyColumn(self.num_rows,
                                   partial(self.column, j, raw_max))
                for j, f in enumerate(self.fields)}


def read_tbl(path: str, name: str):
    """A dbgen `.tbl` file of TPC-H table `name` as (fields, {column:
    HostColumn}), the shape `generate_tpch` gives: decimals as int64
    scaled to the field's scale (parsed exactly, never through a float),
    dates as int32 days since the epoch, strings as int32 codes into the
    sorted dictionary of the values present."""
    tbl = TblFile(path, name)
    # numpy and the encoder let go of the GIL in the bulk of each parse
    with ThreadPoolExecutor(min(len(tbl.fields), os.cpu_count() or 1)) as pool:
        cols = list(pool.map(tbl.column, range(len(tbl.fields))))
    return tbl.fields, {f.name: c for f, c in zip(tbl.fields, cols)}


def register_tpch_tbl(ctx, directory: str) -> List[str]:
    """Register every `<table>.tbl` found in `directory` (a dbgen output
    directory) on the session, with the TPC-H fields and primary keys.
    The separators are found here; each column is parsed when a query
    first reads it, each string column RAW where ingest would make it so
    (the threshold in force now, as `register_tpch`). Returns the names
    registered; `ctx.tables[name].tbl` is the `TblFile`."""
    found = []
    raw_max = B.raw_dict_max()
    for name in TPCH_TABLES:
        path = os.path.join(directory, f"{name}.tbl")
        if os.path.exists(path):
            tbl = TblFile(path, name)
            ctx.register_host(name, tbl.fields, tbl.lazy_columns(raw_max),
                              primary_key=TPCH_TABLES[name][1])
            ctx.tables[name].tbl = tbl
            found.append(name)
    if not found:
        raise FileNotFoundError(f"no .tbl files in {directory}")
    return found


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _left_aligned(right: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Rows of right-aligned text, each moved to start at column 0: a
    window of the flat buffer per row (what follows a row's text is
    whatever the buffer holds there; the writer overwrites it)."""
    n, width = right.shape
    flat = np.concatenate((right.ravel(), np.zeros(width, dtype=np.uint8)))
    return np.lib.stride_tricks.sliding_window_view(flat, width)[
        np.arange(n) * width + width - lens]


def _number_text(values: np.ndarray, scale: int):
    """Decimal text of int64 values scaled by 10^scale ("-12.50"; scale 0
    prints an integer): (bytes (n, width) uint8, left-aligned; lengths)."""
    v = values.astype(np.int64)
    neg = v < 0
    rem = np.abs(v)
    digits, n_digits = [], np.ones(len(v), dtype=np.int64)
    while True:
        digits.append((rem % 10).astype(np.uint8) + np.uint8(_ZERO))
        rem //= 10
        if len(digits) > scale and not rem.any():
            break
        n_digits += rem > 0
    n_digits = np.maximum(n_digits, scale + 1)
    dot = int(scale > 0)
    lens = neg + n_digits + dot
    width = max(int(lens.max(initial=0)), 1)
    right = np.zeros((len(v), width), dtype=np.uint8)
    for k in range(width):          # k-th character from the right
        if k < scale:
            ch = digits[k]
        elif dot and k == scale:
            ch = np.uint8(_DOT)
        else:
            i = k - dot
            ch = np.where(i < n_digits, digits[min(i, len(digits) - 1)],
                          np.where(neg & (i == n_digits), np.uint8(_MINUS),
                                   np.uint8(0)))
        right[:, width - 1 - k] = ch
    return _left_aligned(right, lens), lens


def _date_text(days: np.ndarray):
    """'YYYY-MM-DD' of int32 days: the text of each day in the column's
    range, looked up."""
    if not len(days):
        return np.zeros((0, 10), dtype=np.uint8), np.zeros(0, dtype=np.int64)
    lo, hi = int(days.min()), int(days.max())
    span = np.arange(lo, hi + 1).astype("datetime64[D]")
    y = span.astype("datetime64[Y]").astype(np.int64) + 1970
    if y.min() < 0 or y.max() > 9999:
        raise ValueError("a date outside years 0..9999")
    month = span.astype("datetime64[M]")
    m = month.astype(np.int64) % 12 + 1
    day = (span - month.astype("datetime64[D]")).astype(np.int64) + 1
    lut = np.full((len(span), 10), _MINUS, dtype=np.uint8)
    for k, (num, p) in enumerate([(y, 1000), (y, 100), (y, 10), (y, 1),
                                  (None, 0), (m, 10), (m, 1), (None, 0),
                                  (day, 10), (day, 1)]):
        if num is not None:
            lut[:, k] = (num // p) % 10 + _ZERO
    return lut[days - lo], np.full(len(days), 10, dtype=np.int64)


def _string_text(col: B.HostColumn, rows: slice):
    d = [s.encode("utf-8") for s in col.dictionary.tolist()]
    width = max((len(s) for s in d), default=1) or 1
    table = np.array(d, dtype=f"S{width}").view(np.uint8).reshape(-1, width) \
        if d else np.zeros((1, width), dtype=np.uint8)
    lens = np.array([len(s) for s in d] or [0], dtype=np.int64)
    codes = col.values[rows]
    return table[codes], lens[codes]


def _column_text(field: Field, col: B.HostColumn, rows: slice):
    kind = field.dtype.kind
    if kind is TypeKind.STRING:
        mat, lens = _string_text(col, rows)
    elif kind is TypeKind.DATE32:
        mat, lens = _date_text(col.values[rows])
    elif kind in (TypeKind.INT32, TypeKind.INT64, TypeKind.DECIMAL):
        mat, lens = _number_text(col.values[rows], field.dtype.scale
                                 if kind is TypeKind.DECIMAL else 0)
    else:
        raise TypeError(f"column {field.name}: no .tbl text for "
                        f"{field.dtype}")
    return mat, np.where(col.validity[rows], lens, 0)


def tbl_bytes(fields, cols: Dict[str, B.HostColumn], lo: int,
              hi: int) -> bytes:
    """Rows [lo, hi) as dbgen `.tbl` text: each field followed by '|',
    one line per row, NULL as an empty field.

    The lines are laid out in an (n, width) matrix, each field written at
    its offset in its row as one window per row, left to right (the bytes
    a window carries past its field's end are overwritten by the fields
    and separators after it), then the rows are cut to their lengths."""
    n = hi - lo
    if not n:
        return b""
    texts = [_column_text(f, cols[f.name], slice(lo, hi)) for f in fields]
    width = sum(mat.shape[1] for mat, _ in texts) + len(fields) + 1
    lines = np.zeros(n * width + width, dtype=np.uint8)
    windows = {}
    pos = np.arange(n, dtype=np.int64) * width
    for mat, lens in texts:
        w = mat.shape[1]
        if w not in windows:
            windows[w] = np.lib.stride_tricks.sliding_window_view(
                lines, w, writeable=True)
        windows[w][pos] = mat
        pos = pos + lens
        lines[pos] = _PIPE
        pos = pos + 1
    lines[pos] = _NL
    row_len = pos + 1 - np.arange(n, dtype=np.int64) * width
    keep = np.arange(width)[None, :] < row_len[:, None]
    return lines[:n * width].reshape(n, width)[keep].tobytes()


def write_tbl(path: str, fields, cols: Dict[str, B.HostColumn]) -> int:
    """Write a table as a dbgen `.tbl` file; returns its bytes. Blocks of
    rows are formatted on a thread each (numpy lets go of the GIL)."""
    n = len(cols[fields[0].name].values) if fields else 0
    blocks = [(lo, min(n, lo + _WRITE_ROWS)) for lo in range(0, n,
                                                             _WRITE_ROWS)]
    workers = os.cpu_count() or 1
    size = 0
    with open(path, "wb") as fh, ThreadPoolExecutor(workers) as pool:
        for i in range(0, len(blocks), workers):
            for chunk in pool.map(lambda b: tbl_bytes(fields, cols, *b),
                                  blocks[i:i + workers]):
                fh.write(chunk)
                size += len(chunk)
    return size


# ---------------------------------------------------------------------------
# Answer files (tpch.rs --expected-results format)
# ---------------------------------------------------------------------------

def _fmt(v) -> str:
    if v is None:
        return ""
    if isinstance(v, decimal.Decimal):
        return str(v)
    if isinstance(v, float):
        return f"{v:.2f}"   # TPC-H answer convention: 2 fixed decimals
    return str(v)


def write_answers(pdt: dict, out_dir: str, queries=None) -> str:
    """Run the pandas oracle over `pdt` (`oracle.to_pd` frames) and write
    `answers/q{n}.out` files in the reference's format ('|'-delimited,
    with a header). Needs pandas."""
    from ..benchmarks.oracle import ORACLES

    ans = os.path.join(out_dir, "answers")
    os.makedirs(ans, exist_ok=True)
    for q in queries or range(1, 23):
        exp = ORACLES[q](pdt)
        path = os.path.join(ans, f"q{q}.out")
        with open(path, "w") as f:
            f.write("|".join(map(str, exp.columns)) + "\n")
            for row in exp.itertuples(index=False):
                f.write("|".join(_fmt(v) for v in row) + "\n")
    return ans


def _cell(value, valid: bool, dtype, places: int,
          rounding=decimal.ROUND_HALF_EVEN) -> str:
    """One result cell as the reference renders its pandas frame against
    an answer file: decimals quantized to the answer's places (exactly;
    the reference goes through float64), a float with those places, no
    negative zero; dates as timestamps; NULL numbers as "nan", NULL dates
    as "NaT", other NULLs empty."""
    kind = dtype.kind
    if kind in (TypeKind.DECIMAL, TypeKind.FLOAT32, TypeKind.FLOAT64):
        if not valid:
            return "nan"
        if kind is TypeKind.DECIMAL:
            s = str(decimal.Decimal(int(value)).scaleb(-dtype.scale)
                    .quantize(decimal.Decimal(1).scaleb(-places), rounding))
        else:
            s = f"{float(value):.{places}f}"
        return s[1:] if s == "-0." + "0" * places else s
    if not valid:
        return "NaT" if kind is TypeKind.DATE32 else ""
    if kind is TypeKind.DATE32:
        day = datetime.date(1970, 1, 1) + datetime.timedelta(days=int(value))
        return f"{day.isoformat()} 00:00:00"
    if kind is TypeKind.BOOL:
        return str(bool(value))
    return str(value)


def _midpoint(value, dtype, places: int, printed: str) -> bool:
    """Whether an exact decimal lies on the midpoint between two values
    printable at `places`, and the answer prints one of them."""
    down = _cell(value, True, dtype, places, decimal.ROUND_HALF_DOWN)
    up = _cell(value, True, dtype, places, decimal.ROUND_HALF_UP)
    return down != up and printed in (down, up)


def diff_expected(got, expected_dir: str, q: int,
                  notes: Optional[list] = None) -> Optional[str]:
    """Exact diff of an engine result against
    `expected_dir/answers/q{q}.out`. `got` is (Batch, Schema), or the
    `batch.to_numpy` dict of a result and its Schema. Returns None on a
    match, else the first difference in the reference's words.

    Cells compare as the strings `_cell` renders, each column at the
    places of its first non-empty answer cell. Position by position
    first; where that fails, both sides' rows are sorted and compared
    again (an ORDER BY that does not cover every output column leaves
    ties in an engine-defined order).

    Departure from the reference, kept on purpose: the answer files come
    from a float64 oracle, so an exact decimal on the midpoint between
    two printed values (Q9's JAPAN 1998 at SF1, 22091132.2950) may be
    printed rounded either way. Such a cell matches either neighbour, and
    a line saying so is appended to `notes`."""
    cols, schema = got
    if isinstance(cols, B.Batch):
        cols = B.to_numpy(cols, schema)
    path = os.path.join(expected_dir, "answers", f"q{q}.out")
    with open(path) as f:
        lines = [line.rstrip("\n") for line in f]
    header = lines[0].split("|")
    rows = [line.split("|") for line in lines[1:] if line]
    fields = schema.fields
    if len(fields) != len(header):
        return f"column count {len(fields)} vs {len(header)}"
    n = len(cols[fields[0].name][0]) if fields else 0
    if n != len(rows):
        return f"row count {n} vs {len(rows)}"
    places = []
    for ci in range(len(header)):
        cell = next((r[ci] for r in rows if r[ci]), "")
        places.append(len(cell.split(".")[1]) if "." in cell else 0)
    mine = [[_cell(cols[f.name][0][i], bool(cols[f.name][1][i]), f.dtype, p)
             for f, p in zip(fields, places)] for i in range(n)]
    for i in range(n):
        for j, (f, p) in enumerate(zip(fields, places)):
            if mine[i][j] == rows[i][j] or f.dtype.kind is not \
                    TypeKind.DECIMAL or not cols[f.name][1][i]:
                continue
            v = cols[f.name][0][i]
            if _midpoint(v, f.dtype, p, rows[i][j]):
                if notes is not None:
                    exact = decimal.Decimal(int(v)).scaleb(-f.dtype.scale)
                    notes.append(f"q{q}.out row {i} {header[j]}: the exact "
                                 f"value {exact} is a midpoint; the answer "
                                 f"prints {rows[i][j]}")
                mine[i][j] = rows[i][j]
    if mine == rows or sorted(mine) == sorted(rows):
        return None
    gs, es = sorted(mine), sorted(rows)
    for ri in range(len(es)):
        for ci in range(len(header)):
            if gs[ri][ci] != es[ri][ci]:
                return (f"q{q} col {header[ci]} row {ri} (canonical): "
                        f"got {gs[ri][ci]!r} expected {es[ri][ci]!r}")
    return None
