"""Columnar device batches over torch tensors (port of ballista_tpu/batch.py).

The JAX package's contract is kept, so the exec nodes map one to one:

- Every column is a 1-D tensor of a fixed *capacity* plus a bool validity
  tensor of the same capacity.
- `num_rows` is a 0-d int32 tensor on the batch's device; rows
  [num_rows, capacity) are padding and always invalid. Keeping the count on
  the device lets a whole plan run without a host synchronisation.
- Live rows are densely packed at the front, unless the batch is sparse
  (`Batch.live`, see there).

The host half is `HostColumn`: the numpy (values, validity, dictionary,
bounds, raw) tuple that ingest produces (`ballista_tpu/batch.py
ingest_column_host`). Strings are int32 codes into a sorted dictionary, so
code order is lexicographic order, unless the column is RAW (a distinct
count estimated above BALLISTA_RAW_DICT_MAX): then its dictionary is the
column's values in row order and a row's code is its row index. Decimals
are scaled int64; dates are int32 days since the epoch. `ingest_column`
makes one from a numpy array or a Python list and needs no pyarrow; the
arrow and pandas converters import their library inside the function
that uses it.
"""

from __future__ import annotations

import datetime
import decimal as pydecimal
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .schema import (BOOL, DATE32, FLOAT32, FLOAT64, INT32, INT64, STRING,
                     DataType, Field, Schema, TypeKind, wide_to_decimal128,
                     wide_to_ints)

LANE = 128

# Most distinct strings a column may have, by a sampled estimate, and
# still get a sorted dictionary; above it the column is RAW (unsorted,
# code == row index). BALLISTA_RAW_DICT_MAX overrides it, read at each
# ingest as the reference reads it (`_estimate_high_cardinality`), or when
# a lazily ingested table is registered (`raw_dict_max`).
RAW_DICT_MAX = 1 << 21
# rows sampled to guess a string column's distinct values (the RAW
# estimate and `_sorted_distinct`)
_SAMPLE_ROWS = 1 << 16


# most rows a batch may hold: row indices and counts are int32
MAX_CAPACITY = (1 << 31) - LANE


def round_capacity(n: int) -> int:
    """n rounded up to whole lanes; past int32 row indices it raises
    (a capacity grown that far must not wrap)."""
    cap = max(LANE, -(-int(n) // LANE) * LANE)
    if cap > MAX_CAPACITY:
        raise ValueError(f"capacity {cap} rows exceeds {MAX_CAPACITY}: row "
                         "indices and counts are int32")
    return cap


class HostColumn(NamedTuple):
    values: np.ndarray                   # (n,) per DataType.np_dtype
    validity: np.ndarray                 # (n,) bool
    dictionary: Optional[np.ndarray]     # sorted str objects (STRING only;
                                         # RAW: the values in row order)
    bounds: Optional[Tuple[int, int]]    # (min, max) of the valid values
    # RAW string column: `dictionary` holds every row's value in row order
    # ("" for NULL), duplicates and all, and `values` is arange(n)
    raw: bool = False


class Column(NamedTuple):
    data: torch.Tensor      # (capacity,) per DataType.torch_dtype
    validity: torch.Tensor  # (capacity,) bool


class Batch(NamedTuple):
    """Fixed-capacity batch.

    Dense form (live is None): rows 0..num_rows-1 are the live rows.
    Sparse form (live set): the live rows lie where `live` is True and
    num_rows == live.sum(). A sparse batch exists only between a producer
    that leaves out its output compaction (a filter; an inner, semi or
    anti join on a unique build) and a consumer that reads liveness
    through `row_mask` alone (aggregate, sort, filter, join input);
    `exec.plan.plan_sparse_flow` marks the producers, so no other operator
    sees one."""
    columns: Tuple[Column, ...]
    num_rows: torch.Tensor  # () int32, on the batch's device
    live: Optional[torch.Tensor] = None  # (capacity,) bool; None if dense

    @property
    def capacity(self) -> int:
        return int(self.columns[0].data.shape[0]) if self.columns else 0

    @property
    def device(self) -> torch.device:
        return self.num_rows.device


    def replace_columns(self, columns) -> "Batch":
        return Batch(tuple(columns), self.num_rows, self.live)


_ARANGES: dict = {}     # (capacity, device) -> int32 arange
_ARANGES_MAX_BYTES = 256 << 20


def row_index(capacity: int, device) -> torch.Tensor:
    """int32 arange(capacity) on `device`, made once per (capacity,
    device): every operator of a plan asks for the same few. Read only.
    The cache holds `_ARANGES_MAX_BYTES` at most: the oldest go first, and
    an arange larger than that is made anew each time."""
    key = (capacity, str(device))
    idx = _ARANGES.get(key)
    if idx is None:
        idx = torch.arange(capacity, dtype=torch.int32, device=device)
        size = 4 * capacity
        if size <= _ARANGES_MAX_BYTES:
            held = sum(4 * c for c, _ in _ARANGES)
            while held + size > _ARANGES_MAX_BYTES:
                held -= 4 * next(iter(_ARANGES))[0]
                _ARANGES.pop(next(iter(_ARANGES)))
            _ARANGES[key] = idx
    return idx


def drop_row_indices() -> None:
    """Free the cached aranges (`SessionContext.evict_device`)."""
    _ARANGES.clear()


def row_mask(batch: Batch) -> torch.Tensor:
    """Boolean (capacity,) mask of live rows."""
    if batch.live is not None:
        return batch.live
    return row_index(batch.capacity, batch.device) < batch.num_rows


def padded_upload(host: np.ndarray, capacity: int, device) -> torch.Tensor:
    """A host array of rows (1-D, or (n, 2) words of a wide decimal) on
    `device`, zero-padded to `capacity` rows there: only its own rows
    cross to the device."""
    if len(host) > capacity:
        raise ValueError(f"{len(host)} rows exceed capacity {capacity}")
    if not host.flags.writeable:
        host = host.copy()
    src = torch.from_numpy(np.ascontiguousarray(host))
    out = torch.zeros((capacity,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=device)
    out[:len(host)].copy_(src)
    return out


def make_column(values: np.ndarray, validity: np.ndarray, dtype: DataType,
                capacity: int, device) -> Column:
    """Upload one host column, zero-padded to `capacity`."""
    return Column(padded_upload(host_values(values, dtype),
                                capacity, device),
                  padded_upload(np.asarray(validity, dtype=bool), capacity,
                                device))


def upload_parts(parts, capacity: int, device) -> Batch:
    """A batch from host pieces: `parts` holds, per column, (data arrays,
    validity arrays, numpy dtype); each column's pieces are concatenated
    in order and uploaded, zero-padded to `capacity` on the device. Every
    column must have the same number of rows, at most `capacity`; they are
    the batch's live rows. (The serial runtime's `_assemble` and table
    shards.)"""
    totals = {sum(len(d) for d in datas) for datas, _, _ in parts}
    if len(totals) > 1:
        raise ValueError(f"columns differ in length: {sorted(totals)}")
    total = totals.pop() if totals else 0

    def joined(pieces, dtype):
        if len(pieces) == 1:
            return np.asarray(pieces[0], dtype=dtype)
        return (np.concatenate(pieces).astype(dtype, copy=False) if pieces
                else np.zeros(0, dtype=dtype))

    cols = tuple(Column(padded_upload(joined(datas, dtype), capacity, device),
                        padded_upload(joined(valids, bool), capacity, device))
                 for datas, valids, dtype in parts)
    return Batch(cols, torch.tensor(total, dtype=torch.int32, device=device))


def host_range_batch(columns, dtypes, lo: int, hi: int, capacity: int,
                     device) -> Batch:
    """Rows [lo, hi) of a table's HostColumns (one DataType each) as a
    batch of `capacity` rows. String codes stay codes into the table-wide
    dictionary, so every row range of a table shares one code space (a
    join or GROUP BY across ranges agrees); the table-wide dictionary and
    bounds stay in the table's schema."""
    return upload_parts([([host_values(c.values[lo:hi], dt)],
                          [c.validity[lo:hi]], dt.np_dtype)
                         for c, dt in zip(columns, dtypes)], capacity, device)


def host_values(values, dtype: DataType) -> np.ndarray:
    """A host column's values as the array its device column is made
    from: a wide decimal's as (n, 2) int64 words."""
    values = np.asarray(values, dtype=dtype.np_dtype)
    return values.reshape(-1, 2) if dtype.is_wide else values


def to_numpy(batch: Batch, schema: Schema) -> dict:
    """Live rows host-side: name -> (values ndarray, validity ndarray).

    Strings are decoded through the schema dictionary into object arrays;
    decimals stay scaled int64, wide decimals become Python ints (scaled;
    an object array)."""
    n = int(batch.num_rows)
    out = {}
    for f, col in zip(schema.fields, batch.columns):
        data = col.data[:n].cpu().numpy()
        valid = col.validity[:n].cpu().numpy()
        if f.dtype.is_wide:
            out[f.name] = (wide_to_ints(data), valid)
        elif f.dtype.kind is TypeKind.STRING:
            d = schema.dictionary(f.name)
            if d is None:
                d = np.array([], dtype=object)
            decoded = np.empty(n, dtype=object)
            codes = np.clip(data, 0, max(len(d) - 1, 0))
            decoded[:] = d[codes] if len(d) else None
            decoded[~valid] = None
            out[f.name] = (decoded, valid)
        else:
            out[f.name] = (data, valid)
    return out


# ---------------------------------------------------------------------------
# Host ingest: numpy arrays and Python lists -> HostColumn
# ---------------------------------------------------------------------------

_BOUNDED = (TypeKind.INT32, TypeKind.INT64, TypeKind.DATE32, TypeKind.DECIMAL)


def as_array(values) -> np.ndarray:
    """A numpy array of the column; a list that holds None (or mixed
    Python objects) becomes an object array."""
    if isinstance(values, np.ndarray):
        return values
    if isinstance(values, torch.Tensor):
        return values.cpu().numpy()
    values = list(values)
    if any(v is None for v in values) or any(
            isinstance(v, (pydecimal.Decimal, datetime.date)) for v in values):
        arr = np.empty(len(values), dtype=object)
        arr[:] = values
        return arr
    return np.asarray(values) if values else np.zeros(0, dtype=np.float64)


def _not_none(arr: np.ndarray) -> np.ndarray:
    return ~np.equal(arr, None).astype(bool) if arr.dtype == object \
        else np.ones(len(arr), dtype=bool)


def column_dtype(values) -> DataType:
    """The engine type a numpy array or Python list ingests as: what
    pyarrow would infer for it, narrowed to the engine's types (small
    integers widen to int32, unsigned 32/64-bit to int64)."""
    arr = as_array(values)
    k = arr.dtype.kind
    if k == "b":
        return BOOL
    if k in "iu":
        return INT32 if arr.dtype.itemsize < (4 if k == "u" else 8) else INT64
    if k == "f":
        return FLOAT32 if arr.dtype.itemsize <= 4 else FLOAT64
    if k == "M":
        return DATE32
    if k in "US":
        return STRING
    if k == "O":
        some = [v for v in arr[:1024] if v is not None] or \
            [v for v in arr if v is not None]
        if not some or all(isinstance(v, str) for v in some):
            return STRING
        v = some[0]
        if isinstance(v, (bool, np.bool_)):
            return BOOL
        if isinstance(v, (int, np.integer)):
            return INT64
        if isinstance(v, (float, np.floating)):
            return FLOAT64
        if isinstance(v, (datetime.date, np.datetime64)):
            return DATE32
        if isinstance(v, pydecimal.Decimal):
            raise TypeError("a column of Decimal objects needs "
                            "dtype=decimal(precision, scale)")
    raise TypeError(f"unsupported column dtype {arr.dtype} "
                    f"({type(arr[0]).__name__ if len(arr) else 'empty'})")


def _fixed_width_strings(arr: np.ndarray, validity: np.ndarray) -> np.ndarray:
    """`arr` as a fixed-width numpy string array ('U', or 'S' when it
    came so), with "" in the NULL rows."""
    if not len(arr):
        return np.zeros(0, dtype="U1")
    if arr.dtype.kind == "O":
        if not validity.all():
            arr = np.where(validity, arr, "")
        return arr.astype(str)
    if arr.dtype.kind not in "US":
        raise TypeError(f"string column from dtype {arr.dtype}")
    return arr


def _sorted_distinct(strs: np.ndarray):
    """(sorted distinct values as a 'U' array, int64 inverse) of a
    fixed-width string array, in code-point order.

    Text is sorted as bytes, whose order is the code points' (UTF-8): an
    ASCII 'U' array is narrowed to bytes first, and only non-ASCII 'U'
    input is left to np.unique, which compares items one at a time. Bytes
    sort as big-endian uint64 words (`_sort_words`). A long column of few
    distinct values takes them from a sample and a binary search
    instead (below)."""
    n = len(strs)
    ascii_from = None
    if n and strs.dtype.kind == "U" and strs.dtype.itemsize:
        # ASCII text as bytes, cut to the longest string: the code points
        # are read through a uint32 view (astype("S") converts string by
        # string, ten times slower)
        points = np.ascontiguousarray(strs).view(np.uint32).reshape(n, -1)
        if bool((points < 128).all()):
            used = int(np.flatnonzero(points.any(axis=0)).max(initial=0)) + 1
            strs = np.ascontiguousarray(
                points[:, :used].astype(np.uint8)).view(f"S{used}").ravel()
            ascii_from = used
    if strs.dtype.kind == "U":
        uniq, inv = np.unique(strs, return_inverse=True)
        return uniq, inv.reshape(-1)
    words = _words(strs)
    uniq = inv = None
    if n >= _SAMPLE_ROWS * 16:
        # a column of few distinct values: the distinct values of an
        # evenly spaced sample, if every row is one of them, are the
        # column's, and a binary search replaces the sort of all rows
        keys = words[:, 0] if words.shape[1] == 1 else strs
        step = n // _SAMPLE_ROWS
        cand, first = np.unique(keys[::step], return_index=True)
        if len(cand) <= _SAMPLE_ROWS // 4:
            pos = np.searchsorted(cand, keys).clip(max=len(cand) - 1)
            if bool((cand[pos] == keys).all()):
                uniq, inv = strs[first * step], pos
    if uniq is None:
        uniq, inv = _sort_words(strs, words)
    if ascii_from is not None:
        # back to 'U' by widening each byte to a code point (decoding
        # string by string takes seconds per million)
        uniq = np.ascontiguousarray(uniq).view(np.uint8).reshape(
            -1, ascii_from).astype(np.uint32).view(f"U{ascii_from}").ravel()
    else:
        uniq = np.char.decode(uniq, "utf-8") if len(uniq) \
            else uniq.astype(str)
    return uniq, inv.reshape(-1)


def _words(strs: np.ndarray) -> np.ndarray:
    """An 'S' array as (n, ceil(width / 8)) uint64 big-endian words,
    zero-padded: their order, word by word, is the strings' byte order."""
    n, width = len(strs), strs.dtype.itemsize
    k = max(1, -(-width // 8))
    packed = np.zeros((n, 8 * k), dtype=np.uint8)
    packed[:, :width] = strs.view(np.uint8).reshape(n, width)
    return packed.view(">u8").astype(np.uint64)


def _sort_words(strs: np.ndarray, words: np.ndarray):
    """(sorted distinct values, int64 inverse) of an 'S' array and its
    `_words`: one stable sort per word, from the last word up (torch's
    sort runs on every host core)."""
    n = len(strs)
    # flipping the top bit keeps the words' order as signed int64
    w = torch.from_numpy((words ^ np.uint64(1 << 63)).view(np.int64))
    perm = None
    for j in range(w.shape[1] - 1, -1, -1):
        col = w[:, j] if perm is None else w[:, j][perm]
        order = torch.sort(col, stable=True).indices
        perm = order if perm is None else perm[order]
    ordered = w[perm]
    new = torch.ones(n, dtype=torch.bool)
    new[1:] = (ordered[1:] != ordered[:-1]).any(dim=1)
    inv = torch.empty(n, dtype=torch.int64)
    inv[perm] = torch.cumsum(new, 0) - 1
    return strs[perm[new].numpy()], inv.numpy()


def raw_dict_max() -> int:
    """The RAW threshold in force: BALLISTA_RAW_DICT_MAX, else
    RAW_DICT_MAX."""
    return int(os.environ.get("BALLISTA_RAW_DICT_MAX", str(RAW_DICT_MAX)))


def _estimate_high_cardinality(n: int, sample_at,
                               limit: Optional[int] = None) -> bool:
    """Whether a string column of n rows goes RAW: its distinct count,
    estimated from the evenly stepped sample arange(0, n, max(1, n //
    65536)) scaled to n, exceeds `limit` (default `raw_dict_max()`; the
    reference's verdict, bit for bit). `sample_at(idx)` gives the
    column's values at rows idx with "" for NULL. A skewed column's
    estimate runs high, so a column of genuinely few values keeps its
    sorted dictionary."""
    if limit is None:
        limit = raw_dict_max()
    if n <= limit:
        return False
    idx = np.arange(0, n, max(1, n // _SAMPLE_ROWS), dtype=np.int64)
    uniq = len(set(np.asarray(sample_at(idx)).tolist()))
    return uniq / max(len(idx), 1) * n > limit


def _filled_strings(arr: np.ndarray, validity: np.ndarray) -> np.ndarray:
    """`arr` as an object array of str, "" in the NULL rows (a RAW
    column's dictionary)."""
    if arr.dtype.kind == "S":
        arr = np.char.decode(arr, "utf-8") if len(arr) else arr.astype(str)
    out = arr.astype(object)    # a copy: the caller's array stays its own
    if not validity.all():
        out = np.where(validity, out, "")
    return out


def _ingest_strings(arr, validity, dictionary, raw_max=None) -> HostColumn:
    n = len(arr)
    if dictionary is None and _estimate_high_cardinality(
            n, lambda idx: _filled_strings(arr[idx], validity[idx]),
            raw_max):
        # RAW: no sort, no distinct set; predicates evaluate over these
        # values and key uses re-encode on demand (exprs.sorted_recode)
        return HostColumn(np.arange(n, dtype=np.int32), validity,
                          _filled_strings(arr, validity), None, raw=True)
    strs = _fixed_width_strings(arr, validity)
    codes = np.zeros(n, dtype=np.int32)
    if dictionary is not None:
        # encode against a given (global, sorted) dictionary; a value it
        # does not hold keeps code 0
        dict_np = np.asarray(dictionary, dtype=object)
        d = dict_np.astype(str)
        if strs.dtype.kind == "S":
            strs = np.char.decode(strs, "utf-8") if n else strs.astype(str)
        if len(d) and n:
            pos = np.searchsorted(d, strs).clip(max=len(d) - 1)
            found = validity & (d[pos] == strs)
            codes = np.where(found, pos, 0).astype(np.int32)
        return HostColumn(codes, validity, dict_np, None)
    all_valid = bool(validity.all())
    uniq, inv = _sorted_distinct(strs if all_valid else strs[validity])
    if all_valid:
        codes = inv.astype(np.int32)
    else:
        codes[validity] = inv
    return HostColumn(codes, validity, uniq.astype(object), None)


def ingest_column(values, dtype: Optional[DataType] = None, validity=None,
                  dictionary=None, raw_max: Optional[int] = None
                  ) -> HostColumn:
    """One column, as a numpy array or a Python list, to the host tuple
    the engine keeps: what the reference's `ingest_column_host` makes of
    the same column as an arrow array, without pyarrow.

    NULLs come from `validity` (False = NULL) and from None in an object
    array or a list; their data is zeroed. A float NaN is a value, a
    datetime64 NaT is NULL. Strings become int32 codes into the sorted
    dictionary of the distinct non-NULL values (or into `dictionary`,
    when given), or, above the RAW threshold, into a RAW dictionary of
    the column's values in row order (`_estimate_high_cardinality`).
    Integers, dates (datetime64 -> days) and decimals get
    (min, max) bounds of their valid values. A decimal column is declared
    by `dtype=decimal(p, s)`: integer values are taken as already scaled
    by 10^s, Decimal objects are scaled here. `raw_max` is the RAW
    threshold (default `raw_dict_max()`)."""
    arr = as_array(values)
    if dtype is None:
        dtype = column_dtype(arr)
    n = len(arr)
    valid = _not_none(arr)
    if arr.dtype.kind == "M":
        valid &= ~np.isnat(arr)
    if validity is not None:
        valid &= np.asarray(validity, dtype=bool)
    kind = dtype.kind
    if kind is TypeKind.STRING:
        return _ingest_strings(arr, valid, dictionary, raw_max)
    if arr.dtype.kind == "O":
        filled = np.where(valid, arr, _object_zero(arr, valid))
        if kind is TypeKind.DECIMAL:
            out = np.array([int(pydecimal.Decimal(v).scaleb(dtype.scale))
                            for v in filled.tolist()], dtype=np.int64)
        elif kind is TypeKind.DATE32:
            out = filled.astype("datetime64[D]").astype(np.int32)
        else:
            out = filled.astype(dtype.np_dtype)
    elif arr.dtype.kind == "M":
        out = np.where(valid, arr, np.datetime64(0, "D")) \
            .astype("datetime64[D]").astype(np.int32)
    elif kind is TypeKind.DECIMAL and arr.dtype.kind not in "iu":
        raise TypeError("a decimal column takes scaled integers or Decimal "
                        f"objects, not {arr.dtype}")
    else:
        if arr.dtype == np.uint64 and n and int(arr.max()) > np.iinfo(
                np.int64).max:
            raise ValueError("uint64 values above 2^63 - 1 do not fit int64")
        out = arr.astype(dtype.np_dtype)
    if not valid.all():
        out = np.where(valid, out, np.zeros((), dtype=out.dtype))
    bounds = None
    if kind in _BOUNDED and n:
        vv = out if valid.all() else out[valid]
        if len(vv):
            bounds = (int(vv.min()), int(vv.max()))
    return HostColumn(np.ascontiguousarray(out), valid, None, bounds)


def _object_zero(arr: np.ndarray, valid: np.ndarray):
    """A stand-in for the NULLs of an object array, of the valid values'
    type, so that one astype converts the whole column."""
    idx = np.flatnonzero(valid)
    if not len(idx):
        return 0
    v = arr[idx[0]]
    return v if isinstance(v, (datetime.date, np.datetime64,
                               pydecimal.Decimal)) else type(v)(0)


def ingest_string_buffers(data: np.ndarray, offsets: np.ndarray,
                          validity: Optional[np.ndarray] = None,
                          dictionary=None, ends: Optional[np.ndarray] = None,
                          raw_max: Optional[int] = None) -> HostColumn:
    """A string column given as bytes and spans (n + 1 int64 offsets, or
    n starts with `ends`; an arrow array's buffers, a `.tbl` column's
    fields) as the HostColumn `ingest_column` makes of the same strings,
    through the native encoder (`native.py`). A NULL row's span holds ""
    (arrow's filled nulls). RAW above the threshold, else codes into the
    sorted dictionary of the valid rows' values, or into `dictionary`
    (a value it lacks keeps code 0)."""
    from . import native
    starts, ends = native._spans(offsets, ends)
    data = native._data(data)
    native._checked(data, starts, ends)
    n = len(starts)
    if validity is None:
        validity = np.ones(n, dtype=bool)
    if dictionary is None and _estimate_high_cardinality(
            n, lambda idx: native.decode_rows(data, starts, ends, idx),
            raw_max):
        values = np.empty(n, dtype=object)
        step = 1 << 20      # bounds the padded temporaries
        for lo in range(0, n, step):
            values[lo:lo + step] = native.decode_rows(
                data, starts, ends, np.arange(lo, min(lo + step, n)))
        return HostColumn(np.arange(n, dtype=np.int32), validity, values,
                          None, raw=True)
    if dictionary is not None:
        codes = native.dict_encode_against(data, starts, dictionary, ends)
        found = validity & (codes >= 0)
        return HostColumn(np.where(found, codes, 0).astype(np.int32),
                          validity, np.asarray(dictionary, dtype=object), None)
    codes, uniq = native.dict_encode(data, starts, ends)
    if not validity.all():
        # "" stands in the NULL rows: it leaves the dictionary unless a
        # valid row holds it (it sorts first)
        if len(uniq) and uniq[0] == "" and not (validity
                                                 & (codes == 0)).any():
            uniq, codes = uniq[1:], codes - 1
        codes = np.where(validity, codes, 0).astype(np.int32)
    return HostColumn(codes, validity, uniq.astype(object), None)


# ---------------------------------------------------------------------------
# Arrow / pandas interop (each imports its library where it is used)
# ---------------------------------------------------------------------------

def schema_from_arrow(arrow_schema) -> Schema:
    import pyarrow as pa

    fields = []
    for f in arrow_schema:
        t = f.type
        if pa.types.is_boolean(t):
            dt = BOOL
        elif pa.types.is_int32(t) or pa.types.is_int16(t) or pa.types.is_int8(t):
            dt = INT32
        elif pa.types.is_int64(t):
            dt = INT64
        elif pa.types.is_float32(t):
            dt = FLOAT32
        elif pa.types.is_float64(t):
            dt = FLOAT64
        elif pa.types.is_date32(t):
            dt = DATE32
        elif pa.types.is_decimal(t):
            dt = DataType(TypeKind.DECIMAL, t.precision, t.scale)
        elif pa.types.is_string(t) or pa.types.is_large_string(t):
            dt = STRING
        else:
            raise TypeError(f"unsupported arrow type {t} for column {f.name}")
        fields.append(Field(f.name, dt, f.nullable))
    return Schema(tuple(fields))


def ingest_arrow_column(arr, dtype: DataType, dictionary=None,
                        raw_max: Optional[int] = None) -> HostColumn:
    """An arrow Array or ChunkedArray of engine type `dtype` (from
    `schema_from_arrow`) as a HostColumn: strings from their buffers
    through the native encoder (`ingest_string_buffers`), other types
    arrow -> numpy -> ingest_column."""
    import pyarrow as pa
    import pyarrow.compute as pc

    if isinstance(arr, pa.ChunkedArray):
        if arr.num_chunks and pa.types.is_string(arr.type):
            arr = arr.cast(pa.large_string())   # offsets past 2 GiB
        arr = arr.combine_chunks() if arr.num_chunks \
            else pa.array([], type=arr.type)
    n = len(arr)
    validity = (np.asarray(pc.is_valid(arr)) if arr.null_count
                else np.ones(n, dtype=bool))
    kind = dtype.kind
    if kind is TypeKind.STRING:
        from .native import arrow_buffers
        filled = arr.fill_null("") if arr.null_count else arr
        data, offsets = arrow_buffers(filled)
        return ingest_string_buffers(data, offsets, validity, dictionary,
                                     raw_max=raw_max)
    if kind is TypeKind.DECIMAL:
        # decimal128 -> scaled int64: the low limb of the 128-bit
        # mantissa (|v| < 2^63 holds for precision <= 18)
        limbs = np.frombuffer(arr.buffers()[1], dtype=np.int64)
        values = np.ascontiguousarray(
            limbs.reshape(-1, 2)[arr.offset:arr.offset + n, 0])
    elif kind is TypeKind.DATE32:
        values = np.asarray(arr.cast(pa.int32()).fill_null(0), dtype=np.int32)
    else:
        if arr.null_count:
            arr = arr.fill_null(False if kind is TypeKind.BOOL else 0)
        values = np.asarray(arr)
    return ingest_column(values, dtype, validity, dictionary, raw_max)


def to_pandas(batch: Batch, schema: Schema):
    """Live rows as a pandas DataFrame (decimals as float64, NULL dates
    as NaT)."""
    import pandas as pd

    cols = {}
    raw = to_numpy(batch, schema)
    for f in schema.fields:
        data, valid = raw[f.name]
        if f.dtype.kind is TypeKind.DECIMAL:
            vals = np.asarray([float(v) for v in data], dtype=np.float64) \
                if f.dtype.is_wide else data.astype(np.float64)
            vals = vals / (10 ** f.dtype.scale)
            cols[f.name] = pd.Series(np.where(valid, vals, np.nan))
        elif f.dtype.kind is TypeKind.STRING:
            cols[f.name] = pd.Series(data, dtype=object)
        elif f.dtype.kind is TypeKind.DATE32:
            s = pd.Series(data.astype("datetime64[D]"))
            s[~valid] = pd.NaT
            cols[f.name] = s
        elif f.dtype.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
            cols[f.name] = pd.Series(np.where(valid, data, np.nan))
        else:
            s = pd.Series(data)
            if not valid.all():
                s = s.astype("object")
                s[~valid] = None
            cols[f.name] = s
    return pd.DataFrame(cols)


def schema_to_arrow(schema: Schema):
    """Engine Schema -> pyarrow schema."""
    import pyarrow as pa

    from .schema import to_arrow_type
    fields = []
    for f in schema.fields:
        if f.dtype.kind is TypeKind.DECIMAL:
            t = pa.decimal128(max(f.dtype.precision, f.dtype.scale + 1, 1),
                              f.dtype.scale)
        else:
            t = to_arrow_type(f.dtype)
        fields.append(pa.field(f.name, t, f.nullable))
    return pa.schema(fields)


def host_to_numpy(fields, cols) -> dict:
    """Host columns ({name: HostColumn}) in `to_numpy`'s form: name ->
    (values, validity), strings decoded into object arrays."""
    out = {}
    for f in fields:
        h = cols[f.name]
        if f.dtype.kind is TypeKind.STRING:
            decoded = np.empty(len(h.values), dtype=object)
            if len(h.dictionary):
                decoded[:] = h.dictionary[h.values]
            decoded[~h.validity] = None
            out[f.name] = (decoded, h.validity)
        else:
            out[f.name] = (h.values, h.validity)
    return out


def columns_to_arrow(fields, raw: dict):
    """Columns in `to_numpy`'s form as an exact pyarrow Table (decimals
    stay decimal128)."""
    import pyarrow as pa

    arrow_schema = schema_to_arrow(Schema(fields))
    arrays = []
    for f, af in zip(fields, arrow_schema):
        data, valid = raw[f.name]
        mask = ~valid
        if f.dtype.kind is TypeKind.DECIMAL:
            # decimal128: 16-byte little-endian two's complement, the
            # scaled int64 and its sign extension (a wide decimal's Python
            # ints: their low and high 64 bits)
            if f.dtype.is_wide:
                words = wide_to_decimal128(_ints_to_words(data))
            else:
                v = np.asarray(data, dtype=np.int64)
                words = np.stack([v, v >> 63], axis=1)
            arrays.append(pa.Array.from_buffers(
                af.type, len(words),
                [pa.array(np.asarray(valid, dtype=bool)).buffers()[1],
                 pa.py_buffer(np.ascontiguousarray(words).tobytes())]))
        elif f.dtype.kind is TypeKind.STRING:
            arrays.append(pa.array(data, type=pa.string()))
        elif f.dtype.kind is TypeKind.DATE32:
            arrays.append(pa.array(data.astype(np.int32), type=pa.date32(),
                                   mask=mask))
        else:
            arrays.append(pa.array(data, type=af.type, mask=mask))
    return pa.Table.from_arrays(arrays, schema=arrow_schema)


def _ints_to_words(values) -> np.ndarray:
    """Python ints (a wide decimal's `to_numpy` values) as (n, 2) int64
    words hi, lo with value = hi * 2^32 + lo."""
    ints = [int(v) for v in values]
    return np.array([[v >> 32, v & 0xFFFFFFFF] for v in ints],
                    dtype=np.int64).reshape(-1, 2)


def to_arrow(batch: Batch, schema: Schema):
    """Live rows as an exact pyarrow Table (decimals stay decimal128)."""
    return columns_to_arrow(schema.fields, to_numpy(batch, schema))
