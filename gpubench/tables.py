"""The generated data as plain numpy, shared by the registration into the
system under test and by the plain reference.

A table is a dict of column name -> `Col`. Numbers are numpy arrays
(decimals as int64 scaled by 10^scale, dates as int32 days since
1970-01-01); a string column is int32 codes into a sorted, distinct
dictionary (an object array of str); a text column (free text, nearly
distinct per row) is each row's span in a byte buffer, rows sharing
bytes where their spans overlap, as arrow's offsets would hold them if
they did not. Every value is valid: the configurations here have no
NULLs.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np


class Col(NamedTuple):
    values: np.ndarray              # "text": each row's int64 start in `dictionary`
    dtype: str                      # int32 int64 date32 float64 string text decimal(p,s)
    dictionary: Optional[np.ndarray] = None     # "text": the uint8 bytes
    ends: Optional[np.ndarray] = None           # "text": each row's int64 end


Table = Dict[str, Col]
Tables = Dict[str, Table]


def string_col(codes: np.ndarray, dictionary) -> Col:
    return Col(np.asarray(codes, dtype=np.int32), "string",
               np.asarray(dictionary, dtype=object))


def encode(categories, idx: np.ndarray) -> Col:
    """Column of categories[idx] against the sorted distinct categories."""
    cats = np.asarray(categories, dtype=object).astype(str)
    dictionary, inverse = np.unique(cats, return_inverse=True)
    return string_col(inverse.astype(np.int32)[idx], dictionary.astype(object))


def text_col(data: np.ndarray, starts, ends) -> Col:
    return Col(np.asarray(starts, dtype=np.int64), "text",
               np.asarray(data, dtype=np.uint8),
               np.asarray(ends, dtype=np.int64))


def text_bytes(col: Col, rows=None, step: int = 1 << 20) -> np.ndarray:
    """The strings of a text column (at `rows`, else all) as a fixed-width
    'S' array, gathered in blocks of `step` rows."""
    starts = col.values if rows is None else col.values[rows]
    ends = col.ends if rows is None else col.ends[rows]
    n = len(starts)
    lens = ends - starts
    width = max(int(lens.max()), 1) if n else 1
    data = col.dictionary
    if len(data) < int(starts.max(initial=0)) + width:
        data = np.concatenate([data, np.zeros(width, dtype=np.uint8)])
    windows = np.lib.stride_tricks.sliding_window_view(data, width)
    out = np.empty((n, width), dtype=np.uint8)
    cols = np.arange(width)
    for lo in range(0, n, step):
        block = windows[starts[lo:lo + step]]
        block[cols[None, :] >= lens[lo:lo + step, None]] = 0
        out[lo:lo + step] = block
    return out.view(f"S{width}").ravel()


def seed_words(seed: int, *names) -> list:
    """Entropy words for numpy's SeedSequence: any whole seed, negative or
    past 64 bits, and the stream's names."""
    import zlib
    words = [int(seed) % (1 << 64)]
    for name in names:
        words.append(zlib.crc32(str(name).encode()) if isinstance(name, str)
                     else int(name))
    return words


def rng(seed: int, *names) -> np.random.Generator:
    return np.random.default_rng(seed_words(seed, *names))
