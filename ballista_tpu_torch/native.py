"""The native dictionary encoder (port of ballista_tpu/native.py, over
`csrc/ballista_native.cpp`).

A string column reaches it as numpy buffers: the bytes (uint8) and either
int64 offsets (n + 1 of them, arrow's layout) or each row's (start, end)
spans (a `.tbl` column's fields). `dict_encode` sorts the distinct values
into a dictionary and codes every row; `dict_encode_against` codes rows
against a given sorted dictionary, -1 for a value it does not hold.
Offsets are 64-bit, so a column past 2 GiB (SF10 l_comment, a
`large_string`) is encoded like any other; the JAX package's int32 path
gives up there.

The library is built with g++ at first use into `build/native/` (the file
name carries a hash of the source and flags) and loaded with ctypes.
Unlike the JAX package, which falls back to numpy when the build fails,
a failed build raises with the compiler's message: the plain path
(`batch._sorted_distinct`) is taken for numpy string input only, never
in place of a broken encoder. pyarrow is read inside `arrow_buffers`
alone.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "csrc" / "ballista_native.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_loaded: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("native encoder: no C++ compiler (g++ not on "
                           "PATH; set CXX)")
    return cxx


def build(source: Path = SOURCE) -> Path:
    """Compile `source` once per source and flag hash; returns the shared
    library's path. Written under a temporary name and renamed into place,
    so concurrent processes never load half a file. Raises with the
    compiler's output when it fails. `build.seconds` is the last compile's
    wall time (0 when the library was there)."""
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"ballista_native-{digest}.so"
    build.seconds = 0.0
    if lib.exists():
        return lib
    import time
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    t0 = time.perf_counter()
    res = subprocess.run([_compiler(), *CXX_FLAGS, "-o", str(tmp),
                          str(source)], capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native encoder: the C++ build failed "
                           f"({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    build.seconds = time.perf_counter() - t0
    return lib


build.seconds = 0.0


def _library() -> ctypes.CDLL:
    global _loaded
    with _lock:
        if _loaded is None:
            lib = ctypes.CDLL(str(build()))
            p, i64 = ctypes.c_void_p, ctypes.c_int64
            lib.bt_dict_encode.argtypes = [p, p, p, i64, p, p]
            lib.bt_dict_encode.restype = i64
            lib.bt_dict_encode_against.argtypes = [p, p, p, i64, p, p, i64, p]
            lib.bt_dict_encode_against.restype = i64
            lib.bt_gather_padded.argtypes = [p, p, p, p, i64, i64, p]
            lib.bt_gather_padded.restype = None
            _loaded = lib
    return _loaded


def _spans(offsets: np.ndarray, ends: Optional[np.ndarray]):
    """(starts, ends) as contiguous int64 arrays."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if ends is None:
        return offsets[:-1], offsets[1:]
    ends = np.ascontiguousarray(ends, dtype=np.int64)
    if len(ends) != len(offsets):
        raise ValueError(f"{len(offsets)} starts but {len(ends)} ends")
    return offsets, ends


def _checked(data: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """Raise unless every span lies inside `data` (the encoder reads
    through these offsets unchecked)."""
    if len(starts) and (int(starts.min()) < 0 or bool((ends < starts).any())
                        or int(ends.max()) > len(data)):
        raise ValueError("a string span lies outside its data buffer")


def _ptr(a: np.ndarray):
    return a.ctypes.data if a.size else None


def _data(data: np.ndarray) -> np.ndarray:
    data = np.ascontiguousarray(data, dtype=np.uint8)
    # a null pointer for an empty buffer of empty strings would do, but a
    # one-byte buffer keeps every pointer valid
    return data if data.size else np.zeros(1, dtype=np.uint8)


def decode_rows(data: np.ndarray, starts: np.ndarray, ends: np.ndarray,
                rows: np.ndarray) -> np.ndarray:
    """The strings at `rows` as a 'U' array (the plain path's form): bytes
    gathered zero-padded, ASCII widened to code points in bulk, other text
    decoded as UTF-8."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    m = len(rows)
    if not m:
        return np.zeros(0, dtype="U1")
    width = max(int((ends[rows] - starts[rows]).max()), 1)
    mat = np.empty((m, width), dtype=np.uint8)
    _library().bt_gather_padded(_ptr(data), _ptr(starts), _ptr(ends),
                                _ptr(rows), m, width, _ptr(mat))
    if bool((mat < 128).all()):
        return mat.astype(np.uint32).view(f"U{width}").ravel()
    return np.char.decode(mat.view(f"S{width}").ravel(), "utf-8")


def dict_encode(data: np.ndarray, offsets: np.ndarray,
                ends: Optional[np.ndarray] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(int32 codes, sorted distinct values as a 'U' array) of the strings
    of `data` at `offsets` (n + 1 int64 offsets, or n starts with `ends`)."""
    data = _data(data)
    starts, ends = _spans(offsets, ends)
    _checked(data, starts, ends)
    n = len(starts)
    codes = np.empty(n, dtype=np.int32)
    rows = np.empty(max(n, 1), dtype=np.int64)
    nd = _library().bt_dict_encode(_ptr(data), _ptr(starts), _ptr(ends), n,
                                   _ptr(codes), _ptr(rows))
    return codes, decode_rows(data, starts, ends, rows[:nd])


def _dictionary_buffers(dictionary) -> Tuple[np.ndarray, np.ndarray]:
    encoded = [str(s).encode("utf-8") for s in dictionary]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(s) for s in encoded], out=offsets[1:])
    return np.frombuffer(b"".join(encoded) or b"\0", dtype=np.uint8), offsets


def dict_encode_against(data: np.ndarray, offsets: np.ndarray, dictionary,
                        ends: Optional[np.ndarray] = None) -> np.ndarray:
    """int32 codes of the strings of `data` at `offsets` (or starts with
    `ends`) into the sorted `dictionary`; -1 where it lacks the value."""
    data = _data(data)
    starts, ends = _spans(offsets, ends)
    _checked(data, starts, ends)
    n = len(starts)
    d_data, d_offsets = _dictionary_buffers(dictionary)
    codes = np.empty(n, dtype=np.int32)
    _library().bt_dict_encode_against(
        _ptr(data), _ptr(starts), _ptr(ends), n, _ptr(d_data),
        _ptr(d_offsets), len(d_offsets) - 1, _ptr(codes))
    return codes


def arrow_buffers(arr) -> Tuple[np.ndarray, np.ndarray]:
    """(data uint8, int64 offsets) of a pyarrow string or large_string
    Array (one chunk), at its own offset."""
    import pyarrow as pa
    wide = pa.types.is_large_string(arr.type)
    if not (wide or pa.types.is_string(arr.type)):
        raise TypeError(f"arrow_buffers: {arr.type} is not a string type")
    n = len(arr)
    bufs = arr.buffers()
    offsets = np.frombuffer(bufs[1], dtype=np.int64 if wide else np.int32,
                            count=arr.offset + n + 1)[arr.offset:]
    data = (np.frombuffer(bufs[2], dtype=np.uint8) if bufs[2] is not None
            else np.zeros(0, dtype=np.uint8))
    return data, offsets.astype(np.int64)
