"""Masked per-slot multi-aggregate sums: the Hopper port of the repo's
Pallas kernel (`ballista_tpu/ops/pallas_agg.py:fused_masked_sums`).

`masked_slot_sums(row_slot, contribs, T)` returns out[t, a], the int64 sum
of contribs[a, i] over the rows i with row_slot[i] == t, for t in [0, T).
Rows with a slot outside [0, T) add nothing. Sums wrap mod 2^64, which is
exact for signed sums. Counts ride the same call as rows of 0/1
contributions.

`masked_slot_sums_rows(row_slot, rows, T)` is the same function over
contribution rows that are described instead of materialised: `rows` is a
sequence of `(data, validity)` pairs, `(None, None)` a row of ones
(`count(*)`), `(None, validity)` a count, `(data, validity)` the sum of
`data * validity`; `data` is int32[n] or int64[n], `validity` bool[n]. A
row `(data, validity, half)` reads a half of each value: `HI` adds
`data >> 32`, `LO` adds `data & (2^32 - 1)` (`WHOLE`, the default, all
of it). A decimal sum that may pass int64 is two such rows over its one
column: each half's sum over fewer than 2^31 rows fits int64, and
`schema.join_wide` joins them exactly. The kernel reads the columns and
forms each contribution in registers, so no (A, n) matrix is written for
it. A column with any other strides (a
literal argument or a broadcast join side is a stride-0 view) is copied to
a contiguous one first.

A CUDA tensor goes to the hand-written kernels in
`csrc/masked_slot_sums.cu`, built with nvcc at first use into
`build/kernels/` and loaded with ctypes. A CPU tensor goes to
`masked_slot_sums_reference` / `masked_slot_sums_rows_reference`, the plain
PyTorch versions, which the tests and `chip_smoke.py` also hold the kernels
against.

One launch streams up to `MAX_ROWS` columns, and the int64 accumulators of
its outputs must fit the shared memory a block may ask the device for; a
wider call is split into launches, each adding its columns of the one
output. In `masked_slot_sums_rows` a count over the validity column of a
sum shares that sum's pass over the column.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch

from ..tracing import span

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "masked_slot_sums.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# shared memory every CUDA device gives a block unasked; what a CPU call is
# checked against. A CUDA call is held to what its device grants on request
# (`smem_bytes`).
SMEM_BYTES = 48 * 1024
# contribution rows per launch (the kernel's descriptor table)
MAX_ROWS = 16

# half-word read modes of a described row (the kernel's `Half`)
WHOLE, HI, LO = 0, 1, 2

Row = Tuple  # (data, validity) or (data, validity, half)


def _half(row) -> int:
    return row[2] if len(row) > 2 else WHOLE


def masked_slot_sums_reference(row_slot: torch.Tensor, contribs: torch.Tensor,
                               T: int) -> torch.Tensor:
    """Plain PyTorch version: one index_add_ into T + 1 rows, the last of
    which collects every row whose slot lies outside [0, T)."""
    A = contribs.shape[0]
    idx = torch.where((row_slot >= 0) & (row_slot < T), row_slot,
                      T).to(torch.int64)
    out = torch.zeros((T + 1, A), dtype=torch.int64, device=contribs.device)
    out.index_add_(0, idx, contribs.T)
    return out[:T]


def contribution_matrix(row_slot: torch.Tensor,
                        rows: Sequence[Row]) -> torch.Tensor:
    """The int64[A, n] matrix that `rows` describes."""
    contribs = torch.empty((len(rows), row_slot.shape[0]), dtype=torch.int64,
                           device=row_slot.device)
    for row, desc in zip(contribs, rows):
        data, validity, half = desc[0], desc[1], _half(desc)
        if data is not None and half != WHOLE:
            data = data.to(torch.int64)
            data = data >> 32 if half == HI else data & 0xFFFFFFFF
        if validity is None and data is None:
            row.fill_(1)
        elif data is None:
            row.copy_(validity)
        elif validity is None:
            row.copy_(data)
        else:
            torch.mul(data, validity, out=row)
    return contribs


def masked_slot_sums_rows_reference(row_slot: torch.Tensor,
                                    rows: Sequence[Row],
                                    T: int) -> torch.Tensor:
    """Plain PyTorch version of `masked_slot_sums_rows`: materialise the
    contribution matrix, then `masked_slot_sums_reference`."""
    return masked_slot_sums_reference(
        row_slot, contribution_matrix(row_slot, rows), T)


def smem_bytes(device=None) -> int:
    """Shared memory one launch's accumulators may take: what the CUDA
    device grants a block on request, `SMEM_BYTES` for the CPU."""
    if device is None or torch.device(device).type != "cuda":
        return SMEM_BYTES
    return _device_limits(_index(device))[1]


def a_chunk(T: int, device=None) -> int:
    """Most rows of a contribution matrix one launch takes at T slots: the
    descriptor table's size, or what fits T x chunk int64 accumulators
    into shared memory."""
    return min(MAX_ROWS, smem_bytes(device) // (8 * T))


def _index(device) -> int:
    device = torch.device(device)
    return torch.cuda.current_device() if device.index is None else device.index


@functools.cache
def _device_limits(index: int) -> Tuple[int, int]:
    """(multiprocessors, shared memory a block may opt in to), asked of
    the device once."""
    sms, smem = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(index):
        err = _library().masked_slot_sums_limits(ctypes.byref(sms),
                                                 ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"masked_slot_sums_limits: CUDA error {err}")
    return sms.value, smem.value


def _check_slots(row_slot: torch.Tensor, T: int) -> None:
    if row_slot.dtype != torch.int32 or row_slot.dim() != 1:
        raise TypeError(f"row_slot must be int32[n], got {row_slot.dtype}"
                        f"{list(row_slot.shape)}")
    if not row_slot.is_contiguous():
        raise ValueError("row_slot must be contiguous")
    if row_slot.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {row_slot.device}")
    limit = smem_bytes(row_slot.device)
    if not 1 <= T <= limit // 8:
        raise ValueError(f"T must be in [1, {limit // 8}] (one contribution "
                         f"row of T int64 accumulators must fit the kernel's "
                         f"{limit} B of shared memory), got {T}")


def _check(row_slot: torch.Tensor, contribs: torch.Tensor, T: int) -> None:
    if contribs.dtype != torch.int64 or contribs.dim() != 2:
        raise TypeError(f"contribs must be int64[A, n], got {contribs.dtype}"
                        f"{list(contribs.shape)}")
    if row_slot.dim() == 1 and contribs.shape[1] != row_slot.shape[0]:
        raise ValueError(f"contribs has {contribs.shape[1]} rows, row_slot "
                         f"{row_slot.shape[0]}")
    if row_slot.device != contribs.device:
        raise ValueError(f"row_slot on {row_slot.device}, contribs on "
                         f"{contribs.device}")
    if not contribs.is_contiguous():
        raise ValueError("contribs must be contiguous")
    _check_slots(row_slot, T)


_DATA_DTYPES = (torch.int32, torch.int64)


def _column(t: torch.Tensor, a: int, name: str, dtypes,
            row_slot: torch.Tensor) -> torch.Tensor:
    """Column `name` of rows[a], checked and made contiguous (a literal
    argument or a broadcast join side arrives as a stride-0 view)."""
    if t.dtype not in dtypes or t.shape != row_slot.shape:
        raise TypeError(f"rows[{a}]: {name} must be "
                        f"{' or '.join(str(d) for d in dtypes)}"
                        f"{list(row_slot.shape)}, got {t.dtype}"
                        f"{list(t.shape)}")
    if t.device != row_slot.device:
        raise ValueError(f"rows[{a}]: {name} on {t.device}, row_slot on "
                         f"{row_slot.device}")
    return t if t.is_contiguous() else t.contiguous()


def _checked_rows(row_slot: torch.Tensor, rows: Sequence[Row],
                  T: int) -> Sequence[Row]:
    """`rows` with every column checked and contiguous: `rows` itself
    where nothing had to be copied, which is the common case and is kept
    cheap (a call's host time is of the order of its device time)."""
    _check_slots(row_slot, T)
    shape, dev, bool_ = row_slot.shape, row_slot.device, torch.bool
    for row in rows:
        data, validity = row[0], row[1]
        if _half(row) not in (WHOLE, HI, LO):
            raise ValueError(f"half-word mode {_half(row)} is not WHOLE, HI "
                             "or LO")
        if data is not None and not (
                data.dtype in _DATA_DTYPES and data.shape == shape
                and data.device == dev and data.is_contiguous()):
            break
        if validity is not None and not (
                validity.dtype is bool_ and validity.shape == shape
                and validity.device == dev and validity.is_contiguous()):
            break
    else:
        return rows
    return [(None if row[0] is None
             else _column(row[0], a, "data", _DATA_DTYPES, row_slot),
             None if row[1] is None
             else _column(row[1], a, "validity", (bool_,), row_slot),
             _half(row))
            for a, row in enumerate(rows)]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build(source: Path = SOURCE) -> Path:
    """Compile `source` (once per source and flag hash) and return the
    shared library's path. The library is written under a temporary name
    and renamed into place, so concurrent processes never load half a file.
    What ptxas reports (registers, spills) is kept in `build.log`."""
    src = source.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"masked_slot_sums-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    build.log = res.stderr
    os.replace(tmp, lib)
    return lib


build.log = ""
_loaded: Optional[ctypes.CDLL] = None


def load(source: Path = SOURCE) -> ctypes.CDLL:
    """Build `source` and make it the library both entries launch from
    here on. The first CUDA call loads the package's own source; a
    benchmark loads a variant of it."""
    global _loaded
    lib = ctypes.CDLL(str(build(source)))
    ptr, c_int, c_ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.masked_slot_sums_limits.argtypes = [ctypes.POINTER(c_int),
                                            ctypes.POINTER(c_int)]
    tail = [ptr, c_int, c_int, c_int, c_int, ptr]  # out ... stream
    lib.masked_slot_sums.argtypes = [ptr, ptr, c_ll, c_int, c_int, c_int,
                                     *tail]
    lib.masked_slot_sums_rows.argtypes = [ptr, ptr, c_ll, c_int, c_int, *tail]
    for fn in (lib.masked_slot_sums_limits, lib.masked_slot_sums,
               lib.masked_slot_sums_rows):
        fn.restype = c_int
    _loaded = lib
    return lib


def _library() -> ctypes.CDLL:
    return _loaded if _loaded is not None else load()


def _launches(entry, fn, row_slot: torch.Tensor, T: int, A: int, launches):
    """The CUDA side of both entries: allocates the int64[T, A] output and
    calls `fn(slots, *head, out, A, zero, multiprocessors, shared memory,
    stream)` for every `head` of `launches`. The first launch zeroes the
    output. Counts on `entry.launches`."""
    dev = row_slot.device
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if torch.cuda.current_device() != index:
        with torch.cuda.device(index):
            return _launches(entry, fn, row_slot, T, A, launches)
    sms, smem = _device_limits(index)
    out = torch.empty((T, A), dtype=torch.int64, device=dev)
    slots, ptr = row_slot.data_ptr(), out.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    zero = 1
    for head in launches:
        err = fn(slots, *head, ptr, A, zero, sms, smem, stream)
        if err != 0:
            raise RuntimeError(
                f"{entry.__name__} launch failed: CUDA error {err}")
        entry.launches += 1
        zero = 0
    return out


def masked_slot_sums(row_slot: torch.Tensor, contribs: torch.Tensor,
                     T: int) -> torch.Tensor:
    """int32[n] slots, int64[A, n] contributions -> int64[T, A] sums.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (or raise), once per chunk of `a_chunk(T, device)`
    rows of `contribs`. `masked_slot_sums.launches` counts the kernel
    launches."""
    _check(row_slot, contribs, T)
    if row_slot.device.type == "cpu":
        return masked_slot_sums_reference(row_slot, contribs, T)
    A, n = contribs.shape
    if n == 0 or A == 0:
        return torch.zeros((T, A), dtype=torch.int64, device=row_slot.device)
    base = contribs.data_ptr()
    step = a_chunk(T, row_slot.device)
    return _launches(masked_slot_sums, _library().masked_slot_sums, row_slot,
                     T, A, [(base + 8 * n * lo, n, T, min(step, A - lo), lo)
                            for lo in range(0, A, step)])


masked_slot_sums.launches = 0

# what the kernel is told of one described row: data pointer, validity
# pointer, bytes per data element plus 256 x the half-word mode, output
# column of the sum, output column of the count over the validity (-1 for
# none)
_DESCRIPTOR = 5


def _descriptors(rows: Sequence[Row], fuse: bool) -> List[List[int]]:
    """One descriptor per column the kernel streams: a count over the
    validity column of a sum rides that sum's descriptor, so the column
    is read once."""
    out, open_sums = [], {}
    for col, row in enumerate(rows):
        data, validity = row[0], row[1]
        if data is None:
            continue
        valid = 0
        if validity is not None:
            valid = validity.data_ptr()
            if fuse:
                open_sums.setdefault(valid, []).append(len(out))
        out.append([data.data_ptr(), valid,
                    data.element_size() + 256 * _half(row), col, -1])
    for col, row in enumerate(rows):
        data, validity = row[0], row[1]
        if data is not None:
            continue
        valid = 0 if validity is None else validity.data_ptr()
        hosts = open_sums.get(valid)
        if hosts:
            out[hosts.pop()][4] = col
        else:
            out.append([0, valid, 0, col, -1])
    return out


def _pack(part: List[List[int]]) -> bytes:
    """The descriptor table of one launch, as the kernel's entry reads it."""
    return struct.pack(f"{_DESCRIPTOR * len(part)}q",
                       *[x for d in part for x in d])


def masked_slot_sums_rows(row_slot: torch.Tensor, rows: Sequence[Row],
                          T: int) -> torch.Tensor:
    """int32[n] slots and A described contribution rows -> int64[T, A]
    sums, equal to `masked_slot_sums` over `contribution_matrix(rows)`.
    A column that is not contiguous is copied first.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (or raise): one launch takes up to `MAX_ROWS`
    columns to stream and as many outputs as its shared memory holds.
    `masked_slot_sums_rows.launches` counts the kernel launches."""
    with span("ballista.kernel.masked_slot_sums"):
        rows = _checked_rows(row_slot, rows, T)
        if row_slot.device.type == "cpu":
            return masked_slot_sums_rows_reference(row_slot, rows, T)
        n, A = row_slot.shape[0], len(rows)
        if n == 0 or A == 0:
            return torch.zeros((T, A), dtype=torch.int64,
                               device=row_slot.device)
        # as many outputs per launch as its shared memory has cells for
        limit = smem_bytes(row_slot.device) // (8 * T)
        descriptors = _descriptors(rows, fuse=limit >= 2)
        if len(descriptors) <= MAX_ROWS and A <= limit:
            parts = [descriptors]
        else:
            parts, outputs = [[]], 0
            for d in descriptors:
                need = 1 + (d[4] >= 0)
                if parts[-1] and (len(parts[-1]) == MAX_ROWS
                                  or outputs + need > limit):
                    parts.append([])
                    outputs = 0
                parts[-1].append(d)
                outputs += need
        return _launches(masked_slot_sums_rows,
                         _library().masked_slot_sums_rows, row_slot, T, A,
                         [(_pack(part), n, T, len(part)) for part in parts])


masked_slot_sums_rows.launches = 0
