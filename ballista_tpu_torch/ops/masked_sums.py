"""Masked per-slot multi-aggregate sums: the Hopper port of the repo's
Pallas kernel (`ballista_tpu/ops/pallas_agg.py:fused_masked_sums`).

`masked_slot_sums(row_slot, contribs, T)` returns out[t, a], the int64 sum
of contribs[a, i] over the rows i with row_slot[i] == t, for t in [0, T).
Rows with a slot outside [0, T) add nothing. Sums wrap mod 2^64, which is
exact for signed sums. Counts ride the same call as rows of 0/1
contributions.

A CUDA tensor goes to the hand-written kernel in `csrc/masked_slot_sums.cu`,
built with nvcc at first use into `build/kernels/` and loaded with ctypes.
A CPU tensor goes to `masked_slot_sums_reference`, the plain PyTorch
version, which the tests and `chip_smoke.py` also hold the kernel against.

The kernel keeps a block's T x A accumulators in shared memory, so a call
whose T x A exceeds that budget is split into launches over row chunks of
`contribs` (chunks of A), whose results are concatenated along A.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "masked_slot_sums.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
# the kernel's T x A accumulators live in (default, un-opted-in) dynamic
# shared memory
SMEM_BYTES = 48 * 1024
BLOCK = 256
BLOCKS_PER_SM = 8


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


def _check(row_slot: torch.Tensor, contribs: torch.Tensor, T: int) -> None:
    if row_slot.dtype != torch.int32 or row_slot.dim() != 1:
        raise TypeError(f"row_slot must be int32[n], got {row_slot.dtype}"
                        f"{list(row_slot.shape)}")
    if contribs.dtype != torch.int64 or contribs.dim() != 2:
        raise TypeError(f"contribs must be int64[A, n], got {contribs.dtype}"
                        f"{list(contribs.shape)}")
    if contribs.shape[1] != row_slot.shape[0]:
        raise ValueError(f"contribs has {contribs.shape[1]} rows, row_slot "
                         f"{row_slot.shape[0]}")
    if row_slot.device != contribs.device:
        raise ValueError(f"row_slot on {row_slot.device}, contribs on "
                         f"{contribs.device}")
    if not (row_slot.is_contiguous() and contribs.is_contiguous()):
        raise ValueError("row_slot and contribs must be contiguous")
    if not 1 <= T <= SMEM_BYTES // 8:
        raise ValueError(f"T must be in [1, {SMEM_BYTES // 8}] (one "
                         f"contribution row of T int64 accumulators must fit "
                         f"the kernel's {SMEM_BYTES} B of shared memory), "
                         f"got {T}")


def a_chunk(T: int) -> int:
    """Most contribution rows one launch takes at T slots: its T x chunk
    int64 accumulators must fit the kernel's shared memory."""
    return SMEM_BYTES // (8 * T)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return nvcc


def build() -> Path:
    """Compile the kernel (once per source and flag hash) and return the
    shared library's path. The library is written under a temporary name
    and renamed into place, so concurrent processes never load half a file."""
    src = _SOURCE.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"masked_slot_sums-{digest[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fn = lib.masked_slot_sums
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def masked_slot_sums(row_slot: torch.Tensor, contribs: torch.Tensor,
                     T: int) -> torch.Tensor:
    """int32[n] slots, int64[A, n] contributions -> int64[T, A] sums.

    CPU tensors take the plain version; CUDA tensors launch the kernel on
    the current stream (or raise), once per chunk of `a_chunk(T)` rows of
    `contribs`. `masked_slot_sums.launches` counts the kernel launches."""
    _check(row_slot, contribs, T)
    dev = row_slot.device
    if dev.type == "cpu":
        return masked_slot_sums_reference(row_slot, contribs, T)
    if dev.type != "cuda":
        raise ValueError(f"masked_slot_sums: unsupported device {dev}")
    A, n = contribs.shape
    chunk = a_chunk(T)
    if n == 0 or A == 0:
        return torch.zeros((T, A), dtype=torch.int64, device=dev)
    if A > chunk:
        return torch.cat([_launch(row_slot, contribs[a:a + chunk], T)
                          for a in range(0, A, chunk)], dim=1)
    return _launch(row_slot, contribs, T)


def _launch(row_slot: torch.Tensor, contribs: torch.Tensor,
            T: int) -> torch.Tensor:
    """One kernel launch; T x A must fit the shared-memory budget."""
    dev = row_slot.device
    A, n = contribs.shape
    out = torch.zeros((T, A), dtype=torch.int64, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        grid = max(1, min(-(-n // BLOCK), sms * BLOCKS_PER_SM))
        err = lib.masked_slot_sums(
            row_slot.data_ptr(), contribs.data_ptr(), n, T, A, out.data_ptr(),
            grid, BLOCK, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"masked_slot_sums launch failed: CUDA error {err}")
    masked_slot_sums.launches += 1
    return out


masked_slot_sums.launches = 0
