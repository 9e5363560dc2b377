"""masked_slot_sums (ballista_tpu_torch) against the TPU kernel it replaces,
`ballista_tpu.ops.pallas_agg.fused_masked_sums`, run in Pallas interpret
mode on the CPU. Inputs come from numpy with a fixed seed; every
comparison is exact (integer sums wrap mod 2^64 on both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.ops.pallas_agg import fused_masked_sums
from ballista_tpu_torch.ops.masked_sums import (SMEM_BYTES, a_chunk,
                                                masked_slot_sums,
                                                masked_slot_sums_reference)

torch.set_num_threads(2)

BIG = 2 ** 62


def _inputs(n, T, A, lo, hi, seed):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, T + 1, n).astype(np.int32)   # slot T = dead row
    contribs = rng.integers(lo, hi, (A, n), dtype=np.int64)
    return slot, contribs


def _numpy_sums(slot, contribs, T):
    out = np.zeros((T + 1, contribs.shape[0]), dtype=np.uint64)
    live = (slot >= 0) & (slot < T)
    np.add.at(out, np.where(live, slot, T), contribs.T.astype(np.uint64))
    return out[:T].astype(np.int64)


# interpret mode costs ~2 s per (padded rows, T, A) shape, far more at T=64
# (the kernel unrolls T*A*8 reductions), so the cases are a chosen subset
@pytest.mark.parametrize("n,T,A,lo,hi", [
    (1, 1, 1, -2 ** 40, 2 ** 40),
    (8191, 6, 3, -2 ** 40, 2 ** 40),
    (20000, 6, 3, BIG - 2 ** 20, BIG),        # wraps mod 2^64
    (20000, 64, 1, -2 ** 40, 2 ** 40),
    (8191, 1, 3, -BIG, -BIG + 2 ** 20),       # wraps mod 2^64
])
def test_matches_pallas_kernel(n, T, A, lo, hi):
    slot, contribs = _inputs(n, T, A, lo, hi, seed=n + T + A)
    want = np.asarray(fused_masked_sums(
        jnp.asarray(slot), [jnp.asarray(c) for c in contribs], T,
        interpret=True))
    got = masked_slot_sums(torch.from_numpy(slot), torch.from_numpy(contribs),
                           T)
    assert got.dtype == torch.int64 and tuple(got.shape) == (T, A)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,T,A", [(0, 6, 3), (1, 64, 1), (8191, 6, 3),
                                   (20000, 64, 3), (20000, 1, 11)])
def test_reference_matches_numpy(n, T, A):
    """Covers the shapes the interpret-mode kernel is too slow (or, at n=0,
    unable) to run, plus slots outside [0, T] in both directions."""
    rng = np.random.default_rng(n * 7 + T)
    slot = rng.integers(-3, T + 3, n).astype(np.int32)
    contribs = rng.integers(-BIG, BIG, (A, n), dtype=np.int64)
    got = masked_slot_sums(torch.from_numpy(slot), torch.from_numpy(contribs),
                           T)
    np.testing.assert_array_equal(got.numpy(), _numpy_sums(slot, contribs, T))


def test_counts_ride_as_zero_one_rows():
    slot = torch.tensor([0, 1, 1, 2, 3, -1, 1], dtype=torch.int32)
    valid = torch.tensor([1, 1, 0, 1, 1, 1, 1], dtype=torch.bool)
    vals = torch.tensor([5, 7, 9, -4, 100, 100, 1], dtype=torch.int64)
    contribs = torch.stack([vals * valid, valid.to(torch.int64)])
    out = masked_slot_sums(slot, contribs, 3)
    assert out.tolist() == [[5, 1], [8, 2], [-4, 1]]


@pytest.mark.parametrize("T,A", [(64, 100), (60, 105), (6144, 2)])
def test_wide_calls_equal_reference(T, A):
    """T x A int64 accumulators beyond the kernel's shared memory: the
    wrapper splits A into launches (on the card) instead of refusing."""
    assert T * A * 8 > SMEM_BYTES and a_chunk(T) < A
    rng = np.random.default_rng(T + A)
    slot = rng.integers(-1, T + 2, 5000).astype(np.int32)
    contribs = rng.integers(-BIG, BIG, (A, 5000), dtype=np.int64)
    got = masked_slot_sums(torch.from_numpy(slot), torch.from_numpy(contribs),
                           T)
    assert tuple(got.shape) == (T, A)
    want = masked_slot_sums_reference(torch.from_numpy(slot),
                                      torch.from_numpy(contribs), T)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), _numpy_sums(slot, contribs, T))


@pytest.mark.parametrize("bad", ["slot_dtype", "contrib_dtype", "rows",
                                 "T", "smem", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    slot = torch.zeros(8, dtype=torch.int32)
    contribs = torch.zeros((2, 8), dtype=torch.int64)
    T = 4
    if bad == "slot_dtype":
        slot = slot.to(torch.int64)
    elif bad == "contrib_dtype":
        contribs = contribs.to(torch.int32)
    elif bad == "rows":
        contribs = torch.zeros((2, 9), dtype=torch.int64)
    elif bad == "T":
        T = 0
    elif bad == "smem":
        # one contribution row of T accumulators no longer fits shared
        # memory (wider A is split into launches, not refused)
        contribs = torch.zeros((1, 8), dtype=torch.int64)
        T = SMEM_BYTES // 8 + 1
    else:
        contribs = torch.zeros((8, 2), dtype=torch.int64).T
    with pytest.raises((TypeError, ValueError)):
        masked_slot_sums(slot, contribs, T)
