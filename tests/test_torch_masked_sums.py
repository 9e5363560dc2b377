"""masked_slot_sums (ballista_tpu_torch) against the TPU kernel it replaces,
`ballista_tpu.ops.pallas_agg.fused_masked_sums`, run in Pallas interpret
mode on the CPU. Inputs come from numpy with a fixed seed; every
comparison is exact (integer sums wrap mod 2^64 on both sides)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.ops.pallas_agg import fused_masked_sums
from ballista_tpu_torch.ops.masked_sums import (
    MAX_ROWS, SMEM_BYTES, _descriptors, a_chunk, contribution_matrix,
    masked_slot_sums, masked_slot_sums_reference, masked_slot_sums_rows,
    masked_slot_sums_rows_reference)

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


def _rows(n, seed, null_share=0.3):
    """Described rows as the aggregate operator builds them, from numpy:
    count(*), two counts, an int64 sum and an int32 sum over nullable
    columns (the sum and its count share one validity column), an int64
    sum without NULLs. Returns (numpy rows, torch rows)."""
    rng = np.random.default_rng(seed)
    v1 = rng.random(n) >= null_share
    v2 = rng.random(n) >= null_share
    d64 = rng.integers(-BIG, BIG, n, dtype=np.int64)
    d32 = rng.integers(-2 ** 31, 2 ** 31 - 1, n).astype(np.int32)
    dense = rng.integers(-2 ** 40, 2 ** 40, n, dtype=np.int64)
    rows = [(None, None), (None, v1), (None, v2), (d64, v1), (d32, v2),
            (dense, None)]
    as_torch = {id(a): torch.from_numpy(a) for a in (v1, v2, d64, d32, dense)}
    return rows, [tuple(None if x is None else as_torch[id(x)] for x in r)
                  for r in rows]


def _masked_contributions(rows, n):
    """What the rows contribute, in numpy: data * validity as int64."""
    out = []
    for data, validity in rows:
        c = np.ones(n, dtype=np.int64) if data is None \
            else data.astype(np.int64)
        out.append(c if validity is None else c * validity)
    return out


# the T at which the kernel changes its code path, T = 26 (Q5) and the
# masked layout's largest, each at a size off every vector width
@pytest.mark.parametrize("n,T", [(1, 1), (2, 2), (3, 3), (4099, 4),
                                 (4099, 5), (1027, 8), (1027, 9),
                                 (1027, 16), (515, 17), (515, 26)])
def test_rows_match_pallas_kernel(n, T):
    """masked_slot_sums_rows against the TPU kernel fed the masked
    contributions: exact (tolerance 0)."""
    rng = np.random.default_rng(n + T)
    slot = rng.integers(-1, T + 2, n).astype(np.int32)
    np_rows, rows = _rows(n, seed=n * 31 + T)
    want = np.asarray(fused_masked_sums(
        jnp.asarray(slot),
        [jnp.asarray(c) for c in _masked_contributions(np_rows, n)], T,
        interpret=True))
    got = masked_slot_sums_rows(torch.from_numpy(slot), rows, T)
    assert got.dtype == torch.int64 and tuple(got.shape) == (T, len(rows))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,T", [(0, 6), (1, 64), (8191, 12), (20000, 64),
                                 (20000, 1)])
def test_rows_match_numpy(n, T):
    """Shapes the interpret-mode kernel is too slow for, against numpy and
    against masked_slot_sums over the matrix the rows describe."""
    rng = np.random.default_rng(n + 3 * T)
    slot = rng.integers(-3, T + 3, n).astype(np.int32)
    np_rows, rows = _rows(n, seed=n + T)
    got = masked_slot_sums_rows(torch.from_numpy(slot), rows, T)
    contribs = np.stack(_masked_contributions(np_rows, n)) if n else \
        np.zeros((len(rows), 0), dtype=np.int64)
    np.testing.assert_array_equal(got.numpy(), _numpy_sums(slot, contribs, T))
    matrix = contribution_matrix(torch.from_numpy(slot), rows)
    np.testing.assert_array_equal(matrix.numpy(), contribs)
    assert torch.equal(got, masked_slot_sums(torch.from_numpy(slot), matrix, T))
    assert torch.equal(got, masked_slot_sums_rows_reference(
        torch.from_numpy(slot), rows, T))


def test_rows_all_null_and_all_dead():
    slot = torch.tensor([0, 1, 2, 2, 0], dtype=torch.int32)
    data = torch.tensor([5, 7, 9, -4, 100], dtype=torch.int64)
    none_valid = torch.zeros(5, dtype=torch.bool)
    out = masked_slot_sums_rows(slot, [(data, none_valid), (None, none_valid),
                                       (None, None)], 3)
    assert out.tolist() == [[0, 0, 2], [0, 0, 1], [0, 0, 2]]
    dead = torch.full((5,), 3, dtype=torch.int32)
    assert not masked_slot_sums_rows(dead, [(data, None), (None, None)],
                                     3).any()


@pytest.mark.parametrize("fuse", [True, False])
def test_counts_share_their_sums_column(fuse):
    """The launch plan: a count over the validity column of a sum rides
    that sum's descriptor, once per sum; every output column is produced
    exactly once either way."""
    _, rows = _rows(64, seed=5)
    rows = rows + [(None, rows[1][1])]        # a second count over v1
    desc = _descriptors(rows, fuse)
    produced = sorted([d[3] for d in desc] + [d[4] for d in desc if d[4] >= 0])
    assert produced == list(range(len(rows)))
    fused = [(d[3], d[4]) for d in desc if d[4] >= 0]
    assert fused == ([(3, 1), (4, 2)] if fuse else [])

    def address(t):
        return 0 if t is None else t.data_ptr()

    for data, validity, width, sum_col, count_col in desc:
        want_data, want_validity = rows[sum_col]
        assert (data, validity) == (address(want_data), address(want_validity))
        assert width == (0 if want_data is None else want_data.element_size())
        if count_col >= 0:
            assert rows[count_col][0] is None
            assert rows[count_col][1].data_ptr() == validity
    assert len(desc) == len(rows) - len(fused)


@pytest.mark.parametrize("T,expect", [(1, MAX_ROWS), (64, MAX_ROWS),
                                      (SMEM_BYTES // 64, 8),
                                      (SMEM_BYTES // 8, 1)])
def test_a_chunk_without_a_device(T, expect):
    assert a_chunk(T) == a_chunk(T, "cpu") == expect


@pytest.mark.parametrize("bad", ["data_dtype", "validity_dtype", "data_rows",
                                 "validity_rows", "strided_slots",
                                 "slot_dtype", "T"])
def test_rows_wrapper_rejects_bad_inputs(bad):
    slot = torch.zeros(8, dtype=torch.int32)
    data = torch.zeros(8, dtype=torch.int64)
    validity = torch.ones(8, dtype=torch.bool)
    T = 4
    if bad == "data_dtype":
        data = data.to(torch.float64)
    elif bad == "validity_dtype":
        validity = validity.to(torch.int64)
    elif bad == "data_rows":
        data = torch.zeros(9, dtype=torch.int64)
    elif bad == "validity_rows":
        validity = torch.ones(7, dtype=torch.bool)
    elif bad == "strided_slots":
        slot = torch.zeros(16, dtype=torch.int32)[::2]
    elif bad == "slot_dtype":
        slot = slot.to(torch.int64)
    else:
        T = 0
    with pytest.raises((TypeError, ValueError)):
        masked_slot_sums_rows(slot, [(None, None), (data, validity)], T)


@pytest.mark.parametrize("T", [1, 4, 26])
@pytest.mark.parametrize("how", ["broadcast", "every_other", "both"])
def test_rows_take_strided_columns(how, T):
    """Columns that are views with stride 0 (a literal, a broadcast join
    side) or any other stride give the sums of their contiguous copies."""
    n = 1027
    rng = np.random.default_rng(T)
    slot = torch.from_numpy(rng.integers(-1, T + 2, n).astype(np.int32))
    wide = torch.from_numpy(rng.integers(-BIG, BIG, 2 * n, dtype=np.int64))
    flags = torch.from_numpy(rng.random(2 * n) >= 0.3)
    seven = torch.tensor([7], dtype=torch.int64).expand(n)
    three = torch.tensor([3], dtype=torch.int32).expand(n)
    yes = torch.tensor([True]).expand(n)
    rows = []
    if how != "every_other":
        rows += [(None, yes), (seven, yes), (three, flags[:n]), (seven, None)]
    if how != "broadcast":
        rows += [(wide[::2], flags[::2]), (None, flags[1::2]),
                 (wide[1::2], yes)]
    assert all(not t.is_contiguous() for t in (seven, three, yes, wide[::2]))
    got = masked_slot_sums_rows(slot, rows, T)
    plain = [tuple(None if t is None else t.contiguous() for t in pair)
             for pair in rows]
    assert torch.equal(got, masked_slot_sums_rows(slot, plain, T))
    contribs = np.stack(_masked_contributions(
        [tuple(None if t is None else t.numpy() for t in pair)
         for pair in plain], n))
    np.testing.assert_array_equal(got.numpy(),
                                  _numpy_sums(slot.numpy(), contribs, T))
