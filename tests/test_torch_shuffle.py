"""The shuffle's device half against the JAX package: `hash_columns` bit for
bit (it picks every row's partition), then `shuffle_dest` and
`exchange_send_layout` (destinations, pre-clamp and clamped counts, the
overflow flag and every send-buffer column) over the same seeded batches,
for P in {1, 2, 4, 8}, a quota that overflows, and salt 2 in `spread` and
`replicate` mode. Inputs carry NULL keys and dead rows past num_rows."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ballista_tpu.batch import Batch as JBatch, Column as JColumn
from ballista_tpu.ops.hash import hash_columns as jax_hash
from ballista_tpu.parallel import shuffle as jshuffle
from ballista_tpu_torch.batch import Batch, Column
from ballista_tpu_torch.ops.hash import hash_columns
from ballista_tpu_torch.parallel import shuffle

torch.set_num_threads(2)

N = 1000
CAP = 1024
KINDS = {
    "int64": lambda rng: rng.integers(-2 ** 62, 2 ** 62, CAP, dtype=np.int64),
    "int32": lambda rng: rng.integers(-2 ** 31, 2 ** 31 - 1, CAP,
                                      dtype=np.int32),
    "date": lambda rng: rng.integers(8000, 11000, CAP).astype(np.int32),
    "small": lambda rng: rng.integers(-3, 4, CAP, dtype=np.int64),
}


def _columns(kinds, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in kinds:
        data = KINDS[k](rng)
        valid = rng.random(CAP) > 0.1
        valid[N:] = False
        data = np.where(valid, data, 0).astype(data.dtype)
        out.append((data, valid))
    return out


@pytest.mark.parametrize("seed", [0x9E3779B9, shuffle.SHUFFLE_SEED])
@pytest.mark.parametrize("kinds", [("int64",), ("int32",), ("date",),
                                   ("int64", "int32"),
                                   ("date", "small", "int64")])
def test_hash_columns_bit_for_bit(kinds, seed):
    cols = _columns(kinds, len(kinds))
    got = hash_columns([torch.from_numpy(d) for d, _ in cols],
                       [torch.from_numpy(v) for _, v in cols], seed=seed)
    want = np.asarray(jax_hash(tuple(jnp.asarray(d) for d, _ in cols),
                               tuple(jnp.asarray(v) for _, v in cols),
                               seed=seed))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def _batches(seed):
    """The same batch in both packages: two key columns (int64 with
    negatives and NULLs; a small int32), a payload, N live rows of CAP."""
    rng = np.random.default_rng(seed)
    k1 = rng.integers(-50, 50, CAP, dtype=np.int64)
    k2 = rng.integers(0, 7, CAP).astype(np.int32)
    pay = rng.normal(size=CAP)
    cols = [(k1, rng.random(CAP) > 0.05), (k2, np.ones(CAP, bool)),
            (pay, rng.random(CAP) > 0.2)]
    live = np.arange(CAP) < N
    cols = [(np.where(v & live, d, 0).astype(d.dtype), v & live)
            for d, v in cols]
    tb = Batch(tuple(Column(torch.from_numpy(d), torch.from_numpy(v))
                     for d, v in cols), torch.tensor(N, dtype=torch.int32))
    jb = JBatch(tuple(JColumn(jnp.asarray(d), jnp.asarray(v))
                      for d, v in cols), jnp.int32(N))
    return tb, jb


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("salt", [1, 2])
def test_shuffle_dest_matches_jax(P, salt):
    tb, jb = _batches(P)
    mode = "spread" if salt > 1 else None
    dest, live = shuffle.shuffle_dest(tb, [0, 1], P, salt, mode)
    jdest, jlive = jshuffle.shuffle_dest(jb, [0, 1], P, salt, mode)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(live.numpy(), np.asarray(jlive))


# (P, case): salting needs two partitions or more
LAYOUTS = [(P, case) for P in (1, 2, 4, 8)
           for case in ("fits", "overflows", "spread", "replicate")
           if P > 1 or case in ("fits", "overflows")]


@pytest.mark.parametrize("P,case", LAYOUTS)
def test_exchange_send_layout_matches_jax(P, case):
    tb, jb = _batches(10 + P)
    quota = max(N // (4 * P), 8) if case == "overflows" else 2 * N // P + 128
    salt, mode = (2, case) if case in ("spread", "replicate") else (1, None)
    out, send, ovf, counts = shuffle.exchange_send_layout(
        tb, [0, 1], P, quota, salt, mode)
    jout, jsend, jovf, jcounts = jshuffle.exchange_send_layout(
        jb, [0, 1], P, quota, salt, mode)
    np.testing.assert_array_equal(send.numpy(), np.asarray(jsend))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert bool(ovf) == bool(jovf) == (case == "overflows")
    assert int(out.num_rows) == int(jout.num_rows)
    assert out.capacity == jout.capacity == P * quota
    for c, jc in zip(out.columns, jout.columns):
        valid = np.asarray(jc.validity)
        np.testing.assert_array_equal(c.validity.numpy(), valid)
        np.testing.assert_array_equal(c.data.numpy()[valid],
                                      np.asarray(jc.data)[valid])


@pytest.mark.parametrize("P,case", LAYOUTS)
def test_send_rows_are_the_layouts_live_slots(P, case):
    """The serial runtime's compact send side: the same counts and
    overflow, and the JAX layout's live slots, in slot order, at the
    front of a batch of (at least) the input's capacity."""
    tb, jb = _batches(20 + P)
    quota = max(N // (4 * P), 8) if case == "overflows" else 2 * N // P + 128
    salt, mode = (2, case) if case in ("spread", "replicate") else (1, None)
    out, send, ovf, counts = shuffle.exchange_send_rows(
        tb, [1, 0], P, quota, salt, mode)
    jout, jsend, jovf, jcounts = jshuffle.exchange_send_layout(
        jb, [1, 0], P, quota, salt, mode)
    np.testing.assert_array_equal(send.numpy(), np.asarray(jsend))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert bool(ovf) == bool(jovf)
    total = int(out.num_rows)
    assert total == int(jout.num_rows) == int(send.sum())
    assert out.capacity == CAP * (salt if mode == "replicate" else 1)
    for c, jc in zip(out.columns, jout.columns):
        slots = np.asarray(jc.validity) | (
            (np.arange(P * quota) % quota)
            < np.repeat(np.asarray(jsend), quota))
        np.testing.assert_array_equal(c.validity.numpy()[:total],
                                      np.asarray(jc.validity)[slots])
        assert not c.validity.numpy()[total:].any()
        valid = c.validity.numpy()[:total]
        np.testing.assert_array_equal(c.data.numpy()[:total][valid],
                                      np.asarray(jc.data)[slots][valid])
