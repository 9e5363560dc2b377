"""ballista_tpu_torch.ops.expand_join against ballista_tpu.ops.expand_join
on the same seeded keys: duplicate build keys, NULL keys on both sides,
dead rows, two-part keys, left outer, an empty build and a forced
overflow. Every field of ExpandedMatch is compared exactly (`need`, the
unclipped total, against the reference's `overflow` flag and, where the
output was clipped, against a count of the matching pairs); and
vsort.rank_in_sorted against the reference's two-sort merge."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.ops import expand_join as JX
from ballista_tpu.ops import vsort as JV
from ballista_tpu_torch.ops import expand_join as TX
from ballista_tpu_torch.ops import vsort as TV

torch.set_num_threads(2)


def _side(rng, n, n_live, n_keys, key_hi, null_frac):
    keys = [rng.integers(0, key_hi, n) for _ in range(n_keys)]
    valids = [rng.random(n) >= null_frac for _ in range(n_keys)]
    live = np.arange(n) < n_live
    return keys, valids, live


def _run_both(build, probe, out_capacity, left_outer):
    def jx(side):
        keys, valids, live = side
        return (tuple(jnp.asarray(k) for k in keys),
                tuple(jnp.asarray(v) for v in valids), jnp.asarray(live))

    def tx(side):
        keys, valids, live = side
        return ([torch.from_numpy(k) for k in keys],
                [torch.from_numpy(v) for v in valids], torch.from_numpy(live))

    want = JX.expand_join(*jx(build), *jx(probe), table_size=256,
                          out_capacity=out_capacity, left_outer=left_outer)
    got = TX.expand_join(*tx(build), *tx(probe), out_capacity,
                         left_outer=left_outer)
    for name in TX.ExpandedMatch._fields:
        if name == "need":   # the reference keeps need > out_capacity
            np.testing.assert_array_equal(
                got.need.numpy() > out_capacity, np.asarray(want.overflow),
                err_msg=name)
            continue
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=name)
    return got


CASES = {   # name: (nb, build live, np, probe live, keys, key range, NULLs)
    "duplicates": (512, 500, 640, 600, 1, 60, 0.0),
    "nulls": (512, 512, 512, 512, 1, 40, 0.1),
    "dead_rows": (384, 100, 768, 300, 1, 30, 0.05),
    "two_keys": (512, 480, 512, 500, 2, 7, 0.05),
    "sparse_matches": (256, 256, 1024, 1000, 1, 5000, 0.0),
    "empty_build": (128, 0, 256, 200, 1, 10, 0.0),
}


@pytest.mark.parametrize("left_outer", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_expand_join_matches_jax(case, left_outer):
    nb, nb_live, np_, np_live, n_keys, hi, nulls = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + left_outer)
    build = _side(rng, nb, nb_live, n_keys, hi, nulls)
    probe = _side(rng, np_, np_live, n_keys, hi, nulls)
    got = _run_both(build, probe, 8192, left_outer)
    assert int(got.need) == int(got.total) <= 8192
    if left_outer:   # every live probe row comes out at least once
        rows = got.probe_row[got.valid].numpy()
        assert set(rows) == set(range(np_live))


def test_matches_come_in_build_row_order():
    """One probe row against a key repeated across the build: its slots
    list the build rows in ascending order."""
    keys = np.array([3, 1, 3, 2, 3, 3] + [0] * 122)
    build = ([keys], [np.ones(128, bool)], np.arange(128) < 6)
    probe = ([np.full(128, 3)], [np.ones(128, bool)], np.arange(128) < 1)
    got = _run_both(build, probe, 128, False)
    assert got.build_row[:int(got.total)].tolist() == [0, 2, 4, 5]


@pytest.mark.parametrize("left_outer", [False, True])
def test_forced_overflow_is_flagged(left_outer):
    rng = np.random.default_rng(11)
    build = _side(rng, 512, 512, 1, 4, 0.0)    # ~128 matches per probe row
    probe = _side(rng, 256, 256, 1, 4, 0.0)
    got = _run_both(build, probe, 1024, left_outer)
    keys_b, _, live_b = build
    keys_p, _, live_p = probe
    per_probe = (keys_p[0][:, None] == keys_b[0][None, live_b]).sum(axis=1)
    want_need = int(np.where(live_p, np.maximum(per_probe, int(left_outer)),
                             0).sum())
    assert int(got.need) == want_need > 1024 and int(got.total) == 1024
    assert bool(got.valid.all())


@pytest.mark.parametrize("M", [1, 100, 1000])
def test_rank_in_sorted_matches_jax(M):
    rng = np.random.default_rng(M)
    csum = np.cumsum(rng.integers(0, 4, 300)).astype(np.int64)
    want = np.asarray(JV.rank_in_sorted(jnp.asarray(csum), M))
    got = TV.rank_in_sorted(torch.from_numpy(csum), M)
    np.testing.assert_array_equal(got.numpy(), want)
