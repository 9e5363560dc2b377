"""The join slice's ops against the JAX package's on the same numpy inputs:
the port's one unique-build probe against `tiny_probe_unique`,
`merge_probe_unique_packed` and `merge_probe_unique` (NULL keys, dead rows,
misses, two keys, a build of <= 256 rows), key packing, SortedLayout
against the JAX SortedLayout, and the compaction and gather helpers. Every
comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu.batch import Batch as JBatch, Column as JColumn
from ballista_tpu.ops import hash as jhash
from ballista_tpu.ops import merge_join as jmj
from ballista_tpu.ops import segagg as jseg
from ballista_tpu.ops import vsort as jvsort
from ballista_tpu.ops.gather import gather_columns as jgather
from ballista_tpu_torch.batch import Batch, Column
from ballista_tpu_torch.ops import hash as thash
from ballista_tpu_torch.ops import merge_join as tmj
from ballista_tpu_torch.ops import segagg as tseg
from ballista_tpu_torch.ops import vsort as tvsort
from ballista_tpu_torch.ops.gather import gather_columns

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _side(rng, keys, null_frac, dead_frac):
    n = len(keys)
    valid = rng.random(n) >= null_frac
    live = rng.random(n) >= dead_frac
    return keys.astype(np.int64), valid, live


def _probe_inputs(seed, nb, np_, key_hi):
    """Unique build keys (some NULL, some dead) and probe keys drawn from
    a wider range, so that some miss."""
    rng = np.random.default_rng(seed)
    build = _side(rng, rng.permutation(key_hi)[:nb] + 5, 0.05, 0.05)
    probe = _side(rng, rng.integers(0, key_hi + 20, np_) + 5, 0.05, 0.05)
    return build, probe


def _jax_args(build, probe):
    (bk, bv, bl), (pk, pv, pl) = build, probe
    return ((jnp.asarray(bk),), (jnp.asarray(bv),), jnp.asarray(bl),
            (jnp.asarray(pk),), (jnp.asarray(pv),), jnp.asarray(pl))


def _port_args(build, probe):
    (bk, bv, bl), (pk, pv, pl) = build, probe
    return ((_t(bk),), (_t(bv),), _t(bl), (_t(pk),), (_t(pv),), _t(pl))


@pytest.mark.parametrize("seed,nb,np_,key_hi", [
    (1, 40, 500, 100), (2, 256, 3000, 600), (3, 7, 50, 7)])
def test_tiny_probe(seed, nb, np_, key_hi):
    build, probe = _probe_inputs(seed, nb, np_, key_hi)
    want = np.asarray(jmj.tiny_probe_unique(*_jax_args(build, probe)))
    got = tmj.probe_unique(*_port_args(build, probe)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got >= 0).any() and (got < 0).any()


@pytest.mark.parametrize("seed,nb,np_,key_hi", [
    (4, 1000, 5000, 3000), (5, 3000, 2000, 3000), (6, 1, 100, 1)])
def test_merge_probe(seed, nb, np_, key_hi):
    build, probe = _probe_inputs(seed, nb, np_, key_hi)
    want = np.asarray(jmj.merge_probe_unique(*_jax_args(build, probe)))
    got = tmj.probe_unique(*_port_args(build, probe)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,nb,np_,key_hi", [
    (7, 1000, 5000, 3000), (8, 4000, 8000, 5000)])
def test_merge_probe_packed(seed, nb, np_, key_hi):
    build, probe = _probe_inputs(seed, nb, np_, key_hi)
    lo, hi = 5, key_hi + 25
    kb = max(((hi - lo + 5).bit_length() + 3) // 4 * 4, 4)
    (bk,), (bv,), bl, (pk,), (pv,), pl = _jax_args(build, probe)
    want = np.asarray(jmj.merge_probe_unique_packed(bk, bv, bl, pk, pv, pl,
                                                    lo=lo, key_bits=kb))
    got = tmj.probe_unique(*_port_args(build, probe)).numpy()
    np.testing.assert_array_equal(got, want)


def _two_key_inputs(seed, nb, np_):
    """Unique (k1, k2) build pairs over a small grid; probes over a wider
    one. Each key has its own NULLs."""
    rng = np.random.default_rng(seed)
    pairs = rng.permutation(60 * 40)[:nb]
    b1, b2 = pairs // 40, pairs % 40 + 1000
    p1 = rng.integers(0, 64, np_)
    p2 = rng.integers(1000, 1044, np_)

    def valid(n):
        return rng.random(n) >= 0.04
    return ((b1, b2), (valid(nb), valid(nb)), rng.random(nb) >= 0.05,
            (p1, p2), (valid(np_), valid(np_)), rng.random(np_) >= 0.05)


@pytest.mark.parametrize("seed,nb,np_", [(9, 500, 4000), (10, 2400, 3000)])
def test_two_key_probe(seed, nb, np_):
    (b1, b2), (bv1, bv2), bl, (p1, p2), (pv1, pv2), pl = \
        _two_key_inputs(seed, nb, np_)
    want = np.asarray(jmj.merge_probe_unique(
        (jnp.asarray(b1), jnp.asarray(b2)),
        (jnp.asarray(bv1), jnp.asarray(bv2)), jnp.asarray(bl),
        (jnp.asarray(p1), jnp.asarray(p2)),
        (jnp.asarray(pv1), jnp.asarray(pv2)), jnp.asarray(pl)))
    # unpacked: the port folds the two keys into one dense code
    got = tmj.probe_unique((_t(b1), _t(b2)), (_t(bv1), _t(bv2)), _t(bl),
                           (_t(p1), _t(p2)), (_t(pv1), _t(pv2)),
                           _t(pl)).numpy()
    np.testing.assert_array_equal(got, want)
    # packed, as HashJoinExec does for two bounded keys
    grp, unp = thash.plan_key_packing([(0, 63), (1000, 1043)],
                                      null_slots=False)
    assert (grp, unp) == jhash.plan_key_packing([(0, 63), (1000, 1043)],
                                                null_slots=False)
    assert len(grp) == 1 and not unp
    tb = thash.pack_key_columns([Column(_t(b1), _t(bv1)),
                                 Column(_t(b2), _t(bv2))], grp, unp, False)
    tp = thash.pack_key_columns([Column(_t(p1), _t(pv1)),
                                 Column(_t(p2), _t(pv2))], grp, unp, False)
    jb = jhash.pack_key_columns([JColumn(jnp.asarray(b1), jnp.asarray(bv1)),
                                 JColumn(jnp.asarray(b2), jnp.asarray(bv2))],
                                grp, unp, False)
    np.testing.assert_array_equal(tb[0].data.numpy(), np.asarray(jb[0].data))
    np.testing.assert_array_equal(tb[0].validity.numpy(),
                                  np.asarray(jb[0].validity))
    got = tmj.probe_unique([tb[0].data], [tb[0].validity], _t(bl),
                           [tp[0].data], [tp[0].validity], _t(pl)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("null_slots", [False, True])
def test_key_packing_plans(null_slots):
    bounds = [(0, 6), None, (-5, 2 ** 40), (3, 3), (0, 2 ** 61)]
    assert thash.plan_key_packing(bounds, null_slots) == \
        jhash.plan_key_packing(bounds, null_slots)
    rng = np.random.default_rng(11)
    data = [rng.integers(0, 7, 300), rng.integers(-9, 9, 300),
            rng.integers(-5, 2 ** 40, 300), np.full(300, 3),
            rng.integers(0, 2 ** 61, 300)]
    valid = [rng.random(300) > 0.1 for _ in data]
    grp, unp = thash.plan_key_packing(bounds, null_slots)
    got = thash.pack_key_columns([Column(_t(d), _t(v))
                                  for d, v in zip(data, valid)],
                                 grp, unp, null_slots)
    want = jhash.pack_key_columns([JColumn(jnp.asarray(d), jnp.asarray(v))
                                   for d, v in zip(data, valid)],
                                  grp, unp, null_slots)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
    norm = thash._norm_keys([c.data for c in got], [c.validity for c in got])
    jnorm = jhash._norm_keys([w.data for w in want], [w.validity for w in want])
    for g, w in zip(norm, jnorm):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _sorted_inputs(seed, n=10_000, groups=1_000, n_live=9_000):
    """Sorted keys with dead rows sentineled to the back (as the aggregate
    presorts them), int64 values with NULLs, float values."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, groups, n))
    live = np.arange(n) < n_live
    keys = np.where(live, keys, 2 ** 62)
    ints = rng.integers(-2 ** 40, 2 ** 40, n)
    floats = rng.standard_normal(n)
    valid = rng.random(n) >= 0.1
    return keys, live, ints, floats, valid


@pytest.mark.parametrize("T", [2048, 700])   # 700 < groups: clipped runs
@pytest.mark.parametrize("method", ["sum", "count", "count_star", "min",
                                    "max", "carry"])
def test_sorted_layout(T, method):
    keys, live, ints, floats, valid = _sorted_inputs(12)
    jl = jseg.layout_from_sorted_keys([jnp.asarray(keys)], jnp.asarray(live), T)
    tl = tseg.layout_from_sorted_keys([_t(keys)], _t(live), T)
    assert tl.T == jl.T and int(tl.n_groups) == int(jl.n_groups)
    # with more runs than T, the last slot's run_end is the last row: its
    # extrema read the dead tail in the reference (an overflowed result is
    # never returned, only retried), so that one slot is not compared
    k = T if int(tl.n_groups) <= T else T - 1
    values = [ints] + ([floats] if method in ("min", "max", "carry") else [])
    for v in values:
        if method == "count_star":
            want, got = jl.count_star(), tl.count_star()
        else:
            want = getattr(jl, method)(jnp.asarray(v), jnp.asarray(valid))
            got = getattr(tl, method)(_t(v), _t(valid))
        np.testing.assert_array_equal(got[1].numpy()[:k],
                                      np.asarray(want[1])[:k])
        np.testing.assert_array_equal(got[0].numpy()[:k],
                                      np.asarray(want[0])[:k])


def test_sorted_sums_wrap():
    """Per-run int64 sums wrap mod 2^64, as the masked path's do."""
    keys, live, _, _, valid = _sorted_inputs(13, n=4000, groups=50,
                                             n_live=4000)
    big = np.full(4000, 2 ** 62, dtype=np.int64)
    jl = jseg.layout_from_sorted_keys([jnp.asarray(keys)], jnp.asarray(live),
                                      64)
    tl = tseg.layout_from_sorted_keys([_t(keys)], _t(live), 64)
    want = jl.sum(jnp.asarray(big), jnp.asarray(valid))
    got = tl.sum(_t(big), _t(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def test_compaction_and_gather():
    rng = np.random.default_rng(14)
    n = 1000
    a = rng.integers(-50, 50, n)
    b = rng.standard_normal(n).astype(np.float32)
    va, vb = rng.random(n) > 0.2, rng.random(n) > 0.2
    keep = rng.random(n) > 0.6
    tb = Batch((Column(_t(a), _t(va)), Column(_t(b), _t(vb))),
               torch.tensor(n, dtype=torch.int32))
    jb = JBatch((JColumn(jnp.asarray(a), jnp.asarray(va)),
                 JColumn(jnp.asarray(b), jnp.asarray(vb))), jnp.int32(n))
    got = tvsort.compact_batch(tb, _t(keep))
    want = jvsort.compact_batch(jb, jnp.asarray(keep))
    assert int(got.num_rows) == int(want.num_rows) == keep.sum()
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
        m = g.validity.numpy()
        np.testing.assert_array_equal(g.data.numpy()[m], np.asarray(w.data)[m])
    T = 300
    np.testing.assert_array_equal(
        tvsort.first_positions(_t(keep), T).numpy()[:keep.sum()],
        np.asarray(jvsort.first_positions(jnp.asarray(keep), T))[:keep.sum()])
    idx = rng.integers(0, n, 700)
    mask = rng.random(700) > 0.3
    got = gather_columns(tb.columns, _t(idx), valid_and=_t(mask))
    want = jgather(jb.columns, jnp.asarray(idx.astype(np.int32)),
                   valid_and=jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
