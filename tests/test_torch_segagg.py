"""ballista_tpu_torch.ops.segagg against ballista_tpu.ops.segagg: direct
composite slots, their decoding, and MaskedLayout sums, counts, min, max
and carry, with nullable and non-nullable keys. Exact comparisons."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu import batch as JB
from ballista_tpu.ops import segagg as JS
from ballista_tpu_torch import batch as TB
from ballista_tpu_torch.ops import segagg as TS

torch.set_num_threads(2)

N = 5000
BOUNDS = (3, 2)


def _keys(nullables, seed):
    rng = np.random.default_rng(seed)
    cols = []
    for b, nu in zip(BOUNDS, nullables):
        codes = rng.integers(0, b, N).astype(np.int32)
        valid = rng.random(N) > 0.2 if nu else np.ones(N, dtype=bool)
        cols.append((codes, valid))
    live = rng.random(N) > 0.3
    return cols, live


def _both(cols, live, nullables):
    jk = [JB.Column(jnp.asarray(c), jnp.asarray(v)) for c, v in cols]
    tk = [TB.Column(torch.from_numpy(c), torch.from_numpy(v)) for c, v in cols]
    jslot, jT = JS.direct_slots(jk, BOUNDS, jnp.asarray(live), nullables)
    tslot, tT = TS.direct_slots(tk, BOUNDS, torch.from_numpy(live), nullables)
    return (jk, jslot, jT), (tk, tslot, tT)


@pytest.mark.parametrize("nullables", [[True, True], [False, False],
                                       [True, False]])
def test_direct_slots_and_decode(nullables):
    cols, live = _keys(nullables, seed=len(nullables) + sum(nullables))
    (jk, jslot, jT), (tk, tslot, tT) = _both(cols, live, nullables)
    assert jT == tT
    assert tslot.dtype == torch.int32
    np.testing.assert_array_equal(tslot.numpy(), np.asarray(jslot))
    ids = np.arange(jT, dtype=np.int32)
    jd = JS.decode_direct_slot(jnp.asarray(ids), jk, BOUNDS, nullables)
    td = TS.decode_direct_slot(torch.from_numpy(ids), tk, BOUNDS, nullables)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b.data.numpy(), np.asarray(a.data))
        np.testing.assert_array_equal(b.validity.numpy(),
                                      np.asarray(a.validity))


def _values(kind, seed):
    rng = np.random.default_rng(seed)
    if kind == "int64":
        v = rng.integers(-2 ** 40, 2 ** 40, N, dtype=np.int64)
    elif kind == "int32":
        v = rng.integers(-1000, 1000, N).astype(np.int32)
    else:
        v = rng.standard_normal(N) * 1e3
    return v, rng.random(N) > 0.1


@pytest.mark.parametrize("nullables", [[True, True], [False, False]])
@pytest.mark.parametrize("method", ["sum", "count", "min", "max", "carry"])
@pytest.mark.parametrize("kind", ["int64", "int32", "float64"])
def test_masked_layout(nullables, method, kind):
    cols, live = _keys(nullables, seed=3)
    (_, jslot, jT), (_, tslot, tT) = _both(cols, live, nullables)
    jl = JS.MaskedLayout(jslot, jnp.asarray(live), jT)
    tl = TS.MaskedLayout(tslot, torch.from_numpy(live), tT)
    v, valid = _values(kind, seed=len(method))
    jout, jvalid = getattr(jl, method)(jnp.asarray(v), jnp.asarray(valid))
    tout, tvalid = getattr(tl, method)(torch.from_numpy(v),
                                       torch.from_numpy(valid))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    if kind == "float64" and method == "sum":
        # float sums: the two reductions add in different orders
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   rtol=1e-12, atol=1e-9)
    else:
        np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("nullables", [[True, True], [False, True]])
def test_count_star(nullables):
    cols, live = _keys(nullables, seed=11)
    (_, jslot, jT), (_, tslot, tT) = _both(cols, live, nullables)
    jc, jv = JS.MaskedLayout(jslot, jnp.asarray(live), jT).count_star()
    tc, tv = TS.MaskedLayout(tslot, torch.from_numpy(live), tT).count_star()
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("T", [1, 7, 100, 5000, (1 << 19) + 3])
def test_slot_reduce_takes_each_slot_by_itself(T):
    """Float sums by slot, spread over lanes where the slots are few:
    equal to numpy's per-slot sums (rtol 1e-13: another order of adding),
    the spill cell's rows dropped, and a one-row slot's sum is that row's value
    to the bit, whatever its neighbours hold."""
    rng = np.random.default_rng(T)
    n = 20_000
    index = np.sort(rng.integers(0, T + 1, n))
    values = rng.uniform(0, 100, n)
    lonely = min(3, T)
    values = np.where(index == lonely, 0.0, values)
    values[np.searchsorted(index, lonely)] = 0.017118 * (index == lonely).any()
    idx, vals = torch.from_numpy(index), torch.from_numpy(values)
    got = TS._slot_reduce(idx, vals, T, "sum").numpy()
    want = np.bincount(index, values, minlength=T + 1)[:T]      # no spill
    assert got.shape == (T,)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    if lonely < T and (index == lonely).any():
        assert got[lonely] == 0.017118
    # minima and maxima the same way, exactly, for floats and integers
    ints = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))
    for v, lo, hi in ((vals, float("inf"), float("-inf")),
                      (ints, torch.iinfo(torch.int64).max,
                       torch.iinfo(torch.int64).min)):
        want_min = np.full(T + 1, lo, dtype=v.numpy().dtype)
        want_max = np.full(T + 1, hi, dtype=v.numpy().dtype)
        np.minimum.at(want_min, index, v.numpy())
        np.maximum.at(want_max, index, v.numpy())
        np.testing.assert_array_equal(
            TS._slot_reduce(idx, v, T, "amin", lo).numpy(), want_min[:T])
        np.testing.assert_array_equal(
            TS._slot_reduce(idx, v, T, "amax", hi).numpy(), want_max[:T])


def test_sorted_layout_float_sum_is_exact_for_one_row_groups():
    """The fault the h2o questions found: a float sum on the sorted layout
    was a difference of one running sum over all rows, so a one-row group
    carried the rounding of the whole prefix."""
    rng = np.random.default_rng(3)
    n = 4096
    keys = torch.arange(n, dtype=torch.int64)            # every row a group
    values = torch.from_numpy(rng.uniform(0, 100, n))
    live = torch.ones(n, dtype=torch.bool)
    layout = TS.layout_from_sorted_keys([keys], live, n)
    s, valid = layout.sum(values, live)
    assert bool(valid.all())
    assert torch.equal(s, values)
    ints = torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))
    s, _ = layout.sum(ints, live)
    assert torch.equal(s, ints)      # integers: exact prefix differences
