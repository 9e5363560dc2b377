"""The port's parity files share pytest workers with the JAX package's own
tests, and `tests/test_evict.py` counts every live JAX array of its
process. A parity file must therefore keep no JAX buffer alive past its
own tests: what it caches of the JAX package's answers are host copies.

Each case runs a file's worth of the JAX package's answers through
`test_torch_wide_reads._jax` (the answers the file caches at module
level), then counts the live JAX arrays with the cache full and again
after it is cleared: the cache may hold none of them."""

import gc

import jax
import numpy as np
import pytest

import test_torch_wide_reads as wide_reads


def _live():
    gc.collect()
    return len(jax.live_arrays())


@pytest.mark.parametrize("table", ["eight", "big"])
def test_wide_reads_cache_holds_no_jax_buffer(table):
    saved = dict(wide_reads._jax_cache)
    wide_reads._jax_cache.clear()
    try:
        for name, sql in wide_reads.CASES:
            if name == table:
                wide_reads._jax(name, sql)
        assert wide_reads._jax_cache
        for columns, _types in wide_reads._jax_cache.values():
            for col in columns.values():
                assert all(a.base is None and a.flags.owndata for a in col)
        held = _live()
        wide_reads._jax_cache.clear()
        assert held == _live()
    finally:
        wide_reads._jax_cache.clear()
        wide_reads._jax_cache.update(saved)


def test_host_copy_keeps_values_and_drops_views():
    x = jax.numpy.arange(6, dtype=jax.numpy.int64)
    view = np.asarray(x)[:4]
    copied = wide_reads._host_copy({"c": (view, view > 1)})["c"]
    assert copied[0].tolist() == [0, 1, 2, 3]
    assert copied[1].tolist() == [False, False, True, True]
    assert all(a.base is None for a in copied)
