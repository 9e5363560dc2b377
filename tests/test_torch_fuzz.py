"""Randomised differential testing of the port: the case generators of
tests/test_fuzz_differential.py (joins on numeric and string keys with
NULLs and per-table dictionaries, IN / NOT IN, multi-key joins, windows,
INTERSECT / EXCEPT) and its two correlated NOT IN cases, every seed
through ballista_tpu_torch on the CPU AND ballista_tpu, the two answers
held equal as pandas frames (exactly), and the port's held against pandas
by the generator's own checks."""

import pandas as pd
import pyarrow as pa
import pytest
import torch

import test_fuzz_differential as ref
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu_torch.client import SessionContext

torch.set_num_threads(2)


class _BothFrames:
    def __init__(self, jdf, tdf, sql):
        self.jdf, self.tdf, self.sql = jdf, tdf, sql

    def to_pandas(self):
        want, got = self.jdf.to_pandas(), self.tdf.to_pandas()
        pd.testing.assert_frame_equal(got, want, obj=self.sql)
        return got


class BothContexts:
    """Stands in for the reference's SessionContext in the generators:
    registers every table in both packages and answers `sql().to_pandas()`
    with the port's frame after holding it equal to the JAX package's."""

    def __init__(self):
        self.jctx = JaxContext(capacity_mode="exact")
        self.tctx = SessionContext(device="cpu")

    def register_arrow(self, name, table, primary_key=None):
        self.jctx.register_arrow(name, table, primary_key)
        self.tctx.register_arrow(name, table, primary_key)

    def register_pandas(self, name, df, primary_key=None):
        self.jctx.register_pandas(name, df, primary_key)
        self.tctx.register_pandas(name, df, primary_key)

    def sql(self, query):
        return _BothFrames(self.jctx.sql(query), self.tctx.sql(query), query)


@pytest.fixture(autouse=True)
def both_packages(monkeypatch):
    monkeypatch.setattr(ref, "SessionContext", BothContexts)


@pytest.mark.parametrize("seed", range(12))
def test_differential(seed):
    ref.run_case(seed)


@pytest.mark.parametrize("seed", range(8))
def test_differential_semi_anti(seed):
    ref.run_semi_case(seed)


@pytest.mark.parametrize("seed", range(8))
def test_differential_multikey(seed):
    ref.run_multikey_case(seed)


@pytest.mark.parametrize("seed", range(6))
def test_differential_windows(seed):
    ref.run_window_case(seed)


@pytest.mark.parametrize("seed", range(8))
def test_differential_setops(seed):
    ref.run_setop_case(seed)


def test_correlated_not_in_nulls():
    """Correlated NOT IN: groups containing NULL drop every row; empty
    groups (incl. NULL outer corr keys) keep every row; NULL lhs never
    qualifies against a non-empty group."""
    ctx = BothContexts()
    ctx.register_arrow("a", pa.table({"k": [1, 1, 2, 2, 3, 2, None],
                                      "x": [10, 99, 10, 20, 5, None, 1]}))
    ctx.register_arrow("b", pa.table({"bk": [1, 1, 2, 2],
                                      "y": [10, None, 10, 30]}))
    r = ctx.sql("select k, x from a where x not in "
                "(select y from b where b.bk = a.k) order by k, x"
                ).to_pandas()
    assert r.fillna(-1).values.tolist() == [[2, 20], [3, 5], [-1, 1]], r


def test_correlated_not_in_residual_nulls():
    """Correlated NOT IN with a non-equi residual: the residual restricts
    the group before the three-valued rules apply."""
    ctx = BothContexts()
    ctx.register_arrow("a", pa.table({
        "id": [1, 2, 3, 4, 5, 6, 7],
        "k":  [1, 1, 2, 2, 3, 2, None],
        "z":  [5, 5, 5, 5, 5, 5, 5],
        "x":  [10, 99, 10, 20, 5, None, 1]}))
    ctx.register_arrow("b", pa.table({
        "bk": [1, 1, 2, 2, 2],
        "w":  [0, 0, 0, 0, 9],
        "y":  [10, None, 10, 30, 77]}))
    r = ctx.sql("select k, x from a where x not in "
                "(select y from b where b.bk = a.k and b.w < a.z) "
                "order by k, x").to_pandas()
    assert r.fillna(-1).values.tolist() == [[2, 20], [3, 5], [-1, 1]], r
    r2 = ctx.sql("select k, x from a where x not in "
                 "(select y from b where b.bk = a.k and y > a.z) "
                 "order by k, x").to_pandas()
    assert r2.fillna(-1).values.tolist() == \
        [[1, 99], [2, 20], [3, 5], [-1, 1]], r2
