"""GROUPING SETS / ROLLUP / CUBE (a union of aggregates) and mixed DISTINCT
aggregates: the six cases of tests/test_grouping_sets.py through
ballista_tpu_torch on the CPU and ballista_tpu on JAX-CPU, and ROLLUP and
CUBE over TPC-H keys at SF 0.01. Every comparison is exact: the result
rows as a multiset where no ORDER BY fixes the order, row by row where
one does."""

from collections import Counter

import pyarrow as pa
import pytest
import torch

from ballista_tpu.batch import to_numpy
from ballista_tpu_torch.batch import to_numpy as port_to_numpy
from test_torch_stats_aggs import both, same_sql
from test_torch_tpch_six import _contexts

torch.set_num_threads(2)

SALES = pa.table({
    "region": pa.array(["e", "e", "w", "w", "w"]),
    "prod": pa.array(["x", "y", "x", "x", "y"]),
    "amt": pa.array([1, 2, 4, 8, 16], pa.int64()),
})
MIXED = pa.table({
    "g": pa.array(["a", "a", "a", "b", "b"]),
    "x": pa.array([1, 1, 2, 3, None], pa.int64()),
    "v": pa.array([10, 20, 30, 40, 50], pa.int64()),
})
ALL_NULL = pa.table({
    "g": pa.array(["b", "b"]),
    "x": pa.array([None, None], pa.int64()),
})


@pytest.fixture(scope="module")
def ctxs():
    return both({"s": SALES, "t": MIXED, "n": ALL_NULL})


def _rows(columns):
    """{name: (values, validity)} -> Counter of row tuples, None for NULL."""
    cols = [[v.item() if hasattr(v, "item") and o else (v if o else None)
             for v, o in zip(*columns[name])] for name in columns]
    return Counter(zip(*cols))


def same_rows(ctxs, sql):
    """Both packages give the same multiset of rows and the same schema."""
    jctx, tctx = ctxs
    jbatch, jschema = jctx.sql(sql).collect()
    tbatch, tschema = tctx.sql(sql).collect()
    assert [(f.name, repr(f.dtype)) for f in tschema.fields] == \
        [(f.name, repr(f.dtype)) for f in jschema.fields]
    got = _rows(port_to_numpy(tbatch, tschema))
    assert got == _rows(to_numpy(jbatch, jschema))
    return got


def test_rollup(ctxs):
    got = same_rows(ctxs, """
      select region, prod, sum(amt) as s, count(*) as c
      from s group by rollup(region, prod)""")
    assert got == Counter([
        ("e", "x", 1, 1), ("e", "y", 2, 1), ("e", None, 3, 2),
        ("w", "x", 12, 2), ("w", "y", 16, 1), ("w", None, 28, 3),
        (None, None, 31, 5)])


def test_cube(ctxs):
    got = same_rows(ctxs, "select region, prod, sum(amt) as s from s "
                          "group by cube(region, prod)")
    assert got == Counter([
        ("e", "x", 1), ("e", "y", 2), ("e", None, 3),
        ("w", "x", 12), ("w", "y", 16), ("w", None, 28),
        (None, "x", 13), (None, "y", 18), (None, None, 31)])


def test_grouping_sets_with_having(ctxs):
    got = same_rows(ctxs, """
      select region, prod, sum(amt) as s
      from s group by grouping sets ((region), (prod), ())
      having sum(amt) > 3""")
    assert got == Counter([("w", None, 28), (None, "x", 13), (None, "y", 18),
                           (None, None, 31)])


def test_grouping_sets_order_by(ctxs):
    got = same_sql(ctxs, """
      select region, sum(amt) as s from s group by grouping sets ((region), ())
      order by s desc""", 0)
    assert list(got["s"][0]) == [31, 28, 3]


def test_mixed_distinct_aggregates(ctxs):
    got = same_sql(ctxs, """
      select g, count(distinct x) as cd, sum(v) as sv, count(*) as c,
             avg(v) as av, min(v) as mn, sum(distinct x) as sd
      from t group by g order by g""", 0)
    assert list(got["cd"][0]) == [2, 1]
    assert list(got["sv"][0]) == [60, 90]
    assert list(got["c"][0]) == [3, 2]
    assert list(got["av"][0]) == [20.0, 45.0]
    assert list(got["mn"][0]) == [10, 40]
    assert list(got["sd"][0]) == [3, 3]


def test_distinct_agg_nulls_skipped(ctxs):
    got = same_sql(ctxs, "select g, count(distinct x) cd from n group by g", 0)
    assert list(got["cd"][0]) == [0]


@pytest.fixture(scope="module")
def tpch():
    return _contexts(0.01, ["lineitem", "orders", "customer", "nation"])


TPCH = {
    # ROLLUP over a join
    "rollup_join": ("""
        select n_name, o_orderpriority, count(*) as n,
               sum(o_totalprice) as total
        from orders, customer, nation
        where o_custkey = c_custkey and c_nationkey = n_nationkey
          and n_regionkey = 1
        group by rollup(n_name, o_orderpriority)""", 5 * 5 + 5 + 1),
    # CUBE over two dictionary keys
    "cube_two_keys": ("""
        select l_shipmode, l_returnflag, sum(l_quantity) as q,
               avg(l_discount) as d, max(l_shipdate) as last_ship
        from lineitem group by cube(l_shipmode, l_returnflag)""",
        7 * 3 + 7 + 3 + 1),
    "grouping_sets_having_order": ("""
        select l_linestatus, l_returnflag, count(*) as n
        from lineitem
        group by grouping sets ((l_linestatus), (l_returnflag), ())
        having count(*) > 20000 order by n desc""", None),
}


@pytest.mark.parametrize("name", sorted(TPCH))
def test_tpch_grouping_sets(tpch, name):
    sql, n_rows = TPCH[name]
    got = same_rows(tpch, sql)
    assert sum(got.values()) == (n_rows or sum(got.values())) > 0
