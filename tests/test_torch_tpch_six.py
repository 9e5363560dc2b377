"""The rest of the six-table TPC-H queries end to end: SQL through
ballista_tpu_torch's SessionContext on the CPU against ballista_tpu's on
JAX-CPU, over the same tables (seed 19940101). Q4, Q6, Q7, Q10, Q12, Q13,
Q15, Q18 and Q22 at SF 0.01, Q21 at SF 0.02, where its answer is not
empty; the expanding join's overflow retry, views, and outer joins over a
filtered probe side. Every comparison is exact: int64 values, validity and
decoded strings, row by row in the order ORDER BY fixes."""

import numpy as np
import pytest
import torch

from ballista_tpu.batch import to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu_torch.batch import to_numpy as port_to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, generate_tpch, register_tpch
from ballista_tpu_torch.planner.physical import PhysicalOptions

torch.set_num_threads(2)

SF = 0.01
Q21_SF = 0.02        # Q21 is empty at SF 0.01 and below
SIX = (4, 6, 7, 10, 12, 13, 15, 18, 22)


def _contexts(sf, tables):
    jctx = JaxContext(capacity_mode="exact")
    for name in tables:
        jctx.register_arrow(name, generate_table(name, sf),
                            primary_key=REF_TABLES[name][1])
    tctx = SessionContext(device="cpu")
    register_tpch(tctx, sf, tables=tables)
    return jctx, tctx


@pytest.fixture(scope="module")
def contexts():
    return _contexts(SF, list(TPCH_TABLES))


def _assert_same(tbatch, tschema, jbatch, jschema):
    assert [f.name for f in tschema.fields] == [f.name for f in jschema.fields]
    assert [repr(f.dtype) for f in tschema.fields] == \
        [repr(f.dtype) for f in jschema.fields]
    assert int(tbatch.num_rows) == int(jbatch.num_rows)
    got, want = port_to_numpy(tbatch, tschema), to_numpy(jbatch, jschema)
    for name in want:
        wv, wvalid = want[name]
        gv, gvalid = got[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
        np.testing.assert_array_equal(gv[gvalid], wv[wvalid], err_msg=name)


def _same_sql(jctx, tctx, sql):
    jbatch, jschema = jctx.sql(sql).collect()
    tbatch, tschema = tctx.sql(sql).collect()
    _assert_same(tbatch, tschema, jbatch, jschema)
    return int(tbatch.num_rows)


@pytest.mark.parametrize("q", SIX)
def test_query_matches_jax(contexts, q):
    jctx, tctx = contexts
    assert _same_sql(jctx, tctx, TPCH_QUERIES[q]) > 0


def test_q21_nonempty_matches_jax():
    jctx, tctx = _contexts(Q21_SF, ["supplier", "lineitem", "orders",
                                    "nation"])
    assert _same_sql(jctx, tctx, TPCH_QUERIES[21]) > 0


def test_plans_take_the_new_paths(contexts):
    _, tctx = contexts

    def labels(q):
        plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[q]).plan).display()
        return [line.strip() for line in plan.splitlines()]

    # Q13: customer preserved, orders a duplicate-key build
    assert any(x.startswith("HashJoinExec[left_outer,expanding]")
               for x in labels(13))
    # Q6 and Q12 aggregate through the masked layout: no key (T = 1), and
    # l_shipmode's 7 dictionary codes + NULL (T = 8)
    agg6 = next(x for x in labels(6) if x.startswith("HashAggregateExec"))
    assert "T=1)" in agg6
    agg12 = next(x for x in labels(12) if x.startswith("HashAggregateExec"))
    assert "T=8)" in agg12


def test_expanding_join_overflow_retries(contexts):
    """An expanding join whose output capacity is forced too small raises
    the overflow flag; the port retries with join_out_factor grown to the
    rows the run counted and returns the JAX answer, never a clipped
    batch."""
    jctx, _ = contexts
    sql = TPCH_QUERIES[13]
    jbatch, jschema = jctx.sql(sql).collect()
    tctx = SessionContext(device="cpu",
                          options=PhysicalOptions(join_out_factor=1 / 64))
    register_tpch(tctx, SF, tables=["customer", "orders"])
    tbatch, tschema = tctx.sql(sql).collect()
    _assert_same(tbatch, tschema, jbatch, jschema)
    assert len(tctx.warnings) == 1   # factor 1/64 overflowed; 1 fit
    assert "join_out_factor 0.015625); growth group 4x" in tctx.warnings[0]
    with pytest.raises(RuntimeError, match="overflowed"):
        tctx.collect(tctx.sql(sql).plan, max_retries=1)


def test_view_script(contexts):
    """CREATE VIEW; a SELECT that reads the view twice (once through a
    scalar subquery folded to a literal); DROP VIEW. The SELECT was
    planned while the view existed; afterwards the name is gone."""
    jctx, tctx = contexts
    sql = """
        create view big_orders (ck, total) as
            select o_custkey, sum(o_totalprice) from orders
            group by o_custkey;
        select c_name, total from customer, big_orders
        where c_custkey = ck
          and total > (select avg(total) from big_orders)
        order by total desc, c_name;
        drop view big_orders"""
    assert _same_sql(jctx, tctx, sql) > 0
    assert tctx.views == {}
    with pytest.raises(KeyError, match="big_orders"):
        tctx.sql("select * from big_orders").collect()


@pytest.mark.parametrize("sql,path", [
    # unique build (customer), orders the filtered probe: FilterExec
    ("""select o_orderkey, c_name from orders left join customer
        on o_custkey = c_custkey where o_orderdate < date '1993-01-01'
        order by o_orderkey""", "unique"),
    # duplicate-key build (orders), customer the filtered probe: the
    # filter rides the probe's live mask
    ("""select c_custkey, o_orderkey from customer left join orders
        on c_custkey = o_custkey where c_nationkey = 3
        order by c_custkey, o_orderkey""", "expanding"),
])
def test_left_outer_filtered_probe_drops_rows(contexts, sql, path):
    """A probe row that fails the WHERE is dropped, not NULL-extended."""
    jctx, tctx = contexts
    plan = tctx.physical_plan(tctx.sql(sql).plan).display()
    assert f"HashJoinExec[left_outer,{path}]" in plan
    if path == "unique":
        assert "FilterExec" in plan
    n = _same_sql(jctx, tctx, sql)
    got = tctx.sql(sql).to_numpy()
    tables = {name: cols for name, (_, cols) in
              generate_tpch(SF, tables=["customer", "orders"]).items()}
    if path == "unique":
        dates = tables["orders"]["o_orderdate"].values
        cutoff = (np.datetime64("1993-01-01") - np.datetime64("1970-01-01")
                  ).astype(int)
        assert n == int((dates < cutoff).sum())
        assert got["c_name"][1].all()   # every order has its customer
    else:
        nk = tables["customer"]["c_nationkey"].values
        assert set(got["c_custkey"][0]) == set(
            tables["customer"]["c_custkey"].values[nk == 3])
        assert not got["o_orderkey"][1].all()   # some customers have none
