"""`SessionContext.converge` (the plan that ran without overflow, re-runnable
with `run_plan`) and `exec.cse.cse_tree` (structurally identical subtrees
shared and evaluated once per run), in ballista_tpu_torch on the CPU.
Answers are held exactly against ballista_tpu on JAX-CPU."""

import numpy as np
import pytest
import torch

from ballista_tpu.benchmarks import h2o as ref_h2o
from ballista_tpu_torch.benchmarks import TPCH_QUERIES, h2o
from ballista_tpu_torch.client import SessionContext, context
from ballista_tpu_torch.datagen import register_tpch
from ballista_tpu_torch.exec import plan as TP
from ballista_tpu_torch.exec.cse import cse_tree
from ballista_tpu_torch.exec.plan import Run, _next_pow2, run_plan
from ballista_tpu_torch.planner.physical import PhysicalOptions
from test_torch_h2o import _both, _register
from test_torch_tpch_six import _assert_same, _contexts, _same_sql

torch.set_num_threads(2)

SF = 0.01


@pytest.fixture(scope="module")
def contexts():
    return _contexts(0.02, ["supplier", "lineitem", "orders", "nation",
                            "part", "partsupp"])


def _nodes(root):
    """(distinct node objects, nodes of the tree with shared ones repeated)."""
    seen, total = {}, 0
    stack = [root]
    while stack:
        n = stack.pop()
        total += 1
        seen[id(n)] = n
        stack.extend(n.children)
    return list(seen.values()), total


def test_converge_returns_a_plan_that_reruns_without_overflow():
    """Q13 with the expanding join's output forced too small: converge
    retries as collect does, and the plan it returns runs again, without
    planning and without overflow, to the same batch."""
    jctx, _ = _contexts(SF, ["customer", "orders"])
    sql = TPCH_QUERIES[13]
    jbatch, jschema = jctx.sql(sql).collect()
    tctx = SessionContext(device="cpu",
                          options=PhysicalOptions(join_out_factor=1 / 64))
    register_tpch(tctx, SF, tables=["customer", "orders"])
    df = tctx.sql(sql)
    exec_plan, inputs, out = df.converge()
    _assert_same(out, exec_plan.schema, jbatch, jschema)
    warnings = list(tctx.warnings)
    # the run counted the join's need: 1/64 grows to 1 in one re-run
    assert len(warnings) == 1 and "join_out_factor 0.015625" in warnings[0]
    assert "join 64x" in warnings[0]
    join = next(n for n in _nodes(exec_plan)[0]
                if isinstance(n, TP.HashJoinExec))
    first = next(n for n in _nodes(tctx.physical_plan(df.plan))[0]
                 if isinstance(n, TP.HashJoinExec))
    assert join.out_capacity > first.out_capacity
    for _ in range(2):
        again, overflow = run_plan(exec_plan, inputs)
        assert overflow is not None and not bool(overflow)
        _assert_same(again, exec_plan.schema, jbatch, jschema)
    assert tctx.warnings == warnings          # re-running plans nothing
    # collect is a thin caller: the same warnings, word for word
    tctx.warnings.clear()
    batch, schema = df.collect()
    _assert_same(batch, schema, jbatch, jschema)
    assert tctx.warnings == warnings
    with pytest.raises(RuntimeError, match=r"overflowed capacity after 1 "
                       r"runs \(last max_group_table 2097152, "
                       r"join_out_factor 0.015625\)"):
        tctx.converge(df.plan, max_retries=1)


def _planned(ctx):
    """The PhysicalOptions of each plan `ctx` builds from here on."""
    seen, plan = [], ctx.physical_plan
    ctx.physical_plan = lambda p, options=None: (seen.append(options),
                                                 plan(p, options))[1]
    return seen


def _reads(monkeypatch):
    """Every tensor `converge` reads on the host from here on."""
    seen, read = [], context._read
    monkeypatch.setattr(context, "_read",
                        lambda t: (seen.append(t), read(t))[1])
    return seen


def test_one_group_per_row_converges_in_one_rerun(monkeypatch):
    """h2o q10 has one group per row. The run over a table of 2^10 slots
    counts them, and the one re-run takes the table to 2^10 times the
    power of two at or above the need over 2^10 (4x steps would take
    three re-runs)."""
    n = 20_000
    jctx, tctx = _register({"x": ref_h2o.groupby_table(n)},
                           {"x": h2o.groupby_table(n)})
    tctx.options = PhysicalOptions(max_group_table=1 << 10)
    planned, reads = _planned(tctx), _reads(monkeypatch)
    exec_plan, _, out = tctx.sql(h2o.GROUPBY_QUERIES[10]).converge()
    need = int(out.num_rows)
    assert need > 16 << 10
    assert [o.max_group_table for o in planned] == \
        [1 << 10, (1 << 10) * _next_pow2(-(-need // (1 << 10)))]
    (agg,) = _aggs(exec_plan)
    assert agg.table_size == planned[-1].max_group_table
    assert len(tctx.take_warnings()) == 1
    # the verdict of each run, and the growth of the one that overflowed
    assert [r.dim() for r in reads] == [0, 1, 0]
    _both(jctx, tctx, h2o.GROUPBY_QUERIES[10],
          ["id1", "id2", "id3", "id4", "id5", "id6"])


# a group table feeding an expanding join: while the aggregate is clipped
# the join counts its need from the rows it was given
CHAINED = """select a.o_custkey, count(*) as n
from (select o_custkey, o_orderpriority from orders
      group by o_custkey, o_orderpriority) a
join orders o on a.o_custkey = o.o_custkey
group by a.o_custkey order by a.o_custkey"""


@pytest.fixture(scope="module")
def orders():
    jctx, _ = _contexts(SF, ["orders"])
    return jctx.sql(CHAINED).collect()


def _orders_context(options):
    tctx = SessionContext(device="cpu", options=options)
    register_tpch(tctx, SF, tables=["orders"])
    return tctx


def test_group_overflow_grows_joins_by_the_minimum(orders):
    """Only the group table overflowed: join_out_factor grows by
    grow_capacities' least step, 4x, and the join then fits."""
    tctx = _orders_context(PhysicalOptions(max_group_table=16))
    planned = _planned(tctx)
    exec_plan, _, out = tctx.sql(CHAINED).converge()
    _assert_same(out, exec_plan.schema, *orders)
    (warning,) = tctx.take_warnings()
    assert warning.endswith("join 4x (need 1x)")
    assert [o.join_out_factor for o in planned] == [1.0, 4.0]
    assert planned[1].max_group_table > 4 * 16


def test_clipped_aggregate_feeding_a_join_converges(orders):
    """The first run clips the aggregate, so its join fits what it was
    given; the second, with the table grown to the need, overflows the
    join, and the third fits: each step sized from what its run counted."""
    tctx = _orders_context(PhysicalOptions(max_group_table=16,
                                           join_out_factor=1 / 16))
    planned = _planned(tctx)
    exec_plan, _, out = tctx.sql(CHAINED).converge()
    _assert_same(out, exec_plan.schema, *orders)
    first, second = tctx.take_warnings()
    assert "join 4x (need 1x)" in first
    assert "growth group 4x (need 1x)" in second
    assert len(planned) == 3
    assert planned[2].join_out_factor > 4 * planned[1].join_out_factor


def test_a_run_that_fits_reads_the_host_once(orders, monkeypatch):
    """A plan that could overflow and did not: one read, its verdict."""
    tctx = _orders_context(PhysicalOptions(join_out_factor=4.0))
    reads = _reads(monkeypatch)
    exec_plan, _, out = tctx.sql(CHAINED).converge()
    _assert_same(out, exec_plan.schema, *orders)
    assert not tctx.warnings
    assert [r.dim() for r in reads] == [0]


def test_q21_shared_nodes_evaluate_once(contexts):
    """Q21 reads lineitem's (l_orderkey, l_suppkey, l_commitdate,
    l_receiptdate) scan twice; after cse_tree it is one node with two
    parents, and a run evaluates every distinct node exactly once."""
    jctx, tctx = contexts
    plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[21]).plan)
    distinct, total = _nodes(plan)
    shared = [n for n in distinct if n.n_parents > 1]
    assert len(distinct) < total and shared
    assert all(n.n_parents == 2 for n in shared)
    inputs = tctx.bind_inputs([leaf.input_id for leaf in plan.leaves()])
    calls = []
    run = Run(inputs)
    for n in distinct:
        n.evaluate = (lambda r, _n=n, _e=n.evaluate:
                      (calls.append(id(_n)), _e(r))[1])
    out = run.eval(plan)
    assert run.evaluated == len(calls) == len(distinct)
    assert len(set(calls)) == len(calls)
    assert run._shared == {}      # every shared output was handed on and dropped
    assert int(out.num_rows) > 0
    assert _same_sql(jctx, tctx, TPCH_QUERIES[21]) > 0


# query -> (distinct nodes, nodes of the tree it was lowered to)
SHARED = {2: (29, 31), 7: (22, 23), 16: (17, 20), 18: (17, 18), 21: (27, 28)}


@pytest.mark.parametrize("q", sorted(SHARED))
def test_tpch_plans_share_subtrees(q):
    """The TPC-H plans in which cse_tree finds something to share, and how
    much: evaluate calls per run fall from the second count to the first."""
    tctx = SessionContext(device="cpu")
    register_tpch(tctx, SF)
    plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[q]).plan)
    distinct, total = _nodes(plan)
    assert (len(distinct), total) == SHARED[q]
    assert any(n.n_parents > 1 for n in distinct)


def test_q16_shared_chain(contexts):
    """Q16's NOT IN plans its subquery three times (the anti join and the
    two counts of the three-valued test): one chain after cse_tree."""
    jctx, tctx = contexts
    plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[16]).plan)
    distinct, total = _nodes(plan)
    chains = [n for n in distinct if n.n_parents > 1 and n.children]
    assert chains and total - len(distinct) >= 2
    assert _same_sql(jctx, tctx, TPCH_QUERIES[16]) > 0


AGG = ("select l_suppkey as k, {agg} as s from lineitem {where} "
       "group by l_suppkey")


def _union(tctx, left, right):
    sql = f"select k, s from ({left}) a union all select k, s from ({right}) b"
    return tctx.sql(sql), tctx.physical_plan(tctx.sql(sql).plan)


def _aggs(plan):
    return [n for n in _nodes(plan)[0] if isinstance(n, TP.HashAggregateExec)]


def test_identical_aggregates_merge(contexts):
    jctx, tctx = contexts
    one = AGG.format(agg="sum(l_quantity)", where="where l_quantity < 10")
    df, plan = _union(tctx, one, one)
    (agg,) = _aggs(plan)
    assert agg.pre_filter is not None
    # the topmost node of the shared chain is the one with two parents
    (top,) = [n for n in _nodes(plan)[0] if n.n_parents > 1]
    assert agg in _nodes(top)[0]
    inputs = tctx.bind_inputs([leaf.input_id for leaf in plan.leaves()])
    run = Run(inputs)
    out = run.eval(plan)
    assert run.evaluated == len(_nodes(plan)[0])
    assert int(out.num_rows) == 2 * int(run_plan(agg, inputs)[0].num_rows)
    sql = (f"select k, s from ({one}) a union all select k, s from ({one}) b "
           "order by k, s")
    assert _same_sql(jctx, tctx, sql) > 0


def _lineitem(tctx):
    return {n: h.values for n, h in tctx.tables["lineitem"].host.items()}


# pairs that a key made of display names would merge (the same output names
# over a different filter, CASE, IN list or BETWEEN), each with its numpy
# answer: (left sql, right sql, per-row weight of the left, of the right).
# Quantities are decimal(15,2): 10 is 1000.
DIFFERENT = {
    "pre_filter": (AGG.format(agg="sum(l_quantity)",
                              where="where l_quantity < 10"),
                   AGG.format(agg="sum(l_quantity)",
                              where="where l_quantity < 20"),
                   lambda t: t["l_quantity"] * (t["l_quantity"] < 1000),
                   lambda t: t["l_quantity"] * (t["l_quantity"] < 2000)),
    "case": (AGG.format(agg="sum(case when l_quantity < 10 then 1 else 0 end)",
                        where=""),
             AGG.format(agg="sum(case when l_quantity < 20 then 1 else 0 end)",
                        where=""),
             lambda t: t["l_quantity"] < 1000,
             lambda t: t["l_quantity"] < 2000),
    "in_list": (AGG.format(agg="count(*)",
                           where="where l_linenumber in (1, 2)"),
                AGG.format(agg="count(*)",
                           where="where l_linenumber in (1, 3)"),
                lambda t: np.isin(t["l_linenumber"], (1, 2)),
                lambda t: np.isin(t["l_linenumber"], (1, 3))),
    "between": (AGG.format(agg="count(*)",
                           where="where l_quantity between 1 and 5"),
                AGG.format(agg="count(*)",
                           where="where l_quantity between 1 and 9"),
                lambda t: (t["l_quantity"] >= 100) & (t["l_quantity"] <= 500),
                lambda t: (t["l_quantity"] >= 100) & (t["l_quantity"] <= 900)),
}


@pytest.mark.parametrize("name", sorted(DIFFERENT))
def test_different_aggregates_do_not_merge(contexts, name):
    """Held against numpy: the reference's own key tells nodes apart by
    display names and merges all of these pairs but the first."""
    _, tctx = contexts
    left, right, wl, wr = DIFFERENT[name]
    df, plan = _union(tctx, left, right)
    aggs = _aggs(plan)
    assert len(aggs) == 2
    assert all(n.n_parents == 1 for n in _nodes(plan)[0] if n.children)
    t = _lineitem(tctx)
    got = df.to_numpy()
    rows = sorted(zip(got["k"][0].tolist(), got["s"][0].tolist()))
    want = []
    for w in (wl, wr):
        weight = w(t).astype(np.int64)
        sums = np.bincount(t["l_suppkey"], weights=weight).astype(np.int64)
        seen = np.bincount(t["l_suppkey"], weights=weight != 0) > 0
        if "where" not in left:     # no filter: every supplier has a row
            seen = np.bincount(t["l_suppkey"]) > 0
        want += [(int(k), int(sums[k])) for k in np.nonzero(seen)[0]]
    assert got["s"][1].all() and rows == sorted(want)


def test_limit_offset_and_join_filters_reach_the_key(contexts):
    _, tctx = contexts
    scan = "select o_orderkey as k from orders order by o_orderkey"
    _, plan = _union(
        tctx, f"select k, k as s from ({scan} limit 5) x",
        f"select k, k as s from ({scan} limit 5 offset 5) x")
    limits = [n for n in _nodes(plan)[0] if isinstance(n, TP.LimitExec)]
    assert len(limits) == 2
    got = tctx.sql(f"select k from ({scan} limit 5) x union all "
                   f"select k from ({scan} limit 5 offset 5) y").to_numpy()
    assert len(set(got["k"][0])) == 10
    join = ("select o_orderkey as k, l_quantity as s from orders, lineitem "
            "where o_orderkey = l_orderkey and l_quantity < {q}")
    _, plan = _union(tctx, join.format(q=3), join.format(q=4))
    joins = [n for n in _nodes(plan)[0] if isinstance(n, TP.HashJoinExec)]
    assert len(joins) == 2
    filters = {(repr(j.build_pre_filter), repr(j.probe_pre_filter))
               for j in joins}
    assert len(filters) == 2


def test_shared_node_flags_overflow_once(contexts):
    """A shared aggregate whose table is too small raises the run's
    overflow flag once, not once per parent."""
    _, tctx = contexts
    small = SessionContext(device="cpu",
                           options=PhysicalOptions(max_group_table=16))
    small.tables = tctx.tables
    one = AGG.format(agg="sum(l_quantity)", where="")
    _, plan = _union(small, one, one)
    (agg,) = _aggs(plan)
    assert [n.n_parents for n in _nodes(plan)[0] if n.n_parents > 1] == [2]
    inputs = small.bind_inputs([leaf.input_id for leaf in plan.leaves()])
    run = Run(inputs)
    run.eval(plan)
    assert len(run.flags) == 1 and bool(run.flags[0])


def test_cse_tree_is_idempotent(contexts):
    _, tctx = contexts
    plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[16]).plan)
    before = [(id(n), n.n_parents) for n in _nodes(plan)[0]]
    assert cse_tree(plan) is plan
    assert [(id(n), n.n_parents) for n in _nodes(plan)[0]] == before
