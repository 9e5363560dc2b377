"""The partitioned runtime against the JAX package: the cases of
tests/test_distributed.py and tests/test_skew.py, the port on 8 CPU
partitions (`make_mesh(8, devices=[cpu] * 8)`), the JAX package on its
virtual 8-device mesh (tests/conftest.py).

- the 22 TPC-H queries at SF 0.002 through `execute_distributed`, equal to
  the JAX package's local answers;
- Q1, Q3, Q11, Q13, Q18 and Q21 also against the JAX DistributedRuntime
  on the same stage plan: the answer, and every stage's output rows (the
  port's run lowers the plan again with the rows each stage sent; the JAX
  runtime runs the static plan);
- the full outer join, window, cross join, EXCEPT ALL and group-bound
  cases;
- the skew cases, with the sequence of options the overflow retries take
  equal to the JAX package's.

Tolerances: validity, integers, decimals, dates and strings exact, row by
row; f64 at rtol 1e-9 (a distributed run adds partial sums in another
order)."""

import dataclasses

import numpy as np
import pyarrow as pa
import pytest
import torch

import ballista_tpu.scheduler.runtime as jruntime
from ballista_tpu.batch import to_numpy as jax_to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.client.context import _rebind_scans as jax_rebind
from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ballista_tpu.planner.optimizer import (prune_columns as jax_prune,
                                            reduce_group_keys as jax_reduce)
from ballista_tpu.scheduler.distributed_planner import (
    DistOptions as JaxDistOptions, DistributedPlanner as JaxPlanner)
from ballista_tpu_torch.batch import to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.context import rebind_scans
from ballista_tpu_torch.datagen import TPCH_TABLES, register_tpch
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.planner.optimizer import (prune_columns,
                                                  reduce_group_keys)
from ballista_tpu_torch.scheduler.distributed_planner import (
    DistOptions, DistributedPlanner)
from ballista_tpu_torch.scheduler.runtime import (DistributedRuntime,
                                                  execute_distributed)
from ballista_tpu_torch.scheduler.standalone import JobContext

torch.set_num_threads(2)

SF = 0.002
P = 8
F64_RTOL = 1e-9
CPU8 = [torch.device("cpu")] * P


def cpu_mesh(n=P):
    return make_mesh(n, devices=[torch.device("cpu")] * n)


@pytest.fixture(scope="module")
def env():
    jctx = JaxContext(capacity_mode="exact")
    for name in TPCH_TABLES:
        jctx.register_arrow(name, generate_table(name, SF),
                            primary_key=REF_TABLES[name][1])
    tctx = SessionContext(device="cpu")
    register_tpch(tctx, SF)
    return jctx, tctx


def assert_same(got, want, want_to_numpy=jax_to_numpy):
    """A port answer (batch, schema) against a JAX one (or, with
    `want_to_numpy=to_numpy`, another port answer): names, row count and
    validity equal; f64 at rtol 1e-9, everything else exact."""
    (gb, gs), (wb, ws) = got, want
    assert [f.name for f in gs.fields] == [f.name for f in ws.fields]
    assert int(gb.num_rows) == int(wb.num_rows)
    g, w = to_numpy(gb, gs), want_to_numpy(wb, ws)
    for name in w:
        np.testing.assert_array_equal(g[name][1], w[name][1], err_msg=name)
        gv, wv = g[name][0][g[name][1]], w[name][0][w[name][1]]
        if wv.dtype.kind == "f":
            np.testing.assert_allclose(gv, wv, rtol=F64_RTOL, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=name)


def run_distributed(ctx, sql, options=None, n=P):
    return execute_distributed(ctx, ctx.sql(sql).plan, cpu_mesh(n),
                               options or DistOptions(n_partitions=n))


def test_stage_decomposition_q1(env):
    _, tctx = env
    dplan = DistributedPlanner(tctx, DistOptions(n_partitions=P)).plan(
        tctx.sql(TPCH_QUERIES[1]).plan)
    labels = [s.root._label() for s in dplan.stages]
    assert len(dplan.stages) == 3, dplan.display()
    assert "ExchangeExec" in labels[0]
    assert "GatherExec" in labels[1]
    assert "PartitionPruneExec" in labels[2]


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_matches_jax_local(env, q):
    jctx, tctx = env
    got = run_distributed(tctx, TPCH_QUERIES[q])
    assert_same(got, jctx.sql(TPCH_QUERIES[q]).collect())
    assert len(tctx.dist_metrics) >= 2
    assert all(m.partitions == P for m in tctx.dist_metrics)


def _jax_stage_run(jctx, sql):
    plan = jax_prune(jax_reduce(jax_rebind(jctx.sql(sql).plan, jctx)))
    opts = JaxDistOptions(n_partitions=P)
    dplan = JaxPlanner(jctx, opts).plan(plan)
    rt = jruntime.DistributedRuntime(jctx, jax_make_mesh(P), opts)
    out = rt.execute(dplan)
    return out, dplan, rt.metrics


def _port_stage_run(tctx, sql):
    """The port's answer through `execute_distributed`, its first stage
    plan and its StageMetrics by stage id."""
    plan = prune_columns(reduce_group_keys(rebind_scans(tctx.sql(sql).plan,
                                                        tctx)))
    opts = DistOptions(n_partitions=P)
    dplan = DistributedPlanner(tctx, opts).plan(plan)
    out = execute_distributed(tctx, plan, cpu_mesh(), opts)
    assert len(tctx.dist_attempts) == 1
    return out, dplan, dict(enumerate(tctx.dist_metrics))


@pytest.mark.parametrize("q", [1, 3, 11, 13, 18, 21])
def test_stage_rows_match_jax_runtime(env, q):
    """The same stage plan through both runtimes: every stage's output
    rows (summed over the partitions; a gather's P copies count P times,
    as in the reference) and the answer."""
    jctx, tctx = env
    jout, jplan, jmetrics = _jax_stage_run(jctx, TPCH_QUERIES[q])
    tout, tplan, tmetrics = _port_stage_run(tctx, TPCH_QUERIES[q])
    assert [s.root._label().split("(")[0] for s in tplan.stages] == \
        [s.root._label().split("(")[0] for s in jplan.stages]
    assert {k: m.output_rows for k, m in tmetrics.items()} == \
        {k: m.output_rows for k, m in jmetrics.items()}
    assert_same(tout, jout)


@pytest.mark.parametrize("q", [3, 9, 18, 21])
def test_relowered_leaves_within_static_plan(env, q):
    """A job lowers the plan again before each stage with the rows the
    stages before it sent: it answers as the JAX package does, through
    the stages of the static plan, and no leaf reading a stage is larger
    than the static plan's (some are smaller)."""
    jctx, tctx = env
    plan = prune_columns(reduce_group_keys(rebind_scans(
        tctx.sql(TPCH_QUERIES[q]).plan, tctx)))
    rt = DistributedRuntime(tctx, cpu_mesh(), DistOptions(n_partitions=P))
    static_plan = DistributedPlanner(tctx, rt.opts).plan(plan)
    jc = JobContext("relowered", rt, tctx, plan,
                    DistributedPlanner(tctx, rt.opts))
    assert_same(jc.run(), jctx.sql(TPCH_QUERIES[q]).collect())
    assert len(jc.attempts) == 1

    def leaves(dplan):
        return [sorted((leaf.input_id, leaf.capacity)
                       for leaf in s.root.leaves()) for s in dplan.stages]

    shrunk = 0
    assert len(jc.dplan.stages) == len(static_plan.stages)
    for got, want in zip(leaves(jc.dplan), leaves(static_plan)):
        assert [i for i, _ in got] == [i for i, _ in want]
        assert all(g <= w for (_, g), (_, w) in zip(got, want))
        shrunk += sum(g < w for (_, g), (_, w) in zip(got, want))
    assert shrunk > 0


def test_from_less_rows_on_the_partition_device(env):
    """A FROM-less row is made on the device of the run's partition (a
    mesh of several cards puts each partition on its own), and a
    FROM-less query answers as the JAX package's."""
    from ballista_tpu_torch.exec.plan import OneRowExec, Run
    row = OneRowExec(torch.device("meta")).evaluate(
        Run({}, partition=3, device=torch.device("cpu")))
    assert row.device == torch.device("cpu") and int(row.num_rows) == 1
    jctx, tctx = env
    sql = "select 1 + 2 as x, 'a' as s"
    assert_same(run_distributed(tctx, sql), jctx.sql(sql).collect())


def test_full_outer_join(env):
    """FULL OUTER over the shuffle path: unmatched build rows appear once
    across partitions (broadcast is refused for full)."""
    jctx, tctx = env
    sql = """
        select c_custkey, c_name, o_orderkey, o_totalprice
        from customer full outer join orders on c_custkey = o_custkey
        order by c_custkey, o_orderkey
    """
    got = run_distributed(tctx, sql)
    assert_same(got, jctx.sql(sql).collect())
    v = to_numpy(*got)["o_orderkey"][1]
    assert (~v).any() and v.any()   # customers without orders


def test_window(env):
    jctx, tctx = env
    sql = """
        select o_custkey, o_orderkey,
               row_number() over (partition by o_custkey
                                  order by o_orderdate, o_orderkey) as rn,
               sum(o_totalprice) over (partition by o_custkey) as spend
        from orders order by o_custkey, rn
    """
    assert_same(run_distributed(tctx, sql), jctx.sql(sql).collect())


def test_cross_join(env):
    jctx, tctx = env
    sql = "select count(*) c from region cross join nation"
    got = run_distributed(tctx, sql)
    assert_same(got, jctx.sql(sql).collect())
    assert int(to_numpy(*got)["c"][0][0]) == 5 * 25


def test_except_all():
    """Bag semantics through the partitioned runtime at P = 4."""
    xa = pa.table({"x": [1, 1, 1, 2, 2, 3, None, None]})
    xb = pa.table({"x": [1, 1, 2, 4, None]})
    jctx = JaxContext(capacity_mode="exact")
    tctx = SessionContext(device="cpu")
    for ctx in (jctx, tctx):
        ctx.register_arrow("xa", xa)
        ctx.register_arrow("xb", xb)
    sql = "select x from xa except all select x from xb"
    batch, schema = run_distributed(tctx, sql, n=4)
    jb, js = jruntime.execute_distributed(
        jctx, jctx.sql(sql).plan, jax_make_mesh(4),
        JaxDistOptions(n_partitions=4))
    got, want = to_numpy(batch, schema)["x"], jax_to_numpy(jb, js)["x"]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][got[1]], want[0][want[1]])
    assert sorted(got[0][got[1]].tolist()) == [1, 2, 3]
    assert (~got[1]).sum() == 1


def test_agg_exchange_sized_by_group_bound(env):
    """Q12's partial-aggregate exchange is sized by the aggregate's group
    bound (7 ship modes), not its group table, with the JAX package's
    quotas."""
    jctx, tctx = env
    tplan = prune_columns(rebind_scans(tctx.sql(TPCH_QUERIES[12]).plan, tctx))
    jplan = jax_rebind(jax_prune(jctx.sql(TPCH_QUERIES[12]).plan), jctx)
    quotas = []
    for planner, plan in ((DistributedPlanner(tctx, DistOptions(
            n_partitions=4)), tplan), (JaxPlanner(jctx, JaxDistOptions(
                n_partitions=4)), jplan)):
        dplan = planner.plan(plan)
        ex = [s.root for s in dplan.stages
              if type(s.root).__name__ == "ExchangeExec"
              and "shipmode" in ",".join(s.root.key_names)]
        assert ex, dplan.display()
        assert all(e.quota <= 4096 for e in ex)
        quotas.append([e.quota for e in ex])
    assert quotas[0] == quotas[1]


# -- skew: salted shuffle joins and the overflow escalation --------------------

SKEW_SQL = ("select k, sum(v + w) as s, count(*) c from fact join dim "
            "on k = dk group by k order by k")


@pytest.fixture(scope="module")
def skew():
    rng = np.random.default_rng(0)
    n = 4000
    keys = np.where(rng.random(n) < 0.85, 7, rng.integers(0, 100, n))
    fact = pa.table({"k": pa.array(keys, pa.int64()),
                     "v": pa.array(rng.integers(0, 1000, n), pa.int64())})
    dim = pa.table({"dk": pa.array(np.arange(100), pa.int64()),
                    "w": pa.array(np.arange(100) * 10, pa.int64())})
    jctx = JaxContext(capacity_mode="exact")
    tctx = SessionContext(device="cpu")
    for ctx in (jctx, tctx):
        ctx.register_arrow("fact", fact, primary_key=None)
        ctx.register_arrow("dim", dim, primary_key=("dk",))
    return jctx, tctx, keys


def _jax_attempts(jctx, sql, opts, monkeypatch, max_retries=4):
    """The JAX answer and the options of each attempt (the first and the
    escalations of `escalate_overflow_opts`)."""
    seen = [opts]
    orig = jruntime.escalate_overflow_opts

    def record(o, err, attempt):
        seen.append(orig(o, err, attempt))
        return seen[-1]

    monkeypatch.setattr(jruntime, "escalate_overflow_opts", record)
    out = jruntime.execute_distributed(jctx, jctx.sql(sql).plan,
                                       jax_make_mesh(P), opts, max_retries)
    monkeypatch.undo()
    return out, seen


def _fields(o):
    return (o.quota_headroom, o.join_salt, o.max_group_table,
            o.broadcast_threshold, o.min_quota)


@pytest.mark.parametrize("max_retries", [4, 2])
def test_skew_escalates_to_salt_as_jax(skew, monkeypatch, max_retries):
    """A hot key (85 % of the rows) on a tiny quota: the first run
    overflows, the stats-driven retry salts the join (converging in one
    retry, so max_retries=2 suffices), and the options of every attempt
    equal the JAX package's."""
    jctx, tctx, keys = skew
    kw = dict(n_partitions=P, broadcast_threshold=0, min_quota=16,
              quota_headroom=1.05)
    jout, jseq = _jax_attempts(jctx, SKEW_SQL, JaxDistOptions(**kw),
                               monkeypatch, max_retries)
    got = execute_distributed(tctx, tctx.sql(SKEW_SQL).plan, cpu_mesh(),
                              DistOptions(**kw), max_retries)
    assert_same(got, jout)
    seq = tctx.dist_attempts
    assert [_fields(o) for o in seq] == [_fields(o) for o in jseq]
    assert len(seq) == 2 and seq[-1].join_salt > 1
    k = to_numpy(*got)["k"][0]
    np.testing.assert_array_equal(k, np.unique(keys))


def test_explicit_join_salt(skew):
    jctx, tctx, keys = skew
    opts = dict(n_partitions=P, broadcast_threshold=0, join_salt=4)
    got = run_distributed(tctx, SKEW_SQL, DistOptions(**opts))
    assert_same(got, jctx.sql(SKEW_SQL).collect())
    assert len(tctx.dist_attempts) == 1
    c = to_numpy(*got)["c"][0]
    assert c.sum() == len(keys)


def test_salted_left_outer(skew):
    jctx, tctx, keys = skew
    sql = "select count(*) c, count(w) cw from fact left join dim on k = dk"
    got = run_distributed(tctx, sql, DistOptions(
        n_partitions=P, broadcast_threshold=0, join_salt=4))
    assert_same(got, jctx.sql(sql).collect())
    out = to_numpy(*got)
    assert int(out["c"][0][0]) == len(keys)
    assert int(out["cw"][0][0]) == int((keys < 100).sum())


def test_operator_overflow_grows_capacities(env):
    """A group table that outgrows its capacity (the exchanges within
    their quotas) is retried with group tables and join outputs grown by
    the power of two at or above its observed need (at least 4x) and the
    quotas left as they were (the port departs from the reference here,
    which raises every quota for either overflow)."""
    jctx, tctx = env
    sql = ("select l_orderkey, count(*) c from lineitem group by l_orderkey "
           "order by l_orderkey")
    got = run_distributed(tctx, sql, DistOptions(n_partitions=P,
                                                 max_group_table=64))
    assert_same(got, jctx.sql(sql).collect())
    seq = tctx.dist_attempts
    assert len(seq) >= 2
    assert all(o.quota_headroom == seq[0].quota_headroom for o in seq)
    tables = [o.max_group_table for o in seq]
    assert tables[0] == 64
    for before, after in zip(tables, tables[1:]):
        factor = after // before
        assert after == before * factor and factor >= 4
        assert factor & (factor - 1) == 0


def test_repeat_starts_from_converged_options(skew):
    """Without explicit options the converged options are kept per (plan,
    P): the second run of a query starts from them."""
    _, tctx, _ = skew
    tctx._dist_opts_memo = {}
    plan = tctx.sql(SKEW_SQL).plan
    execute_distributed(tctx, plan, cpu_mesh())
    first = tctx.dist_attempts[-1]
    execute_distributed(tctx, plan, cpu_mesh())
    assert tctx.dist_attempts == [first]
    assert len(tctx._dist_opts_memo) == 1
