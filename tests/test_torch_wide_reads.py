"""A wide SUM read as a value: where an operator reads a SUM whose exact
total may pass int64 (ORDER BY, HAVING, arithmetic, a window, a group or
join key, an aggregate over it), the lowering narrows it at the output of
the aggregate that made it to the JAX package's decimal(18, s), and a
value that passes int64 fails the run with "wide decimal" on its first
attempt. A SUM that is only carried stays wide and exact
(`test_torch_wide_sums.py`). Bounds for abs, coalesce and aggregate
outputs keep the sums that cannot pass int64 narrow.

Every answer is held against the JAX package's (values and result types)
on the CPU, in-core, on the serial runtime, over a mesh of 4 CPU
partitions and over the wire; the run past int64 also across two gloo
processes."""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.batch import to_numpy as jax_to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu_torch import batch as B
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.context import rebind_scans
from ballista_tpu_torch.exec import plan as TP
from ballista_tpu_torch.exprs import Col, Lit, ScalarFn, bind_expr
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.planner import logical as L
from ballista_tpu_torch.scheduler import serial, standalone
from ballista_tpu_torch.schema import Field, INT64, Schema, decimal

torch.set_num_threads(2)


def _decimal(values, precision, scale):
    x = np.asarray(values, dtype=np.int64)
    return pa.Array.from_buffers(
        pa.decimal128(precision, scale), len(x),
        [None, pa.py_buffer(np.stack([x, x >> 63], 1).tobytes())])


# t(g int64, x decimal(12,2)): eight rows, x = 0.00, 1.00, ..., 7.00
EIGHT = pa.table({"g": pa.array(np.arange(8) % 3, pa.int64()),
                  "x": _decimal(np.arange(8) * 100, 12, 2)})
# t(g int64, x decimal(18,6)): one row of 9 x 10^17 and ten of 1 (scaled).
# Each sum fits int64; eleven rows times the bound do not, so the sum is
# wide by its bound and narrowed where it is read
BIG = pa.table({"g": pa.array(np.zeros(11), pa.int64()),
                "x": _decimal([9 * 10 ** 17] + [1] * 10, 18, 6)})
# eleven rows of 9 x 10^17: the total, 9.9 x 10^18, passes int64
PAST = pa.table({"g": pa.array(np.zeros(11), pa.int64()),
                 "x": _decimal([9 * 10 ** 17] * 11, 18, 6)})

EIGHT_QUERIES = [
    "select g, sum(coalesce(x, 0)) as s from t group by g order by s desc",
    "select g, sum(abs(x)) as s from t group by g having sum(abs(x)) > 0 "
    "order by g",
    "select g, sum(coalesce(x, 0)) / count(*) as m from t group by g "
    "order by g",
    "select g, sum(s) as ss from (select g, sum(x) as s from t group by g) v "
    "group by g order by ss",
    "select g, rank() over (order by sum(coalesce(x, 0)) desc) as r from t "
    "group by g order by g",
    "select g, max(sx) as m from (select g, sum(coalesce(x, 0)) as sx "
    "from t group by g) v group by g order by g",
    "select g, sum(coalesce(x, 0)) as s from t group by g",
]
BIG_QUERIES = [
    "select g, sum(x) as s from t group by g order by s",
    "select g, sum(x) as s from t group by g having sum(x) > 5",
    "select g, sum(x) / count(*) as m from t group by g",
]
CASES = ([("eight", q) for q in EIGHT_QUERIES]
         + [("big", q) for q in BIG_QUERIES])
TABLES = {"eight": EIGHT, "big": BIG, "past": PAST}
RUNTIMES = ["in_core", "serial", "distributed"]

_jax_cache = {}


def _host_copy(columns):
    """`jax_to_numpy`'s columns copied off the JAX buffers: its arrays are
    numpy views of them on the CPU, and a view kept in a module-level
    cache keeps them alive for every later file of the worker."""
    return {name: tuple(np.array(a, copy=True) for a in col)
            for name, col in columns.items()}


def _jax(table, sql):
    """The JAX package's (numpy columns, field types) of `sql` over t."""
    key = (table, sql)
    if key not in _jax_cache:
        ctx = JaxContext(capacity_mode="exact")
        ctx.register_arrow("t", TABLES[table])
        batch, schema = ctx.sql(sql).collect()
        _jax_cache[key] = (_host_copy(jax_to_numpy(batch, schema)),
                           [(f.name, repr(f.dtype)) for f in schema.fields])
    return _jax_cache[key]


def _port_ctx(runtime, tables):
    kwargs = {"serial": dict(serial_partitions=4),
              "distributed": dict(distributed=True, mesh=make_mesh(
                  4, devices=[torch.device("cpu")] * 4))}.get(runtime, {})
    ctx = SessionContext(device="cpu", **kwargs)
    for name, table in tables.items():
        ctx.register_arrow(name, table)
    return ctx


def _assert_equal(got, want):
    """Two (numpy columns, field types) answers: equal types, validity and
    live values."""
    (gcols, gtypes), (wcols, wtypes) = got, want
    assert gtypes == wtypes
    for name, (wv, wvalid) in wcols.items():
        gv, gvalid = gcols[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
        np.testing.assert_array_equal(gv[gvalid], wv[wvalid], err_msg=name)


def _answer(batch, schema):
    return (B.to_numpy(batch, schema),
            [(f.name, repr(f.dtype)) for f in schema.fields])


def _narrowed(ctx, sql):
    """The names of the sums that the in-core plan of `sql` narrows."""
    root = ctx.physical_plan(ctx.sql(sql).plan)
    out, todo = [], [root]
    while todo:
        node = todo.pop()
        if isinstance(node, TP.HashAggregateExec):
            out += [shown for _, shown in node._narrow]
        todo.extend(node.children)
    return out


@pytest.mark.parametrize("runtime", RUNTIMES)
@pytest.mark.parametrize("table,sql", CASES)
def test_reads_equal_jax(table, sql, runtime):
    """Values and result types are the JAX package's. Over the 8-row
    table the bounds keep every sum narrow; over the big one the sum is
    wide by its bound and narrowed at its aggregate."""
    ctx = _port_ctx(runtime, {"t": TABLES[table]})
    _assert_equal(_answer(*ctx.sql(sql).collect()), _jax(table, sql))
    if runtime == "in_core":
        assert bool(_narrowed(ctx, sql)) == (table == "big")


def test_sum_types_are_jax_types():
    """sum(coalesce(x, 0)) and sum(abs(x)) are decimal(18,2), as the JAX
    package types them: their bounds keep them narrow, where an unbounded
    argument made them wide, decimal(22,2)."""
    ctx = _port_ctx("in_core", {"t": EIGHT})
    for sql in ("select sum(coalesce(x, 0)) as s from t",
                "select sum(abs(x)) as s from t"):
        _, schema = ctx.sql(sql).collect()
        assert repr(schema.field("s").dtype) == "decimal(18,2)"


def test_carried_wide_sum_stays_wide_beside_a_read_one():
    """One aggregate, two sums over one column: the one read by ORDER BY is
    narrowed, the one only carried stays wide and exact."""
    sql = ("select g, sum(x) as a, sum(x * 1) + 0 as b from t group by g "
           "order by b")
    ctx = _port_ctx("in_core", {"t": BIG})
    batch, schema = ctx.sql(sql).collect()
    got = B.to_numpy(batch, schema)
    assert schema.field("a").dtype.is_wide
    assert repr(schema.field("b").dtype) == "decimal(18,6)"
    total = 9 * 10 ** 17 + 10
    assert got["a"][0].tolist() == [total] and got["b"][0].tolist() == [total]


# a many-to-many join on crafted tables: 10 x 10 rows times a bound of
# 10^17 passes int64, each group's sum does not
JOIN_A = pa.table({"ak": pa.array(np.arange(10) % 2, pa.int64()),
                   "x": _decimal([10 ** 17] + list(range(1, 10)), 18, 2)})
JOIN_B = pa.table({"bk": pa.array(np.arange(10) % 2, pa.int64()),
                   "y": pa.array(np.arange(10), pa.int64())})
JOIN_SQL = ("select ak, sum(x) as s from a join b on ak = bk group by ak "
            "order by s desc")


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_many_to_many_join_sum_is_narrowed(runtime):
    jctx = JaxContext(capacity_mode="exact")
    jctx.register_arrow("a", JOIN_A)
    jctx.register_arrow("b", JOIN_B)
    want = (_host_copy(jax_to_numpy(*jctx.sql(JOIN_SQL).collect())),
            [("ak", "int64"), ("s", "decimal(18,2)")])
    ctx = _port_ctx(runtime, {"a": JOIN_A, "b": JOIN_B})
    _assert_equal(_answer(*ctx.sql(JOIN_SQL).collect()), want)
    if runtime == "in_core":
        assert _narrowed(ctx, JOIN_SQL) == ["s"]


def _schema(**bounds):
    fields = tuple(Field(n, decimal(12, 3 if n == "y" else 2))
                   for n in bounds)
    return Schema(fields, int_bounds={n: b for n, b in bounds.items()
                                      if b is not None})


@pytest.mark.parametrize("bound,want", [
    ((-5, 3), (0, 5)), ((-7, -2), (2, 7)), ((2, 7), (2, 7)),
    ((0, 0), (0, 0)), (None, None)])
def test_abs_bound(bound, want):
    b = bind_expr(ScalarFn("abs", (Col("x"),)), _schema(x=bound))
    assert b.int_bound == want


def test_coalesce_bound():
    """The hull of the parts' bounds at the common scale; none where a
    part has none."""
    s = _schema(x=(-100, 700), y=(5, 90000), z=None)
    assert bind_expr(ScalarFn("coalesce", (Col("x"), Lit(0))),
                     s).int_bound == (-100, 700)
    # decimal(12,2) and decimal(12,3): x is scaled by 10
    assert bind_expr(ScalarFn("coalesce", (Col("x"), Col("y"))),
                     s).int_bound == (-1000, 90000)
    assert bind_expr(ScalarFn("coalesce", (Col("x"), Col("z"))),
                     s).int_bound is None


def _aggregate(ctx, sql):
    plan = rebind_scans(ctx.sql(sql).plan, ctx)
    while not isinstance(plan, L.Aggregate):
        plan = plan.children()[0]
    return plan


def test_aggregate_output_bounds():
    """A narrow SUM's output is bounded by +-rows x its argument's largest
    magnitude; min/max keep their argument's bound, an expression's too;
    a wide SUM's output has none."""
    ctx = _port_ctx("in_core", {"t": EIGHT, "big": BIG})

    def schema(sql):
        return rebind_scans(ctx.sql(sql).plan, ctx).schema()
    s = schema("select g, sum(x) as s, sum(coalesce(x, 0)) as c, "
               "min(abs(x - 1)) as m, max(x * 2) as mx from t group by g")
    assert s.int_bound("s") == (-8 * 700, 8 * 700)
    assert s.int_bound("c") == (-8 * 700, 8 * 700)
    assert s.int_bound("m") == (0, 600)
    assert s.int_bound("mx") == (0, 1400)
    sql = "select g, sum(x) as s from big group by g"
    assert _aggregate(ctx, sql).sized_aggs()[0].wide
    assert schema(sql).int_bound("s") is None


def test_sum_over_a_sum_is_narrow_by_bounds():
    """The inner sum's bound (8 x 700) keeps the outer one narrow."""
    ctx = _port_ctx("in_core", {"t": EIGHT})
    sql = ("select sum(s) as ss from (select g, sum(x) as s from t "
           "group by g) v")
    assert not _aggregate(ctx, sql).sized_aggs()[0].wide
    _, schema = ctx.sql(sql).collect()
    assert repr(schema.field("ss").dtype) == "decimal(18,2)"


PAST_SQL = "select g, sum(x) as s from t group by g order by s"


@pytest.fixture
def no_escalation(monkeypatch):
    """Fails on any capacity or quota escalation of a distributed job."""
    def refuse(*args):
        raise AssertionError("the job was escalated and retried")
    for mod in (standalone, serial):
        for name in ("grow_capacities", "escalate_overflow_opts"):
            monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("runtime", RUNTIMES)
def test_past_int64_raises_once(runtime, monkeypatch, no_escalation):
    """A read value past int64 fails the query with "wide decimal", naming
    the column, on its first run."""
    runs = []
    monkeypatch.setattr(TP.Run, "verdict", lambda self, _f=TP.Run.verdict:
                        runs.append(1) or _f(self))
    executes = []
    monkeypatch.setattr(serial.SerialRuntime, "execute",
                        lambda self, plan, _f=serial.SerialRuntime.execute:
                        executes.append(1) or _f(self, plan))
    ctx = _port_ctx(runtime, {"t": PAST})
    with pytest.raises(Exception, match="wide decimal") as err:
        ctx.sql(PAST_SQL).collect()
    assert "s: its value passes int64" in str(err.value)
    if runtime == "in_core":
        assert runs == [1] and not ctx.warnings
    elif runtime == "serial":
        assert executes == [1]
    else:
        assert "failed permanently (not_implemented)" in str(err.value)


def _files(tmp_path, table):
    pq.write_table(TABLES[table], str(tmp_path / f"{table}.parquet"))
    return {"kind": "files", "tables": {"t": {
        "format": "parquet", "path": str(tmp_path / f"{table}.parquet"),
        "primary_key": None}}}


def test_wire_order_by_reads_and_past_int64(tmp_path):
    """Over the wire: the ORDER BY cases answer as the JAX package, and a
    value past int64 fails the job permanently on its first task."""
    from ballista_tpu_torch.scheduler.rpc import SchedulerRpcClient
    from test_torch_rpc import spawn_executor, start_scheduler, stop_all
    service, httpd, url = start_scheduler(tmp_path / "work")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-wide-reads", partitions=2))
        client = SchedulerRpcClient(url, device="cpu")
        for table, sql in [("eight", EIGHT_QUERIES[0]),
                           ("eight", EIGHT_QUERIES[3]),
                           ("big", BIG_QUERIES[0])]:
            job = client.submit_sql(sql, _files(tmp_path, table),
                                    options={"n_partitions": 2})
            _assert_equal(_answer(*client.wait_batch(job, timeout_s=120)),
                          _jax(table, sql))
        job = client.submit_sql(PAST_SQL, _files(tmp_path, "past"),
                                options={"n_partitions": 2})
        with pytest.raises(RuntimeError, match="wide decimal") as err:
            client.wait_batch(job, timeout_s=120)
        assert "failed permanently (not_implemented)" in str(err.value)
    finally:
        stop_all(procs, httpd)


def test_gloo_processes_narrow_and_raise(tmp_path):
    """Two gloo processes over one mesh of 8: the narrowed ORDER BY
    answers; past int64 both processes raise on the first attempt."""
    from test_torch_multihost import _assert_ok, _results, _spawn_pair
    procs, outs = _spawn_pair("wide", tmp_path)
    _assert_ok(procs, outs)
    want, _ = _jax("big", BIG_QUERIES[0])
    for res in _results(tmp_path):
        assert res["dtype"] == "decimal(18,6)"
        for name, (wv, wvalid) in want.items():
            gv, gvalid = res["fits"][name]
            np.testing.assert_array_equal(gvalid, wvalid)
            np.testing.assert_array_equal(gv[gvalid], wv[wvalid])
        assert "wide decimal" in res["past"] and res["escalations"] == []

