"""The serial (out-of-core) runtime: partition-at-a-time execution with the
shuffle on the host must match the in-core run row for row.

tests/test_serial.py's five cases run through the port's serial runtime,
the port's in-core path and the JAX package's serial runtime, as frames;
the overflow retry at quota_headroom 0.05 and `escalate_overflow_opts`
against the JAX package's; tests/test_stats_aggs.py's serial case; the 22
TPC-H queries at SF 0.01 with serial_partitions=4 against the port
in-core; a full outer join with unmatched rows on both sides; a one-row
broadcast past the cross join's cell bound; one stage plan run P times.

Tolerances: validity, integers, decimals, dates and strings exact; f64 at
rtol 1e-9 (a serial run sums each partition, then merges: another order
of addition)."""

import dataclasses

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.scheduler.distributed_planner import \
    DistOptions as JaxDistOptions
from ballista_tpu.scheduler.runtime import (
    ShuffleOverflowError as JaxOverflow,
    escalate_overflow_opts as jax_escalate)
from ballista_tpu_torch.batch import Batch, Column, to_numpy, to_pandas
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.config import BallistaConfig
from ballista_tpu_torch.datagen import TPCH_TABLES, register_tpch
from ballista_tpu_torch.errors import classify
from ballista_tpu_torch.exec.distributed import (ExchangeExec, GatherExec,
                                                 PartitionPruneExec)
from ballista_tpu_torch.exec.plan import CrossJoinExec, InputLeaf, Run
from ballista_tpu_torch.schema import INT64, Field, Schema
from ballista_tpu_torch.scheduler import serial as serial_mod
from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
from ballista_tpu_torch.scheduler.runtime import (ShuffleOverflowError,
                                                  escalate_overflow_opts)
from ballista_tpu_torch.scheduler.serial import SerialRuntime, execute_serial
from test_torch_distributed_planner import SERIAL_QUERIES, serial_tables

torch.set_num_threads(2)

F64_RTOL = 1e-9


def _port(serial, tables=None):
    ctx = SessionContext(device="cpu", serial_partitions=4 if serial else None)
    for name, table in (tables or serial_tables()).items():
        ctx.register_arrow(name, table)
    return ctx


def _jax(tables=None):
    ctx = JaxContext(capacity_mode="exact", serial_partitions=4)
    for name, table in (tables or serial_tables()).items():
        ctx.register_arrow(name, table)
    return ctx


def _frame(ctx, sql):
    return ctx.sql(sql).to_pandas().reset_index(drop=True)


@pytest.mark.parametrize("qi", range(len(SERIAL_QUERIES)))
def test_serial_matches_local_and_jax_serial(qi):
    q = SERIAL_QUERIES[qi]
    serial = _frame(_port(True), q)
    pd.testing.assert_frame_equal(serial, _frame(_port(False), q),
                                  check_dtype=False)
    pd.testing.assert_frame_equal(serial, _frame(_jax(), q),
                                  check_dtype=False)
    assert len(serial) > 0


def test_serial_overflow_retry():
    """A tiny quota headroom overflows the join's exchanges; the retry
    escalates the options and the answer is the in-core one."""
    ctx = _port(False)
    plan = ctx.sql(SERIAL_QUERIES[1]).plan
    out, schema = execute_serial(
        ctx, plan, 4, options=DistOptions(n_partitions=4,
                                          quota_headroom=0.05, min_quota=8,
                                          broadcast_threshold=0))
    assert max(m.retries for m in ctx.serial_metrics) >= 1
    pd.testing.assert_frame_equal(to_pandas(out, schema),
                                  _frame(_port(False), SERIAL_QUERIES[1]),
                                  check_dtype=False)


def test_operator_overflow_grows_capacities_not_quotas(caplog):
    """A group table that outgrows its capacity is retried with 4x group
    tables and join outputs, the quotas left as they were."""
    ctx = _port(False)
    plan = ctx.sql(SERIAL_QUERIES[0]).plan
    out, schema = execute_serial(
        ctx, plan, 4, options=DistOptions(n_partitions=4, max_group_table=16))
    assert max(m.retries for m in ctx.serial_metrics) >= 1
    retries = [r.getMessage() for r in caplog.records
               if "serial overflow" in r.getMessage()]
    assert retries and all("outgrew its capacity" in r and
                           "headroom 2.0," in r for r in retries)
    pd.testing.assert_frame_equal(to_pandas(out, schema),
                                  _frame(_port(False), SERIAL_QUERIES[0]),
                                  check_dtype=False)


def _err(cls, stats):
    e = cls("overflow")
    if stats is not None:
        e.stats = stats
    return e


ESCALATIONS = {
    "no stats, first retry": (None, 0),
    "no stats, later retry": (None, 2),
    "flat overflow": ([{"quota": 256, "salt_kind": None,
                        "counts": np.array([[300, 280, 310, 290]])}], 0),
    "skewed join side": ([{"quota": 256, "salt_kind": "spread",
                           "counts": np.array([[2000, 10, 12, 9]])}], 0),
    "under quota": ([{"quota": 256, "salt_kind": "replicate",
                      "counts": np.array([[100, 90, 80, 70]])}], 1),
}


@pytest.mark.parametrize("case", sorted(ESCALATIONS))
def test_escalate_overflow_opts_matches_jax(case):
    stats, attempt = ESCALATIONS[case]
    base = dict(n_partitions=4, quota_headroom=2.0, join_salt=1)
    got = escalate_overflow_opts(DistOptions(**base),
                                 _err(ShuffleOverflowError, stats), attempt)
    want = jax_escalate(JaxDistOptions(**base), _err(JaxOverflow, stats),
                        attempt)
    assert {k: v for k, v in dataclasses.asdict(got).items()
            if k != "join_out_factor"} == dataclasses.asdict(want)
    assert got.join_out_factor == 4.0


def test_stats_serial_matches_local():
    rng = np.random.default_rng(5)
    n = 3000
    data = pa.table({
        "g": rng.integers(0, 12, n),
        "x": rng.normal(50, 12, n),
        "y": rng.normal(0, 3, n) + np.repeat(np.arange(n // 100), 100) * 0.01,
        "i": rng.integers(-100, 100, n)})
    q = ("select g, stddev(x) as sd, median(x) as m, corr(x, y) as c, "
         "approx_percentile_cont(i, 0.75) as p from t group by g order by g")
    local = _frame(_port(False, {"t": data}), q)
    pd.testing.assert_frame_equal(_frame(_port(True, {"t": data}), q), local,
                                  check_dtype=False, atol=0, rtol=F64_RTOL)
    pd.testing.assert_frame_equal(_frame(_jax({"t": data}), q), local,
                                  check_dtype=False, atol=1e-9)


def assert_same(got, want):
    """Two (batch, schema) answers: names, row count, validity equal; f64
    at rtol 1e-9, everything else exactly, row by row."""
    (gb, gs), (wb, ws) = got, want
    assert [f.name for f in gs.fields] == [f.name for f in ws.fields]
    assert int(gb.num_rows) == int(wb.num_rows)
    g, w = to_numpy(gb, gs), to_numpy(wb, ws)
    for name in w:
        np.testing.assert_array_equal(g[name][1], w[name][1], err_msg=name)
        gv, wv = g[name][0][g[name][1]], w[name][0][w[name][1]]
        if wv.dtype.kind == "f":
            np.testing.assert_allclose(gv, wv, rtol=F64_RTOL, atol=0,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(gv, wv, err_msg=name)


@pytest.fixture(scope="module")
def tpch():
    incore = SessionContext(device="cpu")
    serial = SessionContext(device="cpu", serial_partitions=4)
    for ctx in (incore, serial):
        register_tpch(ctx, 0.01, tables=list(TPCH_TABLES))
    return incore, serial


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_serial_matches_in_core(tpch, q):
    incore, serial = tpch
    want = incore.sql(TPCH_QUERIES[q]).collect()
    got = serial.sql(TPCH_QUERIES[q]).collect()
    assert_same(got, want)
    assert int(want[0].num_rows) > 0
    assert len(serial.serial_metrics) > 1
    assert all(m.partitions in (1, 4) for m in serial.serial_metrics)


def test_one_row_broadcast_past_the_cell_bound(tpch, monkeypatch):
    """Q16's NOT IN count: with the cell bound lowered below P x 128 x the
    probe, the serial plan broadcasts the gathered row (the reference's
    would raise) and still answers as in-core does."""
    incore, serial = tpch
    want = incore.sql(TPCH_QUERIES[16]).collect()
    monkeypatch.setattr(CrossJoinExec, "MAX_CELLS", 1 << 10)
    assert_same(serial.sql(TPCH_QUERIES[16]).collect(), want)


def test_full_outer_join_shuffles_both_sides():
    """Unmatched rows on both sides (phase 9's shape, small): a full outer
    join never broadcasts, or each partition would append the build's
    unmatched rows again."""
    rng = np.random.default_rng(3)
    left = pa.table({"lk": np.arange(0, 3000, 3, dtype=np.int64),
                     "lv": rng.integers(0, 100, 1000)})
    right = pa.table({"rk": rng.integers(-500, 3500, 2000),
                      "rv": rng.normal(size=2000)})
    q = ("select lk, rk, lv, rv from l full outer join r on lk = rk "
         "order by lk, rk, rv")
    tables = {"l": left, "r": right}
    local, serial = _port(False, tables), _port(True, tables)
    got = serial.sql(q).collect()
    assert_same(got, local.sql(q).collect())
    raw = to_numpy(*got)
    assert not raw["lk"][1].all() and not raw["rk"][1].all()
    dplan_roots = [type(s.root).__name__ for s in
                   serial_mod.DistributedPlanner(
                       serial, DistOptions(n_partitions=4)).plan(
                           serial.sql(q).plan).stages]
    assert dplan_roots[:2] == ["ExchangeExec", "ExchangeExec"]


def test_stage_planned_once_and_run_per_partition(monkeypatch):
    """The counterpart of test_serial_one_compile_per_stage: each stage's
    body is made once and called once per partition it runs."""
    made, calls = [], []
    real = SerialRuntime._compile_stage

    def spy(self, stage):
        fn, leaf_ids, kind = real(self, stage)
        made.append(stage.stage_id)

        def counted(pid, inputs):
            calls.append((stage.stage_id, pid))
            return fn(pid, inputs)
        return counted, leaf_ids, kind

    monkeypatch.setattr(SerialRuntime, "_compile_stage", spy)
    ctx = _port(True)
    df = _frame(ctx, SERIAL_QUERIES[0])
    assert len(df) == 200
    assert sorted(made) == list(range(len(ctx.serial_metrics)))
    for sid in made:
        pids = sorted(p for s, p in calls if s == sid)
        assert pids in ([0], [0, 1, 2, 3])
        assert ctx.serial_metrics[sid].partitions == len(pids)
    assert [len(made), len(calls)] == [3, 9]   # partial, final, merge sort
    m = ctx.serial_metrics[0]
    assert m.bytes_to_device > 0 and m.bytes_to_host > 0
    assert sum(m.operator_rows.values()) > 0


def test_stages_are_sized_by_the_rows_sent(tpch, monkeypatch):
    """Each stage is lowered again with the rows the finished stages sent:
    its stage-fed leaves are never larger than the static plan's, smaller
    after a shuffle join (where the static plan doubles them), and the
    stages are those of the static plan."""
    from ballista_tpu_torch.client.context import rebind_scans
    from ballista_tpu_torch.planner.optimizer import (prune_columns,
                                                      reduce_group_keys)
    _, ctx = tpch
    plan = prune_columns(reduce_group_keys(rebind_scans(
        ctx.sql(TPCH_QUERIES[9]).plan, ctx)))
    opts = DistOptions(n_partitions=4)
    static = serial_mod.DistributedPlanner(ctx, opts).plan(plan)
    ran = []
    real = SerialRuntime._compile_stage

    def spy(self, stage):
        ran.append(stage)
        return real(self, stage)

    monkeypatch.setattr(SerialRuntime, "_compile_stage", spy)
    rt = SerialRuntime(ctx, opts)
    rt.execute(plan)
    assert rt.plannings > 1
    assert [type(s.root).__name__ for s in ran] == \
        [type(s.root).__name__ for s in static.stages]

    def fed(stage):
        return {leaf.input_id: leaf.capacity for leaf in stage.root.leaves()
                if leaf.input_id.startswith("stage_")}

    pairs = [(fed(r)[k], fed(s)[k]) for r, s in zip(ran, static.stages)
             for k in fed(s)]
    assert all(got <= planned for got, planned in pairs)
    assert any(got < planned for got, planned in pairs)


def test_stage_root_operators_refuse_to_run_in_a_plan():
    leaf = InputLeaf("t", Schema((Field("a", INT64),), {}), 128)
    col = Column(torch.arange(128), torch.arange(128) < 3)
    run = Run({"t": Batch((col,), torch.tensor(3, dtype=torch.int32))})
    for node in (ExchangeExec(leaf, ["a"], 4, 256), GatherExec(leaf, 4)):
        with pytest.raises(NotImplementedError, match="multi-device"):
            node.evaluate(run)
    with pytest.raises(RuntimeError, match="partition id"):
        PartitionPruneExec(leaf).evaluate(run)
    run.partition = 1
    assert int(PartitionPruneExec(leaf).evaluate(run).num_rows) == 0


def test_config_and_error_kinds():
    opts = BallistaConfig({"ballista.shuffle.quota_headroom": "3.5"}) \
        .to_dist_options(6)
    assert (opts.n_partitions, opts.quota_headroom) == (6, 3.5)
    assert classify(ShuffleOverflowError("q")).kind == "shuffle_overflow"
