"""The device-memory model and the routing of `collect()` (exec/memory.py,
SessionContext.collect) against the JAX package's: row and batch bytes of
the eight TPC-H schemas, `plan_serial_partitions` over a grid, the route
decision with an explicit budget and with routing turned off, the OOM memo,
a tiny BALLISTA_HBM_BYTES sending `collect()` to the serial runtime, and an
in-core run that raises torch.cuda.OutOfMemoryError falling back to it and
teaching the memo."""

import numpy as np
import pytest
import torch

from ballista_tpu.exec import memory as jax_memory
from ballista_tpu_torch.batch import to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, register_tpch
from ballista_tpu_torch.exec import memory
from ballista_tpu_torch.scheduler.distributed_planner import (
    DistOptions, DistributedPlanner)
from ballista_tpu_torch.scheduler.serial import (estimate_serial_hbm,
                                                 fit_partitions)
from test_torch_tpch_six import _contexts

torch.set_num_threads(2)

ROUTED = "plan routed out-of-core (serial@"
FELL_BACK = ("in-core execution exhausted device memory; falling back to the "
             "out-of-core serial runtime")


@pytest.fixture(scope="module")
def both():
    return _contexts(0.01, list(TPCH_TABLES))


@pytest.fixture
def memo(monkeypatch, tmp_path):
    path = tmp_path / "oom_memo.json"
    monkeypatch.setattr(memory, "_oom_memo_path", lambda: str(path))
    monkeypatch.delenv("BALLISTA_HBM_BYTES", raising=False)
    monkeypatch.delenv("BALLISTA_ROUTE_FACTOR", raising=False)
    return path


@pytest.mark.parametrize("table", sorted(TPCH_TABLES))
def test_row_and_batch_bytes_match_jax(both, table):
    jctx, tctx = both
    js, ts = jctx.tables[table].schema, tctx.tables[table].schema
    assert memory.row_bytes(ts) == jax_memory.row_bytes(js)
    cap = tctx.tables[table].capacity
    assert memory.batch_bytes(ts, cap) == jax_memory.batch_bytes(js, cap)


def test_plan_serial_partitions_matches_jax():
    for est in (0, 1, 10 ** 6, 3 * 10 ** 9, 10 ** 11, 10 ** 13):
        for budget in (10 ** 6, 10 ** 9, 16 * 2 ** 30, 80 * 10 ** 9):
            for max_parts in (8, 64):
                assert memory.plan_serial_partitions(est, budget, max_parts) \
                    == jax_memory.plan_serial_partitions(est, budget,
                                                         max_parts)


def _plan(ctx, q):
    return ctx.physical_plan(ctx.sql(TPCH_QUERIES[q]).plan)


def test_estimate_follows_the_run(both):
    _, tctx = both
    plan = _plan(tctx, 9)
    peak, rows = memory.estimate_plan_hbm(plan, detail=True)
    assert peak == max(r[1] for r in rows) == memory.estimate_plan_hbm(plan)
    assert peak > memory._leaf_bytes(plan) > 0
    # every node but the leaves is priced once per evaluation
    assert len(rows) == sum(1 for r in rows if "InputLeaf" not in r[0])


def test_route_serial_with_an_explicit_budget(both, memo, monkeypatch):
    _, tctx = both
    plan = _plan(tctx, 5)
    est = memory.estimate_plan_hbm(plan)
    assert memory.route_serial(plan, est) == 0
    n = memory.route_serial(plan, est // 8)
    assert n == memory.plan_serial_partitions(est, est // 8) > 1
    monkeypatch.setenv("BALLISTA_ROUTE_FACTOR", "0")
    assert memory.route_serial(plan, est // 8) == 0
    assert memory.route_serial(plan, 1) == 0


def test_stage_estimates_shrink_with_partitions(both):
    """A serial stage's estimated peak falls as P grows, and the fitted
    count is the first whose largest stage fits half the budget times the
    route factor."""
    _, tctx = both
    plan = tctx.sql(TPCH_QUERIES[9]).plan
    peaks = [estimate_serial_hbm(tctx, plan, n) for n in (2, 4, 8)]
    assert peaks[0] > peaks[1] > peaks[2] > 0
    stages = DistributedPlanner(tctx, DistOptions(n_partitions=4)).plan(
        _serial_plan(tctx, plan)).stages
    assert peaks[1] == max(memory.estimate_stage_hbm(s.root) for s in stages)
    budget = int(peaks[1] / (0.5 * memory.ROUTE_FACTOR)) + 1
    assert fit_partitions(tctx, plan, 2, budget) == 4
    assert fit_partitions(tctx, plan, 2, 10 ** 15) == 2
    assert fit_partitions(tctx, plan, 8, 1) == 64


def _serial_plan(ctx, plan):
    from ballista_tpu_torch.client.context import rebind_scans
    from ballista_tpu_torch.planner.optimizer import (prune_columns,
                                                      reduce_group_keys)
    return prune_columns(reduce_group_keys(rebind_scans(plan, ctx)))


def test_oom_memo_round_trip(both, memo):
    _, tctx = both
    fp = memory.plan_fingerprint(_plan(tctx, 3))
    assert memory.oom_memo_lookup(fp) == 0
    memory.oom_memo_record(fp, 16)
    memory.oom_memo_record("other", 4)
    assert memory.oom_memo_lookup(fp) == 16 and memo.exists()
    assert memory.route_serial(_plan(tctx, 3), 10 ** 15) == 16
    memo.write_text("not json")
    assert memory.oom_memo_lookup(fp) == 0


def _ctx():
    ctx = SessionContext(device="cpu")
    register_tpch(ctx, 0.01, tables=["lineitem", "orders", "customer"])
    return ctx


def _same(a, b):
    ga, gb = to_numpy(*a), to_numpy(*b)
    assert list(ga) == list(gb)
    for k in ga:
        np.testing.assert_array_equal(ga[k][1], gb[k][1])
        np.testing.assert_array_equal(ga[k][0][ga[k][1]], gb[k][0][gb[k][1]])


def test_tiny_budget_routes_collect_to_serial(memo, monkeypatch):
    ctx = _ctx()
    want = ctx.sql(TPCH_QUERIES[3]).collect()
    assert not ctx.take_warnings()
    est = memory.estimate_plan_hbm(_plan(ctx, 3))
    monkeypatch.setenv("BALLISTA_HBM_BYTES", str(est // 2))
    got = ctx.sql(TPCH_QUERIES[3]).collect()
    n = fit_partitions(ctx, ctx.sql(TPCH_QUERIES[3]).plan,
                       memory.plan_serial_partitions(est, est // 2), est // 2)
    assert ctx.take_warnings() == [
        f"{ROUTED}{n}): predicted working set exceeds device memory"]
    assert len(ctx.serial_metrics) > 1
    _same(got, want)


def test_oom_falls_back_then_the_memo_routes(memo, monkeypatch):
    ctx = _ctx()
    want = ctx.sql(TPCH_QUERIES[3]).collect()
    real = SessionContext.converge
    ooms = []

    def fail_once(self, plan, max_retries=5):
        if not ooms:
            ooms.append(1)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (test)")
        return real(self, plan, max_retries)

    monkeypatch.setattr(SessionContext, "converge", fail_once)
    got = ctx.sql(TPCH_QUERIES[3]).collect()
    assert ctx.take_warnings() == [FELL_BACK]
    _same(got, want)
    plan = ctx.sql(TPCH_QUERIES[3]).plan
    est = memory.estimate_plan_hbm(ctx.physical_plan(plan))
    n = fit_partitions(ctx, plan, 4, est)
    fp = memory.plan_fingerprint(ctx.physical_plan(plan))
    assert memory.oom_memo_lookup(fp) == n >= 4 and memo.exists()
    # the next collect goes out-of-core through the memo alone: the gate
    # is open and the estimate can never route
    monkeypatch.setenv("BALLISTA_HBM_BYTES", "1")
    monkeypatch.setenv("BALLISTA_ROUTE_FACTOR", "1e12")
    ctx.serial_metrics = []
    again = ctx.sql(TPCH_QUERIES[3]).collect()
    assert ctx.take_warnings() == [
        f"{ROUTED}{n}): predicted working set exceeds device memory"]
    assert ooms == [1] and ctx.serial_metrics
    _same(again, want)


def test_other_errors_are_raised_as_they_are(memo, monkeypatch):
    ctx = _ctx()

    def broken(self, plan, max_retries=5):
        raise ValueError("not an out-of-memory error")

    monkeypatch.setattr(SessionContext, "converge", broken)
    with pytest.raises(ValueError, match="not an out-of-memory"):
        ctx.sql(TPCH_QUERIES[3]).collect()
    assert not ctx.take_warnings() and not memo.exists()


def test_no_budget_off_the_card(monkeypatch):
    monkeypatch.delenv("BALLISTA_HBM_BYTES", raising=False)
    assert memory.hbm_budget_bytes("cpu") is None
    monkeypatch.setenv("BALLISTA_HBM_BYTES", "2.5e9")
    assert memory.hbm_budget_bytes("cpu") == 2_500_000_000
