"""The program's spans (`ballista_tpu_torch/tracing.py`) on the CPU.

Under `torch.profiler` a query records `ballista.sql` (parse, plan) and
`ballista.collect` (route, then one `ballista.attempt` per run of the
plan: physical planning, binding, the operators nested as the plan, the
verdict read); a run that overflowed is re-run in one more attempt; with
no profiler recording no range is entered; answers are the same with
tracing on and off."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ballista_tpu_torch import batch as B
from ballista_tpu_torch import tracing
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.dataframe import col
from ballista_tpu_torch.datagen import register_tpch
from ballista_tpu_torch.exec.aggregate import AggExpr
from ballista_tpu_torch.planner.physical import PhysicalOptions

torch.set_num_threads(2)

SF = 0.01
TABLES = ["customer", "orders", "lineitem", "nation", "region", "supplier"]


def _context(**kwargs):
    ctx = SessionContext(device="cpu", **kwargs)
    register_tpch(ctx, SF, tables=TABLES)
    return ctx


@pytest.fixture(scope="module")
def ctx():
    return _context()


def _profiled(fn):
    """fn() under the profiler: (its result, the ballista.* ranges as a
    forest of (name, [children]) nested by time)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("ballista.")),
                    key=lambda r: (r[0], -r[1]))
    forest = []
    stack = [(float("inf"), forest)]
    for s, e, name in ranges:
        while stack[-1][0] <= s:
            stack.pop()
        node = (name, [])
        stack[-1][1].append(node)
        stack.append((e, node[1]))
    return out, forest


def _names(nodes):
    return [n for n, _ in nodes]


def _canon(node, keep=lambda name: True):
    name, children = node
    return (name, sorted(_canon(c, keep) for c in children if keep(c[0])))


def _plan_tree(node):
    return ("ballista.exec." + type(node).__name__,
            sorted(_plan_tree(c) for c in node.children))


def _shares(node):
    return node.n_parents > 1 or any(_shares(c) for c in node.children)


def _sql_collect(ctx, q):
    return lambda: ctx.sql(TPCH_QUERIES[q]).collect()


@pytest.mark.parametrize("q", [3, 5, 10, 12])
def test_query_records_the_span_tree(ctx, q):
    ctx.take_warnings()
    _, forest = _profiled(_sql_collect(ctx, q))
    assert ctx.take_warnings() == []
    assert _names(forest) == ["ballista.sql", "ballista.collect"]
    sql, collect = forest
    assert _names(sql[1]) == ["ballista.sql.parse", "ballista.sql.plan"]
    assert _names(collect[1]) == ["ballista.route", "ballista.attempt"]
    attempt = collect[1][1]
    names = _names(attempt[1])
    assert names[:2] == ["ballista.plan.physical", "ballista.plan.bind"]
    assert names[3:] in ([], ["ballista.verdict"])
    # the operators nested as the plan collect ran (no subtree shared)
    plan = ctx.physical_plan(ctx.sql(TPCH_QUERIES[q]).plan)
    assert not _shares(plan)
    recorded = _canon(attempt[1][2], lambda n: n.startswith(tracing.EXEC))
    assert recorded == _plan_tree(plan)


def test_kernel_span_inside_its_aggregate(ctx):
    _, forest = _profiled(_sql_collect(ctx, 1))
    found = []

    def walk(node, path):
        if node[0] == "ballista.kernel.masked_slot_sums":
            found.append(path[-1])
        for c in node[1]:
            walk(c, path + [node[0]])
    for root in forest:
        walk(root, [])
    assert found and set(found) == {"ballista.exec.HashAggregateExec"}


@pytest.mark.parametrize("options", [
    PhysicalOptions(max_group_table=16),
    PhysicalOptions(max_group_table=64),
    PhysicalOptions(join_out_factor=1 / 64),
], ids=["group16", "group64", "join1_64"])
def test_each_overflow_rerun_is_one_more_attempt(options):
    ctx = _context(options=options)
    q = 13 if options.join_out_factor < 1 else 3
    _, forest = _profiled(_sql_collect(ctx, q))
    reruns = [w for w in ctx.take_warnings()
              if w.startswith("output overflowed capacity")]
    assert reruns
    collect = forest[1]
    attempts = [c for c in collect[1] if c[0] == "ballista.attempt"]
    assert len(attempts) == 1 + len(reruns)
    for a in attempts:
        assert _names(a[1])[:2] == ["ballista.plan.physical",
                                    "ballista.plan.bind"]
        # every attempt reads its verdict: each one could overflow
        assert _names(a[1])[-1] == "ballista.verdict"


def test_serial_runtime_records_operator_spans():
    ctx = _context(serial_partitions=2)
    _, forest = _profiled(_sql_collect(ctx, 3))
    assert _names(forest) == ["ballista.sql", "ballista.collect"]
    below = []

    def walk(node):
        below.append(node[0])
        for c in node[1]:
            walk(c)
    walk(forest[1])
    assert "ballista.attempt" not in below
    assert "ballista.exec.HashJoinExec" in below


def test_dataframe_collect_records_no_sql_span(ctx):
    df = ctx.table("orders").aggregate(
        [col("o_orderstatus")], [AggExpr("count", col("o_orderkey"), "n")])
    _, forest = _profiled(df.collect)
    assert _names(forest) == ["ballista.collect"]


class _Counting:
    entered = 0

    def __init__(self, name):
        pass

    def __enter__(self):
        type(self).entered += 1

    def __exit__(self, *exc):
        return False


def test_no_range_entered_without_a_profiler(ctx, monkeypatch):
    monkeypatch.setattr(tracing, "_range", _Counting)
    assert tracing.span("ballista.x") is tracing.span("ballista.y")
    for q in (1, 3, 13):
        _sql_collect(ctx, q)()
    assert _Counting.entered == 0
    # the same calls under a profiler enter the ranges: the patch is where
    # the program opens them
    _profiled(_sql_collect(ctx, 3))
    assert _Counting.entered > 10


@pytest.mark.parametrize("q", [1, 3, 13, 18, 21])
def test_answers_equal_with_tracing_on_and_off(ctx, q):
    off_batch, off_schema = _sql_collect(ctx, q)()
    (on_batch, on_schema), forest = _profiled(_sql_collect(ctx, q))
    assert forest
    off, on = B.to_numpy(off_batch, off_schema), B.to_numpy(on_batch,
                                                            on_schema)
    assert list(off) == list(on)
    for name in off:
        np.testing.assert_array_equal(off[name][0], on[name][0])
        np.testing.assert_array_equal(off[name][1], on[name][1])
