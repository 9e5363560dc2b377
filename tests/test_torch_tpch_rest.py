"""The nine TPC-H queries that read part or partsupp (Q2, Q8, Q9, Q11,
Q14, Q16, Q17, Q19 and Q20) end to end: SQL through ballista_tpu_torch's
SessionContext on the CPU against ballista_tpu's on JAX-CPU, over all
eight tables at SF 0.01 (seed 19940101). With the thirteen six-table
queries this is all 22. Every comparison is exact: int64 values,
validity and decoded strings, row by row in the order ORDER BY fixes."""

import pytest
import torch

from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.datagen import TPCH_TABLES

from test_torch_tpch_six import _contexts, _same_sql

torch.set_num_threads(2)

SF = 0.01
REST = (2, 8, 9, 11, 14, 16, 17, 19, 20)


@pytest.fixture(scope="module")
def contexts():
    return _contexts(SF, list(TPCH_TABLES))


@pytest.mark.parametrize("q", REST)
def test_query_matches_jax(contexts, q):
    jctx, tctx = contexts
    assert _same_sql(jctx, tctx, TPCH_QUERIES[q]) > 0


def test_plans_take_the_new_paths(contexts):
    _, tctx = contexts

    def labels(q):
        plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[q]).plan).display()
        return [line.strip() for line in plan.splitlines()]

    # Q14, Q17's outer aggregate and Q19 have no key: the kernel's T = 1
    for q in (14, 17, 19):
        agg = next(x for x in labels(q) if x.startswith("HashAggregateExec"))
        assert "keys=[]" in agg and agg.endswith("T=1)"), (q, agg)
    # Q16's NOT IN crosses the one-row count aggregate: a broadcast
    assert "CrossJoinExec[broadcast build]" in labels(16)
