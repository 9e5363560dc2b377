"""The stage planner against the JAX package: for the 22 TPC-H queries at
SF 0.01 and the serial runtime's own test queries (tests/test_serial.py),
the port's DistributedPlan equals the JAX package's in stage count, each
stage's root kind, the exchange keys, P, quota and salt, and each stage's
sources. (The leaf ids differ by design: the port names a pruned scan
`table::c1,c2`, the reference `table#c1_c2`; sources are compared by
table and columns.)"""

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.client.context import _rebind_scans
from ballista_tpu.planner.optimizer import (prune_columns as jax_prune,
                                            reduce_group_keys as jax_reduce)
from ballista_tpu.scheduler.distributed_planner import (
    DistOptions as JaxDistOptions, DistributedPlanner as JaxPlanner)
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.context import rebind_scans
from ballista_tpu_torch.datagen import TPCH_TABLES
from ballista_tpu_torch.exec.distributed import ExchangeExec, GatherExec
from ballista_tpu_torch.exec.plan import CrossJoinExec
from ballista_tpu_torch.planner.optimizer import (prune_columns,
                                                  reduce_group_keys)
from ballista_tpu_torch.scheduler.distributed_planner import (
    DistOptions, DistributedPlanner)
from test_torch_tpch_six import _contexts

torch.set_num_threads(2)

SERIAL_QUERIES = [
    "select cust, count(*) as c, sum(amount) as s from orders "
    "group by cust order by cust",
    "select c.seg, sum(o.amount) as s, count(*) as n from orders o "
    "join cust c on o.cust = c.c_id group by c.seg order by c.seg",
    "select o_id, amount from orders where amount > 900 "
    "order by amount desc, o_id limit 25",
    "select cust, amount, row_number() over "
    "(partition by cust order by amount desc, o_id) as rn "
    "from orders where cust < 10 order by cust, rn limit 40",
    "select seg from cust union select cust - cust + 7 as seg "
    "from orders where cust = 3 order by seg",
]


def serial_tables():
    """tests/test_serial.py's two tables (seed 11)."""
    rng = np.random.default_rng(11)
    n = 4000
    orders = pa.table({"o_id": np.arange(n, dtype=np.int64),
                       "cust": rng.integers(0, 200, n),
                       "amount": rng.integers(1, 1000, n)})
    cust = pa.table({"c_id": np.arange(200, dtype=np.int64),
                     "seg": rng.integers(0, 5, 200)})
    return {"orders": orders, "cust": cust}


def stage_summary(dplan):
    out = []
    for st in dplan.stages:
        r = st.root
        d = {"kind": type(r).__name__}
        if type(r).__name__ == "ExchangeExec":
            d.update(keys=tuple(r.key_names), P=r.n_parts, quota=r.quota,
                     salt=r.salt, salt_mode=r.salt_mode)
        elif type(r).__name__ == "GatherExec":
            d["P"] = r.n_parts
        d["sources"] = sorted((s.kind, s.name, tuple(s.columns or ()))
                              for s in st.sources.values())
        out.append(d)
    return out


def jax_stages(jctx, sql, P):
    plan = jax_prune(jax_reduce(_rebind_scans(jctx.sql(sql).plan, jctx)))
    return JaxPlanner(jctx, JaxDistOptions(n_partitions=P)).plan(plan)


def port_stages(tctx, sql, P):
    plan = rebind_scans(prune_columns(reduce_group_keys(tctx.sql(sql).plan)),
                        tctx)
    return DistributedPlanner(tctx, DistOptions(n_partitions=P)).plan(plan)


@pytest.fixture(scope="module")
def tpch():
    return _contexts(0.01, list(TPCH_TABLES))


@pytest.fixture(scope="module")
def serial_ctxs():
    jctx = JaxContext(capacity_mode="exact")
    tctx = SessionContext(device="cpu")
    for name, table in serial_tables().items():
        jctx.register_arrow(name, table)
        tctx.register_arrow(name, table)
    return jctx, tctx


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_stage_plan_matches_jax(tpch, q):
    jctx, tctx = tpch
    P = 4 if q % 2 else 8
    want = stage_summary(jax_stages(jctx, TPCH_QUERIES[q], P))
    got = stage_summary(port_stages(tctx, TPCH_QUERIES[q], P))
    assert got == want
    assert len(got) > 1


@pytest.mark.parametrize("qi", range(len(SERIAL_QUERIES)))
def test_serial_query_stage_plan_matches_jax(serial_ctxs, qi):
    jctx, tctx = serial_ctxs
    want = stage_summary(jax_stages(jctx, SERIAL_QUERIES[qi], 4))
    assert stage_summary(port_stages(tctx, SERIAL_QUERIES[qi], 4)) == want


def test_every_stage_but_the_last_is_cut(tpch):
    _, tctx = tpch
    dplan = port_stages(tctx, TPCH_QUERIES[3], 4)
    *cut, last = dplan.stages
    assert all(isinstance(s.root, (ExchangeExec, GatherExec)) for s in cut)
    assert not isinstance(last.root, (ExchangeExec, GatherExec))
    assert dplan.final_stage == last.stage_id
    assert [leaf.input_id for leaf in cut[0].root.leaves()] == \
        ["customer::c_custkey,c_mktsegment"]


def test_one_row_side_broadcasts_past_the_cell_bound(tpch, monkeypatch):
    """Q16's NOT IN count is a global aggregate gathered to every partition;
    past CrossJoinExec.MAX_CELLS (where the reference raises) the cross
    join broadcasts its one row instead of forming every cell."""
    _, tctx = tpch
    monkeypatch.setattr(CrossJoinExec, "MAX_CELLS", 1 << 10)
    dplan = port_stages(tctx, TPCH_QUERIES[16], 4)
    crosses = [n for s in dplan.stages for n in _nodes(s.root)
               if isinstance(n, CrossJoinExec)]
    assert [c._label() for c in crosses] == ["CrossJoinExec[broadcast build]"]
    assert crosses[0].capacity == crosses[0].children[1].capacity


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)
