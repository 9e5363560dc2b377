"""The port's slice end to end: SQL through ballista_tpu_torch's
SessionContext on the CPU against ballista_tpu's on JAX-CPU, over the same
lineitem (registered in both through the JAX package's host ingest).
Raw scaled values, validity and decoded keys must be equal."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from ballista_tpu.batch import ingest_column_host, schema_from_arrow, to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import from_ingested
from ballista_tpu_torch.ops.masked_sums import masked_slot_sums
from ballista_tpu_torch.schema import DataType, Field, TypeKind

torch.set_num_threads(2)

SF = 0.01
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUERIES = {
    "q1": TPCH_QUERIES[1],
    # no GROUP BY: one slot, every row live or not by the WHERE clause
    "q6_shape": """
        select sum(l_extendedprice * l_discount) as revenue, count(*) as n
        from lineitem
        where l_shipdate >= date '1994-01-01' and l_shipdate < date '1995-01-01'
          and l_discount >= 0.05 and l_discount <= 0.07 and l_quantity < 24
    """,
    # min / max / int sums beside the fused sums, one key
    "extremes": """
        select l_linestatus, min(l_shipdate) as first_ship,
               max(l_quantity) as most, min(l_returnflag) as flag,
               count(l_tax) as n, avg(l_tax) as avg_tax
        from lineitem
        where l_quantity > 10
        group by l_linestatus
        order by l_linestatus
    """,
    # FROM-less: OneRowExec + int and decimal literal arithmetic
    "one_row": "select 1 + 2 as x, 7 % 3 as y, 2.50 * 4 as z",
}


@pytest.fixture(scope="module")
def lineitem():
    return generate_table("lineitem", SF)


@pytest.fixture(scope="module")
def contexts(lineitem):
    jctx = JaxContext(capacity_mode="exact")
    jctx.register_arrow("lineitem", lineitem,
                        primary_key=REF_TABLES["lineitem"][1])
    tctx = SessionContext(device="cpu")
    fields, cols = [], {}
    for f in schema_from_arrow(lineitem.schema).fields:
        values, validity, dictionary, _, bounds = ingest_column_host(
            lineitem[f.name], f, lineitem.num_rows)
        cols[f.name] = from_ingested(values, validity, dictionary, bounds)
        fields.append(Field(f.name, DataType(TypeKind(f.dtype.kind.value),
                                             f.dtype.precision, f.dtype.scale),
                            f.nullable))
    tctx.register_host("lineitem", fields, cols,
                       primary_key=REF_TABLES["lineitem"][1])
    return jctx, tctx


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_matches_jax(contexts, query):
    jctx, tctx = contexts
    jbatch, jschema = jctx.sql(QUERIES[query]).collect()
    want = to_numpy(jbatch, jschema)
    before = masked_slot_sums.launches
    df = tctx.sql(QUERIES[query])
    tbatch, tschema = df.collect()
    got = df.to_numpy()
    assert [f.name for f in tschema.fields] == [f.name for f in jschema.fields]
    assert [repr(f.dtype) for f in tschema.fields] == \
        [repr(f.dtype) for f in jschema.fields]
    assert int(tbatch.num_rows) == int(jbatch.num_rows) > 0
    for name in want:
        wv, wvalid = want[name]
        gv, gvalid = got[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
        np.testing.assert_array_equal(gv[gvalid], wv[wvalid], err_msg=name)
    # CPU tensors take the plain version: the kernel counter never moves
    assert masked_slot_sums.launches == before


def test_plan_shape(contexts):
    _, tctx = contexts
    plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[1]).plan).display()
    lines = [line.strip() for line in plan.splitlines()]
    assert lines[0].startswith("SortExec")
    assert lines[1].startswith("ProjectExec")
    assert lines[2].startswith("HashAggregateExec[single]") and "T=12" in lines[2]
    assert lines[3].startswith("InputLeaf(lineitem::")


def test_unported_sql_raises(contexts):
    _, tctx = contexts
    with pytest.raises(NotImplementedError, match="window"):
        tctx.sql("select l_orderkey, row_number() over (order by l_orderkey) "
                 "as r from lineitem").collect()


def test_cuda_context_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SessionContext()


def test_q1_runs_without_jax_pyarrow_pandas():
    """The port's Q1 path in a fresh interpreter where importing jax,
    ballista_tpu, pyarrow or pandas fails."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "ballista_tpu", "pyarrow", "pandas"):
            sys.modules[m] = None
        import torch
        torch.set_num_threads(2)
        from ballista_tpu_torch.benchmarks import TPCH_QUERIES
        from ballista_tpu_torch.client import SessionContext
        from ballista_tpu_torch.datagen import register_tpch
        ctx = SessionContext(device="cpu")
        register_tpch(ctx, 0.001)
        out = ctx.sql(TPCH_QUERIES[1]).to_numpy()
        assert list(out["l_returnflag"][0]) == ["A", "N", "N", "R"], out
        assert int(out["count_order"][0].sum()) > 0
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
