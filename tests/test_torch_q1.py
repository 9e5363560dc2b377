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

from ballista_tpu.batch import to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.ops.masked_sums import masked_slot_sums

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
    tctx.register_arrow("lineitem", lineitem,
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


@pytest.mark.parametrize("query,n_rows", [("q1", 11), ("q6_shape", 3),
                                          ("extremes", 3)])
def test_aggregate_passes_columns_not_a_matrix(contexts, monkeypatch, query,
                                               n_rows):
    """HashAggregateExec hands masked_slot_sums_rows the value and validity
    columns themselves: count(*) first, each distinct sum and count once,
    no (A, n) matrix; the batch equals the JAX package's."""
    from ballista_tpu_torch.exec import plan as plan_mod
    jctx, tctx = contexts
    calls = []
    real = plan_mod.masked_slot_sums_rows

    def spy(row_slot, rows, T):
        calls.append((row_slot, list(rows), T))
        return real(row_slot, rows, T)

    monkeypatch.setattr(plan_mod, "masked_slot_sums_rows", spy)
    df = tctx.sql(QUERIES[query])
    got = df.to_numpy()
    (row_slot, rows, T), = calls
    assert len(rows) == n_rows and rows[0] == (None, None)
    for data, validity in rows[1:]:
        assert validity.dtype == torch.bool and validity.shape == row_slot.shape
        assert data is None or (data.dtype in (torch.int64, torch.int32)
                                and data.shape == row_slot.shape)
    jbatch, jschema = jctx.sql(QUERIES[query]).collect()
    want = to_numpy(jbatch, jschema)
    for name in want:
        np.testing.assert_array_equal(got[name][1], want[name][1], err_msg=name)
        np.testing.assert_array_equal(got[name][0][got[name][1]],
                                      want[name][0][want[name][1]],
                                      err_msg=name)


TOP = "(select max(l_quantity) as top from lineitem) m"
# aggregates whose argument columns are not plain contiguous int64: a
# literal binds to a stride-0 view, a broadcast cross-join side too, and
# an int32 column goes to the fused call as it is. (query, what the call
# must have been handed)
ODD_COLUMNS = {
    "literals": ("select count(1) as n, sum(1) as s, count('x') as c "
                 "from lineitem", "strided"),
    "literals_grouped": (
        "select l_linestatus, count(1) as n, sum(1) as s, sum(2.5) as d, "
        "avg(3) as a from lineitem group by l_linestatus "
        "order by l_linestatus", "strided"),
    "broadcast": (f"select sum(m.top) as s, count(m.top) as c "
                  f"from lineitem, {TOP}", "strided"),
    "broadcast_grouped": (
        f"select l_linestatus, sum(m.top) as s, count(m.top) as c, "
        f"sum(l_quantity * m.top) as p from lineitem, {TOP} "
        f"group by l_linestatus order by l_linestatus", "strided"),
    "int32": ("select sum(l_linenumber) as s, avg(l_linenumber) as a, "
              "count(l_linenumber) as c from lineitem where l_quantity < 10",
              "int32"),
    "int32_grouped": ("select l_returnflag, sum(l_linenumber) as s "
                      "from lineitem group by l_returnflag "
                      "order by l_returnflag", "int32"),
}


def odd_column_calls(ctx, query, monkeypatch):
    """Runs ODD_COLUMNS[query] on `ctx`; returns (columns as numpy, the
    masked_slot_sums_rows calls the aggregate made). The last call must
    have been handed the kind of column the case is about."""
    from ballista_tpu_torch.exec import plan as plan_mod
    sql, kind = ODD_COLUMNS[query]
    calls = []
    real = plan_mod.masked_slot_sums_rows

    def spy(row_slot, rows, T):
        calls.append((row_slot, list(rows), T))
        return real(row_slot, rows, T)

    monkeypatch.setattr(plan_mod, "masked_slot_sums_rows", spy)
    got = ctx.sql(sql).to_numpy()
    columns = [t for pair in calls[-1][1] for t in pair if t is not None]
    if kind == "strided":
        assert any(not t.is_contiguous() for t in columns)
    else:
        assert any(t.dtype == torch.int32 for t in columns)
    return got, calls


@pytest.mark.parametrize("query", sorted(ODD_COLUMNS))
def test_odd_argument_columns_match_jax(contexts, monkeypatch, query):
    """count(1), sum(1), a sum over a broadcast cross-join column and a sum
    over an int32 column, with no keys and with a small GROUP BY: the
    masked layout answers them as the JAX package does."""
    jctx, tctx = contexts
    got, _ = odd_column_calls(tctx, query, monkeypatch)
    jbatch, jschema = jctx.sql(ODD_COLUMNS[query][0]).collect()
    want = to_numpy(jbatch, jschema)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name][1], want[name][1], err_msg=name)
        np.testing.assert_array_equal(got[name][0][got[name][1]],
                                      want[name][0][want[name][1]],
                                      err_msg=name)


def test_plan_shape(contexts):
    _, tctx = contexts
    plan = tctx.physical_plan(tctx.sql(TPCH_QUERIES[1]).plan).display()
    lines = [line.strip() for line in plan.splitlines()]
    assert lines[0].startswith("SortExec")
    assert lines[1].startswith("ProjectExec")
    assert lines[2].startswith("HashAggregateExec[single]") and "T=12" in lines[2]
    assert lines[3].startswith("InputLeaf(lineitem::")


def test_unported_sql_raises(contexts):
    """A window function and the catalog tables, which used to raise,
    equal the JAX answers; an unknown catalog table raises KeyError in
    both."""
    jctx, tctx = contexts
    sql = ("select l_orderkey, l_linenumber, row_number() over "
           "(order by l_orderkey, l_linenumber) as r from lineitem")
    jbatch, jschema = jctx.sql(sql).collect()
    want, got = to_numpy(jbatch, jschema), tctx.sql(sql).to_numpy()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name][1], want[name][1], err_msg=name)
        np.testing.assert_array_equal(got[name][0], want[name][0], err_msg=name)
    assert sorted(got["r"][0]) == list(range(1, len(got["r"][0]) + 1))
    for sql in ("select * from information_schema.tables",
                "select column_name, data_type from information_schema.columns"
                " where table_name = 'lineitem' order by column_name"):
        jbatch, jschema = jctx.sql(sql).collect()
        want, got = to_numpy(jbatch, jschema), tctx.sql(sql).to_numpy()
        assert list(got) == list(want)
        for name in want:
            np.testing.assert_array_equal(got[name][0], want[name][0],
                                          err_msg=name)
    for ctx in (jctx, tctx):
        with pytest.raises(KeyError, match="unknown catalog table"):
            ctx.sql("select * from information_schema.nothing").collect()


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


def test_every_module_runs_without_jax_pyarrow_pandas():
    """In a fresh interpreter where jax, jaxlib, ballista_tpu, pyarrow and
    pandas cannot be imported: every module of the port imports, a table
    with strings and NULLs registers from numpy arrays, and a DataFrame
    query, EXPLAIN, SHOW TABLES and an h2o question at N = 1000 run."""
    code = textwrap.dedent("""
        import sys
        for m in ("jax", "jaxlib", "ballista_tpu", "pyarrow", "pandas"):
            sys.modules[m] = None
        import importlib, pkgutil
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import ballista_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            ballista_tpu_torch.__path__, "ballista_tpu_torch.")]
        assert len(names) > 30, names
        for name in names:
            importlib.import_module(name)
        from ballista_tpu_torch.benchmarks import h2o
        from ballista_tpu_torch.client import SessionContext, col, lit
        from ballista_tpu_torch.exec.aggregate import AggExpr
        ctx = SessionContext(device="cpu")
        ctx.register_numpy("t", {
            "tag": ["x", None, "y", "x", "y", None],
            "a": np.arange(6), "b": [1.5, None, 2.5, 4.0, None, 8.0]})
        out = (ctx.table("t").filter(col("a") > lit(0))
               .aggregate([col("tag")], [AggExpr("sum", col("a"), "sa"),
                                         AggExpr("count", col("b"), "nb")])
               .sort(col("tag")).to_numpy())
        assert list(out["tag"][0]) == ["x", "y", None], out
        assert list(out["sa"][0]) == [3, 6, 6] and list(out["nb"][0]) == [1, 1, 1]
        plan = ctx.sql("explain select tag, sum(a) from t group by tag").to_numpy()
        assert list(plan["plan_type"][0]) == ["logical_plan", "physical_plan"]
        assert "not available" not in plan["plan"][0][1]
        assert list(ctx.sql("show tables").to_numpy()["table_name"][0]) == ["t"]
        ctx.register_numpy("x", h2o.groupby_table(1000))
        q1 = ctx.sql(h2o.GROUPBY_QUERIES[1]).to_numpy()
        assert int(q1["v1"][0].sum()) == int(h2o.groupby_table(1000)["v1"].sum())
        for fn in (lambda: ctx.table("t").to_pandas(),
                   lambda: ctx.table("t").to_arrow()):
            try:
                fn()
            except ImportError:
                pass
            else:
                raise AssertionError("pandas / pyarrow were importable")
        print("ok")
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
