"""The DataFrame API: every method of ballista_tpu_torch's DataFrame against
ballista_tpu's on the same tables, built by the same calls, and TPC-H Q1
and Q3 written as DataFrame calls against their SQL. Integers, decimals,
strings, validity and row order are exact; f64 averages rtol 1e-9."""

import datetime
import inspect

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu import client as JC
from ballista_tpu.exec.aggregate import AggExpr as JAgg
from ballista_tpu_torch import client as TC
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.benchmarks.queries import q1_frame, q3_frame
from ballista_tpu_torch.exec.aggregate import AggExpr as TAgg
from test_torch_stats_aggs import assert_close, both
from test_torch_tpch_six import _contexts

torch.set_num_threads(2)

_RNG = np.random.default_rng(11)
N = 400
T = pa.table({
    "k": pa.array(_RNG.integers(0, 50, N), pa.int64()),
    "tag": pa.array([None if v == 0 else f"t{v}"
                     for v in _RNG.integers(0, 6, N)]),
    "a": pa.array(_RNG.integers(-20, 20, N), pa.int64()),
    "b": pa.array([None if v < 0.1 else float(np.round(v * 100, 3))
                   for v in _RNG.random(N)], pa.float64()),
})
U = pa.table({
    "k": pa.array(np.arange(0, 60, 2), pa.int64()),
    "k2": pa.array(np.arange(0, 60, 2) % 7, pa.int64()),
    "w": pa.array(_RNG.integers(0, 1000, 30), pa.int64()),
    "name": pa.array([f"n{v:02d}" for v in range(30)]),
})


@pytest.fixture(scope="module")
def ctxs():
    return both({"t": T, "u": U})


def _same(ctxs, build, rtol=1e-9):
    """`build(ctx, col, lit, AggExpr)` through both packages."""
    jctx, tctx = ctxs
    jdf = build(jctx, JC.col, JC.lit, JAgg)
    tdf = build(tctx, TC.col, TC.lit, TAgg)
    assert isinstance(tdf, TC.DataFrame)
    jb, js = jdf.collect()
    tb, ts = tdf.collect()
    assert [f.name for f in tdf.schema().fields] == \
        [f.name for f in jdf.schema().fields]
    return assert_close(tb, ts, jb, js, rtol), tdf, jdf


CASES = {
    "table": lambda c, col, lit, A: c.table("t"),
    "filter": lambda c, col, lit, A: c.table("t").filter(col("a") > lit(3)),
    "filter_string": lambda c, col, lit, A:
        c.table("t").filter(col("tag").eq(lit("t3"))),
    "filter_and_null": lambda c, col, lit, A:
        c.table("t").filter((col("b") > lit(50.0)) & (col("a") < lit(0))),
    "select": lambda c, col, lit, A:
        c.table("t").select(col("k"), (col("a") * lit(2) - col("k")).alias("e"),
                            col("tag")),
    "select_columns": lambda c, col, lit, A:
        c.table("t").select_columns("tag", "a"),
    "aggregate": lambda c, col, lit, A:
        c.table("t").aggregate(
            [col("tag")], [A("sum", col("a"), "sa"), A("count_star", alias="n"),
                           A("avg", col("b"), "ab"), A("min", col("k"), "mk"),
                           A("count", col("b"), "nb")]).sort(col("tag")),
    "aggregate_no_keys": lambda c, col, lit, A:
        c.table("t").aggregate([], [A("sum", col("a"), "sa"),
                                    A("max", col("b"), "mb")]),
    "aggregate_filtered": lambda c, col, lit, A:
        c.table("t").filter(col("b") > lit(4.0)).aggregate(
            [col("k")], [A("sum", col("a"), "sum_a")]).sort(col("k")),
    "sort_expr": lambda c, col, lit, A:
        c.table("t").sort(col("k"), col("a"), col("b"), col("tag")),
    "sort_2tuple": lambda c, col, lit, A:
        c.table("t").sort((col("a"), False), (col("k"), True), col("b"),
                          col("tag")),
    "sort_3tuple": lambda c, col, lit, A:
        c.table("t").sort((col("tag"), True, True), (col("b"), False, False),
                          col("k"), col("a")),
    "limit": lambda c, col, lit, A:
        c.table("t").sort(col("k"), col("a"), col("b"), col("tag")).limit(17),
    # a shared key name (str, list of str) can only be used where one
    # side's columns are dropped: the joined schema refuses duplicates.
    # The left frame is the build side and must hold each key once
    "join_str_semi": lambda c, col, lit, A:
        c.table("u").select_columns("k").join(c.table("t"), "k", how="semi")
        .sort(col("k"), col("a"), col("b"), col("tag")),
    "join_list_anti": lambda c, col, lit, A:
        c.table("u").select_columns("k").join(c.table("t"), ["k"], how="anti")
        .sort(col("k"), col("a"), col("b"), col("tag")),
    "join_pairs_unique": lambda c, col, lit, A:
        c.table("u").select(col("k").alias("uk"), col("w")).join(
            c.table("t").select_columns("k", "a"), [("uk", "k")])
        .sort(col("k"), col("a"), col("w")),
    "join_left": lambda c, col, lit, A:
        c.table("u").select(col("k").alias("uk"), col("name")).join(
            c.table("t").select_columns("k", "tag"), [("uk", "k")],
            how="left_outer")
        .sort(col("k"), col("tag"), col("name")),
    "distinct": lambda c, col, lit, A:
        c.table("t").select_columns("tag", "k").distinct()
        .sort(col("tag"), col("k")),
    "chain": lambda c, col, lit, A:
        c.table("t").filter(col("a") > lit(-10))
        .join(c.table("u").select(col("k").alias("uk"), col("w")),
              [("k", "uk")])
        .aggregate([col("tag")], [A("sum", col("w"), "sw")])
        .sort((col("sw"), False), col("tag")).limit(3),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_method_matches_jax(ctxs, case):
    _, tdf, jdf = _same(ctxs, CASES[case])
    # explain() renders the same logical plan
    assert tdf.explain() == jdf.explain()


def test_join_on_shared_name_refuses_duplicate_columns(ctxs):
    for ctx in ctxs:
        with pytest.raises(ValueError, match="duplicate column names"):
            ctx.table("t").join(ctx.table("u"), ["k"]).collect()


def test_signatures_match_reference():
    for name, jm in inspect.getmembers(JC.DataFrame, inspect.isfunction):
        if name.startswith("_") and name != "__init__":
            continue
        tm = getattr(TC.DataFrame, name)
        assert list(inspect.signature(tm).parameters) == \
            list(inspect.signature(jm).parameters), name
    assert inspect.signature(TC.col) == inspect.signature(JC.col)
    assert set(JC.__dict__) - set(TC.__dict__) <= {"context", "dataframe"}
    for name in ("table", "register_arrow", "register_pandas", "register_csv",
                 "register_parquet", "register_json", "read_csv",
                 "read_parquet", "read_json", "register_udf", "list_functions",
                 "warn", "take_warnings", "unique_keys", "sql", "set_config",
                 "evict_device"):
        assert list(inspect.signature(
            getattr(TC.SessionContext, name)).parameters) == list(
            inspect.signature(getattr(JC.SessionContext, name)).parameters), \
            name


def test_to_pandas_and_to_arrow(ctxs):
    jctx, tctx = ctxs
    build = CASES["aggregate"]
    jdf = build(jctx, JC.col, JC.lit, JAgg)
    tdf = build(tctx, TC.col, TC.lit, TAgg)
    pd.testing.assert_frame_equal(tdf.to_pandas(), jdf.to_pandas(),
                                  check_exact=False, rtol=1e-9)
    assert tdf.to_arrow().schema.equals(jdf.to_arrow().schema)
    assert tdf.to_arrow().select(["tag", "sa", "n"]).equals(
        jdf.to_arrow().select(["tag", "sa", "n"]))


def test_table_carries_unique_columns(ctxs):
    jctx, tctx = ctxs
    assert set(tctx.table("u").plan.unique_cols) == \
        set(jctx.table("u").plan.unique_cols) == {("k",), ("w",), ("name",)} \
        or set(tctx.table("u").plan.unique_cols) == \
        set(jctx.table("u").plan.unique_cols)
    with pytest.raises(KeyError):
        tctx.table("nope")


def test_session_warnings_functions_config_evict(ctxs):
    from ballista_tpu.config import BallistaConfig as JConfig
    from ballista_tpu_torch.config import (BALLISTA_MAX_GROUP_TABLE,
                                           BALLISTA_PLUGIN_DIR, BallistaConfig)
    jctx, tctx = ctxs
    tctx.warn("w1")
    assert tctx.take_warnings()[-1] == "w1" and tctx.take_warnings() == []
    assert {f.name for f in tctx.list_functions("window")} == \
        {f.name for f in jctx.list_functions("window")}
    assert {f.name for f in jctx.list_functions("aggregate")} <= \
        {f.name for f in tctx.list_functions("aggregate")} | {"variance"}
    cfg = BallistaConfig({BALLISTA_MAX_GROUP_TABLE: "4096"})
    assert cfg.to_physical_options().max_group_table == 4096 == \
        JConfig({BALLISTA_MAX_GROUP_TABLE: "4096"}).to_physical_options() \
        .max_group_table
    tctx.set_config(cfg)
    assert tctx.config is cfg
    from ballista_tpu_torch.plugin import PluginError
    with pytest.raises(PluginError, match="does not exist"):
        tctx.set_config(BallistaConfig({BALLISTA_PLUGIN_DIR: "/nowhere"}))
    with pytest.raises(KeyError):
        BallistaConfig({"ballista.nope": "1"})
    tctx.table("t").collect()
    assert tctx.tables["t"]._cols
    tctx.evict_device()
    assert not tctx.tables["t"]._cols
    assert int(tctx.table("t").collect()[0].num_rows) == N


def test_listed_scalar_functions_all_bind(ctxs):
    """`list_functions` is read off the binder's own table: every scalar
    it lists binds, and a name it does not list raises."""
    from ballista_tpu_torch import exprs as E
    _, tctx = ctxs
    schema = tctx.tables["t"].schema
    date = E.Lit(datetime.date(1995, 3, 15))
    args = {"extract_year": (date,), "extract_month": (date,),
            "extract_day": (date,),
            "date_trunc": (E.Lit("month"), date),
            "substring": (E.Col("tag"), E.Lit(1), E.Lit(1)),
            "replace": (E.Col("tag"), E.Lit("t"), E.Lit("u")),
            "concat": (E.Col("tag"), E.Lit("x")),
            "coalesce": (E.Col("b"), E.Lit(0.0))}
    strings = ("upper", "lower", "trim", "ltrim", "rtrim", "reverse", "length",
               "char_length", "character_length", "octet_length")
    listed = [f.name for f in tctx.list_functions("scalar")]
    assert sorted(listed) == sorted(E.SCALAR_FN_NAMES)
    for name in listed:
        a = args.get(name, (E.Col("tag"),) if name in strings
                     else (E.Col("b"),))
        E.bind_expr(E.ScalarFn(name, a), schema)
    with pytest.raises(NotImplementedError, match="no_such_fn"):
        E.bind_expr(E.ScalarFn("no_such_fn", (E.Col("b"),)), schema)


def test_errors_classify():
    from ballista_tpu.errors import classify as jclassify
    from ballista_tpu_torch.errors import BallistaError, classify
    for exc in (NotImplementedError("x"), OSError("x"), MemoryError("x"),
                KeyError("x"), ValueError("x"), RuntimeError("x"),
                SyntaxError("x")):
        assert classify(exc).kind == jclassify(exc).kind, exc
    assert classify(RuntimeError("CUDA out of memory")).kind == \
        "resource_exhausted"
    e = BallistaError("io", "lost")
    assert e.retryable and BallistaError.from_dict(e.to_dict()) == e


# -- TPC-H Q1 and Q3 as DataFrame calls -------------------------------------

@pytest.fixture(scope="module")
def tpch():
    return _contexts(0.01, ["lineitem", "orders", "customer"])


@pytest.mark.parametrize("q,frame", [(1, q1_frame), (3, q3_frame)])
def test_tpch_frame_equals_sql(tpch, q, frame):
    jctx, tctx = tpch
    got, tdf, _ = _same(tpch, frame)
    want = tctx.sql(TPCH_QUERIES[q]).to_numpy()
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name][1], want[name][1], err_msg=name)
        np.testing.assert_array_equal(got[name][0], want[name][0], err_msg=name)
    assert len(got[list(got)[0]][0]) > 0
