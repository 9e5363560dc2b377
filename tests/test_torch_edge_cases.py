"""Edge cases through both packages: the SQL and DataFrame cases of
tests/test_edge_cases.py (empty tables, fully filtered batches, single
rows, NULLs, FROM-less selects, modulo, uncorrelated EXISTS, expression IN),
tests/test_parity_extras.py (function registry, information_schema),
tests/test_ndv_capacity.py (aggregate capacity from key metadata) and
tests/test_group_key_reduction.py (dependent group keys). `BothContexts`
registers every table in ballista_tpu_torch (CPU) and ballista_tpu and
holds the two answers equal as pandas frames before a case checks the
port's against its expectation; plan-shape cases compare the two plans."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu.client.context import _rebind_scans
from ballista_tpu.exec import plan as JP
from ballista_tpu.planner.physical import create_physical_plan as jax_physical
from ballista_tpu_torch.exec import plan as TP
from test_torch_fuzz import BothContexts

torch.set_num_threads(2)


def pd_isna(x):
    return pd.isna(x)


@pytest.fixture(scope="module")
def ctx():
    c = BothContexts()
    c.register_arrow("empty", pa.table({
        "k": pa.array([], pa.int64()), "v": pa.array([], pa.float32()),
        "s": pa.array([], pa.string())}))
    c.register_arrow("one", pa.table({
        "k": pa.array([42], pa.int64()), "v": pa.array([1.5], pa.float32())}))
    c.register_arrow("nullt", pa.table({
        "k": pa.array([1, None, 3], pa.int64()),
        "v": pa.array([None, None, None], pa.float32())}))
    c.register_arrow("big", pa.table({
        "k": pa.array(list(range(100)), pa.int64()),
        "g": pa.array(["a", "b"] * 50)}), primary_key=("k",))
    return c


def test_empty_table_scan_and_agg(ctx):
    df = ctx.sql("select count(*) as n, sum(v) as s from empty").to_pandas()
    assert int(df["n"][0]) == 0
    assert np.isnan(df["s"][0])  # SUM over empty = NULL


def test_empty_group_by(ctx):
    df = ctx.sql("select s, count(*) as n from empty group by s").to_pandas()
    assert len(df) == 0


def test_filter_eliminates_all(ctx):
    df = ctx.sql("select k from big where k < 0").to_pandas()
    assert len(df) == 0
    df = ctx.sql("select g, count(*) n from big where k < 0 group by g") \
        .to_pandas()
    assert len(df) == 0
    df = ctx.sql("select k from big where k < 0 order by k").to_pandas()
    assert len(df) == 0


def test_join_with_empty_side(ctx):
    df = ctx.sql("select one.k from one, empty where one.k = empty.k").to_pandas()
    assert len(df) == 0
    df2 = ctx.sql(
        "select big.k from big left join empty on big.k = empty.k "
        "order by big.k limit 3").to_pandas()
    assert list(df2["k"]) == [0, 1, 2]


def test_single_row(ctx):
    df = ctx.sql("select k, v from one where v > 1").to_pandas()
    assert list(df["k"]) == [42]


def test_all_null_aggregates(ctx):
    df = ctx.sql("select sum(v) as s, min(v) as mn, count(v) as c, "
                 "count(*) as n from nullt").to_pandas()
    assert np.isnan(df["s"][0]) and np.isnan(df["mn"][0])
    assert int(df["c"][0]) == 0 and int(df["n"][0]) == 3


def test_group_by_null_key(ctx):
    df = ctx.sql("select k, count(*) as n from nullt group by k "
                 "order by k nulls first").to_pandas()
    assert len(df) == 3
    assert df["k"].isna().iloc[0]


def test_select_without_from():
    df = BothContexts().sql("select 1 + 1 as two, 7 * 6 as ans").to_pandas()
    assert len(df) == 1
    assert int(df["two"][0]) == 2 and int(df["ans"][0]) == 42


def test_modulo_and_trunc_division():
    ctx = BothContexts()
    ctx.register_arrow("m", pa.table({
        "a": pa.array([7, -7, 7, -7, 5, 0], pa.int64()),
        "b": pa.array([2, 2, -2, -2, 0, 3], pa.int64()),
    }))
    df = ctx.sql("select a, b, a % b as m, a / b as d from m").to_pandas()
    # SQL semantics: / truncates toward zero, % has dividend's sign
    assert [None if pd_isna(x) else int(x) for x in df["d"]] == \
        [3, -3, -3, 3, None, 0]
    got_m = [None if pd_isna(x) else int(x) for x in df["m"]]
    assert got_m == [1, -1, 1, -1, None, 0]


def test_float_modulo():
    df = BothContexts().sql("select 7.5 % 2 as m").to_pandas()
    assert abs(float(df["m"][0]) - 1.5) < 1e-9


# -- uncorrelated EXISTS / NOT EXISTS: a global row-count fact ----------------

@pytest.fixture(scope="module")
def exists_ctx():
    c = BothContexts()
    c.register_arrow("t", pa.table({"x": [1, 2, 3, None],
                                    "y": [10, 20, 30, 40]}))
    c.register_arrow("s", pa.table({"z": [5]}))
    c.register_arrow("e", pa.table({"z": pa.array([], type=pa.int64())}))
    return c


@pytest.mark.parametrize("sql,expect", [
    ("select y from t where exists (select 1 from s)", [10, 20, 30, 40]),
    ("select y from t where exists (select 1 from e)", []),
    ("select y from t where exists (select 1 from s where z = 99)", []),
    ("select y from t where not exists (select z from e where z > 3)",
     [10, 20, 30, 40]),
    ("select y from t where not exists (select 1 from s where z = 5)", []),
])
def test_uncorrelated_exists(exists_ctx, sql, expect):
    assert sorted(exists_ctx.sql(sql).to_pandas().y) == expect


def test_non_equi_correlated_exists():
    """Correlated non-equi predicates must not be planned as an
    uncorrelated global count: EXISTS (SELECT 1 FROM s WHERE s.z > t.x)
    is a per-row theta semi-join."""
    ctx = BothContexts()
    ctx.register_arrow("t", pa.table({"x": [10, 20, 30]}))
    ctx.register_arrow("s", pa.table({"z": [15]}))
    r = ctx.sql("select x from t where exists "
                "(select 1 from s where s.z > t.x) order by x")
    assert r.to_pandas().x.tolist() == [10]
    r = ctx.sql("select x from t where not exists "
                "(select 1 from s where s.z > t.x) order by x")
    assert r.to_pandas().x.tolist() == [20, 30]


# -- <expr> IN (subquery) -----------------------------------------------------

@pytest.fixture(scope="module")
def in_ctx():
    c = BothContexts()
    c.register_arrow("t", pa.table({"x": [1, 2, 3, None],
                                    "y": [10, 20, 30, 40]}))
    c.register_arrow("s", pa.table({"z": [3, 4]}))
    c.register_arrow("u", pa.table({"k": [1, 2, 3], "w": [2, 99, 4]}))
    c.register_arrow("u2", pa.table({"k": [1, 2, 3], "w": [0, 99, 2]}))
    return c


@pytest.mark.parametrize("sql,expect", [
    ("select y from t where x + 1 in (select z from s)", [20, 30]),
    ("select y from t where x + 1 not in (select z from s)", [10]),
    ("select y from t where x + 1 in (select w from u where u.k = t.x)",
     [10, 30]),
    ("select y from t where x in (select w + 1 from u2 where u2.k = t.x)",
     [10, 30]),
])
def test_expression_lhs_in(in_ctx, sql, expect):
    assert sorted(in_ctx.sql(sql).to_pandas().y) == expect


def test_in_subquery_with_order_by_limit():
    """IN (... ORDER BY ... LIMIT k) is a top-k membership set: the Limit
    must not be stripped (only the order is irrelevant)."""
    ctx = BothContexts()
    ctx.register_arrow("lt", pa.table({"x": [1, 2, 3, 4]}))
    ctx.register_arrow("ls", pa.table({"z": [3, 1, 2]}))
    r = ctx.sql("select x from lt where x in "
                "(select z from ls order by z desc limit 1)").to_pandas()
    assert sorted(r.x) == [3]
    r = ctx.sql("select x from lt where x in "
                "(select z from ls order by z limit 2)").to_pandas()
    assert sorted(r.x) == [1, 2]


# -- tests/test_parity_extras.py ----------------------------------------------

def test_functions_list_and_search():
    from ballista_tpu.functions import list_functions as jlist
    from ballista_tpu_torch.functions import list_functions, search_functions
    names = {f.name for f in list_functions()}
    assert {"sum", "avg", "row_number", "coalesce"} <= names
    hits = search_functions("rank")
    assert {"rank", "dense_rank", "percent_rank"} <= {f.name for f in hits}
    assert all(f.kind == "aggregate"
               for f in list_functions(kind="aggregate"))
    # whatever the reference lists as a built-in, the port lists too, bar
    # the reference's one display name ("variance" there is var/variance)
    assert {f.name for f in jlist() if f.kind != "udf"} <= names
    assert {f.as_dict()["signature"] for f in list_functions()}


def test_udfs_listed_and_callable():
    from ballista_tpu import schema as JS
    from ballista_tpu_torch import schema as TS
    from ballista_tpu_torch.functions import list_functions
    ctx = BothContexts()
    ctx.jctx.register_udf("edge_double", lambda x: x * 2, JS.INT64)
    ctx.tctx.register_udf("edge_double", lambda x: x * 2, TS.INT64)
    assert "edge_double" in {f.name for f in list_functions(kind="udf")}
    assert "edge_double" in {f.name for f in ctx.tctx.list_functions("udf")}
    ctx.register_arrow("t", pa.table({"x": [1, 2, 3]}))
    df = ctx.sql("select edge_double(x) as y from t order by y").to_pandas()
    assert df["y"].tolist() == [2, 4, 6]


def test_information_schema_tables_and_columns():
    ctx = BothContexts()
    ctx.register_arrow("t", pa.table({"x": [1, 2], "s": ["a", None]}))
    df = ctx.sql("select table_name, table_type from "
                 "information_schema.tables where table_name = 't'"
                 ).to_pandas()
    assert df["table_name"].tolist() == ["t"]
    cols = ctx.sql("select column_name, data_type from "
                   "information_schema.columns where table_name = 't' "
                   "order by column_name").to_pandas()
    assert cols["column_name"].tolist() == ["s", "x"]
    assert cols["data_type"].tolist() == ["string", "int64"]


# -- tests/test_ndv_capacity.py -----------------------------------------------

def _plans(ctx, sql):
    jctx, tctx = ctx.jctx, ctx.tctx
    jplan = _rebind_scans(jctx.sql(sql).plan, jctx)
    caps = {n: tp.capacity for n, tp in jctx.tables.items()}
    return (jax_physical(jplan, caps, jctx.options),
            tctx.physical_plan(tctx.sql(sql).plan))


def _aggs(root, mod):
    out = []

    def walk(n):
        if isinstance(n, mod.HashAggregateExec):
            out.append(n)
        for c in n.children:
            walk(c)
    walk(root)
    return out


@pytest.fixture(scope="module")
def ndv():
    rng = np.random.default_rng(7)
    n = 5000
    df = pd.DataFrame({
        "k": rng.integers(0, 40, n),           # int_bound width 40
        "d": (pd.to_datetime("1995-01-01") + pd.to_timedelta(
            rng.integers(0, 365 * 3, n), unit="D")).date,
        "v": rng.integers(0, 1000, n).astype(np.int64),
    })
    c = BothContexts()
    c.register_pandas("t", df)
    return c, df


@pytest.mark.parametrize("sql", [
    "select k, sum(v) s from t group by k",
    # 3 distinct years
    "select extract(year from d) y, count(*) c from t group by y",
    # ~37 months; the raw day-range width (~1100) would not bound this
    "select date_trunc('month', d) m, count(*) c from t group by m",
])
def test_key_metadata_bounds_the_aggregate(ndv, sql):
    ctx, _ = ndv
    jroot, troot = _plans(ctx, sql)
    (jagg,), (tagg,) = _aggs(jroot, JP), _aggs(troot, TP)
    assert tagg.capacity <= 256 and tagg.table_size <= 256
    assert (tagg.capacity, tagg.table_size) == (jagg.capacity, jagg.table_size)
    assert len(ctx.sql(sql).to_pandas()) > 0


def test_results_exact_under_bounding(ndv):
    ctx, df = ndv
    got = ctx.sql("select k, sum(v) s, count(*) c from t group by k "
                  "order by k").to_pandas()
    exp = (df.groupby("k").agg(s=("v", "sum"), c=("v", "count"))
           .reset_index().sort_values("k"))
    assert (got["k"].to_numpy() == exp["k"].to_numpy()).all()
    assert (got["s"].to_numpy() == exp["s"].to_numpy()).all()
    assert (got["c"].to_numpy() == exp["c"].to_numpy()).all()


def test_year_group_exact(ndv):
    ctx, df = ndv
    got = ctx.sql("select extract(year from d) y, sum(v) s from t "
                  "group by y order by y").to_pandas()
    exp = (df.assign(y=pd.to_datetime(df["d"]).dt.year).groupby("y")
           .agg(s=("v", "sum")).reset_index().sort_values("y"))
    assert (got["y"].to_numpy() == exp["y"].to_numpy()).all()
    assert (got["s"].to_numpy() == exp["s"].to_numpy()).all()


# -- tests/test_group_key_reduction.py ----------------------------------------

@pytest.fixture(scope="module")
def fd():
    rng = np.random.default_rng(3)
    n_c, n_o = 40, 400
    cust = pd.DataFrame({
        "ck": np.arange(n_c),
        "name": [f"Customer#{i:03d}" for i in range(n_c)],
        "bal": rng.integers(-100, 10_000, n_c),
    })
    cust.loc[7, "name"] = None     # one NULL name to check the NULL carry
    orders = pd.DataFrame({
        "ok": np.arange(n_o),
        "ock": rng.integers(0, n_c, n_o),
        "price": rng.integers(1, 500, n_o),
    })
    c = BothContexts()
    c.register_arrow("cust", pa.Table.from_pandas(cust), primary_key=("ck",))
    c.register_arrow("orders", pa.Table.from_pandas(orders),
                     primary_key=("ok",))
    return c, cust, orders


def agg_keys(ctx, sql):
    """The aggregate's key list, the same in both packages' plans."""
    keys = []
    for root in _plans(ctx, sql):
        line = next(ln for ln in root.display().splitlines()
                    if "HashAggregateExec" in ln)
        keys.append(line.split("keys=")[1].split("]")[0] + "]")
    assert keys[0] == keys[1]
    return keys[1]


def test_dependent_keys_demoted(fd):
    ctx, cust, orders = fd
    q = """select c.ck, c.name, c.bal, sum(o.price) s, count(*) n
           from orders o join cust c on o.ock = c.ck
           group by c.ck, c.name, c.bal order by c.ck"""
    assert agg_keys(ctx, q) == "['ck']"
    got = ctx.sql(q).to_pandas()
    exp = (orders.merge(cust, left_on="ock", right_on="ck")
           .groupby("ck", dropna=False)
           .agg(name=("name", "first"), bal=("bal", "first"),
                s=("price", "sum"), n=("price", "count"))
           .reset_index().sort_values("ck"))
    assert (got["ck"].to_numpy() == exp["ck"].to_numpy()).all()
    assert got["name"].fillna("~").tolist() == exp["name"].fillna("~").tolist()
    assert (got["bal"].to_numpy() == exp["bal"].to_numpy()).all()
    assert (got["s"].to_numpy() == exp["s"].to_numpy()).all()
    assert (got["n"].to_numpy() == exp["n"].to_numpy()).all()


def test_transitive_through_join(fd):
    # ok unique in orders -> determines ock; ock = ck -> determines cust cols
    ctx, cust, orders = fd
    q = """select o.ok, o.price, c.name, count(*) n
           from orders o join cust c on o.ock = c.ck
           group by o.ok, o.price, c.name order by o.ok limit 5"""
    assert agg_keys(ctx, q) == "['ok']"
    got = ctx.sql(q).to_pandas()
    exp = (orders.merge(cust, left_on="ock", right_on="ck")
           .groupby("ok").agg(price=("price", "first"),
                              name=("name", "first"), n=("ck", "count"))
           .reset_index().sort_values("ok").head(5))
    assert (got["ok"].to_numpy() == exp["ok"].to_numpy()).all()
    assert (got["price"].to_numpy() == exp["price"].to_numpy()).all()
    assert got["name"].fillna("~").tolist() == exp["name"].fillna("~").tolist()


def test_no_unique_key_no_demotion(fd):
    # price is not unique: grouping keys must be untouched
    ctx, _, _ = fd
    q = "select price, ock, count(*) n from orders group by price, ock"
    assert agg_keys(ctx, q) in ("['o.price', 'o.ock']", "['price', 'ock']")
    assert len(ctx.sql(q + " order by price, ock").to_pandas()) > 0
