"""The statements beside SELECT: CTEs, EXPLAIN, SHOW TABLES, SHOW COLUMNS /
DESCRIBE, CREATE TABLE AS, CREATE EXTERNAL TABLE (csv, parquet, json) and
the information_schema tables, through ballista_tpu_torch's SessionContext
on the CPU and ballista_tpu's, same script, same files. Results are compared
as pandas frames, exactly; EXPLAIN by its row count and plan_type column,
not by plan text."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu_torch.client import SessionContext

torch.set_num_threads(2)

T = pa.table({"x": [1, 2, 3, 4], "g": ["a", "b", "a", "b"]})


def _ctxs():
    jctx, tctx = JaxContext(capacity_mode="exact"), SessionContext(device="cpu")
    jctx.register_arrow("t", T)
    tctx.register_arrow("t", T)
    return jctx, tctx


def _same(ctxs, sql):
    jctx, tctx = ctxs
    want, got = jctx.sql(sql).to_pandas(), tctx.sql(sql).to_pandas()
    pd.testing.assert_frame_equal(got, want)
    return got


# -- tests/test_cte_explain.py's cases --------------------------------------

CTE_CASES = {
    "basic": ("with s as (select g, sum(x) as sx from t group by g) "
              "select * from s where sx > 3 order by g",
              {"g": ["a", "b"], "sx": [4, 6]}),
    "chain_aliases_and_multiple_refs": (
        "with a (k, v) as (select g, sum(x) from t group by g), "
        "b as (select k, v*2 as v2 from a) "
        "select a.k, a.v, b.v2 from a join b on a.k = b.k order by a.k",
        {"v": [4, 6], "v2": [8, 12]}),
    "shadows_base_table": ("with t as (select x+10 as x from t) "
                           "select sum(x) as s from t", {"s": [50]}),
    "under_setop": ("with s as (select x from t where x > 2) "
                    "select x from s union all select x from s order by x",
                    {"x": [3, 3, 4, 4]}),
}


@pytest.mark.parametrize("case", sorted(CTE_CASES))
def test_cte(case):
    sql, expect = CTE_CASES[case]
    got = _same(_ctxs(), sql)
    for name, values in expect.items():
        assert got[name].tolist() == values


def test_cte_scope_does_not_leak():
    for ctx in _ctxs():
        ctx.sql("with s as (select x from t) select * from s")
        with pytest.raises(KeyError):
            ctx.sql("select * from s")


def test_with_recursive_rejected():
    for ctx in _ctxs():
        with pytest.raises(NotImplementedError):
            ctx.sql("with recursive r as (select 1) select * from r")


@pytest.mark.parametrize("sql", [
    "explain select g, sum(x) from t group by g",
    "explain verbose with s as (select x from t) select sum(x) from s",
    "explain select x from t where x > 1 order by x limit 2",
])
def test_explain_statement(sql):
    jctx, tctx = _ctxs()
    want, got = jctx.sql(sql).to_pandas(), tctx.sql(sql).to_pandas()
    assert list(got.columns) == list(want.columns) == ["plan_type", "plan"]
    assert got.plan_type.tolist() == want.plan_type.tolist() == \
        ["logical_plan", "physical_plan"]
    # the logical tier is the same text; the physical tier is rendered
    assert got.plan[0] == want.plan[0]
    assert "TableScan" in got.plan[0]
    assert "not available" not in got.plan[1]
    assert "InputLeaf" in got.plan[1]


def test_explain_survives_a_planning_error(monkeypatch):
    _, tctx = _ctxs()

    def boom(*a, **k):
        raise ValueError("no plan today")
    monkeypatch.setattr(tctx, "physical_plan", boom)
    df = tctx.sql("explain select x from t")
    monkeypatch.undo()
    got = df.to_pandas()
    assert got.plan_type.tolist() == ["logical_plan", "physical_plan"]
    assert got.plan[1] == "<not available: no plan today>"


# -- catalog statements -------------------------------------------------------

def _files(tmp_path):
    csv = tmp_path / "people.csv"
    csv.write_text("id,name,score\n1,ann,2.5\n2,bob,1.0\n3,cat,9.5\n")
    raw = tmp_path / "raw.csv"
    raw.write_text("4,dee\n5,eli\n")
    parquet = tmp_path / "p.parquet"
    pq.write_table(pa.table({
        "k": pa.array([3, 1, 2, None], pa.int64()),
        "s": ["c", None, "b", "a"],
        "d": pa.array([10, 20, None, 40], pa.date32())}), parquet)
    json = tmp_path / "j.json"
    json.write_text('{"a": 1, "b": "x"}\n{"a": 2, "b": null}\n'
                    '{"a": 3, "b": "z"}\n')
    return csv, raw, parquet, json


@pytest.fixture()
def catalog(tmp_path):
    csv, raw, parquet, json = _files(tmp_path)
    ctxs = _ctxs()
    for ctx in ctxs:
        ctx.sql(f"CREATE EXTERNAL TABLE people STORED AS CSV WITH HEADER ROW "
                f"LOCATION '{csv}'; SELECT 1 as ok")
        ctx.sql(f"CREATE EXTERNAL TABLE raw (id int, name varchar) "
                f"STORED AS CSV LOCATION '{raw}'; SELECT 1 as ok")
        ctx.sql(f"CREATE EXTERNAL TABLE pq STORED AS PARQUET "
                f"LOCATION '{parquet}'; SELECT 1 as ok")
        ctx.sql(f"CREATE EXTERNAL TABLE js STORED AS JSON "
                f"LOCATION '{json}'; SELECT 1 as ok")
        ctx.sql("create view big as select x from t where x > 2; select 1")
    return ctxs


@pytest.mark.parametrize("sql", [
    "select name from people where score > 2 order by id",
    "select id, name from raw order by id",
    "select k, s, d from pq order by k",
    "select a, b from js order by a",
    "select count(*) as n, max(s) as m, min(d) as d from pq",
    "SHOW TABLES",
    "SHOW COLUMNS FROM people",
    "SHOW COLUMNS FROM pq",
    "DESCRIBE raw",
    "select * from information_schema.tables",
    "select table_name, table_type from information_schema.tables "
    "where table_type = 'VIEW'",
    "select * from information_schema.columns",
    "select table_name, count(*) as n from information_schema.columns c "
    "group by table_name order by table_name",
    "select x from big order by x",
])
def test_catalog_statement(catalog, sql):
    got = _same(catalog, sql)
    assert len(got) > 0


def test_catalog_shapes(catalog):
    _, tctx = catalog
    t = tctx.sql("SHOW TABLES").to_pandas()
    assert list(t.columns) == ["table_catalog", "table_schema", "table_name",
                               "table_type"]
    assert set(t["table_name"]) == {"t", "people", "raw", "pq", "js", "big"}
    assert set(t["table_type"]) == {"BASE TABLE", "VIEW"}
    d = tctx.sql("DESCRIBE raw").to_pandas()
    assert list(d["column_name"]) == ["id", "name"]
    assert list(d["data_type"]) == ["int32", "string"]
    assert list(d["is_nullable"]) == ["YES", "YES"]
    # the statements' own tables stay out of the listing
    assert not any(n.startswith("__") for n in
                   tctx.sql("show tables").to_pandas()["table_name"])
    for ctx in catalog:
        with pytest.raises(KeyError):
            ctx.sql("show columns from nothing")
        with pytest.raises(KeyError):
            ctx.sql("select * from information_schema.nothing")


def test_show_tables_of_an_empty_session():
    tctx = SessionContext(device="cpu")
    t = tctx.sql("SHOW TABLES").to_pandas()
    assert len(t) == 0 and list(t.columns)[2] == "table_name"
    assert len(tctx.sql("select * from information_schema.columns")
               .to_pandas()) == 0


def test_external_table_of_unknown_format(tmp_path):
    for ctx in _ctxs():
        with pytest.raises(NotImplementedError, match="STORED AS"):
            ctx.sql(f"CREATE EXTERNAL TABLE a STORED AS AVRO LOCATION "
                    f"'{tmp_path}/a.avro'; select 1")


def test_create_table_as(catalog):
    for ctx in catalog:
        ctx.sql("create table agg as select g, sum(x) as sx, avg(x) as ax, "
                "max(g) as mg from t group by g; select 1")
        ctx.sql("create table dated as select k, s, d from pq where k > 1; "
                "select 1")
    _same(catalog, "select * from agg order by g")
    _same(catalog, "select g, sx + 1 as y from agg where mg = 'b'")
    _same(catalog, "select k, s, d from dated order by k")
    _same(catalog, "show columns from agg")
    _same(catalog, "show columns from dated")
    _, tctx = catalog
    # fresh ingest: the new table has its own dictionary and bounds
    assert list(tctx.tables["dated"].host["s"].dictionary) == ["b", "c"]
    assert tctx.tables["dated"].host["k"].bounds == (2, 3)


def test_read_files(tmp_path):
    csv, _, parquet, json = _files(tmp_path)
    for jdf, tdf in zip(*[(ctx.read_csv(str(csv)), ctx.read_parquet(str(parquet)),
                           ctx.read_json(str(json))) for ctx in _ctxs()]):
        pd.testing.assert_frame_equal(tdf.to_pandas(), jdf.to_pandas())
    jctx, tctx = _ctxs()
    for ctx in (jctx, tctx):
        ctx.register_csv("c", str(csv), schema={"id": pa.int64()})
        ctx.register_parquet("p", str(parquet), primary_key=("k",))
        ctx.register_json("j", str(json))
    _same((jctx, tctx), "select id, score from c order by id")
    assert repr(tctx.tables["c"].fields[0].dtype) == "int64"
    assert tctx.unique_keys("p") == [("k",)]
    # an anonymous read does not show up in SHOW TABLES
    tctx.read_csv(str(csv))
    assert "c" in set(tctx.sql("show tables").to_pandas()["table_name"])
    assert not any(n.startswith("__read") for n in
                   tctx.sql("show tables").to_pandas()["table_name"])


def test_script_returns_last_rows_statement():
    jctx, tctx = _ctxs()
    got = _same((jctx, tctx),
                "create view v as select x from t; show tables; "
                "select sum(x) as s from v; drop view v")
    assert got["s"].tolist() == [10]
    for ctx in (jctx, tctx):
        with pytest.raises(ValueError, match="no SELECT"):
            ctx.sql("create view w as select x from t")
    assert np.all(tctx.sql("show tables").to_pandas()["table_name"] != "v")
