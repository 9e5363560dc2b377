"""Per-column lazy ingest (`client/context.py TableProvider`, `HostColumns`,
`rebind_scans`, the lexical pre-pass; `datagen/tbl.py TblFile`;
`runner --lazy-ingest`) at SF 0.01 on the CPU.

The same arrow tables go into the JAX package's SessionContext and the
port's, both lazy for every table (BALLISTA_EAGER_META_ROWS=0): a query
ingests the same columns in both, with the same RAW verdicts,
dictionaries and bounds, and the same answer, which also equals an eagerly
ingested port context's. Columns no query reads are never ingested. `.tbl`
columns are parsed on first use, each equal to the eager reader's."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from ballista_tpu.batch import to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu_torch.batch import to_numpy as port_to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES, runner
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, register_tpch
from ballista_tpu_torch.datagen.tbl import read_tbl, register_tpch_tbl
from ballista_tpu_torch.datagen.tpch import as_ingested

torch.set_num_threads(2)

SF = 0.01
QUERIES = (1, 3, 6, 9, 13, 18)


@pytest.fixture(scope="module")
def arrow_tables():
    return {name: generate_table(name, SF) for name in TPCH_TABLES}


@pytest.fixture(scope="module")
def tbl_dir(tmp_path_factory):
    from ballista_tpu_torch.datagen.__main__ import main as datagen
    out = str(tmp_path_factory.mktemp("tbl"))
    with contextlib.redirect_stdout(io.StringIO()):
        datagen(["--sf", str(SF), "--format", "tbl", "--out", out])
    return out


def _register(ctx, tables):
    for name, t in tables.items():
        ctx.register_arrow(name, t, primary_key=REF_TABLES[name][1])
    return ctx


def _assert_same(tbatch, tschema, want):
    got = port_to_numpy(tbatch, tschema)
    assert list(got) == list(want)
    for name, (wv, wvalid) in want.items():
        gv, gvalid = got[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
        np.testing.assert_array_equal(gv[gvalid], wv[wvalid], err_msg=name)


def _assert_meta_equal(port_tp, names, dicts, bounds, raw):
    schema = port_tp.schema
    for n in names:
        d = schema.dictionary(n)
        assert (d is None) == (n not in dicts), n
        if d is not None:
            assert list(d) == list(dicts[n]), n
        assert schema.int_bound(n) == (tuple(bounds[n]) if n in bounds
                                       else None), n
        assert (n in schema.unsorted) == (n in raw), n


@pytest.mark.parametrize("q", QUERIES)
def test_lazy_matches_jax_lazy_and_eager(monkeypatch, arrow_tables, q):
    monkeypatch.setenv("BALLISTA_EAGER_META_ROWS", "0")
    jctx = _register(JaxContext(capacity_mode="exact"), arrow_tables)
    tctx = _register(SessionContext(device="cpu"), arrow_tables)
    eager = _register(SessionContext(device="cpu"), arrow_tables)
    for tp in eager.tables.values():
        tp.ensure_meta([f.name for f in tp.fields])
    assert not any(tp.host.ingested for tp in tctx.tables.values())

    jbatch, jschema = jctx.sql(TPCH_QUERIES[q]).collect()
    want = to_numpy(jbatch, jschema)
    _assert_same(*tctx.sql(TPCH_QUERIES[q]).collect(), want)
    _assert_same(*eager.sql(TPCH_QUERIES[q]).collect(), want)

    for name, tp in tctx.tables.items():
        jtp = jctx.tables[name]
        assert tp.host.ingested == set(jtp._host), name
        _assert_meta_equal(tp, tp.host.ingested, jtp._dicts, jtp._bounds,
                           jtp._unsorted)
        # and each ingested column equals the eager context's
        e = eager.tables[name].host
        for c in tp.host.ingested:
            h = tp.host[c]
            np.testing.assert_array_equal(h.values, e[c].values)
            np.testing.assert_array_equal(h.validity, e[c].validity)
            assert h.raw == e[c].raw and h.bounds == e[c].bounds
    # nobody's comment is read by these queries' scans (Q13 reads
    # o_comment only)
    assert "l_comment" not in tctx.tables["lineitem"].host.ingested
    assert "ps_comment" not in tctx.tables["partsupp"].host.ingested


def test_unread_columns_never_ingested(monkeypatch, arrow_tables):
    """Q1 at the default threshold: the small tables' schemas ingest their
    string columns, but no numeric column Q1 does not read, and nothing
    of a table Q1 does not scan beyond that."""
    tctx = _register(SessionContext(device="cpu"), arrow_tables)
    tctx.sql(TPCH_QUERIES[1]).collect()
    q1 = {"l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
          "l_discount", "l_tax", "l_shipdate"}
    li = tctx.tables["lineitem"]
    strings = {f.name for f in li.fields if f.dtype.kind.name == "STRING"}
    assert li.host.ingested == q1 | strings
    for name in ("orders", "part", "partsupp"):
        assert tctx.tables[name].host.ingested.isdisjoint(
            {f.name for f in tctx.tables[name].fields
             if f.dtype.kind.name != "STRING"})


def test_big_table_pre_pass_ingests_named_columns(monkeypatch, arrow_tables):
    """Above the threshold the schema ingests nothing; the SQL text's
    words are ingested before planning (a LIKE needs its dictionary at
    logical planning), the reference's `_ensure_referenced_meta`."""
    monkeypatch.setenv("BALLISTA_EAGER_META_ROWS", "0")
    jctx = _register(JaxContext(capacity_mode="exact"), arrow_tables)
    tctx = _register(SessionContext(device="cpu"), arrow_tables)
    sql = ("select p_type, count(*) n from part where p_name like "
           "'%green%' group by p_type order by p_type")
    tctx.sql(sql)      # planned only
    jctx.sql(sql)
    assert tctx.tables["part"].host.ingested == set(jctx.tables["part"]._host)
    assert tctx.tables["part"].host.ingested == {"p_type", "p_name"}
    jb, js = jctx.sql(sql).collect()
    _assert_same(*tctx.sql(sql).collect(), to_numpy(jb, js))


def test_evict_device_keeps_host_columns(arrow_tables):
    tctx = _register(SessionContext(device="cpu"), arrow_tables)
    want = port_to_numpy(*tctx.sql(TPCH_QUERIES[6]).collect())
    li = tctx.tables["lineitem"]
    done = li.host.ingested
    assert li._cols
    tctx.evict_device()
    assert not li._cols and li.host.ingested == done
    got = port_to_numpy(*tctx.sql(TPCH_QUERIES[6]).collect())
    np.testing.assert_array_equal(got["revenue"][0], want["revenue"][0])


def test_raw_threshold_taken_at_registration(monkeypatch):
    """A lazily ingested column takes the RAW verdict of the threshold in
    force when its table was registered, as eager ingest did."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "10")
    ctx = SessionContext(device="cpu")
    ctx.register_numpy("t", {"s": np.array([f"k{i}" for i in range(200)],
                                           dtype=object)})
    register_tpch(ctx, 0.001, tables=["nation"])
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", str(1 << 21))
    assert not ctx.tables["t"].host.ingested
    assert ctx.tables["t"].schema.unsorted == {"s"}
    assert ctx.tables["nation"].schema.unsorted == {"n_name", "n_comment"}


def test_tbl_columns_parsed_on_demand(monkeypatch, tbl_dir):
    """Registering a `.tbl` directory finds the separators only; a query
    parses the columns it reads; every parsed column equals the eager
    reader's (with ingest's RAW verdict), strings through the native
    encoder."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "300")
    monkeypatch.setenv("BALLISTA_EAGER_META_ROWS", "0")
    ctx = SessionContext(device="cpu")
    register_tpch_tbl(ctx, tbl_dir)
    assert all(not tp.tbl.parse_seconds for tp in ctx.tables.values())
    gen = SessionContext(device="cpu")
    register_tpch(gen, SF)
    for q in (1, 13):
        want = port_to_numpy(*gen.sql(TPCH_QUERIES[q]).collect())
        got = port_to_numpy(*ctx.sql(TPCH_QUERIES[q]).collect())
        for name, (wv, wvalid) in want.items():
            np.testing.assert_array_equal(got[name][1], wvalid)
            np.testing.assert_array_equal(got[name][0][wvalid], wv[wvalid])
    li = ctx.tables["lineitem"]
    assert set(li.tbl.parse_seconds) == li.host.ingested
    assert "l_comment" not in li.host.ingested
    assert ctx.tables["orders"].host.ingested >= {"o_comment"}
    for name in ("orders", "lineitem"):
        _, eager = read_tbl(os.path.join(tbl_dir, f"{name}.tbl"), name)
        tp = ctx.tables[name]
        for c in tp.host.ingested:
            h, e = tp.host[c], as_ingested(eager[c], 300)
            assert h.raw == e.raw and h.bounds == e.bounds, c
            np.testing.assert_array_equal(h.values, e.values, err_msg=c)
            np.testing.assert_array_equal(h.validity, e.validity, err_msg=c)
            if h.dictionary is not None:
                assert list(h.dictionary) == list(e.dictionary), c
    assert ctx.tables["orders"].host["o_comment"].raw


def test_runner_lazy_ingest_matches_answers(monkeypatch, tbl_dir, tmp_path):
    """`runner.run(..., lazy_ingest=True)` over the `.tbl` files: exact
    against the JAX package's answer files, with lineitem's unread
    columns never parsed (every table lazy, as SF1's lineitem is)."""
    monkeypatch.setenv("BALLISTA_EAGER_META_ROWS", "0")
    from ballista_tpu.benchmarks.oracle import to_pd
    from ballista_tpu.datagen import generate_tpch as jax_generate
    from ballista_tpu.datagen.tbl import write_answers
    queries = (1, 6, 14)
    answers = str(tmp_path / "answers")
    write_answers(to_pd(jax_generate(SF)), answers, queries)
    ctx = SessionContext(device="cpu")
    register_tpch_tbl(ctx, tbl_dir)
    with contextlib.redirect_stdout(io.StringIO()):
        res = runner.run(SF, queries, 1, lazy_ingest=True, expected=answers,
                         ctx=ctx)
    assert all(res[q]["match"] for q in queries), res
    assert "l_comment" not in ctx.tables["lineitem"].host.ingested
    # without lazy_ingest the warm pass ingests every column first
    ctx = SessionContext(device="cpu")
    register_tpch_tbl(ctx, tbl_dir)
    with contextlib.redirect_stdout(io.StringIO()):
        res = runner.run(SF, (6,), 1, expected=answers, ctx=ctx)
    assert res[6]["match"]
    assert ctx.tables["lineitem"].host.ingested == {
        f.name for f in ctx.tables["lineitem"].fields}
