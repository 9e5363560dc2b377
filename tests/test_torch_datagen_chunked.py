"""The port's chunked datagen (`datagen/tpch.py generate_tpch_parquet`,
`generate_table_chunks`, `datagen --chunks --workers`) against the JAX
package's (tests/test_datagen_chunked.py) at SF 0.01: every chunk's
columns equal the JAX package's chunk for chunk, any worker count writes
the same bytes, the chunks are key-consistent, and the part files
register through `register_parquet_dataset` and answer as the JAX package
does over the same files."""

import contextlib
import io
import os
import sys

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.datagen import tpch as jax_tpch
from ballista_tpu_torch.batch import columns_to_arrow, host_to_numpy
from ballista_tpu_torch.datagen import TPCH_TABLES
from ballista_tpu_torch.datagen import tpch

torch.set_num_threads(2)

SF = 0.01
SQL = ("select o_orderpriority, count(*) n, sum(o_totalprice) p from orders "
       "join customer on o_custkey = c_custkey where o_totalprice > 1000 "
       "group by o_orderpriority order by o_orderpriority")


def _arrow(table):
    fields, cols = table
    return columns_to_arrow(fields, host_to_numpy(fields, cols))


@pytest.mark.parametrize("name", list(TPCH_TABLES))
def test_chunks_equal_jax_chunk_for_chunk(name):
    got = list(tpch.generate_table_chunks(name, SF, 3))
    want = list(jax_tpch.generate_table_chunks(name, SF, 3))
    assert [c for c, _ in got] == [c for c, _ in want]
    for (c, g), (_, w) in zip(got, want):
        g = _arrow(g)
        assert g.schema.names == w.schema.names, (name, c)
        for col in w.schema.names:
            assert g.column(col).to_pylist() == w.column(col).to_pylist(), \
                (name, c, col)


def test_chunk_ranges_equal_jax():
    for name in ("lineitem", "partsupp", "orders", "supplier"):
        for n in (1, 3, 7):
            assert tpch.chunk_ranges(name, SF, n) == \
                jax_tpch.chunk_ranges(name, SF, n)


def test_chunk_row_counts_and_keys():
    def concat(name, n):
        return pa.concat_tables(_arrow(t) for _, t in
                                tpch.generate_table_chunks(name, SF, n))
    for name in ("customer", "orders", "supplier", "part"):
        t = concat(name, 4)
        assert t.num_rows == TPCH_TABLES[name][0](SF)
        keys = np.asarray(t[TPCH_TABLES[name][1][0]])
        assert len(np.unique(keys)) == len(keys)
    assert concat("partsupp", 4).num_rows == 4 * TPCH_TABLES["part"][0](SF)
    okeys = set(np.asarray(concat("orders", 3)["o_orderkey"]).tolist())
    lkeys = set(np.asarray(concat("lineitem", 3)["l_orderkey"]).tolist())
    assert lkeys == okeys


def test_chunk_alone_equals_chunk_in_sequence():
    lo, hi = tpch.chunk_ranges("orders", SF, 4)[2]
    alone = _arrow(tpch.generate_chunk("orders", SF, lo, hi))
    seq = dict(tpch.generate_table_chunks("orders", SF, 4))
    assert alone.equals(_arrow(seq[2]))


def test_whole_table_stream_unchanged():
    """The unchunked stream is the one the answer files were made from."""
    whole = tpch.generate_tpch(SF, tables=["orders"])["orders"]
    w = jax_tpch.generate_table("orders", SF)
    assert _arrow(whole).column("o_orderkey").to_pylist() == \
        w.column("o_orderkey").to_pylist()


def _files(d):
    return {os.path.relpath(os.path.join(r, f), d): open(
        os.path.join(r, f), "rb").read()
        for r, _, fs in os.walk(d) for f in fs}


def test_any_worker_count_same_bytes_and_jax_tables(tmp_path):
    tables = ["nation", "orders", "lineitem", "partsupp"]
    one = tpch.generate_tpch_parquet(SF, str(tmp_path / "w1"), 3,
                                     tables=tables)
    three = tpch.generate_tpch_parquet(SF, str(tmp_path / "w3"), 3,
                                       tables=tables, workers=3)
    assert one == three
    assert one["orders"] == TPCH_TABLES["orders"][0](SF)
    a, b = _files(tmp_path / "w1"), _files(tmp_path / "w3")
    assert a == b and len(a) == 1 + 3 * 3
    jax_tpch.generate_tpch_parquet(SF, str(tmp_path / "jax"), 3,
                                   tables=tables)
    for rel in a:
        g = pq.read_table(tmp_path / "w1" / rel)
        w = pq.read_table(tmp_path / "jax" / rel)
        assert g.to_pylist() == w.to_pylist(), rel


def test_cli_chunks_register_as_dataset_and_answer_as_jax(tmp_path):
    from ballista_tpu.batch import to_numpy
    from ballista_tpu.client import SessionContext as JaxContext
    from ballista_tpu_torch.batch import to_numpy as port_to_numpy
    from ballista_tpu_torch.client import SessionContext
    from ballista_tpu_torch.datagen.__main__ import main as datagen
    out = str(tmp_path / "chunks")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        datagen(["--sf", str(SF), "--chunks", "3", "--workers", "2",
                 "--tables", "orders,customer", "--out", out])
    assert "orders: 15000 rows" in printed.getvalue()
    ctx = SessionContext(device="cpu")
    jctx = JaxContext(capacity_mode="exact")
    for name in ("orders", "customer"):
        ctx.register_parquet_dataset(name, os.path.join(out, name),
                                     primary_key=TPCH_TABLES[name][1])
        jctx.register_arrow(name, pq.read_table(os.path.join(out, name)),
                            primary_key=TPCH_TABLES[name][1])
    got = port_to_numpy(*ctx.sql(SQL).collect())
    want = to_numpy(*jctx.sql(SQL).collect())
    for col, (wv, wvalid) in want.items():
        np.testing.assert_array_equal(got[col][1], wvalid)
        np.testing.assert_array_equal(got[col][0][wvalid], wv[wvalid])


def test_chunks_without_pyarrow_raise_naming_it(monkeypatch, tmp_path):
    from ballista_tpu_torch.datagen.__main__ import main as datagen
    monkeypatch.setitem(sys.modules, "pyarrow.parquet", None)
    with pytest.raises(ImportError, match="pyarrow"):
        datagen(["--sf", str(SF), "--chunks", "2", "--out",
                 str(tmp_path / "x")])
    assert not os.path.exists(tmp_path / "x")
