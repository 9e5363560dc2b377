"""Avro ingest and egress of the port (`ballista_tpu_torch/avro.py`,
`SessionContext.register_avro` / `read_avro`) against the JAX package's
(`ballista_tpu/avro.py`): a round trip under both codecs, files written by
either package read by the other, a query over a registered file equal to
the JAX package's, bad magic, and the `{"format": "avro"}` and
`{"kind": "tbl"}` data environments of `serde/tasks.py`."""

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.avro import read_avro as jax_read_avro
from ballista_tpu.avro import write_avro as jax_write_avro
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu_torch import batch as B
from ballista_tpu_torch.avro import read_avro, write_avro
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES
from ballista_tpu_torch.schema import (BOOL, DATE32, FLOAT64, INT32, INT64,
                                       STRING, Field, decimal as dec_type)
from ballista_tpu_torch.serde import tasks as T

torch.set_num_threads(2)

EPOCH = datetime.date(1970, 1, 1)
DAYS = [datetime.date(2024, 1, 1), None, datetime.date(1969, 12, 31),
        datetime.date(2024, 6, 15)]


def sample_arrow():
    """The JAX package's test table (tests/test_avro.py)."""
    return pa.table({
        "id": pa.array([1, 2, 3, 4], type=pa.int64()),
        "name": pa.array(["ann", "bob", None, "dee"], type=pa.string()),
        "score": pa.array([1.5, None, 3.25, 4.0], type=pa.float64()),
        "flag": pa.array([True, False, True, None], type=pa.bool_()),
        "day": pa.array(DAYS, type=pa.date32()),
    })


def sample_host(with_decimal=False):
    """The same table as port host columns (plus an int32 and a decimal
    column when asked)."""
    cols = {
        "id": B.ingest_column([1, 2, 3, 4], INT64),
        "name": B.ingest_column(["ann", "bob", None, "dee"], STRING),
        "score": B.ingest_column([1.5, None, 3.25, 4.0], FLOAT64),
        "flag": B.ingest_column([True, False, True, None], BOOL),
        "day": B.ingest_column(
            np.array([(d - EPOCH).days if d else 0 for d in DAYS]), DATE32,
            validity=[d is not None for d in DAYS]),
    }
    fields = [Field("id", INT64), Field("name", STRING),
              Field("score", FLOAT64), Field("flag", BOOL),
              Field("day", DATE32)]
    if with_decimal:
        fields += [Field("qty", INT32, nullable=False),
                   Field("price", dec_type(15, 2))]
        cols["qty"] = B.ingest_column([7, -8, 9, 2 ** 31 - 1], INT32)
        cols["price"] = B.ingest_column([12345, -5, 0, -(10 ** 15) + 1],
                                        dec_type(15, 2),
                                        validity=[True, True, False, True])
    return tuple(fields), cols


def host_rows(fields, cols):
    """Per column (values with None for NULL, dictionary decoded)."""
    out = {}
    for f in fields:
        h = cols[f.name]
        vals = (h.dictionary[h.values] if h.dictionary is not None
                else h.values).tolist()
        out[f.name] = [v if ok else None
                       for v, ok in zip(vals, h.validity.tolist())]
    return out


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_roundtrip(tmp_path, codec):
    fields, cols = sample_host(with_decimal=True)
    path = str(tmp_path / "t.avro")
    write_avro(path, (fields, cols), codec=codec)
    got_fields, got = read_avro(path)
    assert got_fields == fields
    assert host_rows(got_fields, got) == host_rows(fields, cols)
    for f in fields:
        assert got[f.name].values.dtype == cols[f.name].values.dtype
        assert got[f.name].bounds == cols[f.name].bounds


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_jax_file_read_by_the_port(tmp_path, codec):
    path = str(tmp_path / "t.avro")
    jax_write_avro(path, sample_arrow(), codec=codec)
    fields, cols = read_avro(path)
    want_fields, want = sample_host()
    assert fields == want_fields
    assert host_rows(fields, cols) == host_rows(want_fields, want)


@pytest.mark.parametrize("codec", ["null", "deflate"])
def test_port_file_read_by_jax(tmp_path, codec):
    path = str(tmp_path / "t.avro")
    write_avro(path, sample_host(with_decimal=True), codec=codec)
    t = jax_read_avro(path)
    for name in sample_arrow().column_names:
        assert t.column(name).to_pylist() == \
            sample_arrow().column(name).to_pylist()
    assert t.column("qty").type == pa.int32() and \
        not t.schema.field("qty").nullable
    assert t.column("price").type == pa.decimal128(15, 2)
    assert t.column("price").to_pylist() == [
        decimal.Decimal("123.45"), decimal.Decimal("-0.05"), None,
        decimal.Decimal("-9999999999999.99")]


def test_register_and_query_equal_jax(tmp_path):
    path = str(tmp_path / "t.avro")
    write_avro(path, sample_host(with_decimal=True))
    jctx, tctx = JaxContext(), SessionContext(device="cpu")
    jctx.register_avro("t", path)
    tctx.register_avro("t", path)
    for sql in ("select count(*) as n, sum(id) as s from t where flag",
                "select flag, count(name) as c, sum(price) as p, max(day) "
                "as d from t group by flag order by flag",
                "select name, score from t order by id"):
        want = jctx.sql(sql).to_pandas()
        got = tctx.sql(sql).to_pandas()
        assert got.astype(str).values.tolist() == \
            want.astype(str).values.tolist(), sql
    assert len(tctx.read_avro(path).to_pandas()) == 4


def test_bad_magic(tmp_path):
    path = str(tmp_path / "bad.avro")
    with open(path, "wb") as fh:
        fh.write(b"nope" + b"\x00" * 32)
    with pytest.raises(ValueError, match="container"):
        read_avro(path)


def test_unsupported_column_types_raise(tmp_path):
    path = str(tmp_path / "b.avro")
    jax_write_avro(path, pa.table({"b": pa.array([b"x"], type=pa.binary())}))
    with pytest.raises(NotImplementedError, match="bytes"):
        read_avro(path)


def test_data_environments(tmp_path):
    """{"format": "avro"} and {"kind": "tbl"} build contexts on the
    executors' side of the scan plane."""
    path = str(tmp_path / "t.avro")
    write_avro(path, sample_host())
    ctx = T.build_context({"kind": "files", "tables": {"t": {
        "format": "avro", "path": path, "primary_key": ["id"]}}},
        device="cpu")
    assert ctx.tables["t"].num_rows == 4
    assert ctx.tables["t"].primary_key == ("id",)
    from ballista_tpu_torch.datagen.__main__ import main as datagen
    tbl = str(tmp_path / "tbl")
    datagen(["--sf", "0.002", "--format", "tbl", "--out", tbl])
    ctx = T.build_context({"kind": "tbl", "dir": tbl}, device="cpu")
    assert set(ctx.tables) == set(TPCH_TABLES)
    n = int(ctx.sql("select count(*) as n from lineitem").collect()[0]
            .num_rows)
    assert n == 1
