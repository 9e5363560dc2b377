"""Per-column reads of a chunked parquet dataset: an in-core query over
`register_parquet_dataset` reads each column it needs across the part
files (`ParquetDatasetProvider._host_column`) and never the whole table
(`arrow_table`, the escape hatch, is spied on and must stay unread); it
reads the columns the plan names and no others; bounds come from the part
files' statistics; and the 22 TPC-H queries at SF 0.01 answer as the JAX
package's `ParquetDatasetProvider` does over the same part files."""

import numpy as np
import pytest
import torch

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen.tpch import TPCH_TABLES, generate_tpch_parquet
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client import context as C
from test_torch_tpch_six import _assert_same

torch.set_num_threads(2)

SF = 0.01
Q1_COLUMNS = {"l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
              "l_discount", "l_tax", "l_shipdate"}


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_chunks_all")
    generate_tpch_parquet(SF, str(d), n_chunks=3)
    return d


def _port(dataset_dir):
    ctx = SessionContext(device="cpu")
    for name in TPCH_TABLES:
        ctx.register_parquet_dataset(name, str(dataset_dir / name),
                                     TPCH_TABLES[name][1])
    return ctx


@pytest.fixture
def no_whole_table(monkeypatch):
    """Any read of `arrow_table` fails the test."""
    def refuse(self):
        raise AssertionError(f"{self.name}: arrow_table read on a query path")
    monkeypatch.setattr(C.ParquetDatasetProvider, "arrow_table",
                        property(refuse))


@pytest.fixture
def reads(monkeypatch):
    """(table, columns) of every part-file read the providers make."""
    log = []
    real = C.ParquetDatasetProvider._read

    def spy(self, path, columns):
        log.append((self.name, tuple(columns)))
        return real(self, path, columns)
    monkeypatch.setattr(C.ParquetDatasetProvider, "_read", spy)
    return log


def test_q1_reads_only_its_columns(dataset_dir, no_whole_table, reads):
    ctx = _port(dataset_dir)
    batch, _ = ctx.sql(TPCH_QUERIES[1]).collect()
    assert int(batch.num_rows) == 4
    read = {c for name, cols in reads for c in cols}
    assert {name for name, _ in reads} == {"lineitem"}
    assert read == Q1_COLUMNS
    # every data read is of one column across the part files
    data_reads = [cols for _, cols in reads if len(cols) == 1]
    assert {c for (c,) in data_reads} == Q1_COLUMNS
    tp = ctx.tables["lineitem"]
    assert tp.read_bytes > 0 and tp._materialized is None


def test_numeric_bounds_come_from_statistics(dataset_dir, reads):
    """A numeric column's bounds are read without its data, and equal
    the bounds ingest computes from the data."""
    ctx = _port(dataset_dir)
    tp = ctx.tables["lineitem"]
    tp.ensure_meta(["l_quantity", "l_shipdate", "l_orderkey"])
    assert reads == []
    for name in ("l_quantity", "l_shipdate", "l_orderkey"):
        assert tp.schema.int_bound(name) == tp._host_column(name).bounds


def test_host_column_equals_whole_table_ingest(dataset_dir):
    """A column read file by file into one array equals the column of the
    materialized table, encoded against the same table-wide dictionary."""
    tp = _port(dataset_dir).tables["orders"]
    for name in ("o_orderkey", "o_orderpriority", "o_totalprice",
                 "o_orderdate", "o_comment"):
        got = tp._host_column(name)
        want = tp._encode(tp.arrow_table, name)
        np.testing.assert_array_equal(got.values, want.values)
        np.testing.assert_array_equal(got.validity, want.validity)
        assert got.bounds == want.bounds
        if want.dictionary is not None:
            assert list(got.dictionary) == list(want.dictionary)


@pytest.fixture(scope="module")
def jax_ctx(dataset_dir):
    ctx = JaxContext(capacity_mode="exact")
    for name in TPCH_TABLES:
        ctx.register_parquet_dataset(name, str(dataset_dir / name),
                                     TPCH_TABLES[name][1])
    return ctx


# queries the JAX package's dataset provider may not bind (Q22's substring
# needs c_phone's dictionary at logical planning, which the reference's
# dataset schema has only once an earlier query read it): held against the
# JAX package over the same rows registered whole
JAX_WHOLE = {22}


@pytest.mark.parametrize("q", sorted(TPCH_QUERIES))
def test_tpch_answers_equal_jax_dataset(dataset_dir, jax_ctx, no_whole_table,
                                        q):
    tbatch, tschema = _port(dataset_dir).sql(TPCH_QUERIES[q]).collect()
    ref = jax_ctx
    if q in JAX_WHOLE:
        import pyarrow.parquet as pq
        ref = JaxContext(capacity_mode="exact")
        for name in TPCH_TABLES:
            ref.register_arrow(name, pq.read_table(str(dataset_dir / name)),
                               TPCH_TABLES[name][1])
    jbatch, jschema = ref.sql(TPCH_QUERIES[q]).collect()
    _assert_same(tbatch, tschema, jbatch, jschema)
