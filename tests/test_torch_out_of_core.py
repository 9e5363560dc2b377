"""The out-of-core scan plane through the port: ParquetDatasetProvider and
the serial runtime read chunked parquet part files range by range and
never materialize a table (tests/test_out_of_core.py's first six cases),
over a dataset the JAX package's `generate_tpch_parquet` writes, held
against the JAX package's provider and serial runtime and against pandas.
The port's provider imports pyarrow inside its functions; the card machine
has none, so these run on the CPU only."""

import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu import batch as JB
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.client.context import \
    ParquetDatasetProvider as JaxDatasetProvider
from ballista_tpu.datagen.tpch import TPCH_TABLES, generate_tpch_parquet
from ballista_tpu.scheduler.serial import execute_serial as jax_serial
from ballista_tpu_torch import batch as B
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.context import ParquetDatasetProvider
from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
from ballista_tpu_torch.scheduler.serial import execute_serial

torch.set_num_threads(2)

SF = 0.01


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tpch_chunks")
    generate_tpch_parquet(SF, str(d), n_chunks=3,
                          tables=["orders", "customer", "lineitem"])
    return d


def _provider(dataset_dir, name):
    return ParquetDatasetProvider(name, str(dataset_dir / name),
                                  torch.device("cpu"), TPCH_TABLES[name][1])


def _contexts(dataset_dir, names):
    tctx = SessionContext(device="cpu")
    jctx = JaxContext(capacity_mode="exact")
    for name in names:
        for ctx in (tctx, jctx):
            ctx.register_parquet_dataset(name, str(dataset_dir / name),
                                         TPCH_TABLES[name][1])
    return tctx, jctx


def test_metadata_without_materialization(dataset_dir):
    tp = _provider(dataset_dir, "orders")
    jtp = JaxDatasetProvider("orders", str(dataset_dir / "orders"),
                             TPCH_TABLES["orders"][1])
    assert tp.num_rows == jtp.num_rows == TPCH_TABLES["orders"][0](SF)
    assert [(f.name, repr(f.dtype)) for f in tp.fields] == \
        [(f.name, repr(f.dtype)) for f in jtp._field_list()]
    names = [f.name for f in tp.schema.fields]
    assert "o_orderkey" in names and "o_comment" in names
    assert tp._materialized is None and not tp._meta


def test_range_table_reads_only_overlap(dataset_dir):
    tp = _provider(dataset_dir, "orders")
    full = pq.read_table(str(dataset_dir / "orders"))
    lo, hi = tp.num_rows // 3 - 5, tp.num_rows // 3 + 7  # crosses a part
    got = tp.range_table(lo, hi, columns=["o_orderkey"])
    assert got.num_rows == hi - lo
    assert got["o_orderkey"].to_pylist() == \
        full["o_orderkey"].to_pylist()[lo:hi]
    batch = tp.range_batch(["o_orderkey", "o_orderpriority"], lo, hi, 128,
                           torch.device("cpu"))
    assert int(batch.num_rows) == hi - lo
    prio = tp.schema.dictionary("o_orderpriority")
    np.testing.assert_array_equal(
        prio[batch.columns[1].data[:hi - lo].numpy()],
        np.asarray(full["o_orderpriority"].to_pylist()[lo:hi], dtype=object))
    assert tp._materialized is None


def test_streaming_dictionaries_match_global(dataset_dir):
    tp = _provider(dataset_dir, "customer")
    stream = tp.dataset_dictionaries(["c_mktsegment"])
    full = JB.compute_dictionaries(
        pq.read_table(str(dataset_dir / "customer"),
                      columns=["c_mktsegment"]))
    jtp = JaxDatasetProvider("customer", str(dataset_dir / "customer"),
                             TPCH_TABLES["customer"][1])
    assert list(stream) == ["c_mktsegment"]
    assert list(stream["c_mktsegment"]) == list(full["c_mktsegment"]) == \
        list(jtp.dataset_dictionaries(["c_mktsegment"])["c_mktsegment"])
    assert list(tp._meta) == ["c_mktsegment"] and tp._materialized is None


def _frames_equal(tout, jout):
    got = B.to_pandas(*tout)
    want = JB.to_pandas(*jout)
    assert list(got.columns) == list(want.columns)
    for c in got.columns:
        if got[c].dtype.kind == "f":
            np.testing.assert_allclose(got[c].astype(float),
                                       want[c].astype(float), rtol=1e-12)
        else:
            assert list(got[c]) == list(want[c]), c
    return got


def test_serial_query_over_dataset_matches_oracle(dataset_dir):
    tctx, jctx = _contexts(dataset_dir, ("orders", "customer"))
    sql = ("select o_orderpriority, count(*) n, sum(o_totalprice) s "
           "from orders join customer on o_custkey = c_custkey "
           "where o_totalprice > 1000 "
           "group by o_orderpriority order by o_orderpriority")
    got = _frames_equal(execute_serial(tctx, tctx.sql(sql).plan, 4),
                        jax_serial(jctx, jctx.sql(sql).plan, 4))
    o = pq.read_table(str(dataset_dir / "orders")).to_pandas()
    c = pq.read_table(str(dataset_dir / "customer")).to_pandas()
    m = o.merge(c, left_on="o_custkey", right_on="c_custkey")
    m = m[m.o_totalprice.astype(float) > 1000]
    exp = (m.groupby("o_orderpriority")
            .agg(n=("o_orderkey", "size"), s=("o_totalprice", "sum"))
            .reset_index().sort_values("o_orderpriority"))
    assert list(got["o_orderpriority"]) == list(exp["o_orderpriority"])
    assert [int(x) for x in got["n"]] == [int(x) for x in exp["n"]]
    assert np.allclose([float(x) for x in got["s"]],
                       [float(x) for x in exp["s"]])
    # the load-bearing claim: the serial scan never materialized a table
    for name in ("orders", "customer"):
        assert tctx.tables[name]._materialized is None


def test_serial_string_groupby_over_dataset(dataset_dir):
    """Dictionary-coded string keys work when the dictionaries come from
    the per-part-file stream (codes must agree across partitions)."""
    tctx, jctx = _contexts(dataset_dir, ("orders",))
    sql = ("select o_orderpriority, min(o_clerk) mc, max(o_clerk) xc, "
           "count(*) n from orders group by o_orderpriority "
           "order by o_orderpriority")
    got = _frames_equal(execute_serial(tctx, tctx.sql(sql).plan, 3),
                        jax_serial(jctx, jctx.sql(sql).plan, 3))
    o = pq.read_table(str(dataset_dir / "orders")).to_pandas()
    exp = (o.groupby("o_orderpriority")
            .agg(mc=("o_clerk", "min"), xc=("o_clerk", "max"),
                 n=("o_clerk", "size"))
            .reset_index().sort_values("o_orderpriority"))
    assert list(got["o_orderpriority"]) == list(exp["o_orderpriority"])
    assert list(got["mc"]) == list(exp["mc"])
    assert list(got["xc"]) == list(exp["xc"])
    assert [int(x) for x in got["n"]] == [int(x) for x in exp["n"]]
    assert tctx.tables["orders"]._materialized is None


def test_serial_overflow_retry_over_dataset(dataset_dir):
    """Quota overflow inside the serial runtime re-plans and re-reads the
    dataset with escalated capacities."""
    tctx, _ = _contexts(dataset_dir, ("orders", "customer"))
    sql = ("select c_nationkey, count(*) n from orders "
           "join customer on o_custkey = c_custkey "
           "group by c_nationkey order by c_nationkey")
    out, schema = execute_serial(
        tctx, tctx.sql(sql).plan, 4,
        options=DistOptions(n_partitions=4, broadcast_threshold=0,
                            min_quota=8, quota_headroom=0.05))
    assert max(m.retries for m in tctx.serial_metrics) >= 1
    got = B.to_pandas(out, schema)
    o = pq.read_table(str(dataset_dir / "orders")).to_pandas()
    c = pq.read_table(str(dataset_dir / "customer")).to_pandas()
    m = o.merge(c, left_on="o_custkey", right_on="c_custkey")
    exp = (m.groupby("c_nationkey").size().reset_index(name="n")
            .sort_values("c_nationkey"))
    assert [int(x) for x in got["n"]] == [int(x) for x in exp["n"]]
    # in-core gives the same answer, reading column by column: the
    # whole-table escape hatch stays unread
    in_core = B.to_pandas(*tctx.sql(sql).collect())
    assert list(in_core["n"]) == list(got["n"])
    assert tctx.tables["orders"]._materialized is None
