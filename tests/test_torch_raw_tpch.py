"""TPC-H with every string column RAW (BALLISTA_RAW_DICT_MAX=0) through
the port's runtimes: the 22 queries in-core at SF 0.002, each equal to
the port's answer over sorted dictionaries on the same rows (which the
other TPC-H tests hold to the JAX package's); Q1 and Q13 through
`SessionContext(distributed=True)` over 8 CPU partitions, the serial
runtime, and two executor processes over the wire that take the same RAW
decision from the variable, each equal to in-core. Tolerances: validity,
integers, decimals, dates and strings exact; f64 at rtol 1e-9."""

import numpy as np
import pytest
import torch

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen.tpch import generate_tpch as jax_generate_tpch
from ballista_tpu.datagen.tpch import register_tpch as jax_register_tpch
from ballista_tpu_torch.batch import to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import generate_tpch, register_tpch
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.scheduler.rpc import SchedulerRpcClient
from test_torch_distributed import assert_same
from test_torch_rpc import spawn_executor, start_scheduler, stop_all

torch.set_num_threads(2)

SF = 0.002


@pytest.fixture(scope="module")
def tables():
    return generate_tpch(SF)


@pytest.fixture(scope="module")
def sorted_ctx(tables):
    ctx = SessionContext(device="cpu")
    register_tpch(ctx, SF, data=tables)
    assert not any(tp.schema.unsorted for tp in ctx.tables.values())
    return ctx


@pytest.fixture
def raw_ctx(monkeypatch, tables):
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "0")
    ctx = SessionContext(device="cpu")
    register_tpch(ctx, SF, data=tables)
    for tp in ctx.tables.values():
        strings = {f.name for f in tp.fields if f.dtype.kind.value == "string"}
        assert tp.schema.unsorted == strings
    return ctx


def _answer(ctx, sql):
    return ctx.sql(sql).collect()


@pytest.mark.parametrize("q", range(1, 23))
def test_all_raw_equals_sorted(raw_ctx, sorted_ctx, q):
    """Each query over RAW strings answers as over sorted dictionaries,
    or raises what the JAX package raises over RAW strings."""
    try:
        got = _answer(raw_ctx, TPCH_QUERIES[q])
    except Exception as e:  # noqa: BLE001 - held to the JAX package's
        jctx = JaxContext(capacity_mode="exact")
        jax_register_tpch(jctx, SF, data=jax_generate_tpch(SF))
        with pytest.raises(type(e)):
            jctx.sql(TPCH_QUERIES[q]).to_pandas()
        return
    assert_same(got, _answer(sorted_ctx, TPCH_QUERIES[q]), to_numpy)


def _cpu_mesh(n=8):
    return make_mesh(n, devices=[torch.device("cpu")] * n)


@pytest.mark.parametrize("q", [1, 13])
def test_all_raw_distributed(raw_ctx, q):
    """Q1 (grouped by two RAW keys) and Q13 (a LIKE over RAW o_comment)
    through the standalone cluster at P = 8, equal to in-core."""
    want = _answer(raw_ctx, TPCH_QUERIES[q])
    dctx = SessionContext(device="cpu", distributed=True, mesh=_cpu_mesh())
    dctx.tables = raw_ctx.tables
    assert_same(dctx.sql(TPCH_QUERIES[q]).collect(), want, to_numpy)


@pytest.mark.parametrize("q", [1, 13])
def test_all_raw_serial(raw_ctx, q):
    want = _answer(raw_ctx, TPCH_QUERIES[q])
    sctx = SessionContext(device="cpu", serial_partitions=4)
    sctx.tables = raw_ctx.tables
    assert_same(sctx.sql(TPCH_QUERIES[q]).collect(), want, to_numpy)


def test_all_raw_over_the_wire(tmp_path, monkeypatch, raw_ctx):
    """Q1 and Q13 through the scheduler service and two executor
    processes spawned with BALLISTA_RAW_DICT_MAX=0: every process makes
    its tables RAW alike, and the result crosses the wire as sorted
    dictionaries, equal to in-core."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        procs = [spawn_executor(url, "raw-a"), spawn_executor(url, "raw-b")]
        client = SchedulerRpcClient(url, device="cpu")
        for q in (1, 13):
            job = client.submit_sql(TPCH_QUERIES[q], {"kind": "tpch",
                                                      "sf": SF},
                                    options={"n_partitions": 2},
                                    ctx=raw_ctx)
            batch, schema = client.wait_batch(job, timeout_s=120)
            assert not schema.unsorted
            for f in schema.fields:
                d = schema.dictionary(f.name)
                if d is not None:
                    assert d.tolist() == sorted(set(d.tolist()))
            assert_same((batch, schema), _answer(raw_ctx, TPCH_QUERIES[q]),
                        to_numpy)
    finally:
        stop_all(procs, httpd)


def test_raw_join_key_shuffles_by_value(monkeypatch):
    """A shuffle join on a RAW key against a sorted one: both exchanges
    hash the key's values, so equal strings meet on one partition, and
    the answer equals in-core."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "50")
    rng = np.random.default_rng(3)
    names = np.array([f"name-{i:05d}" for i in range(400)], dtype=object)
    fact = {"s": names[rng.integers(0, 400, 3000)],
            "v": rng.integers(0, 100, 3000)}
    ctx = SessionContext(device="cpu")
    ctx.register_numpy("fact", fact)
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", str(1 << 21))
    ctx.register_numpy("dim", {"name": names, "w": np.arange(400)},
                       primary_key=("name",))
    assert ctx.tables["fact"].schema.unsorted == {"s"}
    assert not ctx.tables["dim"].schema.unsorted
    sql = ("select name, sum(v) sv, sum(w) sw from dim join fact "
           "on name = s group by name order by name")
    want = ctx.sql(sql).collect()
    from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
    from ballista_tpu_torch.scheduler.runtime import execute_distributed
    got = execute_distributed(ctx, ctx.sql(sql).plan, _cpu_mesh(4),
                              DistOptions(n_partitions=4,
                                          broadcast_threshold=0))
    assert_same(got, want, to_numpy)
