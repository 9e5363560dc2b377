"""Exact decimal sums past 2^63: a SUM over a decimal whose exact total may
pass int64 (rows it may add x the bound of its argument) is "wide": it adds
its argument's two 32-bit halves apart and returns decimal(min(38, p + 10),
s) in two words, where the JAX package's int64 sum wraps. Held on the CPU
through every runtime of the port (in-core, serial, distributed, the wire),
its egress (`to_numpy`, `to_arrow`, `diff_expected`, the CLI), the sorted
layout and the kernel's plain version in its half-word read modes; the 22
TPC-H queries at SF 0.01 keep the JAX package's types and answers (no sum
goes wide there)."""

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.batch import to_numpy as jax_to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu_torch import batch as B
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.ops.masked_sums import (HI, LO, masked_slot_sums_rows,
                                                masked_slot_sums_rows_reference)
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.schema import join_wide, wide_to_ints
from test_torch_tpch_six import _assert_same, _contexts

torch.set_num_threads(2)

# eleven rows of 900000000000.000000 as decimal(18, 6): the scaled total,
# 9.9e18, passes int64 (9.22e18)
ELEVEN = 11
VALUE = 900_000_000_000_000_000
TOTAL = ELEVEN * VALUE
WRAPPED = TOTAL - 2 ** 64            # -8546744073709551616
SUM_SQL = "select g, sum(x) as s from t group by g order by g"


def _table(n=ELEVEN, groups=1, value=VALUE):
    g = np.arange(n, dtype=np.int64) % groups
    x = np.full(n, value, dtype=np.int64)
    return pa.table({
        "g": pa.array(g, pa.int64()),
        "x": pa.Array.from_buffers(
            pa.decimal128(18, 6), n,
            [None, pa.py_buffer(np.stack([x, x >> 63], 1).tobytes())])})


def _port(**kwargs):
    ctx = SessionContext(device="cpu", **kwargs)
    ctx.register_arrow("t", _table())
    return ctx


def _sum(ctx, sql=SUM_SQL):
    batch, schema = ctx.sql(sql).collect()
    return B.to_numpy(batch, schema)["s"], schema.field("s").dtype


def test_jax_package_wraps():
    """The reference adds in int64 and returns the total minus 2^64."""
    ctx = JaxContext(capacity_mode="exact")
    ctx.register_arrow("t", _table())
    batch, schema = ctx.sql(SUM_SQL).collect()
    (values, valid), = [jax_to_numpy(batch, schema)["s"]]
    assert valid.tolist() == [True]
    assert int(values[0]) == WRAPPED == -8546744073709551616


@pytest.mark.parametrize("runtime", ["in_core", "serial", "distributed"])
def test_port_sum_is_exact(runtime):
    kwargs = {"serial": dict(serial_partitions=4),
              "distributed": dict(distributed=True, mesh=make_mesh(
                  4, devices=[torch.device("cpu")] * 4))}.get(runtime, {})
    (values, valid), dtype = _sum(_port(**kwargs))
    assert repr(dtype) == "decimal(28,6)" and dtype.is_wide
    assert valid.tolist() == [True]
    assert values.tolist() == [TOTAL]
    # a global sum too (a gather and a final aggregate on one partition)
    (values, _), _ = _sum(_port(**kwargs), "select sum(x) as s from t")
    assert values.tolist() == [TOTAL]


def test_to_arrow_and_diff_expected_are_exact(tmp_path):
    from ballista_tpu_torch.datagen.tbl import diff_expected
    from ballista_tpu_torch.cli import format_rows
    batch, schema = _port().sql(SUM_SQL).collect()
    table = B.to_arrow(batch, schema)
    assert table.schema.field("s").type == pa.decimal128(28, 6)
    assert str(table.column("s")[0].as_py()) == "9900000000000.000000"
    os.makedirs(tmp_path / "answers")
    with open(tmp_path / "answers" / "q1.out", "w") as f:
        f.write("g|s\n0|9900000000000.000000\n")
    assert diff_expected((batch, schema), str(tmp_path), 1) is None
    with open(tmp_path / "answers" / "q1.out", "w") as f:
        f.write("g|s\n0|-8546744073709.551616\n")
    assert diff_expected((batch, schema), str(tmp_path), 1) is not None
    assert "9900000000000.000000" in format_rows(batch, schema)


def test_wire_sum_is_exact(tmp_path):
    from ballista_tpu_torch.scheduler.rpc import SchedulerRpcClient
    from test_torch_rpc import spawn_executor, start_scheduler, stop_all
    pq.write_table(_table(), str(tmp_path / "t.parquet"))
    tables = {"kind": "files", "tables": {"t": {
        "format": "parquet", "path": str(tmp_path / "t.parquet"),
        "primary_key": None}}}
    service, httpd, url = start_scheduler(tmp_path / "work")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-wide", partitions=2))
        client = SchedulerRpcClient(url, device="cpu")
        job = client.submit_sql(SUM_SQL, tables, options={"n_partitions": 2})
        batch, schema = client.wait_batch(job, timeout_s=120)
        assert repr(schema.field("s").dtype) == "decimal(28,6)"
        assert B.to_numpy(batch, schema)["s"][0].tolist() == [TOTAL]
    finally:
        stop_all(procs, httpd)


@pytest.mark.parametrize("groups", [3, 300])
@pytest.mark.parametrize("runtime", ["in_core", "distributed"])
def test_grouped_wide_sums_equal_python(groups, runtime):
    """Masked (3 groups) and sorted (300 groups) layouts, single and
    partial -> final: every group's exact sum."""
    rng = np.random.default_rng(groups)
    n = 3000
    g = rng.integers(0, groups, n)
    x = rng.integers(-VALUE, VALUE, n)
    table = pa.table({"g": pa.array(g, pa.int64()), "x": pa.Array.from_buffers(
        pa.decimal128(18, 6), n,
        [None, pa.py_buffer(np.stack([x, x >> 63], 1).tobytes())])})
    kwargs = {} if runtime == "in_core" else dict(
        distributed=True, mesh=make_mesh(4, devices=[torch.device("cpu")] * 4))
    ctx = SessionContext(device="cpu", **kwargs)
    ctx.register_arrow("t", table)
    batch, schema = ctx.sql(SUM_SQL).collect()
    got = B.to_numpy(batch, schema)
    assert schema.field("s").dtype.is_wide
    want = {}
    for k, v in zip(g.tolist(), x.tolist()):
        want[k] = want.get(k, 0) + v
    assert got["g"][0].tolist() == sorted(want)
    assert got["s"][0].tolist() == [want[k] for k in sorted(want)]


@pytest.mark.parametrize("sql", [
    "select avg(s) from (select g, sum(x) as s from t group by g) v",
    "select s * 2 as d from (select g, sum(x) as s from t group by g) v",
    "select g from (select g, sum(x) as s from t group by g) v where s > 0",
    "select s, count(*) from (select g, sum(x) as s from t group by g) v "
    "group by s",
    "select g, sum(x) as s from t group by g order by s",
    "select max(s) from (select g, sum(x) as s from t group by g) v",
])
def test_wide_column_uses_raise(sql):
    with pytest.raises(NotImplementedError, match="wide decimal"):
        _port().sql(sql).collect()


def test_wide_column_is_carried():
    """Projection, LIMIT and a sort on another key carry the two words."""
    sql = ("select s, g from (select g, sum(x) as s from t group by g) v "
           "order by g limit 1")
    batch, schema = _port().sql(sql).collect()
    assert B.to_numpy(batch, schema)["s"][0].tolist() == [TOTAL]


@pytest.mark.parametrize("seed", range(4))
def test_half_word_reference_equals_python(seed):
    """The kernel's plain version in its HI and LO read modes: each half's
    per-slot sum joined (hi * 2^32 + lo) equals the Python-int sum."""
    rng = np.random.default_rng(seed)
    n, T = 5000, 6
    values = rng.integers(-2 ** 63, 2 ** 63 - 1, n, dtype=np.int64)
    slots = rng.integers(0, T + 1, n).astype(np.int32)    # slot T is dead
    valid = rng.random(n) > 0.2
    data = torch.from_numpy(values)
    v = torch.from_numpy(valid)
    rows = [(data, v, HI), (data, v, LO)]
    for fn in (masked_slot_sums_rows, masked_slot_sums_rows_reference):
        out = fn(torch.from_numpy(slots), rows, T)
        got = wide_to_ints(join_wide(out[:, 0], out[:, 1]).numpy()).tolist()
        want = [sum(int(x) for x, s, ok in zip(values, slots, valid)
                    if s == t and ok) for t in range(T)]
        assert got == want


@pytest.mark.parametrize("q", sorted(TPCH_QUERIES))
def test_tpch_keeps_jax_types(tpch_contexts, q):
    """At SF 0.01 no sum is wide: every result type and answer is the JAX
    package's."""
    jctx, tctx = tpch_contexts
    jbatch, jschema = jctx.sql(TPCH_QUERIES[q]).collect()
    tbatch, tschema = tctx.sql(TPCH_QUERIES[q]).collect()
    assert not any(f.dtype.is_wide for f in tschema.fields)
    _assert_same(tbatch, tschema, jbatch, jschema)


@pytest.fixture(scope="module")
def tpch_contexts():
    from ballista_tpu_torch.datagen import TPCH_TABLES
    return _contexts(0.01, list(TPCH_TABLES))


@pytest.mark.parametrize("q", sorted(TPCH_QUERIES))
def test_decoded_plans_lower_like_their_source(tpch_contexts, q):
    """A plan decoded from the wire carries no row counts or bounds until
    `rebind_scans`: its sums are not sized before, and after it lower to
    the same types as the plan the client made (Q20's `0.5 * sum(...)`
    once raised on the scheduler)."""
    import json
    from ballista_tpu_torch.client.context import rebind_scans
    from ballista_tpu_torch.serde.plans import decode_plan, encode_plan
    _, tctx = tpch_contexts
    plan = tctx.sql(TPCH_QUERIES[q]).plan
    decoded = decode_plan(json.loads(json.dumps(encode_plan(plan))))
    want = tctx.physical_plan(rebind_scans(plan, tctx)).schema
    got = tctx.physical_plan(rebind_scans(decoded, tctx)).schema
    assert [repr(f.dtype) for f in got.fields] == \
        [repr(f.dtype) for f in want.fields]
