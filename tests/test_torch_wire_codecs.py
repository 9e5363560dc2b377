"""The wire slice's codecs against the JAX package's: the logical-plan
documents (`serde/plans.py`), the task, status, executor-registration and
job-spec wire dicts (`serde/tasks.py`), and the stage blob
(`scheduler/spill.py`), which replaces the JAX package's Arrow IPC with the
port's own format (numpy and torch alone).

- every TPC-H plan and every `ANALYTIC_QUERIES` plan encodes to the JAX
  package's document key for key, and the port decodes the JAX package's
  document back to the same plan. The one difference, listed below: Q15
  and Q22 fold a scalar subquery's decimal result into a literal, which
  the JAX encoder refuses (TypeError: Decimal is not JSON serializable);
  the port encodes it as {"@decimal": "<text>"};
- the job-spec dict equals the JAX package's but for `replay` (the
  scheduler's broadcast choices, which the port's executors replay), which
  a spec carries only when it is set, and the options' `join_out_factor`
  (a field of the port's DistOptions: the capacity retry grows expanding
  join outputs by it); the port reads the JAX package's dict;
- the blob round-trips every column dtype, NULLs, partitions of unequal
  rows, an empty partition and capacity 0; it is made and read without
  pickle or torch.save; a fresh import of the wire modules loads neither
  pyarrow nor pandas;
- Q3's stage outputs at P = 2, spilled by each package's standalone
  cluster, hold the same live rows plane by plane;
- StageSpiller's versioned keys, clean_job and clean_expired.

Tolerances: everything exact (Q3's columns are integers, decimals, dates
and strings)."""

import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu.scheduler import execution_graph as JG
from ballista_tpu.scheduler import server as JS
from ballista_tpu.scheduler.distributed_planner import \
    DistOptions as JaxDistOptions
from ballista_tpu.serde import plans as JP
from ballista_tpu.serde import tasks as JT
from ballista_tpu_torch.batch import Batch, Column
from ballista_tpu_torch.benchmarks import ANALYTIC_QUERIES, TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, register_tpch
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.parallel.partitioned import PartitionedBatch
from ballista_tpu_torch.scheduler import execution_graph as G
from ballista_tpu_torch.scheduler import server as S
from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
from ballista_tpu_torch.scheduler.spill import (StageSpiller, decode_stage,
                                                encode_stage, read_header)
from ballista_tpu_torch.scheduler.standalone import StandaloneCluster
from ballista_tpu_torch.serde import plans as P
from ballista_tpu_torch.serde import tasks as T

torch.set_num_threads(2)

SF = 0.002
# plans whose documents differ from the JAX package's, with the reason
DECIMAL_LITERAL = (15, 22)   # the JAX encoder raises on a Decimal literal


@pytest.fixture(scope="module")
def contexts():
    from ballista_tpu.client import SessionContext as JaxContext
    jctx = JaxContext(capacity_mode="exact")
    for name in TPCH_TABLES:
        jctx.register_arrow(name, generate_table(name, SF),
                            primary_key=REF_TABLES[name][1])
    tctx = SessionContext(device="cpu")
    register_tpch(tctx, SF)
    return jctx, tctx


# -- plan documents --

@pytest.mark.parametrize("q", sorted(set(TPCH_QUERIES) - set(DECIMAL_LITERAL)))
def test_tpch_plan_documents_equal_jax(contexts, q):
    jctx, tctx = contexts
    mine = json.loads(P.plan_to_json(tctx.sql(TPCH_QUERIES[q]).plan))
    theirs = json.loads(JP.plan_to_json(jctx.sql(TPCH_QUERIES[q]).plan))
    assert mine == theirs
    back = P.plan_from_json(json.dumps(theirs))
    assert P.encode_plan(back) == P.encode_plan(tctx.sql(TPCH_QUERIES[q]).plan)


@pytest.mark.parametrize("q", DECIMAL_LITERAL)
def test_decimal_literal_plans_encode(contexts, q):
    """The JAX encoder raises on the folded decimal; the port's document
    round-trips, and holds the literal as {"@decimal": text}."""
    jctx, tctx = contexts
    with pytest.raises(TypeError, match="Decimal"):
        JP.plan_to_json(jctx.sql(TPCH_QUERIES[q]).plan)
    plan = tctx.sql(TPCH_QUERIES[q]).plan
    text = P.plan_to_json(plan)
    assert '"@decimal"' in text
    assert P.encode_plan(P.plan_from_json(text)) == P.encode_plan(plan)
    b1, s1 = tctx.collect(plan)
    b2, s2 = tctx.collect(P.plan_from_json(text))
    assert int(b1.num_rows) == int(b2.num_rows) > 0


@pytest.mark.parametrize("name", sorted(ANALYTIC_QUERIES))
def test_analytic_plan_documents_equal_jax(contexts, name):
    jctx, tctx = contexts
    sql = ANALYTIC_QUERIES[name]
    mine = json.loads(P.plan_to_json(tctx.sql(sql).plan))
    theirs = json.loads(JP.plan_to_json(jctx.sql(sql).plan))
    assert mine == theirs
    assert P.encode_plan(P.plan_from_json(json.dumps(theirs))) == \
        P.encode_plan(tctx.sql(sql).plan)


def test_wire_version_guard():
    from ballista_tpu_torch.planner import logical as L
    from ballista_tpu_torch.schema import DataType, Field, Schema, TypeKind
    plan = L.TableScan("t", Schema([Field("x", DataType(TypeKind.INT64))]),
                       None)
    doc = json.loads(P.plan_to_json(plan))
    assert doc["@wire"] == P.WIRE_VERSION == JP.WIRE_VERSION
    doc["@wire"] = P.WIRE_VERSION + 1
    with pytest.raises(P.WireVersionError):
        P.plan_from_json(json.dumps(doc))
    w = T.task_to_wire(G.TaskDescription("j", 0, (0,), 0, "e"))
    w["@wire"] = 999
    with pytest.raises(P.WireVersionError):
        T.task_from_wire(w)


# -- task, status, registration and job-spec dicts --

def test_task_status_meta_wire_equal_jax():
    t, jt = (G.TaskDescription("job1", 3, (0, 1, 2), 7, "ex-a"),
             JG.TaskDescription("job1", 3, (0, 1, 2), 7, "ex-a"))
    assert T.task_to_wire(t) == JT.task_to_wire(jt)
    assert T.task_from_wire(json.loads(json.dumps(JT.task_to_wire(jt)))) == t
    stats = [{"quota": 256, "salt_kind": "join", "counts": [[1, 2], [3, 4]]}]
    for kw in ({"error": "lost", "failed_input_stage": 2,
                "error_kind": "fetch_failed"},
               {"error": "overflow", "error_kind": "shuffle_overflow",
                "stats": stats, "metrics": {"overflow": "capacity"}}):
        s = G.TaskStatus(7, "job1", 3, (0, 1), "ex-a", "failed", **kw)
        js = JG.TaskStatus(7, "job1", 3, (0, 1), "ex-a", "failed", **kw)
        assert T.status_to_wire(s) == JT.status_to_wire(js)
        assert T.status_from_wire(
            json.loads(json.dumps(JT.status_to_wire(js)))) == s
    m = S.ExecutorMetadata("ex-a", "h", 50051, 4, devices=2, data_port=7)
    jm = JS.ExecutorMetadata("ex-a", "h", 50051, 4, devices=2, data_port=7)
    assert T.executor_meta_to_wire(m) == JT.executor_meta_to_wire(jm)
    assert T.executor_meta_from_wire(JT.executor_meta_to_wire(jm)) == m


def test_jobspec_wire_equal_jax(contexts):
    jctx, tctx = contexts
    sql = TPCH_QUERIES[3]
    tables = {"kind": "tpch", "sf": SF}
    kw = dict(n_partitions=4, quota_headroom=3.0, join_salt=2)
    spec = T.JobSpec("j", tctx.sql(sql).plan, tables, DistOptions(**kw),
                     "/x", version=2, final_stage=5)
    jspec = JT.JobSpec("j", jctx.sql(sql).plan, tables, JaxDistOptions(**kw),
                       "/x", version=2, final_stage=5)
    mine, theirs = T.jobspec_to_wire(spec), JT.jobspec_to_wire(jspec)
    assert mine["options"].pop("join_out_factor") == 1.0
    assert json.loads(json.dumps(mine)) == json.loads(json.dumps(theirs))
    back = T.jobspec_from_wire(json.loads(json.dumps(theirs)))
    assert (back.job_id, back.version, back.final_stage, back.work_dir) == \
        ("j", 2, 5, "/x")
    assert back.options == spec.options and back.replay is None
    assert P.encode_plan(back.plan) == P.encode_plan(spec.plan)
    replay = {"broadcasts": [True, False], "one_rows": []}
    spec = dataclasses.replace(spec, replay=replay)
    d = T.jobspec_to_wire(spec)
    del d["options"]["join_out_factor"]
    assert {k: v for k, v in d.items() if k != "replay"} == mine
    assert T.jobspec_from_wire(json.loads(json.dumps(d))).replay == replay


def test_build_context_kinds(tmp_path):
    ctx = T.build_context({"kind": "tpch", "sf": SF}, device="cpu")
    assert ctx.device == torch.device("cpu")
    assert ctx.tables["nation"].num_rows == 25
    with pytest.raises(FileNotFoundError, match="no .tbl files"):
        T.build_context({"kind": "tbl", "dir": str(tmp_path)}, device="cpu")
    with pytest.raises(FileNotFoundError):
        T.build_context({"kind": "files", "tables": {"a": {
            "format": "avro", "path": str(tmp_path / "a.avro")}}},
            device="cpu")
    import pyarrow as pa
    import pyarrow.parquet as pq
    pq.write_table(pa.table({"k": [1, 2, 3]}), str(tmp_path / "a.parquet"))
    (tmp_path / "b.csv").write_text("k,v\n1,x\n2,y\n")
    ctx = T.build_context({"kind": "files", "tables": {
        "a": {"format": "parquet", "path": str(tmp_path / "a.parquet"),
              "primary_key": ["k"]},
        "b": {"format": "csv", "path": str(tmp_path / "b.csv")}}},
        device="cpu")
    assert ctx.tables["a"].num_rows == 3 and ctx.tables["b"].num_rows == 2


# -- the stage blob --

_DTYPES = (torch.bool, torch.int32, torch.int64, torch.float32, torch.float64)


def _batch(gen, cap, n, dtypes=_DTYPES):
    cols = []
    for dt in dtypes:
        if dt is torch.bool:
            d = torch.rand(cap, generator=gen) > 0.5
        elif dt.is_floating_point:
            d = torch.randn(cap, generator=gen).to(dt)
        else:
            d = torch.randint(-2 ** 31, 2 ** 31 - 1, (cap,), generator=gen
                              ).to(dt)
        v = torch.rand(cap, generator=gen) > 0.3   # NULLs
        v[n:] = False
        cols.append(Column(d, v))
    return Batch(tuple(cols), torch.tensor(n, dtype=torch.int32))


def _assert_same_partitions(got, want):
    assert got.n_partitions == want.n_partitions
    assert got.capacity == want.capacity
    for a, b in zip(got.batches, want.batches):
        assert int(a.num_rows) == int(b.num_rows)
        assert a.num_rows.dtype == torch.int32
        for c, d in zip(a.columns, b.columns):
            assert c.data.dtype == d.data.dtype
            assert torch.equal(c.data, d.data)
            assert torch.equal(c.validity, d.validity)


@pytest.mark.parametrize("case", ["unequal", "empty_partition", "one",
                                  "capacity0", "no_columns"])
def test_blob_round_trip(case):
    gen = torch.Generator().manual_seed(7)
    if case == "unequal":
        pb = PartitionedBatch((_batch(gen, 256, 10), _batch(gen, 256, 200),
                               _batch(gen, 256, 256)))
    elif case == "empty_partition":
        pb = PartitionedBatch((_batch(gen, 128, 0), _batch(gen, 128, 5)))
    elif case == "one":
        pb = PartitionedBatch((_batch(gen, 128, 77),))
    elif case == "capacity0":
        pb = PartitionedBatch((_batch(gen, 0, 0), _batch(gen, 0, 0)))
    else:
        pb = PartitionedBatch((Batch((), torch.tensor(0, dtype=torch.int32)),
                               ) * 2)
    blob = encode_stage(pb)
    h = read_header(blob)
    assert h["P"] == pb.n_partitions and h["cap"] == pb.capacity
    assert h["num_rows"] == [int(b.num_rows) for b in pb.batches]
    assert [p["dtype"] for p in h["planes"]] == [
        n for dt in _DTYPES for n in (str(dt).split(".")[1], "bool")
    ][:len(h["planes"])]
    _assert_same_partitions(decode_stage(blob), pb)
    mesh = make_mesh(pb.n_partitions,
                     devices=[torch.device("cpu")] * pb.n_partitions)
    _assert_same_partitions(decode_stage(blob, mesh), pb)


def test_blob_rejects_malformed():
    gen = torch.Generator().manual_seed(1)
    blob = encode_stage(PartitionedBatch((_batch(gen, 128, 3),)))
    with pytest.raises(ValueError, match="magic"):
        decode_stage(b"PAR1" + blob[4:])
    with pytest.raises(ValueError, match="data bytes"):
        decode_stage(blob[:-8])
    with pytest.raises(ValueError, match="mesh"):
        decode_stage(blob, make_mesh(2, devices=[torch.device("cpu")] * 2))


def test_blob_uses_no_pickle_nor_torch_save(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the stage blob must not pickle")
    for mod, name in ((pickle, "dumps"), (pickle, "loads"),
                      (pickle, "Pickler"), (pickle, "Unpickler"),
                      (torch, "save"), (torch, "load")):
        monkeypatch.setattr(mod, name, refuse)
    gen = torch.Generator().manual_seed(2)
    pb = PartitionedBatch((_batch(gen, 128, 9), _batch(gen, 128, 100)))
    _assert_same_partitions(decode_stage(encode_stage(pb)), pb)
    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "ballista_tpu_torch", "scheduler",
                            "spill.py")).read()
    assert "pickle" not in src.replace("never pickle", "") \
        and "torch.save(" not in src


def test_wire_modules_import_no_pyarrow_nor_pandas():
    code = ("import sys; import ballista_tpu_torch.scheduler.rpc, "
            "ballista_tpu_torch.scheduler.executor_process, "
            "ballista_tpu_torch.serve, ballista_tpu_torch.api, "
            "ballista_tpu_torch.scheduler.kv_remote; "
            "print(sorted(m for m in ('pyarrow', 'pandas', 'jax', "
            "'ballista_tpu') if m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True,
                         cwd=os.path.join(os.path.dirname(__file__), ".."))
    assert out.stdout.strip() == "[]"


def test_q3_stage_outputs_equal_jax_blobs(contexts, tmp_path):
    """Q3 at P = 2 through each package's standalone cluster with a work
    dir: every stage output the port spilled, decoded from its blob, holds
    the JAX package's rows (its `decode_stage` of its own Arrow blob)
    partition by partition, plane by plane, over the live rows."""
    from ballista_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from ballista_tpu.scheduler.spill import StageSpiller as JaxSpiller
    from ballista_tpu.scheduler.standalone import \
        StandaloneCluster as JaxCluster
    jctx, tctx = contexts
    jcl = JaxCluster(jctx, jax_make_mesh(2), JaxDistOptions(n_partitions=2),
                     work_dir=str(tmp_path / "jax"))
    tcl = StandaloneCluster(tctx, make_mesh(2, devices=[torch.device("cpu")]
                                            * 2),
                            DistOptions(n_partitions=2),
                            work_dir=str(tmp_path / "port"))
    jjob, tjob = jcl.submit_sql(TPCH_QUERIES[3]), tcl.submit_sql(
        TPCH_QUERIES[3])
    jcl.wait(jjob)
    tcl.wait(tjob)
    n_stages = len(tcl.launcher.jobs[tjob].dplan.stages)
    assert n_stages == len(jcl.launcher.jobs[jjob].dplan.stages) >= 3
    jsp, tsp = JaxSpiller(str(tmp_path / "jax")), tcl.spiller
    for sid in range(n_stages):
        theirs = jsp.restore(jjob, sid)
        mine = decode_stage(tsp.read_blob(tjob, sid))
        assert mine.n_partitions == theirs.n_partitions == 2
        jrows = np.asarray(theirs.num_rows)
        for p in range(2):
            n = int(mine.batches[p].num_rows)
            assert n == int(jrows[p]), (sid, p)
            assert len(mine.batches[p].columns) == len(theirs.columns)
            for c, jc in zip(mine.batches[p].columns, theirs.columns):
                valid = c.validity[:n].numpy()
                np.testing.assert_array_equal(
                    valid, np.asarray(jc.validity)[p, :n])
                np.testing.assert_array_equal(
                    c.data[:n].numpy()[valid],
                    np.asarray(jc.data)[p, :n][valid])


# -- StageSpiller --

def test_spiller_versioned_keys_and_cleaning(tmp_path):
    gen = torch.Generator().manual_seed(3)
    pb = PartitionedBatch((_batch(gen, 128, 4), _batch(gen, 128, 8)))
    v0 = StageSpiller(str(tmp_path))
    v2 = v0.at_version(2)
    assert v0.spill("jobA", 1, pb) == len(encode_stage(pb))
    v2.spill("jobA", 1, pb)
    v0.spill("jobB", 0, pb)
    assert (tmp_path / "jobA" / "stage_1.stage").is_file()
    assert (tmp_path / "jobA" / "v2_stage_1.stage").is_file()
    assert v2.read_blob("jobA", 0) is None
    _assert_same_partitions(v2.restore("jobA", 1), pb)
    assert StageSpiller(str(tmp_path), version=1).restore("jobA", 1) is None
    # the TTL cleaner removes jobs whose newest file is older than the TTL
    old = time.time() - 3600
    for f in (tmp_path / "jobB").iterdir():
        os.utime(f, (old, old))
    assert v0.clean_expired(ttl_seconds=60) == ["jobB"]
    assert not (tmp_path / "jobB").exists()
    v0.clean_job("jobA")
    assert not (tmp_path / "jobA").exists()
    mem = StageSpiller("mem://bucket/spill")
    mem.spill("jobC", 0, pb)
    _assert_same_partitions(mem.restore("jobC", 0), pb)
    mem.clean_all()
    assert mem.read_blob("jobC", 0) is None


def test_standalone_restores_lost_outputs(contexts, tmp_path):
    """The standalone cluster's three read tiers: a job whose outputs were
    dropped from memory restores them from the spill store, and a stage
    run on restored inputs answers as before."""
    _, tctx = contexts
    cl = StandaloneCluster(tctx, make_mesh(2, devices=[torch.device("cpu")]
                                           * 2),
                           DistOptions(n_partitions=2),
                           work_dir=str(tmp_path))
    job = cl.submit_sql(TPCH_QUERIES[5])
    want_b, want_s = cl.wait(job)
    want = want_b.columns[1].data[:int(want_b.num_rows)].clone()
    jc = cl.launcher.jobs[job]
    last = jc.dplan.final_stage
    jc.outputs.clear()
    jc.observed.clear()
    jc.run_stage(last)
    assert jc.reads["spill"] >= 1
    got_b, _ = jc.final_batch()
    assert int(got_b.num_rows) == int(want_b.num_rows)
    assert torch.equal(got_b.columns[1].data[:int(got_b.num_rows)], want)
