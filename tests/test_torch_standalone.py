"""The standalone cluster against the JAX package's: jobs go through the
port's scheduler control plane (SchedulerServer, ExecutionGraph) into its
partitioned runtime on 8 CPU partitions, and through the JAX package's
onto its virtual 8-device mesh (tests/conftest.py). The seven cases of
tests/test_standalone.py (lifecycle, several jobs, an injected stage
failure retried, `SessionContext(distributed=True)` with Q11's nested
jobs, operator metrics, the circuit breaker, pull mode), each held to the
JAX package's answer and job status; then the command line's one-shot
`-c` with `--distributed`, `--plugin-dir` raising, and `--connect`
refusing to run without a data environment (it runs end to end in
tests/test_torch_rpc.py).

Answers are compared row by row: validity, integers, decimals and strings
exact, f64 at rtol 1e-9."""

import contextlib
import io

import numpy as np
import pytest
import torch

from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu.parallel.mesh import make_mesh as jax_make_mesh
from ballista_tpu.scheduler import standalone as JS
from ballista_tpu.scheduler.distributed_planner import \
    DistOptions as JaxDistOptions
from ballista_tpu_torch import cli
from ballista_tpu_torch.batch import to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, register_tpch
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.plugin import PluginError
from ballista_tpu_torch.scheduler import standalone as S
from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
from test_torch_distributed import assert_same

torch.set_num_threads(2)

SF = 0.002
P = 8


def cpu_mesh(n=P):
    return make_mesh(n, devices=[torch.device("cpu")] * n)


def _jax_ctx(**kw):
    ctx = JaxContext(capacity_mode="exact", **kw)
    for name in TPCH_TABLES:
        ctx.register_arrow(name, generate_table(name, SF),
                           primary_key=REF_TABLES[name][1])
    return ctx


@pytest.fixture(scope="module")
def clusters():
    tctx = SessionContext(device="cpu")
    register_tpch(tctx, SF)
    return (S.StandaloneCluster(tctx, cpu_mesh(), DistOptions(n_partitions=P)),
            JS.StandaloneCluster(_jax_ctx(), jax_make_mesh(P),
                                 JaxDistOptions(n_partitions=P)))


def _states(status):
    """A job status without ids: the job's state and each stage's state,
    partitions, successes and failures."""
    return (status["state"], {sid: (st["state"], st["partitions"],
                                    st["successful"], st["failures"])
                              for sid, st in status["stages"].items()})


def _both(clusters, sql):
    """Submit to both clusters, wait, and hold the answers and the final
    job statuses equal. Returns the two job ids."""
    tcl, jcl = clusters
    tid, jid = tcl.submit_sql(sql), jcl.submit_sql(sql)
    assert tcl.job_status(tid)["state"] in ("queued", "running", "successful")
    assert_same(tcl.wait(tid), jcl.wait(jid))
    assert _states(tcl.job_status(tid)) == _states(jcl.job_status(jid))
    return tid, jid


def test_job_lifecycle_and_result(clusters):
    tcl, _ = clusters
    tid, _ = _both(clusters, TPCH_QUERIES[1])
    final = tcl.job_status(tid)
    assert final["state"] == "successful"
    assert all(s["state"] == "successful" for s in final["stages"].values())
    assert all(s["partitions"] == P for sid, s in final["stages"].items()
               if sid != max(final["stages"]))


def test_multi_job_and_join_query(clusters):
    tcl, jcl = clusters
    t1, t2 = tcl.submit_sql(TPCH_QUERIES[6]), tcl.submit_sql(TPCH_QUERIES[5])
    j1, j2 = jcl.submit_sql(TPCH_QUERIES[6]), jcl.submit_sql(TPCH_QUERIES[5])
    tcl.scheduler.run_until_idle()
    jcl.scheduler.run_until_idle()
    for tid, jid in ((t1, j1), (t2, j2)):
        assert tcl.job_status(tid)["state"] == "successful"
        assert _states(tcl.job_status(tid)) == _states(jcl.job_status(jid))
        assert_same(tcl.launcher.jobs[tid].final_batch(),
                    jcl.launcher.jobs[jid].final_batch())


def test_failed_stage_retries_then_succeeds(clusters, monkeypatch):
    """The first stage run fails once in both packages; the scheduler's
    task retry runs it again and the job succeeds, its status equal to the
    JAX package's."""
    calls = {}
    for mod in (S, JS):
        orig = mod.JobContext.run_stage

        def flaky(self, stage_id, *args, _orig=orig, _mod=mod):
            calls[_mod] = calls.get(_mod, 0) + 1
            if calls[_mod] == 1:
                raise RuntimeError("injected transient failure")
            return _orig(self, stage_id, *args)

        monkeypatch.setattr(mod.JobContext, "run_stage", flaky)
    tid, _ = _both(clusters, "select count(*) as n from lineitem")
    assert calls[S] >= 2 and calls[S] == calls[JS]
    assert clusters[0].job_status(tid)["state"] == "successful"


def test_session_context_distributed_mode():
    """distributed=True sends every collect to the cluster; Q11's eager
    scalar subquery runs as a nested job first."""
    tctx = SessionContext(device="cpu", distributed=True, mesh=cpu_mesh())
    register_tpch(tctx, SF)
    jctx = _jax_ctx(distributed=True, mesh=jax_make_mesh(P))
    assert_same(tctx.sql(TPCH_QUERIES[11]).collect(),
                jctx.sql(TPCH_QUERIES[11]).collect())
    jobs = tctx.cluster().launcher.jobs
    assert len(jobs) == len(jctx.cluster().launcher.jobs) >= 2
    assert all(tctx.cluster().job_status(j)["state"] == "successful"
               for j in jobs)
    held = tctx.cluster().runtime.table_bytes
    assert held > 0
    tctx.evict_device()
    assert tctx.cluster().runtime.table_bytes == 0


def test_operator_metrics_collected(clusters):
    tcl, jcl = clusters
    sql = ("select l_returnflag, count(*) as c from lineitem "
           "where l_quantity < 10 group by l_returnflag")
    tid, jid = tcl.submit_sql(sql), jcl.submit_sql(sql)
    tcl.scheduler.run_until_idle()
    jcl.scheduler.run_until_idle()
    tops, jops = tcl.launcher.jobs[tid].op_metrics, \
        jcl.launcher.jobs[jid].op_metrics
    assert sorted(tops) == sorted(jops)

    def by_kind(ops):
        return {sid: sorted((k.split("(")[0].split("[")[0], v)
                            for k, v in stage.items())
                for sid, stage in ops.items()}

    assert by_kind(tops) == by_kind(jops)
    agg = [v for stage in tops.values() for k, v in stage.items()
           if "HashAggregateExec" in k]
    assert agg and all(v <= 32 for v in agg)


def test_circuit_breaker_trips_on_global_limit(clusters):
    tcl, _ = clusters
    batch, schema = tcl.collect_sql("select l_orderkey from lineitem limit 5")
    assert int(batch.num_rows) == 5
    jid = list(tcl.launcher.jobs)[-1]
    assert tcl.scheduler.circuit_breaker.is_tripped(jid, "global-limit")


def test_pull_mode_cluster_end_to_end(clusters):
    tcl, jcl = clusters
    tpull = S.StandaloneCluster(tcl.ctx, cpu_mesh(),
                                DistOptions(n_partitions=P), policy="pull")
    jpull = JS.StandaloneCluster(jcl.ctx, jax_make_mesh(P),
                                 JaxDistOptions(n_partitions=P),
                                 policy="pull")
    assert_same(tpull.collect_sql(TPCH_QUERIES[6]),
                jpull.wait(jpull.submit_sql(TPCH_QUERIES[6])))
    assert tpull.scheduler.policy == "pull"
    assert tpull.poll_executor is not None


def test_lost_stage_output_raises_fetch_failure(clusters):
    """A stage output that is gone (no spill in the port) raises a fetch
    failure naming its producer."""
    from ballista_tpu_torch.errors import BallistaError
    tcl, _ = clusters
    jid = tcl.submit_sql(TPCH_QUERIES[1])
    jc = tcl.launcher.jobs[jid]
    jc.run_stage(0)
    jc.outputs.clear()
    with pytest.raises(BallistaError) as e:
        jc.run_stage(1)
    assert e.value.kind == "fetch_failed"


def test_context_refuses_a_mesh_of_another_type():
    with pytest.raises(ValueError, match="mesh"):
        SessionContext(device="cpu", distributed=True,
                       mesh=[torch.device("meta")] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            SessionContext(distributed=True)


def _cli(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(argv, device="cpu", mesh=cpu_mesh())
    return out.getvalue()


def test_cli_one_shot_distributed():
    sql = ("select l_returnflag, l_linestatus, count(*) as c, "
           "sum(l_extendedprice) as s from lineitem "
           "group by l_returnflag, l_linestatus order by 1, 2")
    text = _cli(["--sf", str(SF), "--distributed", "--format", "csv",
                 "-c", sql])
    lines = text.splitlines()
    assert lines[0] == "l_returnflag,l_linestatus,c,s"
    jctx = _jax_ctx()
    want = jctx.sql(sql).to_pandas()
    assert lines[-1].startswith(f"{len(want)} row(s) in ")
    rows = [r.split(",") for r in lines[1:1 + len(want)]]
    assert [r[0] for r in rows] == list(want["l_returnflag"])
    assert [int(r[2]) for r in rows] == list(want["c"])
    np.testing.assert_allclose([float(r[3]) for r in rows],
                               want["s"].astype(float), rtol=1e-12)


def test_cli_explain_shows_stages():
    text = _cli(["--sf", str(SF), "--distributed", "-c",
                 "select count(*) from nation"])
    assert "row(s)" in text
    repl = cli.Repl(SessionContext(device="cpu"), True, cpu_mesh(4))
    register_tpch(repl.ctx, SF, tables=["nation"])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        repl.handle_meta("\\explain select n_name from nation order by 1")
    assert "Distributed stages:" in out.getvalue()
    assert "GatherExec(P=4)" in out.getvalue()


@pytest.mark.parametrize("flag, error, match", [
    (["--connect", "http://localhost:50050"], SystemExit,
     "needs a data environment"),
    (["--plugin-dir", "no_such_plugin_dir"], PluginError, "does not exist")],
    ids=["flag0", "flag1"])
def test_cli_unported_flags_raise(flag, error, match):
    with pytest.raises(error, match=match):
        cli.main(flag + ["-c", "select 1"], device="cpu")


def test_escalation_stays_with_the_job():
    """A job whose exchange overflows escalates its own options (quota,
    then salt, as the JAX package's retry does) and answers as the JAX
    cluster does; the cluster's options stay, and the same query submitted
    again starts from the options its job converged to."""
    rng = np.random.default_rng(0)
    n = 4000
    keys = np.where(rng.random(n) < 0.85, 7, rng.integers(0, 100, n))
    cols = {"k": keys.astype(np.int64),
            "v": rng.integers(0, 1000, n).astype(np.int64)}
    dim = {"dk": np.arange(100, dtype=np.int64),
           "w": np.arange(100, dtype=np.int64) * 10}
    import pyarrow as pa
    tctx = SessionContext(device="cpu")
    jctx = JaxContext(capacity_mode="exact")
    tctx.register_numpy("fact", cols)
    tctx.register_numpy("dim", dim, primary_key=("dk",))
    jctx.register_arrow("fact", pa.table(cols))
    jctx.register_arrow("dim", pa.table(dim), primary_key=("dk",))
    kw = dict(n_partitions=P, broadcast_threshold=0, min_quota=16,
              quota_headroom=1.05)
    tcl = S.StandaloneCluster(tctx, cpu_mesh(), DistOptions(**kw))
    jcl = JS.StandaloneCluster(jctx, jax_make_mesh(P), JaxDistOptions(**kw))
    sql = ("select k, sum(v + w) as s, count(*) c from fact join dim "
           "on k = dk group by k order by k")
    first = tcl.submit_sql(sql)
    assert_same(tcl.wait(first), jcl.wait(jcl.submit_sql(sql)))
    attempts = tcl.launcher.jobs[first].attempts
    assert len(attempts) >= 2 and attempts[-1].join_salt > 1
    assert tcl.runtime.opts == DistOptions(**kw)
    again = tcl.submit_sql(sql)
    tcl.wait(again)
    assert tcl.launcher.jobs[again].attempts == [attempts[-1]]


def test_escalation_reruns_finished_stages():
    """Q21 at SF 0.02 on tight quotas: a stage overflows after stages
    numbered above it have finished; the retry re-plans with the escalated
    options, runs every finished stage again (the reference re-runs only
    the stages numbered below, and the job then fails on a lost output)
    and answers as the in-core run does."""
    sf = 0.02
    incore = SessionContext(device="cpu")
    register_tpch(incore, sf)
    cl = S.StandaloneCluster(incore, cpu_mesh(), DistOptions(
        n_partitions=P, min_quota=16, quota_headroom=1.0))
    jid = cl.submit_sql(TPCH_QUERIES[21])
    got = cl.wait(jid)
    jc = cl.launcher.jobs[jid]
    assert len(jc.attempts) >= 2
    assert cl.job_status(jid)["state"] == "successful"
    assert_same(got, incore.sql(TPCH_QUERIES[21]).collect(), to_numpy)
    assert int(got[0].num_rows) > 0


def test_capacity_growth_sized_from_the_need():
    """Q18 from group tables of 16 slots: each retry grows group tables
    and join outputs by the need the overflowing stage counted (a power
    of two, at least 4x), so the job answers within its MAX_ATTEMPTS, as
    the in-core run does; growing 4x blindly needed more attempts than
    that."""
    tctx = SessionContext(device="cpu")
    register_tpch(tctx, SF)
    cl = S.StandaloneCluster(tctx, cpu_mesh(), DistOptions(
        n_partitions=P, max_group_table=16))
    jid = cl.submit_sql(TPCH_QUERIES[18])
    got = cl.wait(jid)
    attempts = cl.launcher.jobs[jid].attempts
    assert 2 <= len(attempts) <= S.MAX_ATTEMPTS
    assert attempts[-1].max_group_table > 16 * 4 ** (len(attempts) - 1)
    assert cl.job_status(jid)["state"] == "successful"
    assert_same(got, tctx.sql(TPCH_QUERIES[18]).collect(), to_numpy)


def test_group_table_growth_leaves_join_outputs_at_4x():
    """An aggregate of about 3,000 groups over an expanding join (four
    partsupp rows per part), from group tables of 16 slots: the
    overflowing attempt grows group tables by their need (far over 4x)
    and the join outputs, which kept to their capacity, by 4x only."""
    sql = ("SELECT l_orderkey, count(*) AS n, sum(ps_availqty) AS q "
           "FROM lineitem JOIN partsupp ON l_partkey = ps_partkey "
           "GROUP BY l_orderkey ORDER BY l_orderkey")
    tctx = SessionContext(device="cpu")
    register_tpch(tctx, SF)
    cl = S.StandaloneCluster(tctx, cpu_mesh(), DistOptions(
        n_partitions=P, max_group_table=16, join_out_factor=8.0))
    jid = cl.submit_sql(sql)
    got = cl.wait(jid)
    jc = cl.launcher.jobs[jid]
    labels = [lbl for rows in jc.op_metrics.values() for lbl in rows]
    assert any("expanding" in lbl for lbl in labels), labels
    attempts = jc.attempts
    assert len(attempts) == 2
    assert attempts[1].max_group_table >= 16 * 16
    assert attempts[1].join_out_factor == 8.0 * 4
    assert cl.job_status(jid)["state"] == "successful"
    assert_same(got, tctx.sql(sql).collect(), to_numpy)
