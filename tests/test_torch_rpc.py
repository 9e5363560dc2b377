"""The port's control plane across processes: the scheduler's RPC service
(`scheduler/rpc.py`) on a thread of the test and executor processes
(`python -m ballista_tpu_torch.scheduler.executor_process --device cpu
--partitions 2`) that register over HTTP, poll for stage tasks, run them on
their own partitions, exchange stage outputs through the job's spill store
and report statuses back. No Python object crosses between the processes,
only wire JSON and stage blobs. The counterparts of tests/test_rpc.py's
pull-mode cases, with answers held to the JAX package's in-core answers:

- TPC-H Q1, Q3, Q5 and Q18 with two executors (both must run tasks);
- a killed executor, a graceful stop, the state snapshot, `cli --connect`;
- skew stats riding the wire; a shuffle overflow and an operator-capacity
  overflow each bumping the job's spec version until the job converges,
  and an overflow that never ends failing the job after MAX_ATTEMPTS;
- re-registration after expiry; mismatched mesh widths;
- two repairs of the JAX package's copy: the scheduler answers a heartbeat
  while `fetch_result` dials a dead peer, and an executor never
  advertises a loopback data endpoint to a remote scheduler.

Every test kills the processes it started in a `finally`. Tolerances:
validity, integers, decimals, dates and strings exact; f64 at rtol 1e-9."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ballista_tpu.datagen.tpch import TPCH_TABLES as REF_TABLES, generate_table
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.datagen import TPCH_TABLES
from ballista_tpu_torch.scheduler.execution_graph import (ExecutionGraph,
                                                          JobState,
                                                          TaskStatus)
from ballista_tpu_torch.scheduler.executor_process import (ExecutorProcess,
                                                           advertised_host)
from ballista_tpu_torch.scheduler.rpc import (SchedulerRpcClient,
                                              serve_scheduler)
from ballista_tpu_torch.scheduler.server import (ExecutorMetadata,
                                                 SchedulerServer,
                                                 TaskLauncher)
from ballista_tpu_torch.serde.tasks import status_to_wire
from test_torch_distributed import assert_same

torch.set_num_threads(2)

N_PART = 2
SF = 0.002
TABLES = {"kind": "tpch", "sf": SF}
REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SQL = """
    select o_orderpriority, count(*) as n
    from orders join customer on o_custkey = c_custkey
    where o_totalprice > 1000
    group by o_orderpriority order by o_orderpriority
"""


# -- process-level helpers (tests/test_torch_rpc_p2p.py uses them too) --

def start_scheduler(work_dir, executor_timeout_s=180.0, policy="pull"):
    service, httpd = serve_scheduler(str(work_dir), policy=policy,
                                     executor_timeout_s=executor_timeout_s,
                                     device="cpu")
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return service, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


def spawn_executor(url, executor_id, work_dir=None, policy="pull",
                   partitions=N_PART):
    """An executor process on the CPU with `partitions` partitions,
    returned once it has registered (its EXECUTOR_READY line)."""
    cmd = [sys.executable, "-m", "ballista_tpu_torch.scheduler.executor_process",
           "--scheduler", url, "--executor-id", executor_id,
           "--device", "cpu", "--partitions", str(partitions),
           "--poll-ms", "20", "--heartbeat-s", "1", "--policy", policy]
    if work_dir:
        cmd += ["--work-dir", str(work_dir)]
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=os.pathsep.join(
                   [REPO] + [p for p in os.environ.get("PYTHONPATH", "")
                             .split(os.pathsep) if p]))
    p = subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    deadline = time.time() + 60
    lines = []
    while time.time() < deadline:
        line = p.stdout.readline()
        lines.append(line)
        if "EXECUTOR_READY" in line:
            # keep draining its output so the pipe never fills
            threading.Thread(target=lambda: [None for _ in p.stdout],
                             daemon=True).start()
            return p
        if p.poll() is not None:
            break
    p.kill()
    raise RuntimeError(f"executor {executor_id} failed to start:\n"
                       + "".join(lines))


def stop_all(procs, httpd):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=30)
    httpd.shutdown()
    httpd.server_close()


def tasks_by_executor(client, job_id):
    """{executor id: stages it ran} from the job's merged stage metrics."""
    out = {}
    for sid, st in client.job_status(job_id)["stages"].items():
        for e in (st.get("metrics") or {}).get("executors", []):
            out.setdefault(e, []).append(sid)
    return out


@pytest.fixture(scope="module")
def jax_ctx():
    from ballista_tpu.client import SessionContext as JaxContext
    jctx = JaxContext(capacity_mode="exact")
    for name in TPCH_TABLES:
        jctx.register_arrow(name, generate_table(name, SF),
                            primary_key=REF_TABLES[name][1])
    return jctx


@pytest.fixture(scope="module")
def port_ctx():
    from ballista_tpu_torch.serde.tasks import build_context
    return build_context(TABLES, device="cpu")


# -- end to end --

def test_rpc_end_to_end_two_executors(tmp_path, jax_ctx, port_ctx):
    """Two executor processes and the scheduler service run Q1, Q3, Q5 and
    Q18; each answer fetched over the wire equals the JAX package's in-core
    answer, both executors ran tasks, and the tasks' metrics carry the
    kernel entry points' launch counts and the bytes spilled."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-a"))
        procs.append(spawn_executor(url, "ex-b"))
        client = SchedulerRpcClient(url, device="cpu")
        ran = set()
        for q in (1, 3, 5, 18):
            job_id = client.submit_sql(TPCH_QUERIES[q], TABLES,
                                       options={"n_partitions": N_PART},
                                       ctx=port_ctx)
            got = client.wait_batch(job_id, timeout_s=120)
            assert_same(got, jax_ctx.sql(TPCH_QUERIES[q]).collect())
            ran |= set(tasks_by_executor(client, job_id))
            stages = client.job_status(job_id)["stages"].values()
            assert all(st["state"] == "successful" for st in stages)
            # each task reports the launches of the kernel's two entry
            # points (none on the CPU, where they take their plain
            # versions; chip_smoke.py phase 14 requires them on the card)
            # and the bytes it spilled
            for st in stages:
                assert set(st["metrics"]["kernel_launches"]) == {
                    "masked_slot_sums_rows", "masked_slot_sums"}
                assert st["metrics"]["spilled_bytes"] > 0
        assert ran == {"ex-a", "ex-b"}
        assert all(p.poll() is None for p in procs)
        # pandas only inside wait()
        df = client.wait(job_id)
        assert len(df) == int(got[0].num_rows)
    finally:
        stop_all(procs, httpd)


def test_rpc_killed_executor_job_completes(tmp_path, jax_ctx, port_ctx):
    """SIGKILL one worker after its first task reports: heartbeat expiry
    removes it and the survivor finishes the job from the spilled outputs
    (executor_manager.rs:450 expiry and reset_stages_on_lost_executor, over
    a real wire)."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle",
                                          executor_timeout_s=3.0)
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-a"))
        procs.append(spawn_executor(url, "ex-b"))
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(TPCH_QUERIES[21], TABLES,
                                   options={"n_partitions": N_PART},
                                   ctx=port_ctx)
        deadline = time.time() + 60
        while time.time() < deadline and \
                "ex-a" not in tasks_by_executor(client, job_id):
            time.sleep(0.01)
        procs[0].send_signal(signal.SIGKILL)
        got = client.wait_batch(job_id, timeout_s=120)
        assert_same(got, jax_ctx.sql(TPCH_QUERIES[21]).collect())
        assert procs[1].poll() is None
    finally:
        stop_all(procs, httpd)


def test_rpc_state_reports_executors_and_metrics(tmp_path, port_ctx):
    """/rpc/state: executors with load and heartbeat-reported gauges, and
    the job statuses (the REST /api/state surface of a remote
    deployment)."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-m"))
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(SQL, TABLES, ctx=port_ctx)
        client.wait_batch(job_id, timeout_s=120)
        deadline = time.time() + 10   # heartbeats are 1 s apart here
        metrics = None
        while time.time() < deadline and metrics is None:
            st = client.state()
            ex = {e["executor_id"]: e for e in st["executors"]}
            metrics = ex["ex-m"].get("metrics")
            time.sleep(0.2)
        assert metrics is not None and "cached_jobs" in metrics
        assert ex["ex-m"]["devices"] == N_PART
        assert st["jobs"][job_id]["state"] == "successful"
        # the partition count defaulted to the fleet's mesh width
        assert service.specs[job_id].options.n_partitions == N_PART
    finally:
        stop_all(procs, httpd)


def test_cli_connect_remote(tmp_path, capsys):
    """ballista-cli --host parity: the one-shot mode submits over the wire
    to a remote scheduler and worker and prints the result."""
    from ballista_tpu_torch.cli import main as cli_main
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-cli"))
        cli_main(["--connect", url, "--sf", str(SF),
                  "-c", "select count(*) n from orders"], device="cpu")
        out = capsys.readouterr().out
        assert str(int(1_500_000 * SF)) in out and "1 row(s)" in out
    finally:
        stop_all(procs, httpd)


def test_rpc_graceful_stop_deregisters(tmp_path):
    """SIGTERM runs the graceful stop: the worker notifies ExecutorStopped,
    exits 0, and the scheduler removes it (executor_process.rs TERMINATING
    grace path over the wire)."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-stop"))
        assert "ex-stop" in service.scheduler.executor_manager.executors
        procs[0].terminate()
        assert procs[0].wait(timeout=30) == 0
        em = service.scheduler.executor_manager
        deadline = time.time() + 10
        while time.time() < deadline:
            with service.lock:
                if "ex-stop" not in em.executors:
                    break
            time.sleep(0.1)
        assert "ex-stop" not in em.executors
        assert em.is_dead("ex-stop")
    finally:
        stop_all(procs, httpd)


def test_rpc_skew_stats_ride_the_wire(tmp_path):
    """A hot-key overflow ships shuffle-write stats in TaskStatus; the
    scheduler's retry is stats-driven (salt for the skewed exchange) and
    the re-run answers as numpy does (PartitionStats,
    serde/scheduler/mod.rs:33-100, over a real wire)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(0)
    n = 4000
    keys = np.where(rng.random(n) < 0.85, 7, rng.integers(0, 100, n))
    v = rng.integers(0, 1000, n)
    pq.write_table(pa.table({"k": pa.array(keys, pa.int64()),
                             "v": pa.array(v, pa.int64())}),
                   str(tmp_path / "fact.parquet"))
    pq.write_table(pa.table({"dk": pa.array(np.arange(100), pa.int64()),
                             "w": pa.array(np.arange(100) * 10, pa.int64())}),
                   str(tmp_path / "dim.parquet"))
    tables = {"kind": "files", "tables": {
        "fact": {"format": "parquet", "path": str(tmp_path / "fact.parquet"),
                 "primary_key": None},
        "dim": {"format": "parquet", "path": str(tmp_path / "dim.parquet"),
                "primary_key": ["dk"]}}}
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        # four partitions: with two, no destination holds four times the
        # median, and the retry raises quotas instead of salting
        procs.append(spawn_executor(url, "ex-a", partitions=4))
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(
            "select k, sum(v + w) as s, count(*) c from fact join dim "
            "on k = dk group by k order by k", tables,
            options={"n_partitions": 4, "broadcast_threshold": 0,
                     "min_quota": 16, "quota_headroom": 1.05})
        batch, schema = client.wait_batch(job_id, timeout_s=120)
        from ballista_tpu_torch.batch import to_numpy
        got = to_numpy(batch, schema)
        uk, cnt = np.unique(keys, return_counts=True)
        sums = np.zeros(100, dtype=np.int64)
        np.add.at(sums, keys, v + np.arange(100)[keys] * 10)
        np.testing.assert_array_equal(got["k"][0], uk)
        np.testing.assert_array_equal(got["c"][0], cnt)
        np.testing.assert_array_equal(got["s"][0], sums[uk])
        spec = service.specs[job_id]
        assert spec.version >= 1
        # stats-driven: the hot key forced a salted retry
        assert spec.options.join_salt > 1
    finally:
        stop_all(procs, httpd)


@pytest.mark.parametrize("kind", ["shuffle", "capacity"])
def test_rpc_overflow_escalates_spec_version(tmp_path, port_ctx, kind):
    """An overflow fails the task over the wire; the scheduler escalates
    the job spec (a version bump) and the re-run converges with the larger
    capacities. A quota overflow escalates the quotas; an operator's
    capacity overflow (a group table of 128 slots) grows group tables and
    join outputs and leaves the quotas as they were. Both converge within
    the job's MAX_ATTEMPTS."""
    from ballista_tpu_torch.batch import to_numpy
    options = ({"n_partitions": N_PART, "broadcast_threshold": 0,
                "min_quota": 1, "quota_headroom": 0.01}
               if kind == "shuffle" else
               {"n_partitions": N_PART, "max_group_table": 128})
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-a"))
        client = SchedulerRpcClient(url, device="cpu")
        sql = SQL if kind == "shuffle" else TPCH_QUERIES[18]
        job_id = client.submit_sql(sql, TABLES, options=options,
                                   ctx=port_ctx)
        got = to_numpy(*client.wait_batch(job_id, timeout_s=120))
        want = to_numpy(*port_ctx.sql(sql).collect())
        for name in want:
            np.testing.assert_array_equal(got[name][1], want[name][1])
            np.testing.assert_array_equal(got[name][0][got[name][1]],
                                          want[name][0][want[name][1]])
        spec = service.specs[job_id]
        assert spec.version >= 1
        if kind == "capacity":
            assert spec.options.max_group_table >= 128 * 4 ** spec.version
            assert spec.options.quota_headroom == 2.0
        else:
            assert spec.options.quota_headroom > 0.01
        # the job's last spill keys carry its last version
        assert any(f.name.startswith(f"v{spec.version}_stage_")
                   for f in (tmp_path / "shuffle" / job_id).iterdir())
    finally:
        stop_all(procs, httpd)


def test_rpc_capacity_growth_answers_q18(tmp_path, port_ctx):
    """Q18 from group tables of 16 slots over the wire: the executor
    reports how many times its capacity the overflowing operator wanted,
    the scheduler grows the spec by that (a power of two, at least 4x),
    and the job answers within MAX_ATTEMPTS, equal to in-core."""
    from ballista_tpu_torch.batch import to_numpy
    from ballista_tpu_torch.scheduler.standalone import MAX_ATTEMPTS
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    procs = []
    try:
        procs.append(spawn_executor(url, "ex-a"))
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(
            TPCH_QUERIES[18], TABLES, ctx=port_ctx,
            options={"n_partitions": N_PART, "max_group_table": 16})
        got = to_numpy(*client.wait_batch(job_id, timeout_s=120))
        want = to_numpy(*port_ctx.sql(TPCH_QUERIES[18]).collect())
        for name in want:
            np.testing.assert_array_equal(got[name][1], want[name][1])
            np.testing.assert_array_equal(got[name][0][got[name][1]],
                                          want[name][0][want[name][1]])
        spec = service.specs[job_id]
        assert 1 <= spec.version <= MAX_ATTEMPTS - 1
        assert spec.options.max_group_table > 16 * 4 ** spec.version
    finally:
        stop_all(procs, httpd)


@pytest.mark.parametrize("kind", ["shuffle", "capacity"])
def test_rpc_permanent_overflow_fails_the_job(tmp_path, port_ctx, kind):
    """An executor whose every attempt overflows: the scheduler escalates
    the spec MAX_ATTEMPTS - 1 times (the budget JobContext has in
    process), then fails the job with the overflow's error instead of
    escalating on. A status of an attempt already rolled back, sent again,
    escalates nothing."""
    from ballista_tpu_torch.scheduler.standalone import MAX_ATTEMPTS
    service, httpd, url = start_scheduler(tmp_path / "shuffle")
    try:
        client = SchedulerRpcClient(url, device="cpu")
        client.register_executor(ExecutorMetadata("ov-1", task_slots=1,
                                                  devices=N_PART))
        job_id = client.submit_sql(SQL, TABLES,
                                   options={"n_partitions": N_PART},
                                   ctx=port_ctx)
        metrics = {"overflow": "capacity"} if kind == "capacity" else None
        stale = []
        for attempt in range(MAX_ATTEMPTS):
            assert service.specs[job_id].version == attempt
            tasks, known = client.poll_work("ov-1", 1, stale)
            assert known and len(tasks) == 1
            assert service.specs[job_id].version == attempt
            t = tasks[0]
            stale = [TaskStatus(t.task_id, job_id, t.stage_id, t.partitions,
                                "ov-1", "failed", f"planted overflow {attempt}",
                                error_kind="shuffle_overflow",
                                metrics=metrics)]
            client.call("update_task_status", executor_id="ov-1",
                        statuses=[status_to_wire(s) for s in stale])
        st = client.job_status(job_id)
        assert st["state"] == "failed"
        assert f"each of {MAX_ATTEMPTS} attempts" in st["error"]
        assert f"planted overflow {MAX_ATTEMPTS - 1}" in st["error"]
        assert service.specs[job_id].version == MAX_ATTEMPTS - 1
        with pytest.raises(RuntimeError, match="overflowed in each of"):
            client.wait_batch(job_id, timeout_s=10)
        tasks, _ = client.poll_work("ov-1", 1, stale)
        assert tasks == []
        assert service.specs[job_id].version == MAX_ATTEMPTS - 1
    finally:
        stop_all([], httpd)


def test_rpc_reregistration_after_expiry(tmp_path):
    """A worker whose id expired (heartbeat lapse, scheduler restart) must
    not poll idle forever: the wire carries known=False, and registering
    again restores the flow."""
    service, httpd, url = start_scheduler(tmp_path / "store")
    try:
        client = SchedulerRpcClient(url, device="cpu")
        meta = ExecutorMetadata("exp-1", task_slots=2, devices=0)
        client.register_executor(meta)
        with service.lock:
            em = service.scheduler.executor_manager
            em.executors["exp-1"].last_heartbeat = 0.0
            service.scheduler.expire_dead_executors()
            assert em.is_dead("exp-1")
        tasks, known = client.poll_work("exp-1", 2, [])
        assert tasks == [] and known is False
        assert client.heartbeat("exp-1").get("known") is False
        client.register_executor(meta)
        with service.lock:
            assert not em.is_dead("exp-1")
        _tasks, known = client.poll_work("exp-1", 2, [])
        assert known is True
    finally:
        stop_all([], httpd)


def test_fill_reservations_skips_mismatched_mesh_width():
    """A job planned for N partitions is never handed to an executor whose
    mesh width differs; an executor handed one refuses it."""
    class _Null(TaskLauncher):
        def launch(self, tasks, report):
            raise AssertionError("pull mode")

    s = SchedulerServer(_Null(), policy="pull")
    s.register_executor(ExecutorMetadata("w8", task_slots=4, devices=8))
    s.register_executor(ExecutorMetadata("w4", task_slots=4, devices=4))
    s.submit_job(ExecutionGraph("jobw", [(0, 4, [])]))
    s.run_until_idle()
    assert s.poll_work("w8", 4) == []
    tasks = s.poll_work("w4", 4)
    assert tasks and tasks[0].job_id == "jobw"

    from types import SimpleNamespace
    ex = ExecutorProcess("http://127.0.0.1:1", "w2", device="cpu",
                         partitions=2)
    assert ex.meta.devices == 2
    ex.client.get_job = lambda job_id: SimpleNamespace(
        version=0, options=SimpleNamespace(n_partitions=4))
    with pytest.raises(RuntimeError, match="mesh has 2"):
        ex._job_for(tasks[0])


# -- repairs of the JAX package's copy --

def test_heartbeat_answers_while_fetch_result_dials_a_dead_peer(tmp_path,
                                                               port_ctx):
    """The JAX package's fetch_result dials peers under the service lock,
    so one dead peer stalls every verb for its timeout. The port's reads
    the job under the lock and dials after: a heartbeat is answered at
    once while the fetch waits on a peer that accepts and never replies."""
    from ballista_tpu_torch.serde.plans import encode_plan
    service, httpd, url = start_scheduler(tmp_path / "store")
    hole = socket.socket()
    hole.bind(("127.0.0.1", 0))
    hole.listen(8)      # connections complete; nothing ever answers
    try:
        service.PEER_TIMEOUT_S = 4.0
        client = SchedulerRpcClient(url, device="cpu")
        client.register_executor(ExecutorMetadata(
            "ghost", "127.0.0.1", 0, 1, devices=N_PART,
            data_port=hole.getsockname()[1]))
        job_id = client.call("submit_job", plan=encode_plan(
            port_ctx.sql("select n_name from nation").plan), tables=TABLES,
            options={"n_partitions": N_PART})["job_id"]
        with service.lock:
            g = service.scheduler.task_manager.jobs[job_id]
            final = g.stages[service.specs[job_id].final_stage]
            final.output_locations = {p: "ghost" for p in range(N_PART)}
            g.state = JobState.SUCCESSFUL
        result = {}
        t = threading.Thread(target=lambda: result.update(
            client.call("fetch_result", job_id=job_id)))
        t0 = time.time()
        t.start()
        time.sleep(0.5)
        assert t.is_alive()           # the fetch is waiting on the peer
        h0 = time.time()
        assert client.heartbeat("ghost")["ok"]
        assert time.time() - h0 < 1.5
        assert t.is_alive()
        t.join(timeout=30)
        assert not t.is_alive() and time.time() - t0 >= 4.0
        assert "not found" in result["error"]
    finally:
        hole.close()
        stop_all([], httpd)


def test_data_endpoint_never_advertises_loopback_to_a_remote_scheduler():
    """The JAX package's executor advertised 127.0.0.1 to any scheduler,
    so peers on other machines dialled themselves. The port advertises a
    loopback bind only to a scheduler on the same machine, the machine's
    name for a wildcard bind, and refuses a loopback bind with a remote
    scheduler."""
    remote = "http://10.1.2.3:50050"
    for bind in ("127.0.0.1", "localhost", "::1"):
        with pytest.raises(ValueError, match="advertise-host"):
            advertised_host(bind, remote)
        assert advertised_host(bind, "http://127.0.0.1:50050") == bind
        assert advertised_host(bind, remote, "worker-3.example") == \
            "worker-3.example"
    assert advertised_host("0.0.0.0", remote) == socket.getfqdn()
    assert advertised_host("10.9.8.7", remote) == "10.9.8.7"
    ex = ExecutorProcess(remote, "adv", device="cpu", partitions=1)
    with pytest.raises(ValueError, match="advertise-host"):
        ex.listen("127.0.0.1", 0, data_only=True)
    port = ex.listen("0.0.0.0", 0, data_only=True)
    try:
        assert ex.meta.host == socket.getfqdn() and ex.meta.data_port == port
    finally:
        ex._httpd.shutdown()
        ex._httpd.server_close()
