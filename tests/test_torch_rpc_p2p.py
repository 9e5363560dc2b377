"""Push scheduling and the peer-to-peer shuffle of the port's control plane
across processes: the counterparts of tests/test_rpc.py's push-mode and
p2p cases, executors spawned as in tests/test_torch_rpc.py (`--device cpu
--partitions 2`), answers held to the JAX package's in-core answers:

- push mode end to end, push with a killed executor, the push verbs'
  queue semantics, the status flush retrying a failed delivery;
- executors with disjoint local work dirs exchanging stage outputs over
  their data endpoints (`fetch_partition`), a worker-to-worker fetch in
  one process, a killed producer recovered by rolling its stage back,
  and a portless executor under a push scheduler getting work by polling;
- a repair of the JAX package's copy: `fetch_partition` never serves an
  attempt a newer spec version superseded, and serves the spilled blob
  before the output in memory.

Every test kills the processes it started in a `finally`."""

import json
import signal
import threading
import time
import urllib.request
from types import SimpleNamespace

import torch

from ballista_tpu_torch.batch import Batch, Column
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.parallel.partitioned import PartitionedBatch
from ballista_tpu_torch.scheduler.execution_graph import (TaskDescription,
                                                          TaskStatus)
from ballista_tpu_torch.scheduler.executor_process import (ExecutorProcess,
                                                           fetch_stage_blob)
from ballista_tpu_torch.scheduler.rpc import SchedulerRpcClient
from ballista_tpu_torch.scheduler.server import ExecutorMetadata
from ballista_tpu_torch.scheduler.spill import (StageSpiller, decode_stage,
                                                encode_stage)
from ballista_tpu_torch.serde.tasks import task_to_wire
from test_torch_distributed import assert_same
from test_torch_rpc import (N_PART, SQL, TABLES, jax_ctx,  # noqa: F401
                            port_ctx, spawn_executor, start_scheduler,
                            stop_all, tasks_by_executor)

torch.set_num_threads(2)


def _answer(jax_ctx, client, job_id, sql=SQL):
    assert_same(client.wait_batch(job_id, timeout_s=120),
                jax_ctx.sql(sql).collect())


def test_push_mode_end_to_end_two_executors(tmp_path, jax_ctx, port_ctx):
    """Push-staged scheduling over the wire (ExecutorGrpc.LaunchTask
    parity, proto:1102): the scheduler POSTs task batches to registered
    executor endpoints; statuses return via UpdateTaskStatus; the stage
    metrics the workers shipped are merged on the scheduler."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle",
                                          policy="push")
    procs = []
    try:
        procs.append(spawn_executor(url, "push-a", policy="push"))
        procs.append(spawn_executor(url, "push-b", policy="push"))
        client = SchedulerRpcClient(url, device="cpu")
        for sql in (SQL, TPCH_QUERIES[5]):
            job_id = client.submit_sql(sql, TABLES, ctx=port_ctx)
            _answer(jax_ctx, client, job_id, sql)
        assert all(p.poll() is None for p in procs)
        stage_metrics = [s.get("metrics") for s in
                         client.job_status(job_id)["stages"].values()]
        assert any(m and m.get("operator_rows") for m in stage_metrics)
        assert any(m and m.get("run_s", 0) > 0 for m in stage_metrics)
        assert {e for m in stage_metrics if m
                for e in m.get("executors", [])} <= {"push-a", "push-b"}
        assert tasks_by_executor(client, job_id)
    finally:
        stop_all(procs, httpd)


def test_push_mode_killed_executor_job_completes(tmp_path, jax_ctx,
                                                 port_ctx):
    """SIGKILL a push worker after its first task reports: its tasks come
    back as retryable failures (a failed LaunchTask, heartbeat expiry) and
    the survivor finishes."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle",
                                          executor_timeout_s=3.0,
                                          policy="push")
    procs = []
    try:
        procs.append(spawn_executor(url, "push-a", policy="push"))
        procs.append(spawn_executor(url, "push-b", policy="push"))
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(TPCH_QUERIES[21], TABLES, ctx=port_ctx)
        deadline = time.time() + 60
        while time.time() < deadline and \
                "push-a" not in tasks_by_executor(client, job_id):
            time.sleep(0.01)
        procs[0].send_signal(signal.SIGKILL)
        _answer(jax_ctx, client, job_id, TPCH_QUERIES[21])
        assert procs[1].poll() is None
    finally:
        stop_all(procs, httpd)


def _post(port, verb, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/exec/{verb}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read())


def test_push_verbs_queue_semantics():
    """The ExecutorGrpc-analog verbs: launch enqueues, cancel drops a job's
    queued tasks, stop rejects later launches (executor_server.rs:1118
    TERMINATING), remove_job_data evicts the cached job."""
    ex = ExecutorProcess.__new__(ExecutorProcess)
    ex.meta = ExecutorMetadata("unit-push", task_slots=1)
    ex.client = SchedulerRpcClient("http://127.0.0.1:1", device="cpu")
    ex.jobs = {"jobx": object()}
    ex._stop = threading.Event()
    port = ex.listen("127.0.0.1", 0)
    try:
        assert ex.meta.port == ex.meta.data_port == port
        t1 = task_to_wire(TaskDescription("joba", 0, (0,), 1, "unit-push"))
        t2 = task_to_wire(TaskDescription("jobb", 1, (0,), 2, "unit-push"))
        t1["spec_version"] = t2["spec_version"] = 0
        assert _post(port, "launch_task", {"tasks": [t1, t2]})["accepted"] == 2
        assert len(ex._queue) == 2
        assert _post(port, "cancel_tasks", {"job_id": "joba"})["ok"]
        assert [t.job_id for t in ex._queue] == ["jobb"]
        assert _post(port, "remove_job_data", {"job_id": "jobx"})["ok"]
        assert "jobx" not in ex.jobs
        assert _post(port, "stop_executor", {})["ok"]
        out = _post(port, "launch_task", {"tasks": [dict(t1)]})
        assert out["accepted"] == 0 and out.get("terminating")
    finally:
        ex._httpd.shutdown()
        ex._httpd.server_close()


def test_push_status_flush_retries_failed_deliveries():
    """A transient update_task_status failure does not park the status:
    the push loop retries pending deliveries on the next flush, in
    order."""
    ex = ExecutorProcess.__new__(ExecutorProcess)
    ex.meta = ExecutorMetadata("flush-unit", task_slots=1)
    ex._statuses = []
    delivered = []

    class _FlakyClient:
        calls = 0

        def update_task_status(self, eid, statuses):
            self.calls += 1
            if self.calls == 1:
                raise OSError("scheduler hiccup")
            delivered.extend(statuses)

    ex.client = _FlakyClient()
    s1 = TaskStatus(1, "j", 0, (0,), "flush-unit", "successful")
    s2 = TaskStatus(2, "j", 1, (0,), "flush-unit", "successful")
    ex._statuses.append(s1)
    ex._flush_statuses()
    assert ex._statuses == [s1]
    ex._statuses.append(s2)
    ex._flush_statuses()
    assert ex._statuses == [] and delivered == [s1, s2]


def test_p2p_shuffle_disjoint_work_dirs(tmp_path, jax_ctx, port_ctx):
    """Two workers with disjoint local work dirs, no shared storage, run a
    join and an aggregate whose exchange crosses processes: stage outputs
    travel over each producer's data endpoint (fetch_partition), and the
    result reaches the client through the scheduler's p2p egress
    (shuffle_reader.rs:226 FlightRemote, flight_service.rs:74 do_get)."""
    service, httpd, url = start_scheduler(tmp_path / "sched_store")
    procs = []
    try:
        procs.append(spawn_executor(url, "p2p-a", work_dir=tmp_path / "wd_a"))
        procs.append(spawn_executor(url, "p2p-b", work_dir=tmp_path / "wd_b"))
        client = SchedulerRpcClient(url, device="cpu")
        fetched = 0
        for sql in (SQL, TPCH_QUERIES[3], TPCH_QUERIES[5]):
            job_id = client.submit_sql(sql, TABLES, ctx=port_ctx)
            _answer(jax_ctx, client, job_id, sql)
            fetched += sum(st["metrics"].get("inputs_fetched", 0) for st in
                           client.job_status(job_id)["stages"].values())
        assert fetched >= 1
        assert all(p.poll() is None for p in procs)
        # the scheduler's store was never the transport
        sched = tmp_path / "sched_store"
        assert not sched.exists() or not [f for f in sched.rglob("*")
                                          if f.is_file()]
        assert len(client.state()["executors"]) == 2
    finally:
        stop_all(procs, httpd)


def test_p2p_fetch_partition_worker_to_worker(tmp_path, port_ctx):
    """Producer A runs every task into its own work dir and serves stage 0
    over its data endpoint; consumer B (a disjoint work dir) finds it
    through the scheduler and pulls the blob over HTTP: the FlightRemote
    tier alone."""
    service, httpd, url = start_scheduler(tmp_path / "sched_store")
    a = b = None
    try:
        mesh = make_mesh(N_PART, devices=[torch.device("cpu")] * N_PART)
        a = ExecutorProcess(url, "peer-a", mesh=mesh, device="cpu",
                            work_dir=str(tmp_path / "wa"))
        b = ExecutorProcess(url, "peer-b", mesh=mesh, device="cpu",
                            work_dir=str(tmp_path / "wb"))
        a.listen("127.0.0.1", 0, data_only=True)
        b.listen("127.0.0.1", 0, data_only=True)
        a.client.register_executor(a.meta)
        b.client.register_executor(b.meta)
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(SQL, TABLES, ctx=port_ctx)
        deadline = time.time() + 60
        while time.time() < deadline:
            tasks, _ = a.client.poll_work("peer-a", 1, a._statuses)
            a._statuses = []
            if not tasks:
                if client.job_status(job_id)["state"] in ("successful",
                                                          "failed"):
                    break
                time.sleep(0.02)
                continue
            for t in tasks:
                a._statuses.append(a._run_task(t))
        assert client.job_status(job_id)["state"] == "successful"
        locs = client.stage_locations(job_id, 0)
        assert [loc["executor_id"] for loc in locs] == ["peer-a"]
        blob = fetch_stage_blob(locs[0]["host"], locs[0]["data_port"],
                                job_id, 0, version=0)
        assert blob == (tmp_path / "wa" / job_id / "stage_0.stage"
                        ).read_bytes()
        assert decode_stage(blob).n_partitions == N_PART
        got = b._peer_fetch(job_id, 0, b.mesh, version=0)
        assert got is not None and got.n_partitions == N_PART
        assert got.batches[1].device == torch.device("cpu")
        # a dead peer disappears from the locations
        with service.lock:
            em = service.scheduler.executor_manager
            em.executors["peer-a"].last_heartbeat = 0.0
            service.scheduler.expire_dead_executors()
        assert client.stage_locations(job_id, 0) == []
    finally:
        for ex in (a, b):
            if ex is not None and hasattr(ex, "_httpd"):
                ex._httpd.shutdown()
                ex._httpd.server_close()
        stop_all([], httpd)


def test_p2p_shuffle_killed_producer_recovers(tmp_path, jax_ctx, port_ctx):
    """SIGKILL a producer where work dirs are disjoint: its peer tier is
    gone and there is no shared store, so the graph rolls the lost stages
    back onto the survivor and still finishes (a three-tier read miss, a
    fetch failure, a rollback)."""
    service, httpd, url = start_scheduler(tmp_path / "sched_store",
                                          executor_timeout_s=3.0)
    procs = []
    try:
        procs.append(spawn_executor(url, "p2p-a", work_dir=tmp_path / "wd_a"))
        procs.append(spawn_executor(url, "p2p-b", work_dir=tmp_path / "wd_b"))
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(TPCH_QUERIES[9], TABLES, ctx=port_ctx)
        deadline = time.time() + 60
        while time.time() < deadline and \
                "p2p-a" not in tasks_by_executor(client, job_id):
            time.sleep(0.01)
        procs[0].send_signal(signal.SIGKILL)
        _answer(jax_ctx, client, job_id, TPCH_QUERIES[9])
        assert procs[1].poll() is None
    finally:
        stop_all(procs, httpd)


def test_push_scheduler_portless_executor_gets_work_via_poll(tmp_path,
                                                             jax_ctx,
                                                             port_ctx):
    """A pull-mode worker (no push endpoint, port 0) registered with a push
    scheduler still gets work through PollWork, and the job succeeds the
    first time, with no synthesized launch failures."""
    service, httpd, url = start_scheduler(tmp_path / "shuffle",
                                          policy="push")
    procs = []
    try:
        procs.append(spawn_executor(url, "pull-on-push"))
        client = SchedulerRpcClient(url, device="cpu")
        job_id = client.submit_sql(SQL, TABLES, ctx=port_ctx)
        _answer(jax_ctx, client, job_id)
        st = client.job_status(job_id)
        assert st["state"] == "successful"
        assert service.specs[job_id].version == 0
    finally:
        stop_all(procs, httpd)


def _pb(value):
    cols = (Column(torch.full((128,), value, dtype=torch.int64),
                   torch.ones(128, dtype=torch.bool)),)
    return PartitionedBatch((Batch(cols, torch.tensor(128,
                                                      dtype=torch.int32)),))


def test_fetch_partition_never_serves_a_superseded_attempt(tmp_path):
    """The JAX package's data endpoint served a request of an older spec
    version from the local work dir while the job ran a newer one, and
    encoded the in-memory output a re-plan could be replacing. The port
    refuses a version older than the newest it has seen of the job (after
    the job left its cache too), serves the stage's spilled blob before
    anything in memory, and takes the in-memory output once under the
    job's lock."""
    import threading as th
    ex = ExecutorProcess.__new__(ExecutorProcess)
    ex.work_dir = str(tmp_path)
    StageSpiller(str(tmp_path), version=0).spill("job1", 0, _pb(1))
    v1 = StageSpiller(str(tmp_path), version=1)
    jc = SimpleNamespace(spiller=v1, outputs={"0": _pb(3)}, lock=th.Lock())
    ex.jobs = {"job1": SimpleNamespace(spec=SimpleNamespace(version=1),
                                       jc=jc)}
    ex._versions = {"job1": 1}

    def served(version):
        blob = ex._fetch_partition_blob({"job_id": "job1", "stage_id": 0,
                                         "spec_version": version})
        return None if blob is None else int(
            decode_stage(blob).batches[0].columns[0].data[0])

    assert served(0) is None          # superseded: the job is at v1
    assert served(1) == 3             # v1 not spilled yet: the output
    v1.spill("job1", 0, _pb(2))
    assert served(1) == 2             # the spilled blob comes first
    assert served(2) is None          # a newer spec than the job's
    ex.jobs.clear()
    # the job evicted: a cold read of the local work dir, still never of
    # the superseded version
    assert served(0) is None and served(1) == 2
    assert encode_stage(_pb(2)) == v1.read_blob("job1", 0)
