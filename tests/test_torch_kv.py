"""The port's key-value cluster storage (`scheduler/kv.py`) and its shared
network backend (`scheduler/kv_remote.py`): the cases of tests/test_kv.py
and tests/test_kv_remote.py run against the port's stores, plus

- a job graph the JAX package's KeyValueJobStore saved to sqlite, read
  and recovered by the port's (the ExecutionGraph documents are one
  format);
- a repair of the JAX package's copy: an unlock that cannot reach the
  service after the renewals have failed for longer than the lease's TTL
  raises LockLostError (the JAX package took every transport failure on
  the unlock as clean)."""

import threading
import time

import pytest

from ballista_tpu_torch.scheduler.execution_graph import (ExecutionGraph,
                                                          JobState,
                                                          TaskStatus)
from ballista_tpu_torch.scheduler.job_store import recover_graphs
from ballista_tpu_torch.scheduler.kv import (Keyspace, KeyValueJobStore,
                                             MemoryKeyValueStore,
                                             SqliteKeyValueStore, WatchEvent)
from ballista_tpu_torch.scheduler.kv_remote import (LockLostError,
                                                    RemoteKeyValueStore,
                                                    serve_kv)
from ballista_tpu_torch.scheduler.server import (ExecutorMetadata,
                                                 SchedulerServer,
                                                 TaskLauncher)


@pytest.fixture(params=["memory", "sqlite"])
def store(request, tmp_path):
    if request.param == "memory":
        return MemoryKeyValueStore()
    return SqliteKeyValueStore(str(tmp_path / "kv.db"))


def _serve(store=None, max_log=None):
    service, httpd = serve_kv(store)
    if max_log is not None:
        service.max_log = max_log
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return service, httpd, f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture()
def kv_url():
    _service, httpd, url = _serve()
    yield url
    httpd.shutdown()
    httpd.server_close()


class _Instant(TaskLauncher):
    """Completes every task at once (VirtualTaskLauncher,
    test_utils.rs:357)."""

    def launch(self, tasks, report):
        report([TaskStatus(t.task_id, t.job_id, t.stage_id, t.partitions,
                           t.executor_id, "successful") for t in tasks])


class _Blackhole(TaskLauncher):
    def launch(self, tasks, report):
        pass


def _diamond(job_id, parts=4):
    return ExecutionGraph(job_id, [(0, parts, []), (1, parts, []),
                                   (2, parts, [0, 1]), (3, 1, [2])])


class TestKeyValueStore:
    def test_put_get_delete(self, store):
        assert store.get(Keyspace.EXECUTORS, "e1") is None
        store.put(Keyspace.EXECUTORS, "e1", '{"slots":4}')
        assert store.get(Keyspace.EXECUTORS, "e1") == '{"slots":4}'
        assert store.get(Keyspace.SESSIONS, "e1") is None
        store.delete(Keyspace.EXECUTORS, "e1")
        assert store.get(Keyspace.EXECUTORS, "e1") is None

    def test_scan_prefix_ordering(self, store):
        for k in ("job3", "job1", "job2", "task1"):
            store.put(Keyspace.JOB_STATUS, k, k.upper())
        assert store.scan(Keyspace.JOB_STATUS, "job") == [
            ("job1", "JOB1"), ("job2", "JOB2"), ("job3", "JOB3")]
        assert len(store.scan(Keyspace.JOB_STATUS)) == 4

    def test_txn_atomic(self, store):
        store.put(Keyspace.SLOTS, "a", "1")
        store.apply_txn([("put", Keyspace.SLOTS, "b", "2"),
                         ("delete", Keyspace.SLOTS, "a", None)])
        assert store.get(Keyspace.SLOTS, "a") is None
        assert store.get(Keyspace.SLOTS, "b") == "2"

    def test_mv(self, store):
        store.put(Keyspace.JOB_STATUS, "j1", "running")
        store.mv(Keyspace.JOB_STATUS, Keyspace.SESSIONS, "j1")
        assert store.get(Keyspace.JOB_STATUS, "j1") is None
        assert store.get(Keyspace.SESSIONS, "j1") == "running"
        store.mv(Keyspace.JOB_STATUS, Keyspace.SESSIONS, "missing")

    def test_watch_prefix_and_cancel(self, store):
        w = store.watch(Keyspace.HEARTBEATS, "e")
        store.put(Keyspace.HEARTBEATS, "e1", "t1")
        store.put(Keyspace.HEARTBEATS, "x9", "t2")
        store.put(Keyspace.EXECUTORS, "e1", "meta")
        store.delete(Keyspace.HEARTBEATS, "e1")
        assert [(e.kind, e.key) for e in w.drain()] == [
            (WatchEvent.PUT, "e1"), (WatchEvent.DELETE, "e1")]
        w.cancel()
        store.put(Keyspace.HEARTBEATS, "e2", "t3")
        assert w.drain() == []

    def test_lock_mutual_exclusion(self, store):
        order = []

        def worker(tag):
            with store.lock(Keyspace.SLOTS, "global"):
                order.append(f"{tag}-in")
                order.append(f"{tag}-out")

        ts = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        with store.lock(Keyspace.SLOTS, "global"):
            for t in ts:
                t.start()
            assert order == []
        for t in ts:
            t.join(timeout=10)
            assert not t.is_alive()
        for i in range(0, len(order), 2):
            assert order[i].split("-")[0] == order[i + 1].split("-")[0]

    def test_sqlite_durability(self, tmp_path):
        path = str(tmp_path / "durable.db")
        s1 = SqliteKeyValueStore(path)
        s1.put(Keyspace.EXECUTION_GRAPH, "j1", '{"g":1}')
        s1.close()
        s2 = SqliteKeyValueStore(path)
        assert s2.get(Keyspace.EXECUTION_GRAPH, "j1") == '{"g":1}'
        s2.close()


class TestKeyValueJobStore:
    def test_round_trip_and_status(self, store):
        js = KeyValueJobStore(store)
        g = ExecutionGraph("jkv1", [(0, 2, []), (1, 1, [0])])
        js.save_job(g, plan_json='{"plan":"p"}')
        doc = js.get_job("jkv1")
        assert doc["plan"] == '{"plan":"p"}'
        assert doc["graph"]["job_id"] == "jkv1"
        assert js.get_job_status("jkv1")["state"] == g.state.value
        assert js.list_jobs() == ["jkv1"]
        js.save_job(g)
        assert js.get_job("jkv1")["plan"] == '{"plan":"p"}'
        js.remove_job("jkv1")
        assert js.get_job("jkv1") is None
        assert js.get_job_status("jkv1") is None

    def test_job_state_events(self, store):
        js = KeyValueJobStore(store)
        w = js.job_state_events()
        js.save_job(ExecutionGraph("jev1", [(0, 2, []), (1, 1, [0])]))
        evs = w.drain()
        assert len(evs) == 1 and evs[0].key == "jev1"

    def test_scheduler_recovery_via_kv(self, store):
        """SchedulerServer.recover_jobs over the KV store: the takeover the
        reference stubs (kv.rs:697)."""
        js = KeyValueJobStore(store)
        s1 = SchedulerServer(_Blackhole(), job_store=js)
        s1.register_executor(ExecutorMetadata("e1", task_slots=4))
        s1.submit_job(_diamond("jrec1"))
        s1.run_until_idle()
        s2 = SchedulerServer(_Instant(), job_store=js)
        s2.register_executor(ExecutorMetadata("e2", task_slots=8))
        assert s2.recover_jobs() == ["jrec1"]
        s2.run_until_idle()
        assert s2.task_manager.jobs["jrec1"].state is JobState.SUCCESSFUL


def test_reads_a_graph_the_jax_package_saved(tmp_path):
    """A job graph the JAX package's KeyValueJobStore wrote to sqlite
    (mid-job: its first stages done) is read and recovered by the port's,
    and a port scheduler finishes it."""
    from ballista_tpu.scheduler import kv as jkv
    from ballista_tpu.scheduler import server as jserver
    from ballista_tpu.scheduler.execution_graph import \
        ExecutionGraph as JaxGraph
    from ballista_tpu.scheduler.execution_graph import \
        TaskStatus as JaxStatus

    class _OneStage(jserver.TaskLauncher):
        """Completes the scan stages, holds the rest."""

        def launch(self, tasks, report):
            report([JaxStatus(t.task_id, t.job_id, t.stage_id, t.partitions,
                              t.executor_id, "successful")
                    for t in tasks if t.stage_id in (0, 1)])

    path = str(tmp_path / "jobs.db")
    jstore = jkv.KeyValueJobStore(jkv.SqliteKeyValueStore(path))
    s1 = jserver.SchedulerServer(_OneStage(), job_store=jstore)
    s1.register_executor(jserver.ExecutorMetadata("e1", task_slots=8))
    s1.submit_job(JaxGraph("jaxjob", [(0, 4, []), (1, 4, []),
                                      (2, 4, [0, 1]), (3, 1, [2])]))
    s1.run_until_idle()
    saved = jstore.get_job("jaxjob")
    assert saved["graph"]["stages"][0]["state"] == "successful"

    js = KeyValueJobStore(SqliteKeyValueStore(path))
    assert js.get_job("jaxjob") == saved
    assert js.get_job_status("jaxjob") == jstore.get_job_status("jaxjob")
    (g,) = recover_graphs(js)
    assert g.to_dict() == saved["graph"]
    assert g.stages[2].inputs == (0, 1)
    s2 = SchedulerServer(_Instant(), job_store=js)
    s2.register_executor(ExecutorMetadata("e2", task_slots=8))
    assert s2.recover_jobs() == ["jaxjob"]
    s2.run_until_idle()
    assert s2.task_manager.jobs["jaxjob"].state is JobState.SUCCESSFUL
    assert js.get_job_status("jaxjob")["state"] == "successful"


# -- the shared network backend (tests/test_kv_remote.py) --

def test_cross_client_put_get_scan_txn(kv_url):
    a, b = RemoteKeyValueStore(kv_url), RemoteKeyValueStore(kv_url)
    a.put(Keyspace.EXECUTORS, "e1", '{"slots":4}')
    assert b.get(Keyspace.EXECUTORS, "e1") == '{"slots":4}'
    b.apply_txn([("put", Keyspace.SLOTS, "s1", "1"),
                 ("put", Keyspace.SLOTS, "s2", "2"),
                 ("delete", Keyspace.EXECUTORS, "e1", None)])
    assert a.get(Keyspace.EXECUTORS, "e1") is None
    assert a.scan(Keyspace.SLOTS) == [("s1", "1"), ("s2", "2")]
    assert a.get(Keyspace.SESSIONS, "s1") is None


def test_watch_sees_other_clients_events(kv_url):
    a, b = RemoteKeyValueStore(kv_url), RemoteKeyValueStore(kv_url)
    w = a.watch(Keyspace.HEARTBEATS, "e")
    b.put(Keyspace.HEARTBEATS, "e1", "t1")
    b.put(Keyspace.HEARTBEATS, "x9", "t2")
    b.delete(Keyspace.HEARTBEATS, "e1")
    assert [(e.kind, e.key) for e in w.drain()] == [("put", "e1"),
                                                    ("delete", "e1")]

    def later():
        time.sleep(0.2)
        b.put(Keyspace.HEARTBEATS, "e2", "t3")
    threading.Thread(target=later, daemon=True).start()
    ev = w.poll(timeout=5.0)
    assert ev is not None and ev.key == "e2"


def test_lease_lock_mutual_exclusion_and_ttl_takeover(kv_url):
    a = RemoteKeyValueStore(kv_url, lock_ttl_s=0.5)
    b = RemoteKeyValueStore(kv_url, lock_ttl_s=0.5)
    order = []
    with a.lock(Keyspace.SLOTS, "global"):
        order.append("a")
        with pytest.raises(TimeoutError):
            with b.lock(Keyspace.SLOTS, "global", acquire_timeout_s=0.2):
                order.append("b-too-early")
    with b.lock(Keyspace.SLOTS, "global", acquire_timeout_s=2.0):
        order.append("b")
    assert order == ["a", "b"]
    assert a._call("lock", ks="slots", key="wedged", ttl_s=0.3)["acquired"]
    with b.lock(Keyspace.SLOTS, "wedged", acquire_timeout_s=2.0):
        order.append("stolen")
    assert order[-1] == "stolen"


def test_job_recovery_through_shared_store(kv_url):
    s1 = KeyValueJobStore(RemoteKeyValueStore(kv_url))
    s1.save_job(ExecutionGraph("jobr", [(0, 4, []), (1, 4, [0])]))
    recovered = recover_graphs(KeyValueJobStore(RemoteKeyValueStore(kv_url)))
    assert [r.job_id for r in recovered] == ["jobr"]
    assert set(recovered[0].stages) == {0, 1}
    assert recovered[0].stages[1].inputs == (0,)


def test_embedded_store_can_back_the_service(tmp_path):
    _service, httpd, url = _serve(SqliteKeyValueStore(str(tmp_path / "kv.db")))
    try:
        c = RemoteKeyValueStore(url)
        c.put(Keyspace.JOB_STATUS, "j1", "running")
        assert c.get(Keyspace.JOB_STATUS, "j1") == "running"
        assert SqliteKeyValueStore(str(tmp_path / "kv.db")).get(
            Keyspace.JOB_STATUS, "j1") == "running"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_lease_keepalive_holds_lock_beyond_ttl(kv_url):
    a = RemoteKeyValueStore(kv_url, lock_ttl_s=0.3)
    b = RemoteKeyValueStore(kv_url, lock_ttl_s=0.3)
    with a.lock(Keyspace.SLOTS, "long"):
        time.sleep(1.0)
        with pytest.raises(TimeoutError):
            with b.lock(Keyspace.SLOTS, "long", acquire_timeout_s=0.2):
                pass
    with b.lock(Keyspace.SLOTS, "long", acquire_timeout_s=2.0):
        pass


def test_lock_lost_raises():
    service, httpd, url = _serve()
    try:
        a = RemoteKeyValueStore(url, lock_ttl_s=30.0)
        b = RemoteKeyValueStore(url, lock_ttl_s=30.0)
        with pytest.raises(LockLostError):
            with a.lock(Keyspace.SLOTS, "steal"):
                with service.cond:
                    lease, _expiry = service.locks[("slots", "steal")]
                    service.locks[("slots", "steal")] = (lease, 0.0)
                out = b._call("lock", ks="slots", key="steal", ttl_s=30.0)
                assert out["acquired"]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_watch_compaction_resyncs():
    _service, httpd, url = _serve(max_log=5)
    try:
        a = RemoteKeyValueStore(url)
        w = a.watch(Keyspace.SLOTS, "k")
        for i in range(20):
            a.put(Keyspace.SLOTS, f"k{i:02d}", str(i))
        a.delete(Keyspace.SLOTS, "k00")
        evs = w.drain()
        assert sorted(e.key for e in evs) == [f"k{i:02d}" for i in range(1, 20)]
        assert all(e.kind == "put" for e in evs)
        a.put(Keyspace.SLOTS, "k99", "x")
        ev = w.poll(timeout=5.0)
        assert ev is not None and ev.key == "k99"
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_watch_compaction_synthesizes_deletes():
    _service, httpd, url = _serve(max_log=5)
    try:
        a = RemoteKeyValueStore(url)
        w = a.watch(Keyspace.SLOTS, "k")
        a.put(Keyspace.SLOTS, "kdead", "1")
        assert [e.key for e in w.drain()] == ["kdead"]
        a.delete(Keyspace.SLOTS, "kdead")
        for i in range(10):
            a.put(Keyspace.SLOTS, f"k{i:02d}", str(i))
        evs = w.drain()
        assert [(e.kind, e.key) for e in evs if e.kind == "delete"] == [
            ("delete", "kdead")]
        assert sorted(e.key for e in evs if e.kind == "put") == [
            f"k{i:02d}" for i in range(10)]
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_unlock_transport_failure_is_not_lock_lost(kv_url):
    """A transport failure on the final unlock while the renewals kept
    succeeding does not raise: the lease expires on its own."""
    a = RemoteKeyValueStore(kv_url, lock_ttl_s=0.5)
    orig_call = a._call

    def flaky_call(verb, **req):
        if verb == "unlock":
            raise OSError("connection reset")
        return orig_call(verb, **req)

    a._call = flaky_call
    with a.lock(Keyspace.SLOTS, "flaky"):
        pass
    b = RemoteKeyValueStore(kv_url, lock_ttl_s=0.5)
    with b.lock(Keyspace.SLOTS, "flaky", acquire_timeout_s=2.0):
        pass


def test_unlock_after_failed_renewals_past_the_ttl_raises(kv_url):
    """The renewals fail (the service is unreachable to this holder) for
    longer than the lease's TTL, and so does the final unlock: the lease
    may have lapsed and a peer taken the lock, so leaving the critical
    section raises LockLostError. (The JAX package took the unlock's
    transport failure as clean whatever the renewals had done.)"""
    a = RemoteKeyValueStore(kv_url, lock_ttl_s=0.3)
    orig_call = a._call
    cut = threading.Event()

    def partitioned(verb, **req):
        if cut.is_set() and verb in ("renew", "unlock"):
            raise OSError("network unreachable")
        return orig_call(verb, **req)

    a._call = partitioned
    with pytest.raises(LockLostError):
        with a.lock(Keyspace.SLOTS, "cut"):
            cut.set()
            time.sleep(0.8)         # several renewal rounds fail, > TTL
    # the lease lapsed on the service: a peer takes the lock
    b = RemoteKeyValueStore(kv_url, lock_ttl_s=0.3)
    with b.lock(Keyspace.SLOTS, "cut", acquire_timeout_s=2.0):
        pass
