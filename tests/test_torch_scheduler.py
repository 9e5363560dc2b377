"""The scheduler's control plane, the port against the JAX package: the
classes of tests/test_scheduler.py (all but TestSchedulerEventBench, whose
port is in tests/test_torch_bench_tools.py) run the same event scripts
through both packages' ExecutionGraph, SchedulerServer and JobStore with virtual
executors. Each script keeps the reference test's assertions and records a
trace: every task handed out as (stage, partitions, executor, task id) in
order, and the job's status (states, partition and failure counts) after
each step; the two packages' traces must be equal. Host only: no device,
no JAX computation."""

import time
import types

import pytest

import ballista_tpu.scheduler.execution_graph as j_graph
import ballista_tpu.scheduler.job_store as j_store
import ballista_tpu.scheduler.server as j_server
import ballista_tpu_torch.scheduler.execution_graph as t_graph
import ballista_tpu_torch.scheduler.job_store as t_store
import ballista_tpu_torch.scheduler.server as t_server

PKGS = {"jax": types.SimpleNamespace(g=j_graph, s=j_server, js=j_store),
        "port": types.SimpleNamespace(g=t_graph, s=t_server, js=t_store)}


def same_trace(script, *args):
    """Run `script(pkg, trace, *args)` for both packages; their traces
    must be equal and not empty."""
    traces = {}
    for name, pkg in PKGS.items():
        trace = []
        script(pkg, trace, *args)
        traces[name] = trace
    assert traces["port"] == traces["jax"]
    assert traces["port"]


def diamond_graph(pkg, job_id="job1", parts=4):
    # 0 -> 2, 1 -> 2, 2 -> 3 (two scans feeding a join stage, then merge)
    return pkg.g.ExecutionGraph(job_id, [
        (0, parts, []), (1, parts, []), (2, parts, [0, 1]), (3, 1, [2]),
    ])


def ok(pkg, task):
    return pkg.g.TaskStatus(task.task_id, task.job_id, task.stage_id,
                            task.partitions, task.executor_id, "successful")


def fail(pkg, task, error="boom"):
    return pkg.g.TaskStatus(task.task_id, task.job_id, task.stage_id,
                            task.partitions, task.executor_id, "failed", error)


def fetch_fail(pkg, task, input_stage, error="fetch"):
    return pkg.g.TaskStatus(task.task_id, task.job_id, task.stage_id,
                            task.partitions, task.executor_id, "fetch_failed",
                            error, failed_input_stage=input_stage)


def task_of(task):
    return ("task", task.job_id, task.stage_id, tuple(task.partitions),
            task.executor_id, task.task_id)


def pop(pkg, g, trace, executor, **kw):
    t = g.pop_next_task(executor, **kw)
    trace.append(task_of(t) if t is not None else ("none", executor))
    return t


def update(g, trace, statuses):
    g.update_task_status(statuses)
    trace.append(("status", g.status()))


def drain(pkg, g, trace, executor="e1", fail_first_of_stage=None):
    failed_once = set()
    while True:
        task = pop(pkg, g, trace, executor)
        if task is None:
            break
        if fail_first_of_stage == task.stage_id and \
                task.stage_id not in failed_once:
            failed_once.add(task.stage_id)
            update(g, trace, [fail(pkg, task)])
        else:
            update(g, trace, [ok(pkg, task)])
    return g


# -- ExecutionGraph ---------------------------------------------------------

def _happy_path(pkg, trace):
    g = diamond_graph(pkg)
    assert g.stages[0].state is pkg.g.StageState.RUNNING
    assert g.stages[2].state is pkg.g.StageState.UNRESOLVED
    drain(pkg, g, trace)
    assert g.state is pkg.g.JobState.SUCCESSFUL
    assert all(s.state is pkg.g.StageState.SUCCESSFUL
               for s in g.stages.values())


def _multi_partition_task_group(pkg, trace):
    g = diamond_graph(pkg, parts=8)
    t = pop(pkg, g, trace, "e1", max_partitions=3)
    assert t.stage_id == 0 and len(t.partitions) == 3
    t2 = pop(pkg, g, trace, "e2", max_partitions=8)
    assert t2.stage_id == 0 and len(t2.partitions) == 5


def _stage_resolution_gating(pkg, trace):
    g = diamond_graph(pkg)
    seen = set()
    while True:
        t = pop(pkg, g, trace, "e1")
        if t is None:
            break
        seen.add(t.stage_id)
        update(g, trace, [ok(pkg, t)])
        if g.stages[0].state is not pkg.g.StageState.SUCCESSFUL or \
           g.stages[1].state is not pkg.g.StageState.SUCCESSFUL:
            assert 2 not in seen


def _task_retry_within_limit(pkg, trace):
    g = diamond_graph(pkg)
    t = pop(pkg, g, trace, "e1")
    update(g, trace, [fail(pkg, t)])
    assert g.state is pkg.g.JobState.RUNNING
    drain(pkg, g, trace)
    assert g.state is pkg.g.JobState.SUCCESSFUL


def _task_failure_limit_fails_job(pkg, trace):
    g = diamond_graph(pkg)
    for _ in range(pkg.g.TASK_MAX_FAILURES + 1):
        t = pop(pkg, g, trace, "e1")
        update(g, trace, [fail(pkg, t)])
    assert g.state is pkg.g.JobState.FAILED
    assert "task failures" in g.error


def _fetch_failure_rolls_back(pkg, trace):
    g = diamond_graph(pkg)
    S = pkg.g.StageState
    while g.stages[0].state is not S.SUCCESSFUL or \
            g.stages[1].state is not S.SUCCESSFUL:
        t = pop(pkg, g, trace, "e1")
        assert t.stage_id in (0, 1)
        update(g, trace, [ok(pkg, t)])
    t = pop(pkg, g, trace, "e1")
    assert t.stage_id == 2
    update(g, trace, [fetch_fail(pkg, t, input_stage=0)])
    assert g.stages[2].state is S.UNRESOLVED
    assert g.stages[0].state is S.RUNNING
    drain(pkg, g, trace)
    assert g.state is pkg.g.JobState.SUCCESSFUL


def _consecutive_stage_failures(pkg, trace):
    g = diamond_graph(pkg)
    for _ in range(pkg.g.STAGE_MAX_FAILURES + 1):
        if g.state is pkg.g.JobState.FAILED:
            break
        while True:
            t = pop(pkg, g, trace, "e1")
            if t is None:
                break
            if t.stage_id == 2:
                update(g, trace, [fetch_fail(pkg, t, input_stage=0)])
                break
            update(g, trace, [ok(pkg, t)])
    assert g.state is pkg.g.JobState.FAILED


def _executor_loss_resets_stages(pkg, trace):
    g = diamond_graph(pkg)
    S = pkg.g.StageState
    while True:
        t = pop(pkg, g, trace, "e1" if len(
            [1 for ti in g.stages[0].task_infos if ti is None]) else "e2")
        if t is None or t.stage_id == 2:
            break
        update(g, trace, [ok(pkg, t)])
    assert g.stages[0].state is S.SUCCESSFUL
    affected = g.reset_stages_on_lost_executor("e1")
    trace.append(("reset", sorted(affected), g.status()))
    assert 0 in affected
    assert g.stages[0].state is S.RUNNING
    assert g.stages[2].state is S.UNRESOLVED
    drain(pkg, g, trace, "e2")
    assert g.state is pkg.g.JobState.SUCCESSFUL


def _delayed_success_ignored(pkg, trace):
    g = diamond_graph(pkg)
    t0 = pop(pkg, g, trace, "e1")
    g.reset_stages_on_lost_executor("e1")
    update(g, trace, [ok(pkg, t0)])  # stale: task ids won't match
    assert g.stages[t0.stage_id].successful_partitions <= len(t0.partitions)
    drain(pkg, g, trace, "e2")
    assert g.state is pkg.g.JobState.SUCCESSFUL


class TestExecutionGraph:
    @pytest.mark.parametrize("script", [
        _happy_path, _multi_partition_task_group, _stage_resolution_gating,
        _task_retry_within_limit, _task_failure_limit_fails_job,
        _fetch_failure_rolls_back, _consecutive_stage_failures,
        _executor_loss_resets_stages, _delayed_success_ignored],
        ids=lambda f: f.__name__.strip("_"))
    def test_script(self, script):
        same_trace(script)

    def test_limits_equal(self):
        for name in ("TASK_MAX_FAILURES", "STAGE_MAX_FAILURES",
                     "OVERFLOW_MAX_FAILURES"):
            assert getattr(t_graph, name) == getattr(j_graph, name)


# -- SchedulerServer --------------------------------------------------------

def virtual_launcher(pkg, behavior=None, report_back=True):
    """Virtual executors that complete at once (VirtualTaskLauncher,
    test_utils.rs:357); `report_back=False` never reports."""

    class Virtual(pkg.s.TaskLauncher):
        def __init__(self):
            self.launched = []

        def launch(self, tasks, report):
            self.launched.extend(tasks)
            if report_back:
                report([(behavior or (lambda t: ok(pkg, t)))(t)
                        for t in tasks])

    return Virtual()


def launched(trace, launcher):
    trace.append(("launched", [task_of(t) for t in launcher.launched]))


def _push_completes_job(pkg, trace):
    launcher = virtual_launcher(pkg)
    s = pkg.s.SchedulerServer(launcher)
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=2))
    s.register_executor(pkg.s.ExecutorMetadata("e2", task_slots=2))
    g = diamond_graph(pkg)
    s.submit_job(g)
    s.run_until_idle()
    launched(trace, launcher)
    trace.append(g.status())
    assert g.state is pkg.g.JobState.SUCCESSFUL
    assert all(e.free_slots == e.meta.task_slots
               for e in s.executor_manager.executors.values())


def _round_robin_across_jobs(pkg, trace):
    launcher = virtual_launcher(pkg)
    s = pkg.s.SchedulerServer(launcher)
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=1))
    g1 = diamond_graph(pkg, "job1")
    g2 = diamond_graph(pkg, "job2")
    s.submit_job(g1)
    s.submit_job(g2)
    s.run_until_idle()
    launched(trace, launcher)
    assert g1.state is pkg.g.JobState.SUCCESSFUL
    assert g2.state is pkg.g.JobState.SUCCESSFUL
    jobs_in_order = [t.job_id for t in launcher.launched]
    assert "job1" in jobs_in_order and "job2" in jobs_in_order


def _statuses_from_dead_executor_dropped(pkg, trace):
    s = pkg.s.SchedulerServer(virtual_launcher(pkg))
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=4))
    g = diamond_graph(pkg)
    s.submit_job(g)
    s.run_until_idle()
    s.executor_lost("zombie")
    before = g.status()
    s.update_task_status("zombie", [pkg.g.TaskStatus(
        999, "job1", 0, (0,), "zombie", "failed", "late")])
    s.run_until_idle()
    trace.append(g.status())
    assert g.status() == before


def _executor_expiry_sweep(pkg, trace):
    s = pkg.s.SchedulerServer(virtual_launcher(pkg), executor_timeout_s=0.0)
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=1))
    time.sleep(0.01)
    s.expire_dead_executors()
    trace.append((sorted(s.executor_manager.executors),
                  s.executor_manager.is_dead("e1")))
    assert "e1" not in s.executor_manager.executors
    assert s.executor_manager.is_dead("e1")


def _keda_metrics(pkg, trace):
    s = pkg.s.SchedulerServer(virtual_launcher(pkg))
    g = diamond_graph(pkg)
    s.submit_job(g)
    trace.append((s.is_active(), s.pending_task_count()))
    assert s.is_active()
    assert s.pending_task_count() > 0
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=8))
    s.run_until_idle()
    trace.append((s.is_active(), s.pending_task_count()))
    assert not s.is_active()
    assert s.pending_task_count() == 0


class TestSchedulerServer:
    @pytest.mark.parametrize("script", [
        _push_completes_job, _round_robin_across_jobs,
        _statuses_from_dead_executor_dropped, _executor_expiry_sweep,
        _keda_metrics], ids=lambda f: f.__name__.strip("_"))
    def test_script(self, script):
        same_trace(script)


# -- lifecycle: CancelJob and graceful executor stop -------------------------

def _cancel_running_job(pkg, trace):
    s = pkg.s.SchedulerServer(virtual_launcher(pkg, report_back=False))
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=4))
    g = diamond_graph(pkg)
    s.submit_job(g)
    s.run_until_idle()
    assert g.state is pkg.g.JobState.RUNNING
    assert s.cancel_job("job1")
    assert g.state is pkg.g.JobState.CANCELLED
    assert not s.cancel_job("job1")
    assert not s.cancel_job("nope")
    s.update_task_status("e1", [pkg.g.TaskStatus(
        0, "job1", 0, (0, 1, 2, 3), "e1", "successful")])
    s.run_until_idle()
    trace.append(g.status())
    assert g.state is pkg.g.JobState.CANCELLED


def _graceful_stop_drains_then_removes(pkg, trace):
    launcher = virtual_launcher(pkg)
    s = pkg.s.SchedulerServer(launcher)
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=4))
    s.stop_executor("e1")
    assert (s.executor_manager.executors["e1"].status
            is pkg.s.ExecutorStatus.TERMINATING)
    g = diamond_graph(pkg)
    s.submit_job(g)
    s.run_until_idle()
    assert not launcher.launched
    assert s.poll_work("e1", 4) == []
    s.executor_stopped("e1")
    s.run_until_idle()
    assert "e1" not in s.executor_manager.executors
    assert s.executor_manager.is_dead("e1")
    s.register_executor(pkg.s.ExecutorMetadata("e2", task_slots=4))
    s.run_until_idle()
    launched(trace, launcher)
    trace.append(g.status())
    assert g.state is pkg.g.JobState.SUCCESSFUL


class TestLifecycle:
    @pytest.mark.parametrize("script", [
        _cancel_running_job, _graceful_stop_drains_then_removes],
        ids=lambda f: f.__name__.strip("_"))
    def test_script(self, script):
        same_trace(script)


# -- pull-staged scheduling (PollWork) ----------------------------------------

def _poll_loop_completes_job(pkg, trace):
    launcher = virtual_launcher(pkg)
    s = pkg.s.SchedulerServer(launcher, policy="pull")
    ex = pkg.s.PollLoopExecutor(s, launcher,
                                pkg.s.ExecutorMetadata("e1", task_slots=2))
    g = diamond_graph(pkg)
    s.submit_job(g)
    s.run_until_idle()
    assert not launcher.launched
    ex.run_until_drained()
    launched(trace, launcher)
    assert g.state is pkg.g.JobState.SUCCESSFUL


def _poll_claims_at_most_free_slots(pkg, trace):
    s = pkg.s.SchedulerServer(virtual_launcher(pkg), policy="pull")
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=4))
    g = diamond_graph(pkg, parts=8)
    s.submit_job(g)
    tasks = s.poll_work("e1", 1)
    assert len(tasks) == 1
    assert s.poll_work("e1", 0) == []
    tasks2 = s.poll_work("e1", 3)
    assert len(tasks2) == 1
    trace.append([task_of(t) for t in tasks + tasks2])


def _poll_from_unknown_or_dead_executor(pkg, trace):
    s = pkg.s.SchedulerServer(virtual_launcher(pkg), policy="pull")
    s.submit_job(diamond_graph(pkg))
    assert s.poll_work("ghost", 4) == []
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=4))
    s.executor_lost("e1")
    assert s.poll_work("e1", 4) == []
    trace.append(s.job_status("job1"))


def _poll_statuses_drive_stage_resolution(pkg, trace):
    s = pkg.s.SchedulerServer(virtual_launcher(pkg), policy="pull")
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=16))
    g = diamond_graph(pkg)
    s.submit_job(g)
    tasks = s.poll_work("e1", 16)
    assert {t.stage_id for t in tasks} == {0, 1}
    tasks2 = s.poll_work("e1", 16, [ok(pkg, t) for t in tasks])
    assert {t.stage_id for t in tasks2} == {2}
    trace.append([task_of(t) for t in tasks + tasks2])


def _pull_retry_on_failure(pkg, trace):
    failed_once = []

    def flaky(task):
        if task.stage_id == 2 and not failed_once:
            failed_once.append(task)
            return fail(pkg, task)
        return ok(pkg, task)

    launcher = virtual_launcher(pkg, flaky)
    s = pkg.s.SchedulerServer(launcher, policy="pull")
    ex = pkg.s.PollLoopExecutor(s, launcher,
                                pkg.s.ExecutorMetadata("e1", task_slots=4))
    g = diamond_graph(pkg)
    s.submit_job(g)
    ex.run_until_drained()
    launched(trace, launcher)
    trace.append(g.status())
    assert g.state is pkg.g.JobState.SUCCESSFUL
    assert len(failed_once) == 1


def _two_pull_executors_share_work(pkg, trace):
    launcher = virtual_launcher(pkg)
    s = pkg.s.SchedulerServer(launcher, policy="pull")
    e1 = pkg.s.PollLoopExecutor(s, launcher,
                                pkg.s.ExecutorMetadata("e1", task_slots=1))
    e2 = pkg.s.PollLoopExecutor(s, launcher,
                                pkg.s.ExecutorMetadata("e2", task_slots=1))
    g = diamond_graph(pkg, parts=8)
    s.submit_job(g)
    for _ in range(200):
        n = e1.poll_once() + e2.poll_once()
        if n == 0 and not s.has_pending_work():
            break
    launched(trace, launcher)
    assert g.state is pkg.g.JobState.SUCCESSFUL
    assert {t.executor_id for t in launcher.launched} == {"e1", "e2"}


class TestPullScheduling:
    @pytest.mark.parametrize("script", [
        _poll_loop_completes_job, _poll_claims_at_most_free_slots,
        _poll_from_unknown_or_dead_executor,
        _poll_statuses_drive_stage_resolution, _pull_retry_on_failure,
        _two_pull_executors_share_work], ids=lambda f: f.__name__.strip("_"))
    def test_script(self, script):
        same_trace(script)


# -- circuit breaker ----------------------------------------------------------

def _trip_stage_preempts(pkg, trace):
    g = diamond_graph(pkg, parts=4)
    t = pop(pkg, g, trace, "e1", max_partitions=1)
    update(g, trace, [ok(pkg, t)])
    events = g.trip_stage(0)
    trace.append(("trip", [e.value for e in events], g.status()))
    assert g.stages[0].state is pkg.g.StageState.SUCCESSFUL
    assert pkg.g.JobEvent.STAGE_COMPLETED in events
    markers = [ti.executor_id for ti in g.stages[0].task_infos]
    assert markers.count("<circuit-breaker>") == 3
    drain(pkg, g, trace)
    assert g.state is pkg.g.JobState.SUCCESSFUL


def _controller_aggregates_and_trips(pkg, trace):
    cb = pkg.s.CircuitBreakerController()
    assert cb.update([("j1", "s", 2, 0, 0, 0.4),
                      ("j1", "s", 2, 0, 1, 0.3)]) == []
    assert not cb.is_tripped("j1", "s")
    trips = cb.update([("j1", "s", 2, 0, 0, 0.7)])
    trace.append(trips)
    assert trips == [("j1", "s", 2, 0)]
    assert cb.is_tripped("j1", "s")
    assert cb.update([("j1", "s", 2, 0, 2, 0.9)]) == []
    cb.clean_job("j1")
    assert not cb.is_tripped("j1", "s")


def _scheduler_update_trips_running_stage(pkg, trace):
    launcher = virtual_launcher(pkg, report_back=False)
    s = pkg.s.SchedulerServer(launcher)
    s.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=2))
    g = diamond_graph(pkg, parts=4)
    s.submit_job(g)
    s.run_until_idle()
    trips = s.send_circuit_breaker_update([(g.job_id, "lim", 0, 0, 0, 1.0)])
    launched(trace, launcher)
    trace.append((trips, g.status()))
    assert trips
    assert g.stages[0].state is pkg.g.StageState.SUCCESSFUL


class TestCircuitBreaker:
    @pytest.mark.parametrize("script", [
        _trip_stage_preempts, _controller_aggregates_and_trips,
        _scheduler_update_trips_running_stage],
        ids=lambda f: f.__name__.strip("_"))
    def test_script(self, script):
        same_trace(script)


# -- job store: persistence and takeover -------------------------------------

def _graph_round_trip(pkg, trace):
    g = diamond_graph(pkg)
    while True:
        t = pop(pkg, g, trace, "e1", max_partitions=2)
        if t is None or t.stage_id != 0:
            break
        update(g, trace, [ok(pkg, t)])
    pop(pkg, g, trace, "e1", max_partitions=1)
    d = g.to_dict()
    g2 = pkg.g.ExecutionGraph.from_dict(d)
    trace.append(("restored", g2.status(), g2._next_task_id))
    assert g2.status() == g.status()
    assert g2._next_task_id == g._next_task_id
    assert g2.stages[0].state is pkg.g.StageState.SUCCESSFUL
    assert g2.stages[0].output_locations == g.stages[0].output_locations


def _file_store_recovery_resumes_job(pkg, trace, root):
    store = pkg.js.FileJobStore(str(root))
    s1 = pkg.s.SchedulerServer(virtual_launcher(pkg, report_back=False),
                               job_store=store)
    s1.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=8))
    g = diamond_graph(pkg, "jobr")
    s1.submit_job(g)
    s1.run_until_idle()
    assert g.state is pkg.g.JobState.RUNNING
    assert store.get_job("jobr") is not None
    launcher = virtual_launcher(pkg)
    s2 = pkg.s.SchedulerServer(launcher, job_store=store)
    s2.register_executor(pkg.s.ExecutorMetadata("e2", task_slots=8))
    recovered = s2.recover_jobs()
    assert recovered == ["jobr"]
    s2.run_until_idle()
    launched(trace, launcher)
    g2 = s2.task_manager.jobs["jobr"]
    trace.append(g2.status())
    assert g2.state is pkg.g.JobState.SUCCESSFUL
    assert pkg.g.ExecutionGraph.from_dict(
        store.get_job("jobr")["graph"]).state is pkg.g.JobState.SUCCESSFUL


def _terminal_jobs_not_recovered(pkg, trace, root):
    store = pkg.js.FileJobStore(str(root))
    s1 = pkg.s.SchedulerServer(virtual_launcher(pkg), job_store=store)
    s1.register_executor(pkg.s.ExecutorMetadata("e1", task_slots=8))
    s1.submit_job(diamond_graph(pkg, "done1"))
    s1.run_until_idle()
    s2 = pkg.s.SchedulerServer(virtual_launcher(pkg), job_store=store)
    recovered = s2.recover_jobs()
    trace.append(("recovered", recovered))
    assert recovered == []


class TestJobStorePersistence:
    def test_graph_round_trip(self):
        same_trace(_graph_round_trip)

    @pytest.mark.parametrize("script", [_file_store_recovery_resumes_job,
                                        _terminal_jobs_not_recovered],
                             ids=lambda f: f.__name__.strip("_"))
    def test_file_store(self, script, tmp_path):
        counter = iter(range(2))
        same_trace(lambda pkg, trace: script(
            pkg, trace, tmp_path / f"store{next(counter)}"))

    def test_wire_version_guard(self, tmp_path):
        """A persisted graph from another wire version is refused, in both
        packages alike."""
        from ballista_tpu.serde.plans import WIRE_VERSION as j_wire
        from ballista_tpu_torch.serde.plans import (WIRE_VERSION,
                                                    WireVersionError)
        assert WIRE_VERSION == j_wire
        store = t_store.FileJobStore(str(tmp_path))
        s = t_server.SchedulerServer(virtual_launcher(PKGS["port"],
                                                      report_back=False),
                                     job_store=store)
        s.register_executor(t_server.ExecutorMetadata("e1", task_slots=2))
        s.submit_job(diamond_graph(PKGS["port"], "jobw"))
        s.run_until_idle()
        doc = store.get_job("jobw")
        doc["@wire"] = WIRE_VERSION + 1
        with pytest.raises(WireVersionError):
            t_store.check_wire_version(doc, "persisted job jobw")
