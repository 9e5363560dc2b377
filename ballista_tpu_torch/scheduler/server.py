"""Scheduler control plane: executor registry, task manager, event loop
(the port's copy of ballista_tpu/scheduler/server.py: host only).

Reference parity (SURVEY.md §2.2):
- ExecutorManager (`executor_manager.rs`): registration, task slots,
  heartbeats, dead-executor expiry (60s alive window / 180s timeout).
- TaskManager (`task_manager.rs`): active-job round-robin queue,
  fill_reservations -> pop_next_task per executor.
- QueryStageScheduler event loop (`query_stage_scheduler.rs`): JobQueued ->
  JobSubmitted -> Tick -> reserve slots -> launch -> TaskUpdating -> ...
- SchedulerServer (`scheduler_server/mod.rs`): submit_job, update_task_status,
  expire_dead_executors sweep.

The data plane is pluggable via TaskLauncher (the reference's TaskLauncher
trait, task_manager.rs:162): production uses the mesh runtime; tests use a
VirtualTaskLauncher that fabricates completions (test_utils.rs:357 analog).
"""

from __future__ import annotations

import collections
import dataclasses
import enum
import logging
import random
import string
import time
from typing import Callable, Dict, List, Optional, Tuple

from .execution_graph import (ExecutionGraph, JobEvent, JobState,
                              TaskDescription, TaskStatus)

log = logging.getLogger("ballista_tpu_torch.scheduler")

DEFAULT_EXECUTOR_TIMEOUT_S = 180.0   # executor_manager.rs:450
ALIVE_WINDOW_S = 60.0                # executor_manager.rs:427
TASKS_PER_TICK = 256                 # scheduler config tasks_per_tick


@dataclasses.dataclass
class ExecutorMetadata:
    executor_id: str
    host: str = "localhost"
    port: int = 0
    task_slots: int = 1
    # local mesh width (ExecutorSpecification parity): lets the scheduler
    # default a job's partition count to what its fleet can actually run
    devices: int = 0
    # shuffle-data endpoint (the reference's separate grpc_port vs
    # flight port, ExecutorMetadata in ballista.proto): peers fetch stage
    # outputs from here directly; 0 = no peer-serving endpoint (shared
    # object store only). Kept distinct from `port` so a pull-mode worker
    # can serve DATA without advertising itself as push-launchable.
    data_port: int = 0


class ExecutorStatus(enum.Enum):
    ACTIVE = "active"
    TERMINATING = "terminating"
    DEAD = "dead"


@dataclasses.dataclass
class ExecutorState:
    meta: ExecutorMetadata
    free_slots: int
    status: ExecutorStatus = ExecutorStatus.ACTIVE
    last_heartbeat: float = dataclasses.field(default_factory=time.time)
    # 1/5/15-min running-task load averages (executor/src/metrics/load.rs
    # parity: exponentially-decayed samples of the RUNNING_TASKS gauge)
    load_avg: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    _load_t: float = dataclasses.field(default_factory=time.time)

    def sample_load(self):
        """Decay the load averages toward the current used-slot count."""
        import math
        now = time.time()
        dt = max(now - self._load_t, 0.0)
        self._load_t = now
        used = float(self.meta.task_slots - self.free_slots)
        self.load_avg = tuple(
            la * math.exp(-dt / tau) + used * (1 - math.exp(-dt / tau))
            for la, tau in zip(self.load_avg, (60.0, 300.0, 900.0)))


class ExecutorManager:
    def __init__(self, timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S):
        self.executors: Dict[str, ExecutorState] = {}
        self.timeout_s = timeout_s
        self._dead: set = set()   # dead-executor cache (moka analog)

    def register(self, meta: ExecutorMetadata):
        # re-registration resurrects an expired id: a worker that missed
        # heartbeats (GC pause, scheduler restart) or restarts with a
        # fixed --executor-id must not stay permanently excluded
        # (the reference's moka dead-cache entries expire by TTL)
        self._dead.discard(meta.executor_id)
        self.executors[meta.executor_id] = ExecutorState(
            meta, free_slots=meta.task_slots)

    def heartbeat(self, executor_id: str):
        ex = self.executors.get(executor_id)
        if ex is not None:
            ex.last_heartbeat = time.time()
            ex.sample_load()

    def is_dead(self, executor_id: str) -> bool:
        return executor_id in self._dead

    def alive_executors(self) -> List[ExecutorState]:
        now = time.time()
        return [e for e in self.executors.values()
                if e.status is ExecutorStatus.ACTIVE
                and now - e.last_heartbeat < ALIVE_WINDOW_S]

    def expired_executors(self) -> List[str]:
        now = time.time()
        return [eid for eid, e in self.executors.items()
                if e.status is not ExecutorStatus.DEAD
                and now - e.last_heartbeat > self.timeout_s]

    def remove_executor(self, executor_id: str):
        ex = self.executors.pop(executor_id, None)
        if ex is not None:
            self._dead.add(executor_id)

    def reserve_slots(self, n: int, round_robin: bool = True,
                      push_capable_only: bool = False) -> List[str]:
        """Claim up to n slots across alive executors (TaskDistribution::
        RoundRobin, cluster/mod.rs:449; Bias = greedy fill).

        push_capable_only skips executors registered without a dialable
        endpoint (port 0): a push-mode scheduler must leave their work
        claimable via PollWork instead of synthesizing launch failures
        until the job exhausts its budget (mixed-policy deployments, e.g. default-flag executor_process under
        serve.py --policy push)."""
        out: List[str] = []
        pool = sorted(self.alive_executors(), key=lambda e: -e.free_slots)
        if push_capable_only:
            pool = [e for e in pool if e.meta.port]
        if not pool:
            return out
        if round_robin:
            i = 0
            while len(out) < n and any(e.free_slots > 0 for e in pool):
                e = pool[i % len(pool)]
                if e.free_slots > 0:
                    e.sample_load()
                    e.free_slots -= 1
                    out.append(e.meta.executor_id)
                i += 1
        else:
            for e in pool:
                while e.free_slots > 0 and len(out) < n:
                    e.sample_load()
                    e.free_slots -= 1
                    out.append(e.meta.executor_id)
        return out

    def cancel_reservations(self, executor_ids: List[str]):
        for eid in executor_ids:
            e = self.executors.get(eid)
            if e is not None:
                e.sample_load()
                e.free_slots = min(e.free_slots + 1, e.meta.task_slots)


class TaskLauncher:
    """Data-plane hook (TaskLauncher trait, task_manager.rs:162)."""

    #: True when launch() dials the executor's registered endpoint — the
    #: scheduler then only push-assigns slots on executors with a port and
    #: leaves the rest claimable via PollWork (mixed-policy deployments).
    requires_endpoint = False

    def launch(self, tasks: List[TaskDescription],
               report: Callable[[List[TaskStatus]], None]) -> None:
        raise NotImplementedError


class TaskManager:
    """Active jobs with round-robin fairness (ActiveJobQueue,
    task_manager.rs:60-133)."""

    def __init__(self, launcher: TaskLauncher):
        self.launcher = launcher
        self.jobs: Dict[str, ExecutionGraph] = {}
        self.queue: collections.deque = collections.deque()

    def submit(self, graph: ExecutionGraph):
        self.jobs[graph.job_id] = graph
        self.queue.append(graph.job_id)

    def fill_reservations(self, executor_ids: List[str],
                          widths: Optional[Dict[str, int]] = None
                          ) -> Tuple[List[TaskDescription], List[str]]:
        """Rotate through active jobs claiming tasks per reserved slot
        (task_manager.rs:585). Returns (tasks, unfilled_executor_ids).

        `widths` maps executor_id -> mesh device count: stage tasks are
        whole-mesh SPMD programs, so a job planned for N partitions can
        only run on an N-device executor — a heterogeneous fleet must not
        hand a task to a mismatched worker, where it would fail at
        ExecutorProcess._job_for and burn TASK_MAX_FAILURES.
        0/absent means any width (in-process mesh launchers always
        match)."""
        tasks: List[TaskDescription] = []
        unfilled: List[str] = []
        for eid in executor_ids:
            task = None
            want = (widths or {}).get(eid, 0)
            for _ in range(len(self.queue)):
                jid = self.queue[0]
                self.queue.rotate(-1)
                g = self.jobs.get(jid)
                if g is None or g.state is not JobState.RUNNING:
                    continue
                if want and g.stages:
                    jp = next(iter(g.stages.values())).n_partitions
                    if jp != want:
                        continue
                task = g.pop_next_task(eid)
                if task is not None:
                    break
            if task is None:
                unfilled.append(eid)
            else:
                tasks.append(task)
        return tasks, unfilled

    def prune_finished(self):
        done = [j for j, g in self.jobs.items()
                if g.state in (JobState.SUCCESSFUL, JobState.FAILED,
                               JobState.CANCELLED)]
        for j in done:
            try:
                self.queue.remove(j)
            except ValueError:
                pass


class CircuitBreakerController:
    """Scheduler-side circuit breaker (`circuit_breaker/controller.rs:15`):
    aggregates per-partition "percent of global row limit consumed" updates
    in a tree keyed (job, shared_state_id, stage, attempt); when the sum
    over partitions reaches 1.0 the key trips. Trips are sticky — late
    updates for a tripped key return it again so stragglers learn to stop
    (the reference's per-executor trip-notification state)."""

    def __init__(self):
        self._percents: Dict[tuple, Dict[int, float]] = {}
        self._tripped: set = set()

    def update(self, updates) -> List[tuple]:
        """updates: iterable of (job_id, shared_state_id, stage_id, attempt,
        partition, percent). Returns keys newly tripped by this batch."""
        trips = []
        for job_id, sid, stage_id, attempt, partition, pct in updates:
            key = (job_id, sid, stage_id, attempt)
            parts = self._percents.setdefault(key, {})
            parts[partition] = max(parts.get(partition, 0.0), float(pct))
            if key not in self._tripped and sum(parts.values()) >= 1.0:
                self._tripped.add(key)
                trips.append(key)
        return trips

    def is_tripped(self, job_id: str, shared_state_id: str) -> bool:
        return any(k[0] == job_id and k[1] == shared_state_id
                   for k in self._tripped)

    def clean_job(self, job_id: str):
        """Stale-state GC (circuit_breaker/client.rs:493 analog)."""
        for d in (self._percents, self._tripped):
            for k in [k for k in d if k[0] == job_id]:
                d.pop(k) if isinstance(d, dict) else d.discard(k)


class SchedulerEvent(enum.Enum):
    JOB_QUEUED = "job_queued"
    JOB_SUBMITTED = "job_submitted"
    TASK_UPDATING = "task_updating"
    TICK = "tick"
    EXECUTOR_LOST = "executor_lost"
    JOB_FINISHED = "job_finished"
    JOB_FAILED = "job_failed"


def random_job_id() -> str:
    """7-char alphanumeric job id (grpc.rs job id generation parity)."""
    return "".join(random.choices(string.ascii_lowercase + string.digits, k=7))


class SchedulerServer:
    """Single-controller scheduler: event-driven, deterministic-steppable
    (the event loop is pumped synchronously — tests drive it tick by tick
    like SchedulerTest, test_utils.rs:409)."""

    def __init__(self, launcher: TaskLauncher,
                 executor_timeout_s: float = DEFAULT_EXECUTOR_TIMEOUT_S,
                 job_store=None, metrics_collector=None,
                 policy: str = "push"):
        from .metrics import InMemoryMetricsCollector
        if policy not in ("push", "pull"):
            raise ValueError(f"unknown scheduling policy {policy!r}")
        # TaskSchedulingPolicy{PushStaged,PullStaged} (core/src/config.rs:298)
        self.policy = policy
        self.executor_manager = ExecutorManager(executor_timeout_s)
        self.task_manager = TaskManager(launcher)
        self.events: collections.deque = collections.deque()
        self.job_events: Dict[str, List[JobEvent]] = {}
        self._pending_statuses: List[TaskStatus] = []
        # optional persistent JobState store (job_store.py): graphs saved on
        # submit and on progress, enabling scheduler-restart takeover
        self.job_store = job_store
        self.circuit_breaker = CircuitBreakerController()
        # job-lifecycle + event-processing metrics (metrics/prometheus.rs)
        self.metrics = metrics_collector or InMemoryMetricsCollector()
        self._job_times: Dict[str, dict] = {}  # job_id -> queued/terminal ts

    # -- public API (SchedulerGrpc analog) --
    def register_executor(self, meta: ExecutorMetadata):
        self.executor_manager.register(meta)
        self.events.append((SchedulerEvent.TICK, None))

    def submit_job(self, graph: ExecutionGraph) -> str:
        now = time.time()
        queued_at = getattr(graph, "queued_at", now)
        self._job_times[graph.job_id] = {"queued": queued_at}
        self.metrics.record_submitted(graph.job_id, queued_at, now)
        self.task_manager.submit(graph)
        self.job_events.setdefault(graph.job_id, [])
        if self.job_store is not None:
            self.job_store.save_job(graph)
        self.events.append((SchedulerEvent.JOB_SUBMITTED, graph.job_id))
        self.events.append((SchedulerEvent.TICK, None))
        return graph.job_id

    def recover_jobs(self) -> List[str]:
        """Scheduler-restart takeover: reload non-terminal jobs from the
        store and resume them (the try_acquire_job hook the reference
        declares but never implements, kv.rs:697)."""
        from .job_store import recover_graphs
        if self.job_store is None:
            return []
        out = []
        for g in recover_graphs(self.job_store):
            self.task_manager.submit(g)
            self.job_events.setdefault(g.job_id, [])
            out.append(g.job_id)
        if out:
            self.events.append((SchedulerEvent.TICK, None))
        return out

    def update_task_status(self, executor_id: str,
                           statuses: List[TaskStatus]):
        """Drops updates from executors already marked dead
        (scheduler_server/mod.rs:228-240)."""
        if self.executor_manager.is_dead(executor_id):
            log.warning("dropping %d statuses from dead executor %s",
                        len(statuses), executor_id)
            return
        self._pending_statuses.extend(statuses)
        # freed slots return to the pool
        self.executor_manager.cancel_reservations(
            [s.executor_id for s in statuses])
        self.events.append((SchedulerEvent.TASK_UPDATING, None))
        self.events.append((SchedulerEvent.TICK, None))

    def poll_work(self, executor_id: str, num_free_slots: int,
                  statuses: Optional[List[TaskStatus]] = None
                  ) -> List[TaskDescription]:
        """Pull-staged scheduling RPC (SchedulerGrpc::poll_work,
        grpc.rs:82): the executor reports finished task statuses and its
        free slot count; the scheduler applies the statuses, then claims up
        to that many tasks for this executor from the round-robin job queue.
        Unknown/dead executors get nothing (the reference drops their
        statuses the same way, scheduler_server/mod.rs:228)."""
        em = self.executor_manager
        ex = em.executors.get(executor_id)
        if ex is None or em.is_dead(executor_id):
            return []
        em.heartbeat(executor_id)
        if ex.status is not ExecutorStatus.ACTIVE:
            # TERMINATING: keep accepting statuses, hand out no new work
            # (executor_server.rs launch_task rejects while TERMINATING)
            if statuses:
                self._pending_statuses.extend(statuses)
                self.events.append((SchedulerEvent.TASK_UPDATING, None))
                self.run_until_idle()
            return []
        if statuses:
            self._pending_statuses.extend(statuses)
            self.events.append((SchedulerEvent.TASK_UPDATING, None))
        self.run_until_idle()
        # the executor's report is the truth for its free slots (grpc.rs
        # poll_work fills reservations from num_free_slots, not server state)
        ex.free_slots = min(int(num_free_slots), ex.meta.task_slots)
        if ex.free_slots <= 0:
            return []
        tasks, _unfilled = self.task_manager.fill_reservations(
            [executor_id] * ex.free_slots,
            widths={executor_id: ex.meta.devices})
        ex.free_slots -= len(tasks)
        ex.sample_load()
        return tasks

    def send_circuit_breaker_update(self, updates) -> List[tuple]:
        """SendCircuitBreakerUpdate RPC analog (grpc.rs:559): feed the
        controller; newly tripped keys preempt their stage via
        ExecutionGraph.trip_stage. Returns the tripped keys so the sender
        (executor/launcher) can end its streams early."""
        trips = self.circuit_breaker.update(updates)
        for job_id, _sid, stage_id, _attempt in trips:
            g = self.task_manager.jobs.get(job_id)
            if g is not None:
                evs = g.trip_stage(stage_id)
                self.job_events.setdefault(job_id, []).extend(evs)
                if self.job_store is not None and evs:
                    self.job_store.save_job(g)
            self.events.append((SchedulerEvent.TICK, None))
        return trips

    def cancel_job(self, job_id: str) -> bool:
        """CancelJob RPC (grpc.rs:523): terminal-state a queued/running job.
        In-flight task statuses for the job are ignored on arrival (the
        graph drops updates once terminal) and their slots return through
        the normal status path."""
        g = self.task_manager.jobs.get(job_id)
        if g is None or g.state not in (JobState.QUEUED, JobState.RUNNING):
            return False
        g.state = JobState.CANCELLED
        g.error = "cancelled by user"
        if self.job_store is not None:
            self.job_store.save_job(g)
        self.task_manager.prune_finished()
        self._sweep_terminal_jobs()
        return True

    def stop_executor(self, executor_id: str):
        """Graceful-stop half 1 (StopExecutor, executor_server.rs:1157):
        mark TERMINATING — it stops receiving tasks (alive_executors
        filters ACTIVE) while in-flight tasks drain; the expiry sweep's
        timeout is the termination grace period."""
        ex = self.executor_manager.executors.get(executor_id)
        if ex is not None:
            ex.status = ExecutorStatus.TERMINATING

    def executor_stopped(self, executor_id: str):
        """Graceful-stop half 2 (ExecutorStopped RPC, grpc.rs:496): the
        executor finished draining — remove it; any stages still holding
        its outputs roll back via the executor-lost path."""
        self.executor_lost(executor_id)

    def executor_lost(self, executor_id: str):
        self.executor_manager.remove_executor(executor_id)
        self.events.append((SchedulerEvent.EXECUTOR_LOST, executor_id))
        self.events.append((SchedulerEvent.TICK, None))

    def expire_dead_executors(self):
        """Periodic sweep (scheduler_server/mod.rs:268)."""
        for eid in self.executor_manager.expired_executors():
            log.warning("executor %s expired", eid)
            self.executor_lost(eid)

    def job_status(self, job_id: str) -> dict:
        g = self.task_manager.jobs.get(job_id)
        return g.status() if g else {"state": "not_found"}

    # -- event pump --
    def run_until_idle(self, max_events: int = 100_000):
        n = 0
        while self.events and n < max_events:
            kind, payload = self.events.popleft()
            t0 = time.time()
            self._process(kind, payload)
            self.metrics.record_event(kind.value, time.time() - t0)
            n += 1
        self._sweep_terminal_jobs()

    def _sweep_terminal_jobs(self):
        """Record queued->terminal latency once per job reaching a terminal
        state (PrometheusMetricsCollector job histograms)."""
        now = time.time()
        for jid, times in self._job_times.items():
            if "terminal" in times:
                continue
            g = self.task_manager.jobs.get(jid)
            if g is None:
                continue
            if g.state is JobState.SUCCESSFUL:
                times["terminal"] = now
                self.metrics.record_completed(jid, times["queued"], now)
            elif g.state is JobState.FAILED:
                times["terminal"] = now
                self.metrics.record_failed(jid)
            elif g.state is JobState.CANCELLED:
                times["terminal"] = now
                self.metrics.record_cancelled(jid)

    def _process(self, kind: SchedulerEvent, payload):
        if kind is SchedulerEvent.TASK_UPDATING:
            statuses, self._pending_statuses = self._pending_statuses, []
            by_job: Dict[str, List[TaskStatus]] = {}
            for s in statuses:
                by_job.setdefault(s.job_id, []).append(s)
            for jid, sts in by_job.items():
                g = self.task_manager.jobs.get(jid)
                if g is None:
                    continue
                evs = g.update_task_status(sts)
                self.job_events[jid].extend(evs)
                if self.job_store is not None and evs:
                    self.job_store.save_job(g)
            self.task_manager.prune_finished()
        elif kind is SchedulerEvent.EXECUTOR_LOST:
            for g in self.task_manager.jobs.values():
                g.reset_stages_on_lost_executor(payload)
        elif kind is SchedulerEvent.TICK:
            if self.policy == "pull":
                return  # pull mode: executors claim tasks via poll_work
            pending = sum(g.available_tasks()
                          for g in self.task_manager.jobs.values()
                          if g.state is JobState.RUNNING)
            if pending == 0:
                return
            reserved = self.executor_manager.reserve_slots(
                min(pending, TASKS_PER_TICK),
                push_capable_only=self.task_manager.launcher.requires_endpoint)
            if not reserved:
                return
            tasks, unfilled = self.task_manager.fill_reservations(
                reserved, widths={
                    eid: e.meta.devices
                    for eid, e in self.executor_manager.executors.items()})
            self.executor_manager.cancel_reservations(unfilled)
            if tasks:
                self.task_manager.launcher.launch(
                    tasks, lambda sts: self._report(sts))
                self.events.append((SchedulerEvent.TICK, None))

    def _report(self, statuses: List[TaskStatus]):
        if statuses:
            self.update_task_status(statuses[0].executor_id, statuses)

    def has_pending_work(self) -> bool:
        return bool(self.events) or self.pending_task_count() > 0

    # -- KEDA autoscaler metric (scheduler_server/external_scaler.rs) --
    def pending_task_count(self) -> int:
        return sum(g.available_tasks() for g in self.task_manager.jobs.values()
                   if g.state is JobState.RUNNING)

    def is_active(self) -> bool:
        return any(g.state in (JobState.RUNNING, JobState.QUEUED)
                   for g in self.task_manager.jobs.values())


class PollLoopExecutor:
    """Pull-mode executor loop (executor/src/execution_loop.rs:56): each
    poll delivers the statuses of tasks finished since the last poll and
    claims up to free-slot-count new tasks, which run through the same
    TaskLauncher data plane as push mode. Slot permits are held for the
    task's duration (run_received_task:192); statuses queue for the next
    poll (the reference's std mpsc channel)."""

    def __init__(self, scheduler: SchedulerServer, launcher: TaskLauncher,
                 meta: ExecutorMetadata):
        self.scheduler = scheduler
        self.launcher = launcher
        self.meta = meta
        scheduler.register_executor(meta)
        self._finished: List[TaskStatus] = []
        self._running = 0

    def _report(self, statuses: List[TaskStatus]):
        self._finished.extend(statuses)
        self._running -= len(statuses)

    def poll_once(self) -> int:
        """One PollWork round-trip; returns tasks claimed + statuses sent."""
        free = self.meta.task_slots - self._running
        statuses, self._finished = self._finished, []
        tasks = self.scheduler.poll_work(
            self.meta.executor_id, free, statuses)
        self._running += len(tasks)
        if tasks:
            self.launcher.launch(tasks, self._report)
        return len(tasks) + len(statuses)

    def run_until_drained(self, max_polls: int = 100_000):
        """Poll until two consecutive empty polls with no scheduler work
        (the reference loop sleeps 100ms when idle; tests step instead)."""
        idle = 0
        for _ in range(max_polls):
            if self.poll_once() == 0:
                idle += 1
                if idle >= 2 and not self.scheduler.has_pending_work():
                    return
            else:
                idle = 0
