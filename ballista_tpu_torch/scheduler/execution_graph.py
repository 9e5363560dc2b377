"""ExecutionGraph: per-job DAG of stages with task scheduling & recovery
(the port's copy of ballista_tpu/scheduler/execution_graph.py: host only).

Reference parity: `ballista/scheduler/src/state/execution_graph.rs` (the
~2.9k-line heart of the scheduler) and `execution_stage.rs`'s state machine:

  UnResolved -> Resolved -> Running -> Successful
                   ^            |-> (task failure, <=4 retries) Running
                   |            |-> (fetch/input failure) roll back + re-run
                   |____________|    missing producer partitions
                                |-> (>=4 stage failures) Failed -> job Failed

A "task" is stage x partition-group handed to an executor
(`pop_next_task`, execution_graph.rs:1025); completions flow back through
`update_task_status` (:362) which resolves dependent stages and emits
scheduler events. Executor loss resets that executor's tasks
(`reset_stages_on_lost_executor`, :1130).

Single-controller adaptation: a partition is one shard of the mesh; one
task usually covers ALL partitions of a stage (the partitioned runtime
runs them together — the reference's multi-partition "task group" taken to its
limit), but the graph supports per-partition tasks for degraded/multi-host
operation.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

TASK_MAX_FAILURES = 4   # task_manager.rs:156
OVERFLOW_MAX_FAILURES = 10  # capacity-discovery rounds, not flakiness
STAGE_MAX_FAILURES = 4  # task_manager.rs:159


class StageState(enum.Enum):
    UNRESOLVED = "unresolved"
    RESOLVED = "resolved"
    RUNNING = "running"
    SUCCESSFUL = "successful"
    FAILED = "failed"


class JobState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SUCCESSFUL = "successful"
    FAILED = "failed"
    CANCELLED = "cancelled"


@dataclasses.dataclass
class TaskInfo:
    """Per-partition scheduling record (execution_stage.rs:271)."""
    task_id: int
    partition: int
    executor_id: str
    scheduled_at: float
    finished_at: Optional[float] = None
    status: str = "running"   # running | successful | failed


@dataclasses.dataclass
class TaskDescription:
    """A unit of work handed to an executor: one stage, N partitions
    (multi-partition task group, execution_graph.rs:1730)."""
    job_id: str
    stage_id: int
    partitions: Tuple[int, ...]
    task_id: int
    executor_id: str


@dataclasses.dataclass
class TaskStatus:
    task_id: int
    job_id: str
    stage_id: int
    partitions: Tuple[int, ...]
    executor_id: str
    state: str                      # successful | failed | fetch_failed
    error: Optional[str] = None
    # fetch_failed: which producer stage's outputs were lost
    failed_input_stage: Optional[int] = None
    # classified failure cause (errors.BallistaError.kind): a
    # non-retryable kind fails the job immediately instead of burning
    # TASK_MAX_FAILURES retries (the reference's ExecutionError-vs-
    # retryable split, execution_graph.rs:540-580); None keeps the
    # plain bounded-retry behavior
    error_kind: Optional[str] = None
    # shuffle_overflow only: per-exchange shuffle-write stats
    # [{"quota", "salt_kind", "counts": [[...]]}] — the PartitionStats
    # that ride TaskStatus in the reference (serde/scheduler/mod.rs:33);
    # lets a remote scheduler size the retry instead of blind escalation
    stats: Optional[list] = None
    # successful tasks: executor-collected per-operator metrics
    # ({"operator_rows": {label: rows}, "run_s": float}) — the
    # OperatorMetricsSet that rides TaskStatus in the reference
    # (proto:286-319) and is merged on the scheduler for the REST
    # /api/job/{id}/stages view (api/handlers.rs:198)
    metrics: Optional[dict] = None


@dataclasses.dataclass
class GraphStage:
    stage_id: int
    n_partitions: int
    inputs: Tuple[int, ...]                  # producer stage ids
    state: StageState = StageState.UNRESOLVED
    task_infos: List[Optional[TaskInfo]] = dataclasses.field(default_factory=list)
    completed_inputs: Set[int] = dataclasses.field(default_factory=set)
    failure_count: int = 0
    task_failures: int = 0
    # partition -> executor that produced it (for loss tracking)
    output_locations: Dict[int, str] = dataclasses.field(default_factory=dict)
    # executor-shipped per-operator metrics, merged across this stage's
    # tasks (update_task_metrics parity, state/execution_stage.rs)
    metrics: Dict = dataclasses.field(default_factory=dict)

    def reset_tasks(self):
        self.task_infos = [None] * self.n_partitions
        self.output_locations = {}

    @property
    def successful_partitions(self) -> int:
        return sum(1 for t in self.task_infos
                   if t is not None and t.status == "successful")

    @property
    def all_successful(self) -> bool:
        return self.successful_partitions == self.n_partitions


class JobEvent(enum.Enum):
    JOB_FINISHED = "job_finished"
    JOB_FAILED = "job_failed"
    JOB_UPDATED = "job_updated"
    STAGE_COMPLETED = "stage_completed"
    CANCEL_TASKS = "cancel_tasks"


class ExecutionGraph:
    """Tracks one job's stage DAG through scheduling and recovery."""

    def __init__(self, job_id: str, stage_specs: Sequence[Tuple[int, int, Sequence[int]]]):
        """stage_specs: (stage_id, n_partitions, input_stage_ids)."""
        self.job_id = job_id
        self.stages: Dict[int, GraphStage] = {}
        for sid, nparts, inputs in stage_specs:
            st = GraphStage(sid, nparts, tuple(inputs))
            st.reset_tasks()
            self.stages[sid] = st
        self.state = JobState.QUEUED
        self._next_task_id = 0
        self.error: Optional[str] = None
        self._revive()

    # -- helpers --
    @classmethod
    def from_distributed_plan(cls, job_id: str, dplan, n_partitions: int):
        specs = []
        for stage in dplan.stages:
            inputs = [int(s.name) for s in stage.sources.values()
                      if s.kind == "stage"]
            specs.append((stage.stage_id, n_partitions, inputs))
        return cls(job_id, specs)

    def _revive(self) -> bool:
        """UnResolved -> Resolved when every input stage is successful;
        Resolved -> Running (revive, execution_graph.rs:334)."""
        changed = False
        for st in self.stages.values():
            if st.state is StageState.UNRESOLVED and all(
                    self.stages[i].state is StageState.SUCCESSFUL
                    for i in st.inputs):
                st.state = StageState.RESOLVED
                changed = True
            if st.state is StageState.RESOLVED:
                st.state = StageState.RUNNING
                changed = True
        if changed and self.state is JobState.QUEUED:
            self.state = JobState.RUNNING
        return changed

    # -- scheduling --
    def available_tasks(self) -> int:
        return sum(
            sum(1 for t in st.task_infos if t is None)
            for st in self.stages.values() if st.state is StageState.RUNNING)

    def pop_next_task(self, executor_id: str,
                      max_partitions: int = 1 << 30) -> Optional[TaskDescription]:
        """Claim up to max_partitions unscheduled partitions of ONE running
        stage as a single multi-partition task (execution_graph.rs:1025)."""
        for st in sorted(self.stages.values(), key=lambda s: s.stage_id):
            if st.state is not StageState.RUNNING:
                continue
            free = [i for i, t in enumerate(st.task_infos) if t is None]
            if not free:
                continue
            claim = tuple(free[:max_partitions])
            tid = self._next_task_id
            self._next_task_id += 1
            now = time.time()
            for p in claim:
                st.task_infos[p] = TaskInfo(tid, p, executor_id, now)
            return TaskDescription(self.job_id, st.stage_id, claim, tid,
                                   executor_id)
        return None

    # -- status application (execution_graph.rs:362 update_task_status) --
    def update_task_status(self, statuses: Sequence[TaskStatus]) -> List[JobEvent]:
        events: List[JobEvent] = []
        for s in statuses:
            st = self.stages.get(s.stage_id)
            if st is None or self.state in (JobState.FAILED, JobState.CANCELLED):
                continue
            if st.state is not StageState.RUNNING:
                # delayed update racing a rollback (execution_graph.rs:652):
                # ignore successes; still count fetch failures below
                if s.state != "fetch_failed":
                    continue
            if s.state == "successful":
                now = time.time()
                for p in s.partitions:
                    ti = st.task_infos[p]
                    if ti is not None and ti.task_id == s.task_id:
                        ti.status = "successful"
                        ti.finished_at = now
                        st.output_locations[p] = s.executor_id
                if s.metrics:
                    # merge executor-collected metrics: run_s takes the
                    # stage wall max; counts sum across tasks (disjoint
                    # partitions) and attempts, per key where they are a
                    # dict (operator rows, kernel launches) (proto:286-319
                    # OperatorMetricsSet merge on the scheduler)
                    st.metrics.setdefault("operator_rows", {})
                    for key, v in s.metrics.items():
                        if key == "run_s":
                            st.metrics["run_s"] = round(max(
                                st.metrics.get("run_s", 0.0), float(v)), 4)
                        elif isinstance(v, dict):
                            merged = st.metrics.setdefault(key, {})
                            for k, n in v.items():
                                merged[k] = merged.get(k, 0) + int(n)
                        elif isinstance(v, int):
                            st.metrics[key] = st.metrics.get(key, 0) + v
                    st.metrics.setdefault("executors", [])
                    if s.executor_id not in st.metrics["executors"]:
                        st.metrics["executors"].append(s.executor_id)
                if st.all_successful:
                    st.state = StageState.SUCCESSFUL
                    events.append(JobEvent.STAGE_COMPLETED)
                    for consumer in self.stages.values():
                        if st.stage_id in consumer.inputs:
                            consumer.completed_inputs.add(st.stage_id)
            elif s.state == "fetch_failed":
                # consumer stage couldn't read producer outputs: roll back
                # consumer, re-run producer's lost partitions
                # (execution_graph.rs:430-520)
                events.extend(self._handle_fetch_failure(s))
            else:  # plain task failure: retryable up to TASK_MAX_FAILURES
                if s.error_kind is not None:
                    from ..errors import BallistaError
                    if s.error_kind in BallistaError.PERMANENT:
                        # permanent failure (planning/not_implemented/
                        # resource_exhausted...): retrying is wasted work
                        self.state = JobState.FAILED
                        self.error = (f"stage {st.stage_id} failed "
                                      f"permanently ({s.error_kind}): "
                                      f"{s.error}")
                        events.append(JobEvent.JOB_FAILED)
                        continue
                # shuffle-overflow failures are planned capacity-discovery
                # rounds (the scheduler escalates the job spec after each,
                # rpc.py _escalate_on_overflow), not flakiness: they get
                # their own larger budget instead of burning the flaky-task
                # allowance. The /P^2 cell quota sizing starts small by
                # design and may need several escalations on skewed data.
                limit = (OVERFLOW_MAX_FAILURES
                         if s.error_kind == "shuffle_overflow"
                         else TASK_MAX_FAILURES)
                st.task_failures += 1
                if st.task_failures > limit:
                    self.state = JobState.FAILED
                    self.error = (f"stage {st.stage_id} exceeded "
                                  f"{limit} task failures: {s.error}")
                    events.append(JobEvent.JOB_FAILED)
                    continue
                for p in s.partitions:
                    ti = st.task_infos[p]
                    if ti is not None and ti.task_id == s.task_id:
                        st.task_infos[p] = None  # reschedule
        self._revive()
        if self._finished():
            self.state = JobState.SUCCESSFUL
            events.append(JobEvent.JOB_FINISHED)
        elif events:
            events.append(JobEvent.JOB_UPDATED)
        return events

    def _handle_fetch_failure(self, s: TaskStatus) -> List[JobEvent]:
        consumer = self.stages[s.stage_id]
        producer_id = s.failed_input_stage
        events: List[JobEvent] = []
        consumer.failure_count += 1
        if consumer.failure_count > STAGE_MAX_FAILURES:
            self.state = JobState.FAILED
            self.error = (f"stage {consumer.stage_id} exceeded "
                          f"{STAGE_MAX_FAILURES} failures (fetch)")
            events.append(JobEvent.JOB_FAILED)
            return events
        # roll back the consumer entirely
        consumer.state = StageState.UNRESOLVED
        consumer.reset_tasks()
        consumer.completed_inputs.discard(producer_id)
        events.append(JobEvent.CANCEL_TASKS)
        # re-run lost partitions of the producer
        if producer_id is not None:
            producer = self.stages[producer_id]
            bad_exec = s.executor_id if s.error == "executor_lost" else None
            lost = [p for p, e in producer.output_locations.items()
                    if bad_exec is None or e == bad_exec]
            producer.state = StageState.RUNNING
            for p in (lost or range(producer.n_partitions)):
                producer.task_infos[p] = None
                producer.output_locations.pop(p, None)
        return events

    def reset_stages_on_lost_executor(self, executor_id: str) -> List[int]:
        """Reset running tasks + successful outputs on a dead executor
        (execution_graph.rs:1130). Returns affected stage ids."""
        affected = []
        for st in self.stages.values():
            hit = False
            if st.state in (StageState.RUNNING, StageState.SUCCESSFUL):
                for i, ti in enumerate(st.task_infos):
                    if ti is not None and ti.executor_id == executor_id:
                        st.task_infos[i] = None
                        st.output_locations.pop(i, None)
                        hit = True
            if hit:
                affected.append(st.stage_id)
                if st.state is StageState.SUCCESSFUL:
                    st.state = StageState.RUNNING
                    # consumers depending on it must roll back if unresolved
                    for consumer in self.stages.values():
                        if st.stage_id in consumer.inputs and \
                                consumer.state in (StageState.RUNNING,
                                                   StageState.RESOLVED):
                            consumer.state = StageState.UNRESOLVED
                            consumer.reset_tasks()
                            consumer.completed_inputs.discard(st.stage_id)
        self._revive()
        return affected

    def trip_stage(self, stage_id: int) -> List[JobEvent]:
        """Circuit-breaker preemption (execution_graph.rs:1510): synthesize
        successful completions for all unscheduled/running partitions of a
        stage — used when a global row limit is already satisfied and the
        remaining work is unnecessary."""
        st = self.stages.get(stage_id)
        events: List[JobEvent] = []
        if st is None or st.state is not StageState.RUNNING:
            return events
        now = time.time()
        for p in range(st.n_partitions):
            ti = st.task_infos[p]
            if ti is None:
                tid = self._next_task_id
                self._next_task_id += 1
                st.task_infos[p] = TaskInfo(tid, p, "<circuit-breaker>", now,
                                            now, "successful")
            elif ti.status == "running":
                ti.status = "successful"
                ti.finished_at = now
        if st.all_successful:
            st.state = StageState.SUCCESSFUL
            events.append(JobEvent.STAGE_COMPLETED)
            events.append(JobEvent.CANCEL_TASKS)
            for consumer in self.stages.values():
                if stage_id in consumer.inputs:
                    consumer.completed_inputs.add(stage_id)
        self._revive()
        if self._finished():
            self.state = JobState.SUCCESSFUL
            events.append(JobEvent.JOB_FINISHED)
        return events

    def _finished(self) -> bool:
        return all(st.state is StageState.SUCCESSFUL
                   for st in self.stages.values())

    # -- persistence (encode/decode_execution_graph parity,
    #    execution_graph.rs:1327,1431) --
    def to_dict(self) -> dict:
        return {
            "job_id": self.job_id,
            "state": self.state.value,
            "error": self.error,
            "next_task_id": self._next_task_id,
            "stages": [
                {"stage_id": st.stage_id,
                 "n_partitions": st.n_partitions,
                 "inputs": list(st.inputs),
                 "state": st.state.value,
                 "failure_count": st.failure_count,
                 "task_failures": st.task_failures,
                 "completed_inputs": sorted(st.completed_inputs),
                 "output_locations": {str(p): e for p, e
                                      in st.output_locations.items()},
                 "task_infos": [
                     None if t is None else dataclasses.asdict(t)
                     for t in st.task_infos]}
                for st in self.stages.values()],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ExecutionGraph":
        g = cls.__new__(cls)
        g.job_id = d["job_id"]
        g.state = JobState(d["state"])
        g.error = d.get("error")
        g._next_task_id = d["next_task_id"]
        g.stages = {}
        for sd in d["stages"]:
            st = GraphStage(sd["stage_id"], sd["n_partitions"],
                            tuple(sd["inputs"]))
            st.state = StageState(sd["state"])
            st.failure_count = sd["failure_count"]
            st.task_failures = sd["task_failures"]
            st.completed_inputs = set(sd["completed_inputs"])
            st.output_locations = {int(p): e for p, e
                                   in sd["output_locations"].items()}
            st.task_infos = [None if t is None else TaskInfo(**t)
                             for t in sd["task_infos"]]
            g.stages[st.stage_id] = st
        return g

    def reset_in_flight(self):
        """Recovery hook: running tasks died with the old scheduler
        (running-stage state is memory-only in the reference,
        execution_stage.rs:178-182) — unschedule them so a recovering
        scheduler re-runs only incomplete work."""
        for st in self.stages.values():
            if st.state is StageState.RUNNING:
                for i, ti in enumerate(st.task_infos):
                    if ti is not None and ti.status == "running":
                        st.task_infos[i] = None
        self._revive()

    # -- introspection (REST /api/job/{id}/stages analog) --
    def status(self) -> dict:
        return {
            "job_id": self.job_id,
            "state": self.state.value,
            "error": self.error,
            # planning warnings (WarningCollector -> JobStatus parity)
            "warnings": list(getattr(self, "warnings", ())),
            "stages": {
                sid: {
                    "state": st.state.value,
                    "partitions": st.n_partitions,
                    "successful": st.successful_partitions,
                    "failures": st.failure_count,
                    # executor-shipped per-operator metrics (merged here;
                    # the reference's task_manager -> REST stages path)
                    "metrics": st.metrics or None,
                } for sid, st in self.stages.items()
            },
        }
