"""Standalone cluster: the scheduler's control plane driving the
partitioned runtime in one process (port of
ballista_tpu/scheduler/standalone.py).

Reference parity: `standalone.rs:42` (in-process scheduler and executor,
used by `BallistaContext::standalone`), single controller: the executor is
a TaskLauncher that runs each stage as one task over every partition of
the mesh. Jobs go through the real control plane (the SchedulerServer
event loop, the ExecutionGraph state machine, slots, retries), so failures
and retries behave as in distributed operation while the data stays on
the devices. With a `work_dir` every stage output is spilled
(`scheduler/spill.py`) and restored when the copy in memory is gone; an
output found in no tier raises a fetch failure, and the graph rolls back
and runs its producer again.

`JobContext` is also the executor process's stage loop
(`scheduler/executor_process.py`): there an input another process
produced comes from the spill store or its producer's data endpoint, and
an overflow fails the task so the scheduler escalates the job for every
executor alike (`escalate=False`).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from .distributed_planner import DistOptions, DistributedPlan, DistributedPlanner
from .execution_graph import (ExecutionGraph, JobState, TaskDescription,
                              TaskStatus)
from .runtime import (CapacityOverflowError, DistributedRuntime,
                      escalate_overflow_opts, grow_capacities)
from .server import ExecutorMetadata, SchedulerServer, TaskLauncher, random_job_id

log = logging.getLogger("ballista_tpu_torch.standalone")

# the attempts a job makes (its first planning and every escalation after
# an overflow) before the overflow fails it: one budget for the in-process
# paths (JobContext) and the wire (rpc.py _escalate_on_overflow)
MAX_ATTEMPTS = 4


class MeshTaskLauncher(TaskLauncher):
    """Runs stage tasks on the partitioned runtime and reports TaskStatus
    back.

    A task covers all partitions of one stage. Stage outputs are kept per
    job for the stages that read them; a quota overflow re-plans the job
    with more headroom and retries in place (the fetch-failure rollback of
    fixed-quota exchanges)."""

    def __init__(self, runtime: DistributedRuntime):
        self.runtime = runtime
        self.jobs: Dict[str, "JobContext"] = {}
        self.scheduler = None   # set by StandaloneCluster for CB updates

    def _circuit_breaker_update(self, jc, stage_id: int):
        """CircuitBreakerClient analog (circuit_breaker/client.rs:65): when
        a stage carries a global row limit, stream each partition's share
        of the limit consumed to the scheduler's controller."""
        if self.scheduler is None:
            return
        from ..exec.plan import LimitExec
        stage = jc.stage_by_id[stage_id]
        node, limit = stage.root, None
        while node is not None:
            if isinstance(node, LimitExec):
                limit = node.n
                break
            node = node.children[0] if node.children else None
        if not limit:
            return
        out = jc.outputs.get(str(stage_id))
        if out is None:
            return
        rows = out.num_rows.cpu().numpy()
        self.scheduler.send_circuit_breaker_update(
            [(jc.job_id, "global-limit", stage_id, 0, p,
              float(rows[p]) / limit) for p in range(len(rows))])

    def launch(self, tasks: List[TaskDescription], report):
        statuses = []
        for task in tasks:
            jc = self.jobs[task.job_id]
            try:
                jc.run_stage(task.stage_id)
                self._circuit_breaker_update(jc, task.stage_id)
                statuses.append(TaskStatus(
                    task.task_id, task.job_id, task.stage_id, task.partitions,
                    task.executor_id, "successful"))
            except Exception as e:  # noqa: BLE001 - feed the retry machinery
                from ..errors import classify
                err = classify(e)
                log.warning("stage %s/%s failed (%s): %s", task.job_id,
                            task.stage_id, err.kind, e)
                statuses.append(TaskStatus(
                    task.task_id, task.job_id, task.stage_id, task.partitions,
                    task.executor_id, "failed", str(err),
                    error_kind=err.kind))
        report(statuses)


class JobContext:
    """One job's plans and stage outputs: the partitioned runtime's stage
    loop, driven stage by stage by the scheduler (`MeshTaskLauncher`, an
    executor process) or in order by `run` (`runtime.execute_distributed`).
    `op_metrics` holds each finished stage's output rows per operator,
    `stage_metrics` its StageMetrics, and `attempts` the options of the
    first planning and of every retry; the job makes at most
    `max_attempts`. The options are the job's own (`planner.opts`): an
    escalation leaves the cluster's and other jobs' as they were (the
    reference sets them on the shared runtime, for every later job).

    Each stage's counts are read when it is done, so before a stage that
    reads a finished one the plan is lowered again with the rows that
    stage sent (`DistributedRuntime.relower`; its stages stay those of the
    first lowering) and a stage's output is kept cut to that capacity
    (`DistributedRuntime.trim`).

    A stage input is read from three tiers, as the reference's shuffle
    reader does (shuffle_reader.rs:395-537): the outputs in memory, then
    `spiller.restore`, then `peer_fetch(job_id, stage_id, mesh)` (the
    producing executor's data endpoint); a miss in all three raises a
    fetch failure. A restored output's capacity is the rows its stage sent,
    so it is recorded as observed before the plan is lowered again: an
    executor that never ran the producer lowers the plan as the one that
    did. With `escalate=False` an overflow raises its error (with the
    shuffle-write stats) instead of re-planning here."""

    def __init__(self, job_id: str, runtime: DistributedRuntime, ctx,
                 logical_plan, planner: DistributedPlanner,
                 max_attempts: int = MAX_ATTEMPTS, spiller=None,
                 peer_fetch=None, escalate: bool = True):
        self.job_id = job_id
        self.runtime = runtime
        self.ctx = ctx
        self.logical_plan = logical_plan
        self.max_attempts = max_attempts
        self.outputs: Dict[str, object] = {}
        self.op_metrics: Dict[int, dict] = {}
        self.stage_metrics: Dict[int, object] = {}
        self.attempts: List[DistOptions] = [planner.opts]
        self.spiller = spiller
        self.peer_fetch = peer_fetch
        self.escalate = escalate
        # guards `outputs`: an executor's data endpoint reads them from
        # another thread
        self.lock = threading.Lock()
        # bytes written by spill, and stage inputs read per tier
        self.spilled_bytes = 0
        self.reads = {"spill": 0, "peer": 0}
        # the first lowering with the job's options (its broadcast choices
        # are replayed) and the leaf capacity of each finished stage's
        # output
        self.planner = planner
        self.observed: Dict[int, int] = {}
        self._plan(planner.plan(logical_plan))

    def _plan(self, dplan: DistributedPlan):
        self.dplan = dplan
        self.stage_by_id = {s.stage_id: s for s in dplan.stages}

    def _fetch_input(self, stage_id: int) -> None:
        """Bring a missing stage output in from the spill store or a peer;
        a fetch failure names the producer when neither has it."""
        mesh = self.runtime.mesh
        pb = tier = None
        if self.spiller is not None:
            pb, tier = self.spiller.restore(self.job_id, stage_id, mesh), \
                "spill"
        if pb is None and self.peer_fetch is not None:
            pb, tier = self.peer_fetch(self.job_id, stage_id, mesh), "peer"
        if pb is None:
            # typed fetch failure: carries the producer stage id so the
            # graph can roll back precisely (error.rs:58 FetchFailed)
            from ..errors import fetch_failed
            raise fetch_failed("", stage_id, [],
                               f"stage {stage_id} outputs lost and no spill")
        self.reads[tier] += 1
        with self.lock:
            self.outputs[str(stage_id)] = pb
        self.observed[stage_id] = pb.capacity

    def run_stage(self, stage_id: int):
        """Run one stage over every partition; read its counts (one sync).
        On an overflow, re-plan the job with the escalated options (a quota
        overflow from its shuffle-write stats; an operator's with grown
        capacities), run every finished stage again on it (a salted join
        needs its build side replicated by the exchange that fed it) and
        retry the stage; an overflow on the job's last attempt, or any
        overflow with `escalate=False`, raises. (The reference's cluster
        allows each stage 3 attempts and runs again only the stages
        numbered below this one, so a finished stage numbered above it
        loses its output.)"""
        while True:
            stage = self.stage_by_id[stage_id]
            for src in stage.sources.values():
                if src.kind == "stage" and src.name not in self.outputs:
                    self._fetch_input(int(src.name))
            if self.runtime.stale(stage, self.observed):
                self._plan(self.runtime.relower(self.logical_plan,
                                                self.observed, self.planner))
                stage = self.stage_by_id[stage_id]
            t0 = time.perf_counter()
            run = self.runtime.run_stage(
                stage, self.runtime.stage_inputs(stage, self.outputs))
            counts = run.read()
            if not counts.overflow:
                self.observed[stage_id] = counts.leaf_capacity
                out = self.runtime.trim(run.out, counts.leaf_capacity)
                with self.lock:
                    self.outputs[str(stage_id)] = out
                if self.spiller is not None:
                    self.spilled_bytes += self.spiller.spill(
                        self.job_id, stage_id, out)
                m = self.runtime.stage_metrics(stage, counts,
                                               time.perf_counter() - t0)
                m.retries = len(self.attempts) - 1
                self.stage_metrics[stage_id] = m
                self.op_metrics[stage_id] = m.operator_rows
                return
            err = counts.error(stage_id)
            if not self.escalate or len(self.attempts) >= self.max_attempts:
                raise err
            opts = (grow_capacities(self.planner.opts, err.growth)
                    if isinstance(err, CapacityOverflowError)
                    else escalate_overflow_opts(self.planner.opts, err,
                                                len(self.attempts) - 1))
            self.attempts.append(opts)
            log.warning("job %s stage %d overflow (%s); re-planning with "
                        "headroom %.1f, join salt %d, max group table %d",
                        self.job_id, stage_id, err, opts.quota_headroom,
                        opts.join_salt, opts.max_group_table)
            # the new options, the first lowering's broadcast choices
            # replayed so the stages stay those of the ExecutionGraph
            finished = sorted(int(k) for k in self.outputs)
            self.planner = DistributedPlanner(self.ctx, opts,
                                              replay=self.planner,
                                              replay_quotas=False)
            self._plan(self.planner.plan(self.logical_plan))
            self.observed.clear()
            with self.lock:
                self.outputs.clear()
            if self.spiller is not None:
                # the old attempt's spills are of other capacities and
                # salts: the new attempt keys its own
                self.spiller = self.spiller.at_version(len(self.attempts) - 1)
            for dep in finished:
                self.run_stage(dep)

    def run(self):
        """Run every stage in order, without the scheduler; returns
        `final_batch()`."""
        for stage_id in range(len(self.dplan.stages)):
            self.run_stage(stage_id)
        return self.final_batch()

    def final_batch(self):
        from ..parallel.partitioned import gather_partitions
        return (gather_partitions(self.outputs[str(self.dplan.final_stage)],
                                  self.dplan.final_schema,
                                  mesh=self.runtime.mesh),
                self.dplan.final_schema)


class StandaloneCluster:
    """In-process scheduler and partitioned executor
    (BallistaContext::standalone). `policy` "push" has the scheduler
    launch tasks; "pull" has the executor claim them (PollWork). With a
    `work_dir` (an object-store URL) every stage output is spilled there
    and restored when the copy in memory is lost."""

    def __init__(self, ctx, mesh=None, options: Optional[DistOptions] = None,
                 task_slots: int = 4, work_dir: Optional[str] = None,
                 policy: str = "push"):
        from .server import PollLoopExecutor

        self.ctx = ctx
        self.runtime = DistributedRuntime(ctx, mesh, options)
        # (plan display, P) -> the options its last job ended with: a
        # repeated query starts from them
        self.converged: Dict[tuple, DistOptions] = {}
        self.launcher = MeshTaskLauncher(self.runtime)
        self.scheduler = SchedulerServer(self.launcher, policy=policy)
        self.launcher.scheduler = self.scheduler
        meta = ExecutorMetadata("mesh-executor-0", task_slots=task_slots)
        self.poll_executor = None
        if policy == "pull":
            # pull-staged: the executor claims work via PollWork instead of
            # the scheduler pushing LaunchTask (execution_loop.rs:56)
            self.poll_executor = PollLoopExecutor(
                self.scheduler, self.launcher, meta)
        else:
            self.scheduler.register_executor(meta)
        self.spiller = None
        if work_dir is not None:
            from .spill import StageSpiller
            self.spiller = StageSpiller(work_dir)

    def submit_sql(self, sql: str) -> str:
        df = self.ctx.sql(sql)
        return self.submit_plan(df.plan)

    def submit_plan(self, plan) -> str:
        from ..client.context import rebind_scans
        from ..planner.optimizer import prune_columns, reduce_group_keys

        plan = prune_columns(reduce_group_keys(rebind_scans(plan, self.ctx)))
        key = (plan.display(), len(self.runtime.mesh))
        planner = DistributedPlanner(
            self.ctx, self.converged.get(key, self.runtime.opts))
        job_id = random_job_id()
        jc = JobContext(job_id, self.runtime, self.ctx, plan, planner,
                        spiller=self.spiller)
        self.launcher.jobs[job_id] = jc
        graph = ExecutionGraph.from_distributed_plan(
            job_id, jc.dplan, self.runtime.opts.n_partitions)
        # planning warnings ride the job status (WarningCollector parity:
        # the reference propagates session warnings into JobStatus)
        graph.warnings = self.ctx.take_warnings()
        self.scheduler.submit_job(graph)
        return job_id

    def wait(self, job_id: str):
        """Pump the scheduler until the job reaches a terminal state, then
        return (Batch, Schema) (DistributedQueryExec's poll loop analog:
        single controller, nothing to poll). The job's stage outputs are
        dropped once the result is taken."""
        if self.poll_executor is not None:
            self.poll_executor.run_until_drained()
        self.scheduler.run_until_idle()
        g = self.scheduler.task_manager.jobs[job_id]
        if g.state is not JobState.SUCCESSFUL:
            raise RuntimeError(f"job {job_id} {g.state.value}: {g.error}")
        jc = self.launcher.jobs[job_id]
        self.converged[(jc.logical_plan.display(), len(self.runtime.mesh))] \
            = jc.planner.opts
        out = jc.final_batch()
        # the result is taken: the job's stage outputs leave the devices
        # (the reference keeps them until the cluster goes)
        jc.outputs.clear()
        return out

    def collect_sql(self, query: str):
        """Submit and wait: (Batch, Schema)."""
        return self.wait(self.submit_sql(query))

    def sql(self, query: str):
        """Submit and wait; returns a pandas DataFrame."""
        from .. import batch as B
        return B.to_pandas(*self.collect_sql(query))

    def job_status(self, job_id: str) -> dict:
        return self.scheduler.job_status(job_id)
