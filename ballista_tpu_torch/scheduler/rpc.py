"""Scheduler RPC service: the network control plane (port of
ballista_tpu/scheduler/rpc.py).

Reference parity: `SchedulerGrpc` (`scheduler/src/scheduler_server/grpc.rs`)
— RegisterExecutor, HeartBeatFromExecutor, PollWork, UpdateTaskStatus,
ExecuteQuery, GetJobStatus, CancelJob, StopExecutor, ExecutorStopped,
SendCircuitBreakerUpdate — exposed as JSON-over-HTTP verbs instead of
tonic/gRPC (the wire forms live in serde/tasks.py under the same @wire
version guard as plans).

Threading model: the SchedulerServer event pump is single-consumer by
design (SURVEY §5 race handling); one lock serializes the verb handlers,
making each RPC an atomic scheduler transition. `fetch_result` alone takes
the lock only to read the job's state: it may dial executors, and a dead
peer must not stall heartbeats and polls for its timeout.

The data plane between executors is the stage spill (scheduler/spill.py):
producers spill stage outputs into the job's work dir or their own, and
consumers restore them from there or fetch them from the producer's data
endpoint. When an executor reports an overflow, the scheduler escalates the
job's DistOptions and bumps the JobSpec version, so every executor derives
its stage plans anew and alike (the reference re-ships plan fragments per
task attempt; a versioned spec is the cheaper equivalent).

The scheduler does no device work: it plans on its own context (on
`device`, which only places that context) and its result egress decodes
onto the CPU. Nothing here needs pyarrow or pandas; `wait` converts to a
pandas frame inside the call.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np
import torch

from ..batch import Batch, Column, to_pandas
from ..errors import classify
from ..parallel.partitioned import PartitionedBatch, gather_partitions
from ..schema import Schema, TypeKind
from ..serde.plans import (_decode_schema, _encode_schema, decode_plan,
                           encode_plan)
from ..serde.tasks import (JobSpec, build_context, executor_meta_from_wire,
                           executor_meta_to_wire, jobspec_from_wire,
                           jobspec_to_wire, status_from_wire, status_to_wire,
                           task_from_wire, task_to_wire)
from .execution_graph import (ExecutionGraph, JobEvent, JobState,
                              StageState, TaskStatus)
from .executor_process import fetch_stage_blob
from .runtime import (ShuffleOverflowError, escalate_overflow_opts,
                      grow_capacities)
from .server import SchedulerServer, TaskLauncher, random_job_id
from .spill import StageSpiller, decode_stage, encode_stage
from .standalone import MAX_ATTEMPTS

log = logging.getLogger("ballista_tpu_torch.rpc")


class _NullLauncher(TaskLauncher):
    """Pull-mode scheduler never launches; executors claim via PollWork."""

    def launch(self, tasks, report):  # pragma: no cover - unused in pull
        raise AssertionError("pull-mode scheduler must not push tasks")


class HttpPushLauncher(TaskLauncher):
    """Push-staged launcher over the wire (ExecutorGrpc.LaunchTask,
    proto:1102; executor_server.rs:1118): batch task definitions per
    executor and POST them to its registered endpoint. Failed or rejected
    deliveries synthesize retryable 'io' task failures as the reference's
    failed-launch path does (state/mod.rs:255-320), so the scheduler
    re-plans onto surviving workers instead of wedging."""

    requires_endpoint = True

    def __init__(self, service: "SchedulerRpcService",
                 timeout_s: float = 10.0):
        self.service = service
        self.timeout_s = timeout_s

    def launch(self, tasks, report):
        groups: Dict[str, list] = {}
        for t in tasks:
            groups.setdefault(t.executor_id, []).append(t)
        for eid, ts in groups.items():
            ex = self.service.scheduler.executor_manager.executors.get(eid)
            wires = [self.service._task_wire(t) for t in ts]
            accepted = 0
            if ex is not None and ex.meta.port:
                try:
                    data = json.dumps({"tasks": wires}).encode()
                    r = urllib.request.Request(
                        f"http://{ex.meta.host}:{ex.meta.port}"
                        "/exec/launch_task", data=data,
                        headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(
                            r, timeout=self.timeout_s) as resp:
                        accepted = int(json.loads(resp.read())
                                       .get("accepted", 0))
                except Exception as e:  # noqa: BLE001 - worker down
                    log.warning("launch to %s failed: %s", eid, e)
            if accepted < len(ts):
                report([TaskStatus(t.task_id, t.job_id, t.stage_id,
                                   t.partitions, eid, "failed",
                                   f"launch to {eid} failed",
                                   error_kind="io")
                        for t in ts[accepted:]])


def _result_blob(blob: bytes, schema) -> tuple:
    """(one-partition stage blob, dictionaries) of a final stage's blob:
    its partitions' live rows gathered on the CPU, each string column's
    codes renumbered into the sorted distinct values its rows use (the
    egress ships those, not the table's whole dictionary; a RAW
    dictionary may hold a value under many codes, and the client gets a
    sorted dictionary either way)."""
    batch = gather_partitions(decode_stage(blob), schema)
    n = int(batch.num_rows)
    cols, dicts = [], {}
    for f, c in zip(schema.fields, batch.columns):
        data, valid = c.data[:n], c.validity[:n]
        if f.dtype.kind is TypeKind.STRING:
            codes, ok = data.numpy(), valid.numpy()
            used = np.unique(codes[ok])
            full = schema.dictionary(f.name)
            if full is None or not len(used):
                dicts[f.name] = []
                code = np.zeros(len(codes), dtype=np.int64)
            else:
                values, rank = np.unique(full[used].astype(str),
                                         return_inverse=True)
                dicts[f.name] = values.tolist()
                code = rank.reshape(-1)[np.searchsorted(used, codes).clip(
                    max=len(used) - 1)]
            data = torch.from_numpy(np.where(ok, code, 0).astype(np.int32))
        cols.append(Column(data, valid))
    out = PartitionedBatch((Batch(tuple(cols), batch.num_rows),))
    return encode_stage(out), dicts


class SchedulerRpcService:
    """Verb implementations over a SchedulerServer and the job specs.
    Policy 'pull' (default): executors claim tasks via PollWork; 'push':
    the scheduler POSTs LaunchTask batches to registered executor
    endpoints (TaskSchedulingPolicy::{PullStaged,PushStaged},
    config.rs:298). `device` places the planning contexts."""

    # verbs the HTTP layer runs without the service lock (they take it
    # themselves around the state they read)
    UNLOCKED = frozenset({"fetch_result"})
    # how long the result egress waits on one producer's data endpoint
    PEER_TIMEOUT_S = 60.0

    def __init__(self, work_dir: str, job_store=None,
                 executor_timeout_s: float = 180.0, policy: str = "pull",
                 device="cuda"):
        launcher = (_NullLauncher() if policy == "pull"
                    else HttpPushLauncher(self))
        self.scheduler = SchedulerServer(
            launcher, policy=policy, job_store=job_store,
            executor_timeout_s=executor_timeout_s)
        self.work_dir = work_dir
        self.device = device
        self.specs: Dict[str, JobSpec] = {}
        # each job's first stage plan (the REST API's dot renderings; its
        # final schema's string dictionaries decode the result)
        self.plans: Dict[str, object] = {}
        self.lock = threading.Lock()
        self._plan_ctx_cache = {}

    def _task_wire(self, t) -> dict:
        """A task on the wire with its job's spec version: an executor
        whose cached spec is older fetches the spec again."""
        w = task_to_wire(t)
        spec = self.specs.get(t.job_id)
        w["spec_version"] = spec.version if spec else 0
        return w

    # -- verbs (each called under self.lock by the HTTP layer) --
    def register_executor(self, req: dict) -> dict:
        meta = executor_meta_from_wire(req["metadata"])
        self.scheduler.register_executor(meta)
        log.info("executor %s registered (%d slots)", meta.executor_id,
                 meta.task_slots)
        return {"ok": True}

    def heartbeat(self, req: dict) -> dict:
        em = self.scheduler.executor_manager
        em.heartbeat(req["executor_id"])
        ex = em.executors.get(req["executor_id"])
        if ex is not None and "metrics" in req:
            # executor-reported gauges ride the heartbeat (the reference's
            # HeartBeatParams.metrics, executor_server.rs heartbeat task)
            ex.reported_metrics = req["metrics"]
        self.scheduler.expire_dead_executors()
        self.scheduler.run_until_idle()
        # `known: False` tells the worker to re-register (scheduler
        # restarted, or this id expired): without it a worker polls idle
        # forever after a single heartbeat lapse
        return {"ok": True,
                "known": ex is not None and not em.is_dead(
                    req["executor_id"])}

    def state(self, req: dict) -> dict:
        """Cluster-state snapshot (the REST /api/state surface for remote
        deployments): executors with load and reported metrics, jobs with
        their graph status."""
        em = self.scheduler.executor_manager
        now = time.time()
        executors = []
        for eid, ex in em.executors.items():
            executors.append({
                "executor_id": eid, "status": ex.status.value,
                "task_slots": ex.meta.task_slots,
                "devices": ex.meta.devices,
                "free_slots": ex.free_slots,
                "load_avg": list(ex.load_avg),
                "last_heartbeat_age_s": round(now - ex.last_heartbeat, 1),
                "metrics": getattr(ex, "reported_metrics", None)})
        jobs = {jid: g.status()
                for jid, g in self.scheduler.task_manager.jobs.items()}
        return {"executors": executors, "jobs": jobs,
                "pending_tasks": self.scheduler.pending_task_count()}

    def poll_work(self, req: dict) -> dict:
        statuses = [status_from_wire(s) for s in req.get("statuses", [])]
        self._escalate_on_overflow(statuses)
        em = self.scheduler.executor_manager
        eid = req["executor_id"]
        known = eid in em.executors and not em.is_dead(eid)
        tasks = self.scheduler.poll_work(
            eid, int(req.get("free_slots", 1)), statuses)
        return {"tasks": [self._task_wire(t) for t in tasks], "known": known}

    def update_task_status(self, req: dict) -> dict:
        statuses = [status_from_wire(s) for s in req.get("statuses", [])]
        self._escalate_on_overflow(statuses)
        self.scheduler.update_task_status(req["executor_id"], statuses)
        self.scheduler.run_until_idle()
        return {"ok": True}

    def _escalate_on_overflow(self, statuses) -> None:
        """Overflow coherence: escalate the job's options, bump its spec
        version and roll every stage of its graph back, so that every
        executor plans again with the new capacities (a salted join also
        needs its build side exchanged again). A quota overflow escalates
        from the shuffle-write stats the failing executor shipped in
        TaskStatus (the reference's PartitionStats, serde/scheduler/
        mod.rs:33-100), or blindly without them; an operator-capacity
        overflow (metrics {"overflow": "capacity"}) grows group tables and
        join outputs alone (`grow_capacities`). The reference knows the
        quota overflow only, and a job stuck on a group table retried with
        the same options.

        The job makes at most MAX_ATTEMPTS attempts, as in process
        (JobContext): an overflow of the last fails the job with its
        error. A status of a task the graph no longer runs (an attempt
        already rolled back) escalates nothing."""
        for s in statuses:
            if s.state != "failed" or s.error_kind != "shuffle_overflow":
                continue
            spec = self.specs.get(s.job_id)
            g = self.scheduler.task_manager.jobs.get(s.job_id)
            if spec is None or g is None or g.state is not JobState.RUNNING:
                continue
            st = g.stages.get(s.stage_id)
            if st is None or st.state is not StageState.RUNNING or not any(
                    ti is not None and ti.task_id == s.task_id
                    for ti in st.task_infos):
                continue
            if spec.version + 1 >= MAX_ATTEMPTS:
                g.state = JobState.FAILED
                g.error = (f"stage {s.stage_id} overflowed in each of "
                           f"{MAX_ATTEMPTS} attempts: {s.error}")
                self.scheduler.job_events.setdefault(s.job_id, []).append(
                    JobEvent.JOB_FAILED)
                if self.scheduler.job_store is not None:
                    self.scheduler.job_store.save_job(g)
                log.warning("job %s: %s", s.job_id, g.error)
                continue
            if (s.metrics or {}).get("overflow") == "capacity":
                spec.options = grow_capacities(
                    spec.options, (s.metrics or {}).get("growth", (4, 4)))
            else:
                carrier = ShuffleOverflowError("wire stats")
                carrier.stats = [
                    {"quota": st["quota"], "salt_kind": st["salt_kind"],
                     "counts": np.asarray(st["counts"], np.int64)}
                    for st in s.stats] if s.stats else None
                spec.options = escalate_overflow_opts(
                    spec.options, carrier, attempt=spec.version)
            spec.version += 1
            for stage in g.stages.values():
                stage.reset_tasks()
                stage.state = StageState.UNRESOLVED
                stage.completed_inputs.clear()
            g._revive()
            log.warning("job %s: overflow; spec v%d headroom %.1f, join "
                        "salt %d, max group table %d", s.job_id,
                        spec.version, spec.options.quota_headroom,
                        spec.options.join_salt,
                        spec.options.max_group_table)

    def submit_job(self, req: dict) -> dict:
        """ExecuteQuery (grpc.rs:385): plan the job on the scheduler (the
        scheduler owns the catalog and statistics, as the reference's runs
        the physical planner) and enqueue its graph."""
        from ..client.context import rebind_scans
        from ..planner.optimizer import prune_columns, reduce_group_keys
        from .distributed_planner import DistOptions, DistributedPlanner

        plan = decode_plan(req["plan"])
        tables = req["tables"]
        options = dict(req.get("options") or {})
        if "n_partitions" not in options:
            # default to what the registered fleet can run: a stage task
            # covers every partition, so the partition count must equal
            # an executor's mesh width
            widths = {e.meta.devices
                      for e in self.scheduler.executor_manager
                                   .executors.values() if e.meta.devices}
            if widths:
                options["n_partitions"] = min(widths)
        opts = DistOptions(**options)
        ctx = self._context_for(tables)
        plan = prune_columns(reduce_group_keys(rebind_scans(plan, ctx)))
        planner = DistributedPlanner(ctx, opts)
        dplan = planner.plan(plan)
        job_id = random_job_id()
        spec = JobSpec(job_id, plan, tables, opts, self.work_dir,
                       final_stage=dplan.final_stage,
                       replay={"broadcasts": list(planner.broadcasts),
                               "one_rows": list(planner.one_rows)})
        self.specs[job_id] = spec
        self.plans[job_id] = dplan
        graph = ExecutionGraph.from_distributed_plan(
            job_id, dplan, opts.n_partitions)
        self.scheduler.submit_job(graph)
        self.scheduler.run_until_idle()
        return {"job_id": job_id}

    def _context_for(self, tables: dict):
        key = json.dumps(tables, sort_keys=True)
        if key not in self._plan_ctx_cache:
            self._plan_ctx_cache[key] = build_context(tables, self.device)
        return self._plan_ctx_cache[key]

    def get_job(self, req: dict) -> dict:
        spec = self.specs.get(req["job_id"])
        if spec is None:
            return {"error": f"unknown job {req['job_id']}"}
        return {"spec": jobspec_to_wire(spec)}

    def job_status(self, req: dict) -> dict:
        self.scheduler.expire_dead_executors()
        self.scheduler.run_until_idle()
        return self.scheduler.job_status(req["job_id"])

    def cancel_job(self, req: dict) -> dict:
        return {"cancelled": self.scheduler.cancel_job(req["job_id"])}

    def stage_locations(self, req: dict) -> dict:
        """Who produced a stage's output, with their data endpoints: the
        consumer's ticket for the peer-to-peer read tier (the reference
        embeds PartitionLocation in the task definition,
        shuffle_reader.rs:60; here it is one lookup)."""
        g = self.scheduler.task_manager.jobs.get(req["job_id"])
        if g is None:
            return {"locations": []}
        st = g.stages.get(int(req["stage_id"]))
        if st is None:
            return {"locations": []}
        em = self.scheduler.executor_manager
        locs = []
        for eid in sorted(set(st.output_locations.values())):
            ex = em.executors.get(eid)
            if ex is not None and ex.meta.data_port and not em.is_dead(eid):
                locs.append({"executor_id": eid, "host": ex.meta.host,
                             "data_port": ex.meta.data_port})
        return {"locations": locs}

    def stop_executor(self, req: dict) -> dict:
        self.scheduler.stop_executor(req["executor_id"])
        return {"ok": True}

    def executor_stopped(self, req: dict) -> dict:
        self.scheduler.executor_stopped(req["executor_id"])
        self.scheduler.run_until_idle()
        return {"ok": True}

    def circuit_breaker(self, req: dict) -> dict:
        trips = self.scheduler.send_circuit_breaker_update(
            [tuple(u) for u in req["updates"]])
        return {"tripped": [list(t) for t in trips]}

    def fetch_result(self, req: dict) -> dict:
        """Result egress: the final stage's output, from the job's spill
        store or else its producer's data endpoint (the reference streams
        result partitions via Flight do_get), gathered on the CPU and
        shipped as a one-partition stage blob, base64-encoded, with the
        final schema and the dictionary entries of its string columns.

        The job's state and the producers' endpoints are read under the
        service lock; the peers are dialled after it is released, so a dead
        peer holds this call alone for PEER_TIMEOUT_S, not every verb."""
        job_id = req["job_id"]
        with self.lock:
            g = self.scheduler.task_manager.jobs.get(job_id)
            spec = self.specs.get(job_id)
            if g is None or spec is None:
                return {"error": f"unknown job {job_id}"}
            if g.state is not JobState.SUCCESSFUL:
                return {"error": f"job {job_id} is {g.state.value}: "
                                 f"{g.error}"}
            work_dir, version, final = (spec.work_dir, spec.version,
                                        spec.final_stage)
            schema = self.plans[job_id].final_schema
            locs = self.stage_locations(
                {"job_id": job_id, "stage_id": final})["locations"]
        blob = StageSpiller(work_dir, version=version).read_blob(job_id,
                                                                 final)
        for loc in ([] if blob is not None else locs):
            # disjoint work dirs: pull the final stage straight from its
            # producing executor's data endpoint (p2p result egress)
            blob = fetch_stage_blob(loc["host"], loc["data_port"], job_id,
                                    final, version,
                                    timeout=self.PEER_TIMEOUT_S)
            if blob is not None:
                break
        if blob is None:
            return {"error": "final stage output not found in the object "
                             "store or at its producers"}
        out, dicts = _result_blob(blob, schema)
        return {"result_b64": base64.b64encode(out).decode(),
                "schema": _encode_schema(schema), "dictionaries": dicts}


class _Handler(BaseHTTPRequestHandler):
    service: SchedulerRpcService = None  # set by server factory

    def log_message(self, fmt, *args):  # quiet
        log.debug("http: " + fmt, *args)

    def do_POST(self):
        verb = self.path.rstrip("/").rsplit("/", 1)[-1]
        handler = getattr(self.service, verb, None)
        if not callable(handler) or verb.startswith("_"):
            self.send_error(404, f"unknown verb {verb}")
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            req = json.loads(self.rfile.read(n) or b"{}")
            if verb in self.service.UNLOCKED:
                resp = handler(req)
            else:
                with self.service.lock:
                    resp = handler(req)
            body = json.dumps(resp).encode()
            self.send_response(200)
        except Exception as e:  # noqa: BLE001 - wire errors to the caller
            body = json.dumps(
                {"error": str(e), "error_kind": classify(e).kind}).encode()
            self.send_response(500)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve_scheduler(work_dir: str, host: str = "127.0.0.1", port: int = 0,
                    job_store=None, executor_timeout_s: float = 180.0,
                    policy: str = "pull", device="cuda"):
    """Start the scheduler RPC service; returns (service, http_server).
    Run http_server.serve_forever() on a thread; .shutdown() to stop.
    `device` places the scheduler's planning contexts ("cuda" raises
    without a card)."""
    service = SchedulerRpcService(work_dir, job_store=job_store,
                                  executor_timeout_s=executor_timeout_s,
                                  policy=policy, device=device)
    handler = type("BoundHandler", (_Handler,), {"service": service})
    httpd = ThreadingHTTPServer((host, port), handler)
    return service, httpd


class SchedulerRpcClient:
    """Thin client for the verb set (BallistaClient / SchedulerGrpcClient
    analog), for executors (the poll plane) and query submitters. `device`
    places the planning context `submit_sql` builds when given none."""

    def __init__(self, url: str, timeout: float = 30.0, device="cuda"):
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.device = device

    def call(self, verb: str, **req) -> dict:
        data = json.dumps(req).encode()
        r = urllib.request.Request(
            f"{self.url}/rpc/{verb}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=self.timeout) as resp:
            return json.loads(resp.read())

    # submit plane
    def submit_sql(self, sql: str, tables: dict, options: dict = None,
                   ctx=None) -> str:
        """Parse on the client, ship the logical plan (ExecuteQuery carries
        a serialized plan in the reference too, grpc.rs:385). A scalar
        subquery is folded into a literal here, on `ctx`."""
        if ctx is None:
            ctx = build_context(tables, self.device)
        plan = ctx.sql(sql).plan
        out = self.call("submit_job", plan=encode_plan(plan), tables=tables,
                        options=options or {})
        if "error" in out:
            raise RuntimeError(out["error"])
        return out["job_id"]

    def job_status(self, job_id: str) -> dict:
        return self.call("job_status", job_id=job_id)

    def wait_batch(self, job_id: str, timeout_s: float = 300.0,
                   poll_s: float = 0.05):
        """Poll until the job is terminal, then fetch its result:
        (Batch of CPU tensors, Schema with the string dictionaries it
        uses) (DistributedQueryExec's poll loop, here remote)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            st = self.job_status(job_id)
            state = st.get("state")
            if state == "successful":
                out = self.call("fetch_result", job_id=job_id)
                if "error" in out:
                    raise RuntimeError(out["error"])
                pb = decode_stage(base64.b64decode(out["result_b64"]))
                fields = _decode_schema(out["schema"]).fields
                schema = Schema(fields, dictionaries={
                    name: np.array(d, dtype=object)
                    for name, d in out["dictionaries"].items()})
                return pb.batches[0], schema
            if state in ("failed", "cancelled"):
                raise RuntimeError(f"job {job_id} {state}: {st.get('error')}")
            time.sleep(poll_s)
        raise TimeoutError(f"job {job_id} not terminal after {timeout_s}s")

    def wait(self, job_id: str, timeout_s: float = 300.0,
             poll_s: float = 0.05):
        """`wait_batch` as a pandas DataFrame."""
        return to_pandas(*self.wait_batch(job_id, timeout_s, poll_s))

    # executor plane
    def register_executor(self, meta) -> None:
        self.call("register_executor", metadata=executor_meta_to_wire(meta))

    def poll_work(self, executor_id: str, free_slots: int, statuses):
        """Returns (tasks, known): `known=False` means the scheduler does
        not recognize this executor id (restart, heartbeat expiry) and the
        worker must register again before polling."""
        out = self.call("poll_work", executor_id=executor_id,
                        free_slots=free_slots,
                        statuses=[status_to_wire(s) for s in statuses])
        tasks = []
        for w in out.get("tasks", []):
            v = w.pop("spec_version", 0)
            t = task_from_wire(w)
            t._spec_version = v
            tasks.append(t)
        return tasks, out.get("known", True)

    def update_task_status(self, executor_id: str, statuses) -> None:
        """UpdateTaskStatus (grpc.rs:268): the push-mode status path; pull
        mode sends statuses with PollWork instead."""
        self.call("update_task_status", executor_id=executor_id,
                  statuses=[status_to_wire(s) for s in statuses])

    def get_job(self, job_id: str) -> Optional[JobSpec]:
        out = self.call("get_job", job_id=job_id)
        if "error" in out:
            return None
        return jobspec_from_wire(out["spec"])

    def heartbeat(self, executor_id: str, metrics: dict = None) -> dict:
        req = {"executor_id": executor_id}
        if metrics is not None:
            req["metrics"] = metrics
        return self.call("heartbeat", **req)

    def state(self) -> dict:
        return self.call("state")

    def executor_stopped(self, executor_id: str) -> None:
        self.call("executor_stopped", executor_id=executor_id)

    def stage_locations(self, job_id: str, stage_id: int) -> list:
        """Data endpoints of the executors holding a stage's output (the
        peer-to-peer shuffle-read ticket)."""
        return self.call("stage_locations", job_id=job_id,
                         stage_id=int(stage_id)).get("locations", [])
