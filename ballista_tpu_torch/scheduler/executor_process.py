"""Deployable executor worker: the executor_process binary (port of
ballista_tpu/scheduler/executor_process.py).

Reference parity: `executor/src/executor_process.rs` (start-up, scheduler
registration, heartbeats, work loop, graceful shutdown) with the pull-mode
execution loop (`executor/src/execution_loop.rs:56`): the worker registers
with the scheduler over the RPC wire (scheduler/rpc.py), polls for tasks,
runs each stage task over the partitions of its mesh on its device,
exchanges stage outputs with other executors through the spill store or
its data endpoint (scheduler/spill.py), and reports TaskStatus on the next
poll.

Usage:
  python -m ballista_tpu_torch.scheduler.executor_process \\
      --scheduler http://host:port [--executor-id ID] [--slots N] \\
      [--device cuda|cpu] [--partitions N] [--poll-ms 100] \\
      [--heartbeat-s 10] [--policy pull|push] [--work-dir DIR]

`--partitions N` runs N partitions on the one `--device` (the mesh is
`make_mesh(N, devices=[device] * N)`), so several executors may share one
card. SIGTERM runs the graceful stop: finish the task in flight, flush its
status, notify ExecutorStopped, exit 0 (executor_process.rs's TERMINATING
grace path).
"""

from __future__ import annotations

import collections
import ipaddress
import json
import logging
import os
import signal
import socket
import sys
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

log = logging.getLogger("ballista_tpu_torch.executor")

# jobs whose stage outputs an executor keeps on its device; an older job's
# outputs are dropped (its spills remain)
MAX_CACHED_JOBS = 4


def fetch_stage_blob(host: str, port: int, job_id: str, stage_id: int,
                     version: int, timeout: float = 60.0) -> Optional[bytes]:
    """Dial a peer executor's data endpoint for one stage's spill blob
    (the FetchPartition do_get ticket, flight_service.rs:123). None on
    any failure: the caller decides which tier to try next."""
    import urllib.request
    if not port:
        return None
    data = json.dumps({"job_id": job_id, "stage_id": int(stage_id),
                       "spec_version": int(version)}).encode()
    req = urllib.request.Request(
        f"http://{host}:{port}/exec/fetch_partition", data=data,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.read()
    except Exception as e:  # noqa: BLE001 - peer gone / partition missing
        log.debug("peer fetch %s:%s %s/stage_%s failed: %s",
                  host, port, job_id, stage_id, e)
        return None


def _is_loopback(host: str) -> bool:
    if host == "localhost":
        return True
    try:
        return ipaddress.ip_address(host).is_loopback
    except ValueError:
        return False


def advertised_host(bind_host: str, scheduler_url: str,
                    advertise_host: Optional[str] = None) -> str:
    """The name peers and the scheduler dial for this executor's endpoint.
    An explicit `advertise_host` wins (the reference's external_host). A
    wildcard bind advertises the machine's name. A loopback bind is
    reachable from this machine only, so it is advertised to a scheduler
    on this machine and refused with a remote one: peers elsewhere would
    dial themselves. (The reference advertised 127.0.0.1 to any
    scheduler.)"""
    if advertise_host:
        return advertise_host
    if bind_host in ("", "0.0.0.0", "::"):
        return socket.getfqdn()
    sched = urllib.parse.urlparse(scheduler_url).hostname or ""
    if _is_loopback(bind_host) and not _is_loopback(sched):
        raise ValueError(
            f"the data endpoint binds {bind_host}, which peers of the "
            f"remote scheduler {sched} cannot reach: pass --advertise-host, "
            "or --listen-host 0.0.0.0")
    return bind_host


class _ExecutorJob:
    """Executor-side job state: the job's stage loop (`JobContext`) on the
    executor's mesh, for one spec version. Its spiller writes to the
    executor's own work dir when one is set (peer-to-peer deployments:
    shuffle files stay with their producer) and to the job's shared work
    dir otherwise."""

    def __init__(self, spec, runtime, work_dir=None, peer_fetch=None):
        from types import SimpleNamespace

        from ..client.context import rebind_scans
        from ..planner.optimizer import prune_columns, reduce_group_keys
        from .distributed_planner import DistributedPlanner
        from .spill import StageSpiller
        from .standalone import JobContext

        self.spec = spec
        ctx = runtime.ctx
        plan = prune_columns(reduce_group_keys(rebind_scans(spec.plan, ctx)))
        # the scheduler's first planning's broadcast choices, replayed so
        # that the stages are those of its ExecutionGraph at any version
        replay = SimpleNamespace(quotas=[], **spec.replay) \
            if spec.replay else None
        planner = DistributedPlanner(ctx, spec.options, replay=replay,
                                     replay_quotas=False)
        self.jc = JobContext(spec.job_id, runtime, ctx, plan, planner,
                             spiller=StageSpiller(work_dir or spec.work_dir,
                                                  version=spec.version),
                             peer_fetch=peer_fetch, escalate=False)


class ExecutorProcess:
    """One executor: `device` and `partitions` make its mesh (or pass a
    `mesh`)."""

    def __init__(self, scheduler_url: str, executor_id: str,
                 task_slots: int = 1, mesh=None, poll_interval: float = 0.1,
                 heartbeat_interval: float = 10.0, work_dir: str = None,
                 device="cuda", partitions: int = 0):
        from ..parallel.mesh import make_mesh, visible_devices
        from .rpc import SchedulerRpcClient
        from .server import ExecutorMetadata

        self.client = SchedulerRpcClient(scheduler_url, device=device)
        if mesh is None:
            import torch
            dev = torch.device(device)
            mesh = (make_mesh(partitions, devices=[dev] * partitions)
                    if partitions else
                    make_mesh(devices=visible_devices(dev.type)))
        self.mesh = mesh
        self.device = mesh[0]
        self.meta = ExecutorMetadata(executor_id, task_slots=task_slots,
                                     devices=len(self.mesh))
        self.poll_interval = poll_interval
        self.heartbeat_interval = heartbeat_interval
        # executor-local shuffle dir: when set, stage outputs spill here
        # (not the job's shared work_dir) and peers fetch them over the
        # data endpoint: the reference's per-executor work_dir and
        # FlightRemote read (executor_process.rs work_dir flag,
        # shuffle_reader.rs:226)
        self.work_dir = work_dir
        self.jobs: Dict[str, _ExecutorJob] = collections.OrderedDict()
        # the newest spec version seen of each job, kept past eviction: the
        # data endpoint serves no older attempt
        self._versions: Dict[str, int] = {}
        # one runtime per data environment: its partitioned tables stay on
        # the device across jobs
        self._runtimes: Dict[str, object] = {}
        self._statuses: List = []
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # -- lifecycle --
    def start(self):
        self.client.register_executor(self.meta)
        log.info("executor %s registered at %s (%d partitions on %s, %d "
                 "slots)", self.meta.executor_id, self.client.url,
                 len(self.mesh), self.device, self.meta.task_slots)
        # the readiness marker follows registration (tests and process
        # managers wait on it)
        print(f"EXECUTOR_READY {self.meta.executor_id}", flush=True)
        self._hb_thread = threading.Thread(target=self._heartbeat_loop,
                                           daemon=True)
        self._hb_thread.start()

    def _heartbeat_loop(self):
        """Heartbeater (executor/src/executor_server.rs heartbeat task):
        keeps the executor alive in the scheduler's registry while a long
        stage occupies the poll thread."""
        while not self._stop.wait(self.heartbeat_interval):
            try:
                out = self.client.heartbeat(self.meta.executor_id, metrics={
                    "cached_jobs": len(self.jobs),
                    "pending_statuses": len(self._statuses)})
                if out is not None and out.get("known") is False:
                    # scheduler restarted or expired us: register again so
                    # work flows (a worker that only polls idle would
                    # otherwise be left out forever)
                    self._reregister()
            except Exception as e:  # noqa: BLE001 - scheduler may be down
                log.warning("heartbeat failed: %s", e)

    def _reregister(self):
        if self._stop.is_set():
            # a poll or heartbeat in flight when the stop came back
            # "unknown": the scheduler already let this executor go
            return
        try:
            self.client.register_executor(self.meta)
            log.info("executor %s re-registered", self.meta.executor_id)
        except Exception as e:  # noqa: BLE001 - retried on next signal
            log.warning("re-registration failed: %s", e)

    def stop(self, graceful: bool = True):
        self._stop.set()
        if graceful:
            try:
                if self._statuses:
                    self.client.poll_work(self.meta.executor_id, 0,
                                          self._statuses)
                    self._statuses = []
                self.client.executor_stopped(self.meta.executor_id)
            except Exception as e:  # noqa: BLE001
                log.warning("graceful stop notification failed: %s", e)

    # -- work loop --
    def _runtime_for(self, spec):
        from ..serde.tasks import build_context
        from .runtime import DistributedRuntime
        key = json.dumps(spec.tables, sort_keys=True)
        rt = self._runtimes.get(key)
        if rt is None:
            rt = DistributedRuntime(build_context(spec.tables, self.device),
                                    self.mesh, spec.options)
            self._runtimes[key] = rt
        return rt

    def _job_for(self, task) -> _ExecutorJob:
        ej = self.jobs.get(task.job_id)
        want = getattr(task, "_spec_version", None)
        if ej is not None and (want is None or ej.spec.version >= want):
            self.jobs.move_to_end(task.job_id)
            return ej
        spec = self.client.get_job(task.job_id)
        if spec is None:
            raise RuntimeError(f"scheduler has no spec for {task.job_id}")
        if spec.options.n_partitions != len(self.mesh):
            raise RuntimeError(
                f"job {task.job_id} plans {spec.options.n_partitions} "
                f"partitions but this executor's mesh has "
                f"{len(self.mesh)}")
        version = spec.version
        self._versions[task.job_id] = version

        def peer_fetch(job_id, stage_id, mesh):
            return self._peer_fetch(job_id, stage_id, mesh, version)

        ej = _ExecutorJob(spec, self._runtime_for(spec),
                          work_dir=self.work_dir, peer_fetch=peer_fetch)
        self.jobs[task.job_id] = ej
        self.jobs.move_to_end(task.job_id)
        while len(self.jobs) > MAX_CACHED_JOBS:
            self.jobs.popitem(last=False)
        return ej

    # -- peer-to-peer shuffle fetch (three-tier read, remote tier) --

    def _peer_fetch(self, job_id: str, stage_id: int, mesh, version: int):
        """Pull a stage output straight from its producing executor
        (shuffle_reader.rs:395-537 FlightRemote tier): ask the scheduler
        who produced it, dial that worker's data endpoint, decode the blob
        onto the local mesh. None when no peer can serve it (the caller
        then raises fetch_failed and the graph rolls back)."""
        from .spill import decode_stage
        try:
            locs = self.client.stage_locations(job_id, stage_id)
        except Exception as e:  # noqa: BLE001 - scheduler hiccup
            log.warning("stage_locations(%s, %s) failed: %s",
                        job_id, stage_id, e)
            return None
        for loc in locs:
            if loc.get("executor_id") == self.meta.executor_id:
                continue    # the local tiers already missed
            blob = fetch_stage_blob(loc["host"], loc["data_port"], job_id,
                                    stage_id, version)
            if blob is not None:
                log.info("fetched %s/stage_%s from peer %s (%d bytes)",
                         job_id, stage_id, loc["executor_id"], len(blob))
                return decode_stage(blob, mesh)
        return None

    def _fetch_partition_blob(self, req: dict) -> Optional[bytes]:
        """Serving side of the data endpoint (flight_service.rs:74 do_get
        FetchPartition): the spill blob of (job, stage, spec version).

        A request for a version older than the newest this executor has
        seen of the job is a superseded attempt and gets nothing (the
        reference served it from the local work dir). Otherwise the spilled
        blob
        comes first (the bytes the stage wrote when it finished), then the
        output in memory, taken once under the job's lock and encoded
        after it (the reference encoded an output a re-plan could be
        replacing), then a cold read of the local work dir (job evicted)."""
        from .spill import StageSpiller, encode_stage
        job_id = req["job_id"]
        stage_id = int(req["stage_id"])
        version = int(req.get("spec_version", 0))
        if version < self._versions.get(job_id, version):
            return None
        ej = self.jobs.get(job_id)
        if ej is not None and ej.spec.version == version:
            blob = ej.jc.spiller.read_blob(job_id, stage_id)
            if blob is not None:
                return blob
            with ej.jc.lock:
                pb = ej.jc.outputs.get(str(stage_id))
            if pb is not None:
                return encode_stage(pb)
        if self.work_dir:
            return StageSpiller(self.work_dir,
                                version=version).read_blob(job_id, stage_id)
        return None

    def _run_task(self, task):
        from ..errors import classify
        from ..ops import masked_sums
        from .execution_graph import TaskStatus
        from .runtime import CapacityOverflowError

        entries = (masked_sums.masked_slot_sums_rows,
                   masked_sums.masked_slot_sums)
        try:
            ej = self._job_for(task)
            # escalate=False: an overflow fails the task, so the scheduler
            # escalates the job spec for every executor alike
            # (rpc.py _escalate_on_overflow): a local escalation would give
            # the processes different capacities
            jc = ej.jc
            before = [e.launches for e in entries]
            spilled, reads = jc.spilled_bytes, dict(jc.reads)
            t0 = time.perf_counter()
            jc.run_stage(task.stage_id)
            # operator metrics ride TaskStatus (OperatorMetricsSet,
            # proto:286-319); beside them the task's kernel launches and
            # its spill and fetch traffic
            metrics = {
                "run_s": round(time.perf_counter() - t0, 4),
                "operator_rows": jc.op_metrics.get(task.stage_id) or {},
                "kernel_launches": {
                    e.__name__: e.launches - b
                    for e, b in zip(entries, before)},
                "spilled_bytes": jc.spilled_bytes - spilled,
                "inputs_restored": jc.reads["spill"] - reads["spill"],
                "inputs_fetched": jc.reads["peer"] - reads["peer"]}
            return TaskStatus(task.task_id, task.job_id, task.stage_id,
                              task.partitions, self.meta.executor_id,
                              "successful", metrics=metrics)
        except Exception as e:  # noqa: BLE001 - all failures ride the wire
            err = classify(e)
            log.warning("task %s/%s failed (%s): %s", task.job_id,
                        task.stage_id, err.kind, err.message)
            self.jobs.pop(task.job_id, None)  # derive again on retry
            if err.kind == "fetch_failed":
                return TaskStatus(task.task_id, task.job_id, task.stage_id,
                                  task.partitions, self.meta.executor_id,
                                  "fetch_failed", str(err),
                                  failed_input_stage=err.map_stage_id,
                                  error_kind=err.kind)
            # shuffle-write stats ride the failure (PartitionStats,
            # serde/scheduler/mod.rs:33): the scheduler sizes quota and
            # salt for every executor from the observed counts; an
            # operator that outgrew its capacity says so
            stats = None
            for st in (getattr(e, "stats", None) or ()):
                stats = (stats or [])
                stats.append({"quota": int(st["quota"]),
                              "salt_kind": st["salt_kind"],
                              "counts": [[int(x) for x in row] for row in
                                         st["counts"]]})
            metrics = ({"overflow": "capacity", "growth": list(e.growth)}
                       if isinstance(e, CapacityOverflowError) else None)
            return TaskStatus(task.task_id, task.job_id, task.stage_id,
                              task.partitions, self.meta.executor_id,
                              "failed", str(err), error_kind=err.kind,
                              stats=stats, metrics=metrics)

    def poll_once(self) -> int:
        statuses, self._statuses = self._statuses, []
        try:
            tasks, known = self.client.poll_work(
                self.meta.executor_id, self.meta.task_slots, statuses)
        except Exception as e:  # noqa: BLE001 - scheduler hiccup: retry
            log.warning("poll failed: %s", e)
            self._statuses = statuses  # redeliver next poll
            return 0
        if not known:
            self._reregister()
        for task in tasks:
            self._statuses.append(self._run_task(task))
        return len(tasks)

    def run_forever(self):
        self.start()
        while not self._stop.is_set():
            if self.poll_once() == 0:
                self._stop.wait(self.poll_interval)
        log.info("executor %s stopped", self.meta.executor_id)

    # -- executor HTTP service: push verbs and the data endpoint --

    def listen(self, host: str = "127.0.0.1", port: int = 0,
               advertise_host: str = None, data_only: bool = False):
        """Start the ExecutorGrpc-analog HTTP service (LaunchTask,
        CancelTasks, StopExecutor, RemoveJobData: executor_server.rs:1118,
        1157, 1183, 1210; and the Flight shuffle service's fetch_partition,
        flight_service.rs:74) and advertise its endpoint in the
        registration metadata. Call before start() so the scheduler learns
        the port. The advertised name is `advertised_host`'s.
        `data_only=True` serves fetch_partition alone and advertises no
        push endpoint, so a pull-mode worker can hand out shuffle data
        without being push-launched at."""
        self.meta.host = advertised_host(host, self.client.url,
                                         advertise_host)
        self._queue: collections.deque = collections.deque()
        self._queue_cond = threading.Condition()
        self._cancelled: set = set()
        proc = self

        class _ExecHandler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                log.debug("exec http: " + fmt, *args)

            def do_POST(self):
                verb = self.path.rstrip("/").rsplit("/", 1)[-1]
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if verb == "fetch_partition":
                        blob = proc._fetch_partition_blob(req)
                        if blob is None:
                            self.send_error(404, "partition not found")
                            return
                        self.send_response(200)
                        self.send_header("Content-Type",
                                         "application/octet-stream")
                        self.send_header("Content-Length", str(len(blob)))
                        self.end_headers()
                        self.wfile.write(blob)
                        return
                    if data_only:
                        self.send_error(403, "data-only endpoint")
                        return
                    resp = proc._push_verb(verb, req)
                    body = json.dumps(resp).encode()
                    self.send_response(200)
                except Exception as e:  # noqa: BLE001
                    body = json.dumps({"error": str(e)}).encode()
                    self.send_response(500)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = ThreadingHTTPServer((host, port), _ExecHandler)
        self.meta.data_port = self._httpd.server_address[1]
        if not data_only:
            self.meta.port = self._httpd.server_address[1]
        threading.Thread(target=self._httpd.serve_forever,
                         daemon=True).start()
        return self._httpd.server_address[1]

    def _push_verb(self, verb: str, req: dict) -> dict:
        from ..serde.tasks import task_from_wire
        if verb == "launch_task":
            # rejected while TERMINATING (executor_server.rs:1118 rejects
            # LaunchTask during the drain grace period)
            if self._stop.is_set():
                return {"accepted": 0, "terminating": True}
            tasks = []
            for w in req.get("tasks", []):
                v = w.pop("spec_version", 0)
                t = task_from_wire(w)
                t._spec_version = v
                tasks.append(t)
            with self._queue_cond:
                self._queue.extend(tasks)
                self._queue_cond.notify_all()
            return {"accepted": len(tasks)}
        if verb == "cancel_tasks":
            with self._queue_cond:
                self._cancelled.add(req["job_id"])
                self._queue = collections.deque(
                    t for t in self._queue if t.job_id != req["job_id"])
            self.jobs.pop(req["job_id"], None)
            return {"ok": True}
        if verb == "stop_executor":
            self._stop.set()
            with self._queue_cond:
                self._queue_cond.notify_all()
            return {"ok": True}
        if verb == "remove_job_data":
            self.jobs.pop(req["job_id"], None)
            return {"ok": True}
        raise ValueError(f"unknown verb {verb}")

    def _flush_statuses(self):
        """Deliver pending task statuses via UpdateTaskStatus, keeping them
        queued on failure for the next attempt (push mode's counterpart of
        the pull loop's redelivery on every poll)."""
        if not self._statuses:
            return
        pending, self._statuses = self._statuses, []
        try:
            self.client.update_task_status(self.meta.executor_id, pending)
        except Exception as e:  # noqa: BLE001 - hold for retry
            log.warning("status delivery failed (%d held): %s",
                        len(pending), e)
            self._statuses = pending + self._statuses

    def run_push(self):
        """Push-staged work loop: run queued tasks, report statuses via
        UpdateTaskStatus at once (the reference's status-reporter task
        batches the same way, executor_server.rs:876-1017)."""
        self.start()
        while not self._stop.is_set():
            with self._queue_cond:
                while not self._queue and not self._stop.is_set():
                    self._queue_cond.wait(self.poll_interval)
                task = self._queue.popleft() if self._queue else None
            if task is None:
                # idle tick: retry any statuses whose delivery failed, so
                # a transient scheduler hiccup does not leave a task
                # running (and its slot reserved) forever
                self._flush_statuses()
                continue
            if task.job_id in self._cancelled:
                continue
            self._statuses.append(self._run_task(task))
            self._flush_statuses()
        log.info("executor %s stopped (push)", self.meta.executor_id)


def _parser():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scheduler", required=True, help="scheduler RPC URL")
    ap.add_argument("--executor-id", default=None)
    ap.add_argument("--slots", type=int, default=1)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device every partition runs on")
    ap.add_argument("--partitions", type=int, default=0,
                    help="partitions of the mesh, all on --device (0: one "
                         "per visible device of its type)")
    ap.add_argument("--poll-ms", type=int, default=100)
    ap.add_argument("--heartbeat-s", type=float, default=10.0)
    ap.add_argument("--policy", choices=("pull", "push"), default="pull",
                    help="pull: PollWork loop; push: serve the "
                         "ExecutorGrpc-analog endpoint and run tasks the "
                         "scheduler POSTs (TaskSchedulingPolicy parity)")
    ap.add_argument("--listen-host", default="127.0.0.1")
    ap.add_argument("--listen-port", type=int, default=0)
    ap.add_argument("--advertise-host", default=None,
                    help="hostname the scheduler and peers dial when it "
                         "differs from --listen-host (containers)")
    ap.add_argument("--work-dir", default=None,
                    help="executor-local shuffle spill dir: stage outputs "
                         "spill here and peers fetch them over the data "
                         "endpoint instead of a shared object store "
                         "(executor_process.rs --work-dir parity)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    executor_id = (args.executor_id
                   or f"executor-{os.uname().nodename}-{os.getpid()}")
    ex = ExecutorProcess(args.scheduler, executor_id,
                         task_slots=args.slots,
                         poll_interval=args.poll_ms / 1000.0,
                         heartbeat_interval=args.heartbeat_s,
                         work_dir=args.work_dir, device=args.device,
                         partitions=args.partitions)

    def _term(signum, frame):
        log.info("SIGTERM: graceful stop")
        ex.stop(graceful=True)

    signal.signal(signal.SIGTERM, _term)
    try:
        if args.policy == "push":
            ex.listen(args.listen_host, args.listen_port,
                      advertise_host=args.advertise_host)
            ex.run_push()
        else:
            # pull workers still serve shuffle data to peers (every
            # reference executor runs its Flight service whatever the
            # scheduling policy); data_only keeps them out of push launch
            ex.listen(args.listen_host, args.listen_port,
                      advertise_host=args.advertise_host, data_only=True)
            ex.run_forever()
    except KeyboardInterrupt:
        ex.stop(graceful=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
