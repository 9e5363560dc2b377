"""Scheduler event-loop micro-benchmark (port of
ballista_tpu/benchmarks/scheduler_events.py).

Reference parity: `ballista/scheduler/benches/scheduler_events.rs` — a
criterion bench that submits dummy jobs through a real SchedulerServer with
a virtual launcher (tasks complete instantly) and measures end-to-end event
throughput of the control plane with zero devices involved.

  python -m ballista_tpu_torch.benchmarks.scheduler_events \
      [--jobs 200] [--stages 8] [--partitions 8] [--executors 4] [--wire]

Prints one JSON line: events/s, jobs/s, tasks/s for (a) the in-process
event pump and (b, --wire) the same jobs driven through the HTTP RPC wire
with a polling executor — isolating the wire's overhead from the state
machine's.
"""

from __future__ import annotations

import argparse
import json
import time


def linear_graph(job_id: str, n_stages: int, n_partitions: int):
    """stage i feeds stage i+1 (the dummy exec plan analog)."""
    from ..scheduler.execution_graph import ExecutionGraph
    specs = [(i, n_partitions, [] if i == 0 else [i - 1])
             for i in range(n_stages)]
    return ExecutionGraph(job_id, specs)


def bench_inproc(n_jobs: int, n_stages: int, n_partitions: int,
                 n_executors: int) -> dict:
    from ..scheduler.execution_graph import JobState, TaskStatus
    from ..scheduler.server import (ExecutorMetadata, SchedulerServer,
                                    TaskLauncher)

    class InstantLauncher(TaskLauncher):
        def launch(self, tasks, report):
            report([TaskStatus(t.task_id, t.job_id, t.stage_id,
                               t.partitions, t.executor_id, "successful")
                    for t in tasks])

    s = SchedulerServer(InstantLauncher())
    for e in range(n_executors):
        s.register_executor(ExecutorMetadata(f"e{e}", task_slots=8))
    t0 = time.perf_counter()
    for j in range(n_jobs):
        s.submit_job(linear_graph(f"job{j}", n_stages, n_partitions))
    s.run_until_idle(max_events=10_000_000)
    wall = time.perf_counter() - t0
    done = sum(1 for g in s.task_manager.jobs.values()
               if g.state is JobState.SUCCESSFUL)
    assert done == n_jobs, f"{done}/{n_jobs} jobs completed"
    n_events = sum(h.n for h in
                   getattr(s.metrics, "event_processing", {}).values()) or None
    tasks = n_jobs * n_stages  # one multi-partition task per stage
    return {"mode": "inproc", "jobs": n_jobs, "stages": n_stages,
            "wall_s": round(wall, 4),
            "jobs_per_s": round(n_jobs / wall, 1),
            "tasks_per_s": round(tasks / wall, 1),
            "events_per_s": (round(n_events / wall, 1)
                             if n_events else None)}


def bench_wire(n_jobs: int, n_stages: int, n_partitions: int,
               device="cuda") -> dict:
    """Same state machine driven over the HTTP RPC wire by a polling
    executor loop that fabricates completions (no devices): measures the
    verb-dispatch + JSON + socket overhead per scheduling round-trip. The
    jobs are submitted as graphs, so the scheduler's planning context on
    `device` is never made; its work dir is a temporary directory that no
    task writes."""
    import tempfile
    import threading

    from ..scheduler.rpc import serve_scheduler

    with tempfile.TemporaryDirectory() as work_dir:
        service, httpd = serve_scheduler(work_dir, device=device)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        try:
            return _drive_wire(service, httpd, n_jobs, n_stages,
                               n_partitions, device)
        finally:
            httpd.shutdown()
            httpd.server_close()


def _drive_wire(service, httpd, n_jobs, n_stages, n_partitions, device):
    from ..scheduler.execution_graph import JobState, TaskStatus
    from ..scheduler.rpc import SchedulerRpcClient
    from ..scheduler.server import ExecutorMetadata

    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    client = SchedulerRpcClient(url, device=device)
    client.register_executor(ExecutorMetadata("bench-exec", task_slots=8))

    sched = service.scheduler
    t0 = time.perf_counter()
    for j in range(n_jobs):
        with service.lock:
            sched.submit_job(linear_graph(f"wjob{j}", n_stages,
                                          n_partitions))
    statuses, polls = [], 0
    while True:
        tasks, _known = client.poll_work("bench-exec", 8, statuses)
        polls += 1
        statuses = [TaskStatus(t.task_id, t.job_id, t.stage_id,
                               t.partitions, "bench-exec", "successful")
                    for t in tasks]
        if not tasks and not statuses:
            with service.lock:
                if not any(g.state is JobState.RUNNING
                           for g in sched.task_manager.jobs.values()):
                    break
    wall = time.perf_counter() - t0
    done = sum(1 for g in sched.task_manager.jobs.values()
               if g.state is JobState.SUCCESSFUL)
    assert done == n_jobs, f"{done}/{n_jobs} jobs completed"
    tasks_n = n_jobs * n_stages
    return {"mode": "wire", "jobs": n_jobs, "stages": n_stages,
            "polls": polls, "wall_s": round(wall, 4),
            "jobs_per_s": round(n_jobs / wall, 1),
            "tasks_per_s": round(tasks_n / wall, 1)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--jobs", type=int, default=200)
    ap.add_argument("--stages", type=int, default=8)
    ap.add_argument("--partitions", type=int, default=8)
    ap.add_argument("--executors", type=int, default=4)
    ap.add_argument("--wire", action="store_true",
                    help="also drive the jobs through the HTTP RPC wire")
    ap.add_argument("--device", default="cuda",
                    help="the wire scheduler's planning device")
    args = ap.parse_args(argv)
    out = [bench_inproc(args.jobs, args.stages, args.partitions,
                        args.executors)]
    if args.wire:
        out.append(bench_wire(args.jobs, args.stages, args.partitions,
                              args.device))
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
