"""Multi-executor load test against the scheduler's RPC wire, with one
executor killed under load (port of scripts/loadtest_rpc.py).

Reference parity: `tpch.rs loadtest ballista` (benchmarks/src/bin/tpch.rs:454),
concurrent clients x requests against a real cluster, with heartbeat-expiry
recovery under load. The scheduler (`scheduler.rpc.serve_scheduler`,
executors expire after 5 s without a heartbeat) serves on a thread of this
process; --workers executor processes (`python -m
ballista_tpu_torch.scheduler.executor_process`, pull, --partitions on
--device, sharing the scheduler's work dir) run the stages. Each query runs
once to warm up and is checked; then --clients threads each submit
--requests queries. With --kill-one (the default) one executor is
SIGKILLed: the first that, at one of its PollWork calls, has finished a
task under load and holds a task of a job in flight (running or finished)
while another job is in flight too. Those jobs finish on the survivors.

Every answer is held exactly against numpy on the generated host arrays
(counts as integers, decimal sums as scaled integers, strings as values).
The tables: BALLISTA_TPCH_CACHE (a directory under the work dir unless it
is set already) receives `generate_tpch(sf)` once, as .npz files; the
scheduler's planning context and the executors inherit it and read them.

The last line of the output is a JSON report: the reference's keys, the
kill's moment, the jobs that had a task on the victim with the executors
of their final stage, the seconds until the scheduler dropped the victim,
and the kernel launches the executors' task metrics report. The exit code
is 1 if an answer is wrong, a job fails or times out, or the victim ran no
task before the kill.

Usage:
  python -m ballista_tpu_torch.benchmarks.loadtest_rpc [--clients 4] \\
      [--requests 6] [--workers 3] [--kill-one | --no-kill] \\
      [--device cuda] [--sf 1] [--partitions 4]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from fractions import Fraction

import numpy as np

QUERIES = {
    "join_agg": """
        select o_orderpriority, count(*) as n
        from orders join customer on o_custkey = c_custkey
        where o_totalprice > 1000
        group by o_orderpriority order by o_orderpriority""",
    "filter_agg": """
        select sum(l_extendedprice * l_discount) as revenue
        from lineitem
        where l_discount between 0.05 and 0.07 and l_quantity < 24""",
    "group_sort": """
        select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty,
               count(*) as n
        from lineitem group by l_returnflag, l_linestatus
        order by l_returnflag, l_linestatus""",
}
EXPIRY_S = 5.0
JOB_TIMEOUT_S = 600
_TABLES_LINE = re.compile(
    r"generate_tpch SF \S+: (\d+) tables generated \(.*\), (\d+) read")


def answer_rows(columns: dict, fields) -> list:
    """A result as a list of row tuples: strings as str, integers as int,
    decimals as the exact Fraction of their scaled integer. `columns` is
    `to_numpy`'s {name: (values, validity)} and `fields` the schema's
    fields (the port's or the JAX package's); a NULL is None."""
    cols = []
    for f in fields:
        values, valid = columns[f.name]
        scale = f.dtype.scale if f.dtype.kind.value == "decimal" else None
        cols.append([None if not ok else
                     Fraction(int(v), 10 ** scale) if scale is not None
                     else v if isinstance(v, str) else int(v)
                     for v, ok in zip(values, valid)])
    return list(zip(*cols))


def _scaled(literal: str, scale: int) -> int:
    """A SQL literal as an integer at a decimal column's scale."""
    return int(Fraction(literal) * 10 ** scale)


def _group_codes(*cols):
    """Rows grouped by the dictionary codes of string columns: (the
    groups' strings, each row's group index), the groups in string
    order."""
    key = np.zeros(len(cols[0].values), dtype=np.int64)
    for c in cols:
        key = key * len(c.dictionary) + c.values
    uniq, inverse = np.unique(key, return_inverse=True)
    names = []
    for k in uniq.tolist():
        parts = []
        for c in reversed(cols):
            k, code = divmod(k, len(c.dictionary))
            parts.append(str(c.dictionary[code]))
        names.append(tuple(reversed(parts)))
    order = sorted(range(len(names)), key=names.__getitem__)
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return [names[i] for i in order], rank[inverse]


def expected_answers(data: dict) -> dict:
    """Each query's rows computed with numpy on `generate_tpch`'s host
    arrays (the engine's own code is not used), in `answer_rows`' form."""
    from ..datagen.tpch import TPCH_TABLES

    def table(name):
        return data[name][1]

    def scale(name, column):
        (f,) = [f for f in TPCH_TABLES[name][2] if f.name == column]
        return f.dtype.scale

    out = {}
    o, c = table("orders"), table("customer")
    ckeys, cmult = np.unique(c["c_custkey"].values, return_counts=True)
    at = np.searchsorted(ckeys, o["o_custkey"].values).clip(
        max=len(ckeys) - 1)
    mult = np.where(ckeys[at] == o["o_custkey"].values, cmult[at], 0)
    mult[o["o_totalprice"].values <= _scaled("1000", scale(
        "orders", "o_totalprice"))] = 0
    names, group = _group_codes(o["o_orderpriority"])
    counts = np.bincount(group, weights=mult, minlength=len(names))
    out["join_agg"] = [(p, int(n)) for (p,), n in zip(names, counts)
                       if n > 0]

    li = table("lineitem")
    ds, qs = scale("lineitem", "l_discount"), scale("lineitem", "l_quantity")
    disc, qty = li["l_discount"].values, li["l_quantity"].values
    keep = ((disc >= _scaled("0.05", ds)) & (disc <= _scaled("0.07", ds))
            & (qty < _scaled("24", qs)))
    revenue = int((li["l_extendedprice"].values[keep]
                   * disc[keep]).sum(dtype=np.int64))
    out["filter_agg"] = [(Fraction(revenue, 10 ** (
        scale("lineitem", "l_extendedprice") + ds)),)]

    names, group = _group_codes(li["l_returnflag"], li["l_linestatus"])
    out["group_sort"] = [
        (*key, Fraction(int(qty[group == g].sum(dtype=np.int64)), 10 ** qs),
         int((group == g).sum())) for g, key in enumerate(names)]
    return out


def report_rows(rows: list) -> list:
    """`answer_rows` as JSON: a Fraction as its str ("num/den")."""
    return [[str(v) if isinstance(v, Fraction) else v for v in r]
            for r in rows]


class Worker:
    """One executor process; its output lines are kept (the tables it
    generated are counted from them, and a failure shows their tail)."""

    def __init__(self, url, eid, device, partitions):
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
                os.pathsep) if p]))
        self.eid = eid
        self.lines = []
        self.ready = threading.Event()
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "ballista_tpu_torch.scheduler.executor_process",
             "--scheduler", url, "--executor-id", eid, "--device", device,
             "--partitions", str(partitions), "--poll-ms", "50",
             "--heartbeat-s", "1"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        threading.Thread(target=self._drain, daemon=True).start()

    def _drain(self):
        for line in self.proc.stdout:
            self.lines.append(line.rstrip())
            if line.startswith("EXECUTOR_READY"):
                self.ready.set()

    def wait_ready(self, timeout=300):
        deadline = time.time() + timeout
        while not self.ready.wait(0.1):
            if self.proc.poll() is not None or time.time() > deadline:
                raise RuntimeError(f"executor {self.eid} did not register: "
                                   f"{self.lines[-20:]}")

    def tables(self) -> dict:
        """TPC-H tables this process generated and read from
        BALLISTA_TPCH_CACHE (`generate_tpch` logs both)."""
        found = [m for m in map(_TABLES_LINE.search, list(self.lines)) if m]
        return {"generated": sum(int(m.group(1)) for m in found),
                "read": sum(int(m.group(2)) for m in found)}

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=60)


def _jobs_in_flight(service):
    """{job_id: graph} of the jobs not yet terminal (under the lock)."""
    from ..scheduler.execution_graph import JobState
    return {jid: g for jid, g in service.scheduler.task_manager.jobs.items()
            if g.state in (JobState.QUEUED, JobState.RUNNING)}


def _tasks_on(graph, eid) -> list:
    """[stage id, task state] of each task of `graph` that executor `eid`
    runs or ran (a task covers every partition of its stage)."""
    return sorted({(sid, t.status) for sid, st in graph.stages.items()
                   for t in st.task_infos
                   if t is not None and t.executor_id == eid})


def _job_summary(service, job_id) -> dict:
    """State, executors per stage and the final stage's, and the kernel
    launches per entry point summed over the job's task metrics."""
    with service.lock:
        g = service.scheduler.task_manager.jobs[job_id]
        final = service.specs[job_id].final_stage
        stages = {sid: dict(st.metrics or {}) for sid, st in g.stages.items()}
        state = g.state.value
    launches = np.zeros(2, dtype=np.int64)
    executors = set()
    for m in stages.values():
        executors |= set(m.get("executors", []))
        counts = m.get("kernel_launches", {})
        launches += [counts.get("masked_slot_sums_rows", 0),
                     counts.get("masked_slot_sums", 0)]
    return {"state": state, "executors": sorted(executors),
            "stage_executors": [e for m in stages.values()
                                for e in m.get("executors", [])],
            "final_executors": sorted(stages[final].get("executors", [])),
            "launches": launches}


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--kill-one", action="store_true", default=True)
    ap.add_argument("--no-kill", dest="kill_one", action="store_false")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of every executor's partitions and of "
                         "the planning contexts (cuda raises without a card)")
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--partitions", type=int, default=4,
                    help="partitions of each executor's mesh and of every job")
    return ap


def main(argv=None) -> dict:
    """Run the load test; returns the report (printed as the last line),
    whose "ok" is False when an answer was wrong, a job failed or timed
    out, or the victim ran no task before the kill."""
    args = _parser().parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("loadtest_rpc --device cuda: CUDA is not "
                           "available; pass --device cpu to run on the CPU")
    from ..client import SessionContext
    from ..datagen import generate_tpch, register_tpch
    from ..scheduler.rpc import SchedulerRpcClient, serve_scheduler

    tables = {"kind": "tpch", "sf": args.sf}
    options = {"n_partitions": args.partitions}
    work_dir = tempfile.mkdtemp(prefix="loadtest_")
    own_cache = "BALLISTA_TPCH_CACHE" not in os.environ
    if own_cache:
        os.environ["BALLISTA_TPCH_CACHE"] = os.path.join(work_dir, "tpch")
    workers, httpd = [], None
    failures, results, lock = [], [], threading.Lock()
    t_start = time.perf_counter()
    try:
        data = generate_tpch(args.sf)
        exp = expected_answers(data)
        service, httpd = serve_scheduler(
            os.path.join(work_dir, "shuffle"), executor_timeout_s=EXPIRY_S,
            device=args.device)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        workers = [Worker(url, f"lt-{i}", args.device, args.partitions)
                   for i in range(args.workers)]
        for w in workers:
            w.wait_ready()
        startup_s = time.perf_counter() - t_start
        print(f"# {args.workers} workers up at {url} in {startup_s:.1f} s",
              flush=True)

        def planning_ctx():
            # one per thread: planning ingests columns into its context
            ctx = SessionContext(device=args.device)
            register_tpch(ctx, args.sf, data=data)
            return ctx

        def run_one(client, ctx, name):
            from ..batch import to_numpy
            t0 = time.perf_counter()
            job_id = None
            try:
                job_id = client.submit_sql(QUERIES[name], tables, options,
                                           ctx=ctx)
                batch, schema = client.wait_batch(job_id, JOB_TIMEOUT_S)
                got = answer_rows(to_numpy(batch, schema), schema.fields)
                error = (None if got == exp[name] else
                         f"{name} answered {report_rows(got)}, expected "
                         f"{report_rows(exp[name])}")
            except Exception as e:  # noqa: BLE001 - a failed job is a result
                error = f"{name} (job {job_id}): {type(e).__name__}: {e}"
            return name, job_id, error, time.perf_counter() - t0

        t0 = time.perf_counter()
        warm = SchedulerRpcClient(url, timeout=120, device=args.device)
        warm_ctx = planning_ctx()
        warm_jobs = []
        for name in QUERIES:
            _, job_id, error, _ = run_one(warm, warm_ctx, name)
            warm_jobs.append(job_id)
            if error:
                failures.append(f"warm-up {error}")
        warmup_s = time.perf_counter() - t0
        print(f"# warm-up in {warmup_s:.1f} s, "
              f"{'verified' if not failures else 'FAILED'}", flush=True)

        names = list(QUERIES)
        t0 = time.perf_counter()

        def client_thread(cid):
            client = SchedulerRpcClient(url, timeout=120, device=args.device)
            ctx = planning_ctx()
            for i in range(args.requests):
                r = run_one(client, ctx, names[(cid + i) % len(names)])
                with lock:
                    results.append(r)

        kill, killed = {}, threading.Event()
        poll_work = service.poll_work

        def poll_then_kill(req):
            # PollWork, under the service lock, is where the victim reports
            # its tasks finished and takes new ones: the check runs at every
            # such step, and the main thread kills once it passes (the
            # victim has finished a task under load and holds a task of a
            # job in flight beside another)
            out = poll_work(req)
            eid = req.get("executor_id")
            if killed.is_set():
                return out
            jobs = service.scheduler.task_manager.jobs
            flight = _jobs_in_flight(service)
            load = {jid: _tasks_on(g, eid) for jid, g in jobs.items()
                    if jid not in warm_jobs}
            hit = {jid: tasks for jid, tasks in load.items()
                   if tasks and jid in flight}
            done = any(state == "successful" for tasks in load.values()
                       for _, state in tasks)
            if done and hit and len(flight) >= 2:
                kill.update(victim=eid, jobs=hit, in_flight=len(flight))
                killed.set()
            return out

        threads = [threading.Thread(target=client_thread, args=(c,))
                   for c in range(args.clients)] if not failures else []
        if args.kill_one:
            service.poll_work = poll_then_kill
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads) and not killed.wait(0.01):
            pass
        killed_at, victim_jobs, expiry_s = None, kill.get("jobs", {}), None
        if killed.is_set():
            victim = kill["victim"]
            next(w for w in workers if w.eid == victim).kill()
            killed_at = time.perf_counter() - t0
            print(f"# killed {victim} (SIGKILL) at {killed_at:.3f} s, "
                  f"{kill['in_flight']} jobs in flight, {len(victim_jobs)} "
                  f"with a task on it", flush=True)
        while killed_at is not None and expiry_s is None and \
                time.perf_counter() - t0 - killed_at < 10 * EXPIRY_S:
            with service.lock:
                gone = victim not in \
                    service.scheduler.executor_manager.executors
            if gone:
                expiry_s = time.perf_counter() - t0 - killed_at
            time.sleep(0.01)
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0

        failures += [f"request {r[2]}" for r in results if r[2]]
        summaries = {r[1]: _job_summary(service, r[1]) for r in results
                     if r[1] is not None}
        for job_id in warm_jobs:
            if job_id is not None:
                summaries[job_id] = _job_summary(service, job_id)
        survivors = {w.eid for w in workers} - {kill.get("victim")}
        launches = sum((s["launches"] for s in summaries.values()),
                       np.zeros(2, dtype=np.int64))
        survivor_launches = sum(
            (s["launches"] for s in summaries.values()
             if set(s["executors"]) <= survivors),
            np.zeros(2, dtype=np.int64))
        victims = [{"job_id": jid,
                    "query": next((r[0] for r in results if r[1] == jid),
                                  None),
                    "tasks_at_kill": tasks,
                    "state": summaries[jid]["state"],
                    "final_executors": summaries[jid]["final_executors"]}
                   for jid, tasks in victim_jobs.items()]
        if args.kill_one and killed_at is None and not failures:
            failures.append("no executor ran a task of a job in flight beside "
                            "another before the load ended: nothing killed")
        if killed_at is not None:
            if expiry_s is None:
                failures.append(f"the scheduler kept {victim} registered "
                                f"{10 * EXPIRY_S} s after the kill")
            if not any(v["state"] == "successful" and v["final_executors"]
                       and set(v["final_executors"]) <= survivors
                       for v in victims):
                failures.append(f"no job with a task on {victim} finished "
                                f"on the survivors: {victims}")
        if args.device == "cuda" and not failures \
                and survivor_launches.sum() < 1:
            failures.append("the survivors' task metrics report no kernel "
                            "launch")
        lats = sorted(r[3] for r in results) or [float("nan")]
        executor_tables = {w.eid: w.tables() for w in workers}
        stages_run = {w.eid: sum(s["stage_executors"].count(w.eid)
                                 for jid, s in summaries.items()
                                 if jid not in warm_jobs)
                      for w in workers}
        report = {
            "clients": args.clients, "requests_per_client": args.requests,
            "workers": args.workers, "killed_one": killed_at is not None,
            "total_queries": len(results),
            "correct": sum(1 for r in results if not r[2]),
            "wall_s": wall, "jobs_per_s": len(results) / wall,
            "p50_s": lats[len(lats) // 2],
            "p95_s": lats[int(len(lats) * 0.95)], "max_s": lats[-1],
            "device": args.device, "sf": args.sf,
            "partitions": args.partitions, "startup_s": startup_s,
            "warmup_s": warmup_s, "killed_at_s": killed_at,
            "victim": kill.get("victim"),
            "victim_jobs": victims, "expiry_s": expiry_s,
            "kernel_launches": launches.tolist(),
            "survivor_launches": survivor_launches.tolist(),
            "executor_tables": executor_tables,
            "stages_run_per_executor": stages_run,
            "expected": {k: report_rows(v) for k, v in exp.items()},
            "failures": failures, "ok": not failures}
    except Exception as e:  # noqa: BLE001 - reported, then exit code 1
        tails = {w.eid: w.lines[-10:] for w in workers}
        report = {"ok": False,
                  "failures": failures + [f"{type(e).__name__}: {e}"],
                  "executor_output": tails}
    finally:
        for w in workers:
            w.kill()
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if own_cache:
            os.environ.pop("BALLISTA_TPCH_CACHE", None)
        shutil.rmtree(work_dir, ignore_errors=True)
    print(json.dumps(report), flush=True)
    return report


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
