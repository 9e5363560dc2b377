"""TPC-H benchmark runner (port of ballista_tpu/benchmarks/runner.py; the
reference's `tpch.rs benchmark` analog, with `loadtest` and
`--expected-results`).

Each query is planned and run until its output fits (`ctx.converge`), then
its converged plan is re-run `iterations` times (`run_plan`); on CUDA each
timed window ends in `torch.cuda.synchronize()`. A plan the memory model
routes out-of-core (`SessionContext.serial_route`), or whose in-core run
raises torch.cuda.OutOfMemoryError (`oom_partitions`), runs on the serial
runtime instead, as `collect()` would run it. Prints a line per query and
a JSON summary as the last line.

Environment: BALLISTA_SERIAL_PASSES=1 (a serial run's first pass is its
measurement), BALLISTA_FAULTDUMP=N (every thread's stack to stderr each N
seconds), BALLISTA_ORACLE_CACHE=DIR (`--verify`'s oracle frames kept in
DIR; `--oracle-cache DIR` says the same, and `oracle_pregen` fills it
ahead of a sweep), BALLISTA_TPCH_CACHE=DIR (generated tables kept in DIR,
`datagen.generate_tpch`) and BALLISTA_PIECE_TIMING=1 (the per-piece
profiler of `exec.plan`, which `benchmarks.roofline` reads).

Usage:
  python -m ballista_tpu_torch.benchmarks.runner --sf 1 [--queries 1,3,6] \
      [--iterations 5] [--distributed] [--tbl-dir DIR --expected DIR] \
      [--device cuda]
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import json
import os
import signal
import subprocess
import sys
import time

import torch


class QueryTimeout(Exception):
    pass


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def oracle_paths(cache: str, sf: float, q: int):
    """The cached oracle frame of query q at `sf` and its JSON file."""
    path = os.path.join(cache, f"oracle_sf{sf:g}_q{q}.pkl")
    return path, path + ".json"


def _oracle(q: int, sf: float, pdt, cache: str = None):
    """The oracle's frame for query q and its wall ms. `pdt` is a
    zero-argument callable returning the pandas tables (made once, and
    only where the frame is computed). With a cache directory (`cache`,
    else BALLISTA_ORACLE_CACHE), the frame is kept there as a pickle
    beside a JSON file holding the ms it first took (so `vs_oracle` stays
    the oracle's own time), and read back by later runs at the same
    `sf`."""
    from .oracle import ORACLES
    cache = cache or os.environ.get("BALLISTA_ORACLE_CACHE")
    path = meta = None
    if cache:
        path, meta = oracle_paths(cache, sf, q)
        if os.path.exists(path) and os.path.exists(meta):
            import pandas as pd
            with open(meta) as f:
                ms = json.load(f)["oracle_ms"]
            return pd.read_pickle(path), ms
    tables = pdt()
    t0 = time.perf_counter()
    exp = ORACLES[q](tables)
    ms = (time.perf_counter() - t0) * 1000
    if path:
        os.makedirs(cache, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        exp.to_pickle(tmp)
        os.replace(tmp, path)
        with open(meta, "w") as f:
            json.dump({"oracle_ms": ms}, f)
    return exp, ms


def _context(sf, device, tbl_dir=None, dataset_dir=None):
    """A context on `device` with the TPC-H tables: from a dbgen `.tbl`
    directory, mounted parquet part files, or generated at `sf`. Returns
    (ctx, the generated tables or None)."""
    from ..client import SessionContext
    from ..datagen import TPCH_TABLES, generate_tpch, register_tpch

    ctx = SessionContext(device=device)
    t0 = time.perf_counter()
    data = None
    if dataset_dir:
        for name in TPCH_TABLES:
            d = os.path.join(dataset_dir, name)
            if os.path.isdir(d):
                ctx.register_parquet_dataset(name, d, TPCH_TABLES[name][1])
        print(f"# dataset mount {time.perf_counter() - t0:.1f}s",
              file=sys.stderr)
    elif tbl_dir:
        # dbgen-format ingest (tpch.rs convert-tpch parity)
        from ..datagen.tbl import register_tpch_tbl
        register_tpch_tbl(ctx, tbl_dir)
        print(f"# tbl ingest {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    else:
        data = generate_tpch(sf)
        register_tpch(ctx, sf, data=data)
        print(f"# datagen {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return ctx, data


def _run_serial(ctx, plan, n_parts, t0):
    """(s from t0 to the end of the first run, timed run s, Batch,
    Schema) on the serial runtime: one first run and one timed pass (an
    out-of-core pass re-streams every table shard through host shuffles,
    so it is not repeated `iterations` times). BALLISTA_SERIAL_PASSES=1
    makes the first run the measurement (its time then includes planning,
    and the two numbers are equal)."""
    from ..scheduler.serial import execute_serial
    out, schema = execute_serial(ctx, plan, n_parts)
    _sync(ctx.device)
    first_s = time.perf_counter() - t0
    if int(os.environ.get("BALLISTA_SERIAL_PASSES", "2")) <= 1:
        return first_s, first_s, out, schema
    t0 = time.perf_counter()
    out, schema = execute_serial(ctx, plan, n_parts)
    _sync(ctx.device)
    return first_s, time.perf_counter() - t0, out, schema


def _run_query(ctx, q, iterations, serial, mesh):
    """(first run s including planning, s per timed iteration, Batch,
    Schema) of one query on the path the flags and the router pick."""
    from ..exec.plan import run_plan
    from ..scheduler.runtime import execute_distributed
    from .queries import TPCH_QUERIES

    t0 = time.perf_counter()
    plan = ctx.sql(TPCH_QUERIES[q]).plan
    route_n = serial or (0 if mesh is not None else ctx.serial_route(plan))
    if route_n:
        if not serial:
            print(f"q{q:2d}  auto-routed out-of-core (serial@{route_n})",
                  file=sys.stderr, flush=True)
        return _run_serial(ctx, plan, route_n, t0)
    if mesh is not None:
        # plan and run per call, as a user's repeated query would
        out, schema = execute_distributed(ctx, plan, mesh)
        _sync(ctx.device)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iterations):
            out, schema = execute_distributed(ctx, plan, mesh)
        _sync(ctx.device)
        return first_s, (time.perf_counter() - t0) / iterations, out, schema
    try:
        exec_plan, inputs, out = ctx.converge(plan)
        _sync(ctx.device)
        first_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(iterations):
            out, _overflow = run_plan(exec_plan, inputs)
        _sync(ctx.device)
        return first_s, (time.perf_counter() - t0) / iterations, out, \
            exec_plan.schema
    except torch.cuda.OutOfMemoryError:
        pass
    # out of the except block, so the failed run's tensors can be freed
    n_parts = ctx.oom_partitions(plan)
    print(f"q{q:2d}  in-core OOM; falling back to serial@{n_parts}",
          file=sys.stderr, flush=True)
    return _run_serial(ctx, plan, n_parts, t0)


def _free(ctx) -> None:
    ctx.evict_device()
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def run(sf: float = 1.0, queries=None, iterations: int = 3,
        distributed: bool = False, lazy_ingest: bool = False,
        verify: bool = False, capacity_mode=None, tbl_dir: str = None,
        expected: str = None, query_timeout: int = 0,
        evict_between: bool = False, serial: int = 0,
        dataset_dir: str = None, save_results: str = None,
        device="cuda", mesh=None, ctx=None, oracle_cache: str = None):
    """Run and time the queries; returns {q: {"ms", "compile_s", "rows",
    ...}} (a query that raised records {"error": ...} and the sweep goes
    on, as the reference's tool does). `ms` is the mean warm time per
    iteration and `compile_s` the first run's seconds, planning included.

    Data: `ctx` (a context with the tables registered), else `tbl_dir`
    (dbgen `.tbl` files), `dataset_dir` (parquet part files; pyarrow), or
    generated at `sf`. `expected` diffs each result exactly against
    DIR/answers/q{n}.out (`datagen.tbl.diff_expected`); `verify` against
    the pandas oracle (needs pandas), whose frames `oracle_cache` (else
    BALLISTA_ORACLE_CACHE) keeps (`oracle_pregen` fills it). `distributed`
    runs each query over `mesh` (default: one partition per visible device
    of `device`'s type); `serial` N on the serial runtime over N
    partitions."""
    if capacity_mode is not None:
        raise NotImplementedError(
            "--capacity-mode has no effect in the port: a table's capacity "
            "is its lane-rounded row count (config.py)")
    if iterations < 1:
        raise ValueError("iterations must be at least 1")
    if verify and not expected:
        from .oracle import _pd
        _pd()       # without pandas, raise before any work
    queries = list(queries or range(1, 23))
    data = None
    if ctx is None:
        ctx, data = _context(sf, device, tbl_dir, dataset_dir)
    if not lazy_ingest:
        # the warm pass: every column of every table ingested on the host
        # before the first query; lazy_ingest skips it, so a column is
        # ingested when a query first reads it and the cost lands in that
        # query's compile_s
        t0 = time.perf_counter()
        for tp in ctx.tables.values():
            tp.ensure_meta([f.name for f in tp.fields])
        print(f"# ingest {time.perf_counter() - t0:.1f}s", file=sys.stderr)
    if distributed and mesh is None:
        from ..parallel.mesh import context_mesh
        mesh = context_mesh(ctx.device)
    if not distributed:
        mesh = None

    pdt = None
    if verify and not expected:
        from .oracle import to_pd
        cache = {}

        def pdt():
            # made at the first query's check
            if "v" not in cache:
                t0 = time.perf_counter()
                cache["v"] = to_pd(data if data is not None else ctx.tables)
                print(f"# oracle tables {time.perf_counter() - t0:.1f}s",
                      file=sys.stderr)
            return cache["v"]

    if query_timeout:
        def _alarm(signum, frame):
            raise QueryTimeout(f"query exceeded {query_timeout}s")

        signal.signal(signal.SIGALRM, _alarm)

    from .. import batch as B
    results = {}
    for q in queries:
        if query_timeout:
            signal.alarm(query_timeout)
        out = schema = None
        try:
            compile_s, per_iter, out, schema = _run_query(
                ctx, q, iterations, serial, mesh)
            nrows = int(out.num_rows)
            results[q] = {"ms": round(per_iter * 1000, 3),
                          "compile_s": round(compile_s, 3), "rows": nrows}
            if save_results:
                import pyarrow.parquet as pq
                os.makedirs(save_results, exist_ok=True)
                pq.write_table(B.to_arrow(out, schema),
                               os.path.join(save_results, f"q{q}.parquet"))
            extra = ""
            if expected:
                # exact diff against captured answer files (tpch.rs
                # --expected-results, benchmarks/src/bin/tpch.rs:421-422)
                from ..datagen.tbl import diff_expected
                notes = []
                mismatch = diff_expected((out, schema), expected, q, notes)
                results[q]["match"] = not mismatch
                if notes:
                    results[q]["midpoints"] = notes
                extra = (f"  MISMATCH: {mismatch}" if mismatch
                         else "  [== expected]")
                extra += "".join(f"  ({n})" for n in notes)
            elif verify:
                from .oracle import diff_frames
                got = B.to_pandas(out, schema)
                exp, oracle_ms = _oracle(q, sf, pdt, oracle_cache)
                mismatch = diff_frames(got, exp)
                results[q]["oracle_ms"] = round(oracle_ms, 1)
                results[q]["vs_oracle"] = round(oracle_ms / max(
                    per_iter * 1000, 1e-3), 1)
                results[q]["match"] = not mismatch
                extra = (f"  MISMATCH: {mismatch}" if mismatch else
                         f"  [oracle {oracle_ms:8.1f} ms, "
                         f"{results[q]['vs_oracle']}x]")
            print(f"q{q:2d}  {per_iter * 1000:10.3f} ms   "
                  f"(compile {compile_s:7.3f}s, {nrows} rows){extra}",
                  flush=True)
        except Exception as e:  # noqa: BLE001 - keep benching other queries
            results[q] = {"error": f"{type(e).__name__}: {e}"}
            print(f"q{q:2d}  ERROR {type(e).__name__}: {e}", flush=True)
            if isinstance(e, torch.cuda.OutOfMemoryError):
                # one oversized query must not fail the rest of the sweep
                out = schema = None
                _free(ctx)
        else:
            if evict_between:
                out = schema = None
                _free(ctx)
        finally:
            if query_timeout:
                signal.alarm(0)
    total = sum(r["ms"] for r in results.values() if "ms" in r)
    print(json.dumps({"sf": sf, "total_ms": round(total, 3),
                      "queries": results}))
    return results


def loadtest(sf: float, clients: int, requests: int, queries,
             device="cuda", tbl_dir: str = None, ctx=None, mesh=None):
    """Concurrent-client load test against a StandaloneCluster
    (`tpch.rs loadtest ballista`, benchmarks/src/bin/tpch.rs:454 parity):
    each client thread submits `requests` queries round-robin through the
    scheduler's control plane; reports throughput and latency
    percentiles. `ctx` is a context with the tables registered, else they
    are read from `tbl_dir` or generated at `sf`."""
    import threading

    from ..scheduler.standalone import StandaloneCluster
    from .queries import TPCH_QUERIES

    if ctx is None:
        ctx, _ = _context(sf, device, tbl_dir)
    cluster = StandaloneCluster(ctx, mesh)
    # plan and run each distinct query once before the clock starts
    for q in queries:
        cluster.collect_sql(TPCH_QUERIES[q])
    _sync(ctx.device)

    latencies = []
    lock = threading.Lock()
    # the scheduler pump and the device are serial resources in-process;
    # the submit lock models the single-controller frontier (queueing
    # latency is part of what the load test measures)
    submit = threading.Lock()
    errors = []

    def client(cid: int):
        try:
            for i in range(requests):
                q = queries[(cid + i) % len(queries)]
                t0 = time.perf_counter()
                with submit:
                    batch, _ = cluster.collect_sql(TPCH_QUERIES[q])
                    int(batch.num_rows)
                dt = time.perf_counter() - t0
                with lock:
                    latencies.append(dt)
        except Exception as e:  # noqa: BLE001 - raised in the caller
            errors.append(e)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    latencies.sort()
    n = len(latencies)
    out = {"clients": clients, "requests_per_client": requests,
           "total_queries": n, "wall_s": round(wall, 3),
           "qps": round(n / wall, 2),
           "p50_ms": round(latencies[n // 2] * 1000, 3),
           "p95_ms": round(latencies[int(n * 0.95)] * 1000, 3),
           "max_ms": round(latencies[-1] * 1000, 3)}
    print(json.dumps(out))
    return out


def run_isolated(sf: float, queries, iterations: int, distributed: bool,
                 per_query_timeout: int, verify: bool = False,
                 device="cuda", tbl_dir: str = None, expected: str = None,
                 serial: int = 0, lazy_ingest: bool = False,
                 dataset_dir: str = None, oracle_cache: str = None):
    """Each query in its own process with a hard timeout, so one
    pathological query cannot take the whole sweep's budget (the
    reference's tpch.rs runs queries in one process). `oracle_cache`
    reaches every process as BALLISTA_ORACLE_CACHE (the sweep's
    `--oracle-cache`, scripts/sf10_sweep.py:41-43), so `verify` reads the
    frames `oracle_pregen` wrote instead of computing them per process."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    if oracle_cache:
        env["BALLISTA_ORACLE_CACHE"] = oracle_cache
    results = {}
    for q in queries:
        cmd = [sys.executable, "-m", "ballista_tpu_torch.benchmarks.runner",
               "--sf", str(sf), "--queries", str(q),
               "--iterations", str(iterations), "--device", str(device)]
        for flag, value in (("--distributed", distributed),
                            ("--verify", verify),
                            ("--lazy-ingest", lazy_ingest)):
            if value:
                cmd.append(flag)
        for flag, value in (("--tbl-dir", tbl_dir), ("--expected", expected),
                            ("--serial", serial),
                            ("--dataset-dir", dataset_dir)):
            if value:
                cmd += [flag, str(value)]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=per_query_timeout, env=env)
            lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
            if not lines:
                raise RuntimeError(f"exit {out.returncode}: "
                                   f"{out.stderr.strip()[-500:]}")
            results[q] = json.loads(lines[-1])["queries"][str(q)]
            print(out.stdout.splitlines()[0], flush=True)
        except subprocess.TimeoutExpired:
            results[q] = {"error": f"timeout>{per_query_timeout}s"}
            print(f"q{q:2d}  TIMEOUT >{per_query_timeout}s", flush=True)
        except Exception as e:  # noqa: BLE001
            results[q] = {"error": f"{type(e).__name__}: {e}"}
            print(f"q{q:2d}  ERROR {type(e).__name__}: {e}", flush=True)
    total = sum(r["ms"] for r in results.values() if "ms" in r)
    print(json.dumps({"sf": sf, "total_ms": round(total, 3),
                      "queries": results}))
    return results


def _parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--queries", default=None,
                    help="comma-separated query numbers (default: all)")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--distributed", action="store_true")
    ap.add_argument("--lazy-ingest", action="store_true",
                    help="skip the warm ingest pass: each column is ingested "
                    "when a query first reads it")
    ap.add_argument("--isolate", type=int, default=None, metavar="SECONDS",
                    help="run each query in a subprocess with this timeout")
    ap.add_argument("--query-timeout", type=int, default=0, metavar="SECONDS",
                    help="in-process SIGALRM per-query timeout (keeps table "
                         "uploads shared, unlike --isolate)")
    ap.add_argument("--serial", type=int, default=0, metavar="N",
                    help="out-of-core: run each query partition by "
                         "partition over N partitions on one device "
                         "(scheduler/serial.py)")
    ap.add_argument("--evict-between", action="store_true",
                    help="free device columns after every query (host "
                         "columns are kept and re-upload on use)")
    ap.add_argument("--tbl-dir", default=None,
                    help="ingest dbgen .tbl files from this directory "
                         "instead of the native datagen")
    ap.add_argument("--dataset-dir", default=None,
                    help="mount chunked parquet part files as out-of-core "
                         "tables (pyarrow); pair with --serial N")
    ap.add_argument("--save-results", default=None, metavar="DIR",
                    help="write each query's result rows to DIR/q{n}.parquet")
    ap.add_argument("--expected", default=None, metavar="DIR",
                    help="EXACT-diff results vs DIR/answers/q{n}.out "
                         "(tpch.rs --expected-results parity)")
    ap.add_argument("--verify", action="store_true",
                    help="diff results against the pandas oracle and "
                         "record its per-query time as the baseline")
    ap.add_argument("--oracle-cache", default=None, metavar="DIR",
                    help="keep and read --verify's oracle frames in DIR "
                         "(BALLISTA_ORACLE_CACHE; with --isolate, passed to "
                         "every process; `oracle_pregen` fills it)")
    ap.add_argument("--capacity-mode", default=None,
                    choices=("exact", "bucket"),
                    help="(has no effect in the port: raises)")
    ap.add_argument("--loadtest", default=None, metavar="CLIENTSxREQUESTS",
                    help="e.g. 4x8: 4 concurrent clients, 8 requests each")
    ap.add_argument("--device", default="cuda",
                    help="the device the queries run on (default cuda)")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    queries = ([int(x) for x in args.queries.split(",")] if args.queries
               else list(range(1, 23)))
    if os.environ.get("BALLISTA_FAULTDUMP"):
        # every thread's stack to stderr each N seconds: where a long
        # unattended sweep stalls
        faulthandler.dump_traceback_later(
            int(os.environ["BALLISTA_FAULTDUMP"]), repeat=True)
        try:
            return _main(args, queries)
        finally:
            faulthandler.cancel_dump_traceback_later()
    return _main(args, queries)


def _main(args, queries):
    if args.loadtest:
        c, r = args.loadtest.lower().split("x")
        return loadtest(args.sf, int(c), int(r), queries, device=args.device,
                        tbl_dir=args.tbl_dir)
    if args.isolate:
        return run_isolated(args.sf, queries, args.iterations,
                            args.distributed, args.isolate,
                            verify=args.verify, device=args.device,
                            tbl_dir=args.tbl_dir, expected=args.expected,
                            serial=args.serial, lazy_ingest=args.lazy_ingest,
                            dataset_dir=args.dataset_dir,
                            oracle_cache=args.oracle_cache)
    return run(args.sf, queries, args.iterations, args.distributed,
               lazy_ingest=args.lazy_ingest, verify=args.verify,
               capacity_mode=args.capacity_mode, tbl_dir=args.tbl_dir,
               expected=args.expected, query_timeout=args.query_timeout,
               evict_between=args.evict_between, serial=args.serial,
               dataset_dir=args.dataset_dir, save_results=args.save_results,
               device=args.device, oracle_cache=args.oracle_cache)


if __name__ == "__main__":
    main()
