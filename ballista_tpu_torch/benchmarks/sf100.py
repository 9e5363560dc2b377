"""The TPC-H sweep at SF100 (port of scripts/sf100_sweep.py): out-of-core
execution over chunked parquet datasets, each answer checked by invariants.

At SF100 (lineitem 600M rows) no oracle answers, so each query's saved
result is held to invariants, as the reference's sweep does:

- exact row counts where the query fixes them (`FIXED_ROWS`: top-k LIMITs,
  closed group domains);
- ratios to the port's own answer at SF10 over a chunked dataset of the
  same layout (`sf10_pass`, where each answer is also held exactly against
  the serial runtime's): additive columns land at 8-12x (`ADDITIVE`),
  ratios of per-row draws at 0.9-1.1x (`RATIO_1X`), saturated group
  domains at the same row count (`SATURATED_ROWS`);
- Q1 and Q6 exactly against a streaming numpy reference over the part
  files (`numpy_q1`, `numpy_q6`), independent of the engine.

Departures from the reference's sweep: an additive query checks every sum
and count column named in `ADDITIVE`, not only the first numeric column
(that check passed a Q1 whose `sum_charge` had wrapped past 2^63, since
`sum_qty` came first); Q17's `avg_yearly` is a sum over a share of the
parts (/ 7.0), so it is additive, not a ratio.

Each query runs in its own process (`python -m
ballista_tpu_torch.benchmarks.sf100 --worker ...`), through
`runner.run(ctx=..., lazy_ingest=True)` with routing on, and saves its
result as parquet; the worker prints one JSON line of its route, serial
partitions, first-run s, peak device and host memory, bytes each way and
the routing estimate. pyarrow reads the saved results; pandas is not used.

Run (the card; SF10 and SF100 written by `datagen --chunks`):
  python -m ballista_tpu_torch.benchmarks.sf100 --sf100-dir D100 \\
      --sf10-dir D10 --out DIR [--queries 1,6]
"""

from __future__ import annotations

import argparse
import datetime
import decimal
import glob
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# output row counts the query fixes at any scale factor >= 1
FIXED_ROWS = {1: 4, 2: 100, 3: 10, 4: 5, 5: 5, 6: 1, 7: 4, 8: 2, 9: 175,
              10: 20, 12: 2, 14: 1, 15: 1, 17: 1, 18: 100, 19: 1, 21: 100,
              22: 7}
# additive queries: every column named here sums to 8-12x its SF10 total
ADDITIVE = {1: ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge",
                "count_order"),
            4: ("order_count",), 6: ("revenue",), 7: ("revenue",),
            12: ("high_line_count", "low_line_count"), 13: ("custdist",),
            17: ("avg_yearly",), 22: ("numcust", "totacctbal")}
# ratios of per-row draws: 0.9-1.1x their SF10 value
RATIO_1X = {14: ("promo_revenue",)}
# group domains saturated at SF >= 10: the SF10 row count
SATURATED_ROWS = {16}
SCALE = (8.0, 12.0)
RATIO = (0.9, 1.1)

_EPOCH = datetime.date(1970, 1, 1)


def _days(iso: str) -> int:
    return (datetime.date.fromisoformat(iso) - _EPOCH).days


# ---------------------------------------------------------------------------
# the worker: one query in this process
# ---------------------------------------------------------------------------

def run_one(q: int, dataset_dir: str, save_dir: str, device: str = "cuda",
            serial_check: int = 0) -> dict:
    """Query q over the datasets under `dataset_dir`, routed as `collect()`
    routes it, its result saved to `save_dir/q{q}.parquet`. With
    `serial_check` N the answer is also computed on the serial runtime
    over N partitions and held equal to it exactly."""
    import resource

    import torch

    from .. import batch as B
    from ..client.context import rebind_scans
    from ..exec import memory
    from . import runner
    from .queries import TPCH_QUERIES

    from ..scheduler.serial import execute_serial
    ctx, _ = runner._context(0, device, dataset_dir=dataset_dir)
    cuda = ctx.device.type == "cuda"
    serial_runs = []
    real_serial = runner._run_serial

    def once(ctx_, plan_, n_parts, t0):
        # the runner's serial path, run once: its timed second pass would
        # double minutes of host copies at SF100; `ms` is the first run's
        serial_runs.append(n_parts)
        out, schema = execute_serial(ctx_, plan_, n_parts)
        runner._sync(ctx_.device)
        first_s = time.perf_counter() - t0
        return first_s, first_s, out, schema

    runner._run_serial = once
    try:
        t0 = time.perf_counter()
        plan = ctx.sql(TPCH_QUERIES[q]).plan
        est = memory.estimate_plan_hbm(
            ctx.physical_plan(rebind_scans(plan, ctx)))
        route = ctx.serial_route(plan)
        plan_s = time.perf_counter() - t0
        ctx.take_warnings()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        res = dict(runner.run(queries=[q], iterations=1, lazy_ingest=True,
                              save_results=save_dir, ctx=ctx,
                              device=device)[q])
    finally:
        runner._run_serial = real_serial
    res["plan_s"] = round(plan_s, 3)
    res["estimate_bytes"] = int(est)
    res["route"] = ("in-core" if not serial_runs else
                    f"serial@{serial_runs[0]}" if route else
                    f"oom->serial@{serial_runs[0]}")
    res["serial_partitions"] = serial_runs[0] if serial_runs else 0
    if cuda:
        res["peak_allocated"] = torch.cuda.max_memory_allocated()
        res["peak_reserved"] = torch.cuda.max_memory_reserved()
        if not serial_runs and res["peak_allocated"]:
            res["estimate_over_peak"] = round(est / res["peak_allocated"], 3)
    res["host_peak_rss"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    if serial_runs:
        res["bytes_up"] = sum(m.bytes_to_device for m in ctx.serial_metrics)
        res["bytes_down"] = sum(m.bytes_to_host for m in ctx.serial_metrics)
    else:
        res["bytes_up"] = sum(t.numel() * t.element_size()
                              for tp in ctx.tables.values()
                              for c in tp._cols.values()
                              for t in (c.data, c.validity))
        res["bytes_down"] = 0
    res["parquet_bytes_read"] = sum(getattr(tp, "read_bytes", 0)
                                    for tp in ctx.tables.values())
    res["metadata_s"] = {f"{name}.{col}": round(sec, 3)
                         for name, tp in ctx.tables.items()
                         for col, sec in getattr(tp, "meta_seconds",
                                                 {}).items() if sec >= 1}
    res["warnings"] = ctx.take_warnings()
    if serial_check and "error" not in res:
        ctx.evict_device()
        out, schema = execute_serial(ctx, plan, serial_check)
        import pyarrow.parquet as pq
        saved = pq.read_table(os.path.join(save_dir, f"q{q}.parquet"))
        res["serial_equal"] = B.to_arrow(out, schema).equals(saved)
    return res


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

def _column_total(table, name):
    """Exact total of a saved result column (decimal as Decimal)."""
    return sum((v for v in table.column(name).to_pylist() if v is not None),
               decimal.Decimal(0) if "decimal" in str(
                   table.schema.field(name).type) else 0)


def check(q: int, got, ref=None, exact=None) -> dict:
    """The invariants of query q on its saved result `got` (an arrow
    table), against `ref` (the SF10 result) and `exact` (the numpy
    reference's table). Returns {"checks": {name: (ok, detail)},
    "verified": bool or None when nothing was checked}."""
    checks = {}
    if q in FIXED_ROWS:
        checks["rows"] = (got.num_rows == FIXED_ROWS[q],
                          f"{got.num_rows} vs {FIXED_ROWS[q]}")
    if ref is not None:
        for name in ADDITIVE.get(q, ()):
            r = float(_column_total(got, name)) / max(
                float(_column_total(ref, name)), 1e-9)
            checks[f"{name} x10"] = (SCALE[0] <= r <= SCALE[1],
                                     f"ratio {r:.4f}")
        for name in RATIO_1X.get(q, ()):
            r = float(_column_total(got, name)) / max(
                float(_column_total(ref, name)), 1e-9)
            checks[f"{name} x1"] = (RATIO[0] <= r <= RATIO[1],
                                    f"ratio {r:.4f}")
        if q in SATURATED_ROWS:
            checks["saturated rows"] = (got.num_rows == ref.num_rows,
                                        f"{got.num_rows} vs SF10 "
                                        f"{ref.num_rows}")
    if exact is not None:
        same = got.select(exact.column_names).cast(exact.schema).equals(
            exact)
        checks["exact vs numpy"] = (same, "equal" if same else
                                    f"got {got.to_pylist()} want "
                                    f"{exact.to_pylist()}")
    return {"checks": {k: [bool(ok), d] for k, (ok, d) in checks.items()},
            "verified": all(ok for ok, _ in checks.values())
            if checks else None}


# ---------------------------------------------------------------------------
# the streaming numpy reference (Q1, Q6): int64 per part file, Python ints
# across them
# ---------------------------------------------------------------------------

def _lineitem_files(dataset_dir: str):
    files = sorted(glob.glob(os.path.join(dataset_dir, "lineitem",
                                          "*.parquet")))
    if not files:
        raise FileNotFoundError(f"no lineitem part files under {dataset_dir}")
    return files


def _numeric(col) -> np.ndarray:
    """A non-null arrow column as numpy: decimals as scaled int64 (their
    low 64 bits), dates as days."""
    import pyarrow as pa
    arr = col.combine_chunks() if isinstance(col, pa.ChunkedArray) else col
    if arr.null_count:
        raise ValueError("the reference expects TPC-H's non-null columns")
    if pa.types.is_decimal(arr.type):
        limbs = np.frombuffer(arr.buffers()[1], dtype=np.int64)
        return limbs.reshape(-1, 2)[arr.offset:arr.offset + len(arr), 0]
    if pa.types.is_date32(arr.type):
        return np.asarray(arr.cast(pa.int32()))
    return np.asarray(arr)


def _q1_file(path: str) -> dict:
    """{(returnflag, linestatus): [sum_qty, sum_base_price,
    sum_disc_price, sum_charge, sum_disc, count]} of one part file, each an
    int64 sum (a file's totals fit) as a Python int."""
    import pyarrow.parquet as pq
    t = pq.read_table(path, columns=[
        "l_returnflag", "l_linestatus", "l_quantity", "l_extendedprice",
        "l_discount", "l_tax", "l_shipdate"],
        read_dictionary=["l_returnflag", "l_linestatus"])
    t = t.unify_dictionaries()
    keep = _numeric(t.column("l_shipdate")) <= _days("1998-09-02")
    flag = t.column("l_returnflag").combine_chunks()
    status = t.column("l_linestatus").combine_chunks()
    qty, price, disc, tax = (_numeric(t.column(c)) for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    fi = np.asarray(flag.indices)
    si = np.asarray(status.indices)
    fd, sd = flag.dictionary.to_pylist(), status.dictionary.to_pylist()
    out = {}
    for a in range(len(fd)):
        for b in range(len(sd)):
            m = keep & (fi == a) & (si == b)
            if m.any():
                out[(fd[a], sd[b])] = [int(x[m].sum()) for x in (
                    qty, price, disc_price, charge, disc)] + [int(m.sum())]
    return out


def _avg(total: int, count: int, digits: int) -> int:
    """total / count at `digits` more decimal places, rounded half away
    from zero (the engine's exact decimal average)."""
    num, den = abs(total) * 10 ** digits, count
    q, r = divmod(num, den)
    q += 2 * r >= den
    return q if total >= 0 else -q


def numpy_q1(dataset_dir: str, workers: int = 8):
    """Q1 over the lineitem part files as an arrow table; decimals are
    decimal128(38, s), to which `check` casts the engine's result (whose
    sum_charge is decimal(18, 6), or decimal(28, 6) where it is wide)."""
    import pyarrow as pa
    with ThreadPoolExecutor(max_workers=workers) as pool:
        parts = list(pool.map(_q1_file, _lineitem_files(dataset_dir)))
    groups = {}
    for part in parts:
        for key, sums in part.items():
            acc = groups.setdefault(key, [0] * 6)
            for i, v in enumerate(sums):
                acc[i] += v
    keys = sorted(groups)
    cols = list(zip(*[groups[k] for k in keys]))
    qty, price, disc_price, charge, disc, count = cols
    # the engine: avg at the argument's scale + 4 (decimal(18, 2) -> 6)
    avg = [[_avg(s, c, 4) for s, c in zip(col, count)]
           for col in (qty, price, disc)]

    return pa.table({
        "l_returnflag": pa.array([k[0] for k in keys]),
        "l_linestatus": pa.array([k[1] for k in keys]),
        "sum_qty": _dec(qty, 2), "sum_base_price": _dec(price, 2),
        "sum_disc_price": _dec(disc_price, 4), "sum_charge": _dec(charge, 6),
        "avg_qty": _dec(avg[0], 6), "avg_price": _dec(avg[1], 6),
        "avg_disc": _dec(avg[2], 6),
        "count_order": pa.array(count, pa.int64())})


def _dec(values, scale: int):
    """Scaled Python ints as decimal128(38, scale)."""
    import pyarrow as pa
    return pa.array([decimal.Decimal(v).scaleb(-scale) for v in values],
                    pa.decimal128(38, scale))


def _q6_file(path: str) -> int:
    import pyarrow.parquet as pq
    t = pq.read_table(path, columns=["l_quantity", "l_extendedprice",
                                     "l_discount", "l_shipdate"])
    ship = _numeric(t.column("l_shipdate"))
    qty, price, disc = (_numeric(t.column(c)) for c in (
        "l_quantity", "l_extendedprice", "l_discount"))
    m = ((ship >= _days("1994-01-01")) & (ship < _days("1995-01-01"))
         & (disc >= 5) & (disc <= 7) & (qty < 2400))
    return int((price[m] * disc[m]).sum())


def numpy_q6(dataset_dir: str, workers: int = 8):
    """Q6 over the lineitem part files: revenue at scale 4."""
    import pyarrow as pa
    with ThreadPoolExecutor(max_workers=workers) as pool:
        total = sum(pool.map(_q6_file, _lineitem_files(dataset_dir)))
    return pa.table({"revenue": _dec([total], 4)})


NUMPY = {1: numpy_q1, 6: numpy_q6}


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def _worker(q: int, dataset_dir: str, save_dir: str, device: str,
            serial_check: int, timeout: int) -> dict:
    """run_one in a process of its own: its last JSON line."""
    cmd = [sys.executable, "-m", "ballista_tpu_torch.benchmarks.sf100",
           "--worker", str(q), "--dataset-dir", dataset_dir,
           "--save", save_dir, "--device", device,
           "--serial-check", str(serial_check)]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    t0 = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout, cwd=REPO, env=env)
        lines = [line for line in p.stdout.splitlines()
                 if line.startswith("{\"q\"")]
        res = (json.loads(lines[-1]) if lines and p.returncode == 0 else
               {"error": f"rc={p.returncode}",
                "tail": (p.stdout + p.stderr)[-2000:]})
    except subprocess.TimeoutExpired:
        res = {"error": f"timeout after {timeout} s"}
    res["wall_s"] = round(time.perf_counter() - t0, 3)
    return res


def sf10_pass(sf10_dir: str, out_dir: str, queries, device="cuda",
              serial_partitions: int = 8, timeout: int = 1800, log=print):
    """The SF10 reference: each query routed as `collect()` routes it, saved
    under out_dir/sf10, and held exactly against the serial runtime's
    answer over `serial_partitions`. Returns {q: result}."""
    save = os.path.join(out_dir, "sf10")
    results = {}
    for q in queries:
        res = _worker(q, sf10_dir, save, device, serial_partitions, timeout)
        res["verified"] = "error" not in res and bool(res.get("serial_equal"))
        results[q] = res
        log(f"sf10 q{q:2d}: {_summary(res)}")
    return results


def sf100_pass(sf100_dir: str, out_dir: str, queries, device="cuda",
               timeout: int = 1800, log=print):
    """The SF100 sweep: each query in its own process, its saved result
    held to the invariants against out_dir/sf10 and, for Q1 and Q6, the
    numpy reference. Returns {q: result}."""
    import pyarrow.parquet as pq
    save = os.path.join(out_dir, "sf100")
    results = {}
    for q in queries:
        res = _worker(q, sf100_dir, save, device, 0, timeout)
        if "error" not in res:
            got = pq.read_table(os.path.join(save, f"q{q}.parquet"))
            ref_path = os.path.join(out_dir, "sf10", f"q{q}.parquet")
            ref = pq.read_table(ref_path) if os.path.exists(ref_path) \
                else None
            exact = NUMPY[q](sf100_dir) if q in NUMPY else None
            res.update(check(q, got, ref, exact))
            if q == 1:
                res["sum_charge"] = [str(v) for v in
                                     got.column("sum_charge").to_pylist()]
        else:
            res["verified"] = False
        results[q] = res
        log(f"sf100 q{q:2d}: {_summary(res)}")
    return results


def _summary(res: dict) -> str:
    if "error" in res:
        return f"ERROR {res['error']} {res.get('tail', '')[-600:]}"
    keys = ("route", "serial_partitions", "compile_s", "ms", "rows",
            "peak_allocated", "peak_reserved", "host_peak_rss", "bytes_up",
            "bytes_down", "parquet_bytes_read", "estimate_over_peak",
            "metadata_s",
            "serial_equal", "checks", "verified", "wall_s")
    return json.dumps({k: res[k] for k in keys if k in res})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--worker", type=int, default=0,
                    help="run one query in this process")
    ap.add_argument("--dataset-dir", help="--worker: the datasets' root")
    ap.add_argument("--save", help="--worker: where results are saved")
    ap.add_argument("--serial-check", type=int, default=0)
    ap.add_argument("--sf100-dir")
    ap.add_argument("--sf10-dir")
    ap.add_argument("--out", default="build/sf100")
    ap.add_argument("--queries", default=None, help="e.g. 1,6,11")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=int, default=1800)
    args = ap.parse_args(argv)
    if args.worker:
        res = run_one(args.worker, args.dataset_dir, args.save, args.device,
                      args.serial_check)
        print(json.dumps({"q": args.worker, **res}, default=str), flush=True)
        return 0
    queries = ([int(x) for x in args.queries.split(",")] if args.queries
               else list(range(1, 23)))
    ten = sf10_pass(args.sf10_dir, args.out, queries, args.device,
                    timeout=args.timeout) if args.sf10_dir else {}
    hundred = sf100_pass(args.sf100_dir, args.out, queries, args.device,
                         timeout=args.timeout)
    ok = all(r.get("verified") is not False and "error" not in r
             for r in list(ten.values()) + list(hundred.values()))
    print(json.dumps({"sf10": ten, "sf100": hundred, "ok": ok},
                     default=str))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
