"""NYC taxi benchmark (reference parity: `benchmarks/src/bin/nyctaxi.rs`),
port of ballista_tpu/benchmarks/nyctaxi.py.

Runs the reference's query set over yellow-tripdata CSVs (pass --path;
needs pyarrow) or a synthetic tripdata table of --n rows (same schema,
nyctaxi.rs:137-158), made as a dict of numpy arrays by the same generator
calls in the same order as the JAX package's.

Usage:
  python -m ballista_tpu_torch.benchmarks.nyctaxi [--path dir_or_csv] [--n 1e6]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

QUERIES = {
    # nyctaxi.rs:104
    "fare_amt_by_passenger":
        "SELECT passenger_count, MIN(fare_amount), MAX(fare_amount), "
        "SUM(fare_amount) FROM tripdata GROUP BY passenger_count",
}


def _as_strings(values: np.ndarray, dtype: str) -> np.ndarray:
    """values.astype(dtype) through the distinct values: one string
    conversion per distinct value instead of one per row."""
    uniq, inv = np.unique(values, return_inverse=True)
    return uniq.astype(dtype)[inv.reshape(-1)]


def synthetic_tripdata(n: int, seed: int = 42) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "VendorID": _as_strings(rng.integers(1, 3, n), "U2"),
        "passenger_count": rng.integers(0, 7, n).astype(np.int32),
        "trip_distance": _as_strings(np.round(rng.exponential(3.0, n), 2),
                                     "U8"),
        "payment_type": _as_strings(rng.integers(1, 5, n), "U2"),
        "fare_amount": np.round(rng.gamma(2.0, 8.0, n), 2),
        "tip_amount": np.round(rng.exponential(2.0, n), 2),
        "total_amount": np.round(rng.gamma(2.0, 10.0, n), 2),
    }


def run(path: str | None, n: int, iterations: int = 3):
    import torch

    from ..client import SessionContext

    ctx = SessionContext()
    print(f"# device {torch.cuda.get_device_name(0)}", file=sys.stderr)
    t0 = time.time()
    if path:
        files = ([path] if os.path.isfile(path)
                 else sorted(glob.glob(os.path.join(path, "*.csv"))))
        import pyarrow as pa
        import pyarrow.csv as pacsv
        ctx.register_arrow("tripdata", pa.concat_tables(
            [pacsv.read_csv(f) for f in files]))
    else:
        ctx.register_numpy("tripdata", synthetic_tripdata(n))
    print(f"# ingest {time.time() - t0:.1f}s", file=sys.stderr)

    results = {}
    for name, sql in QUERIES.items():
        out, _ = ctx.sql(sql).collect()
        torch.cuda.synchronize()
        times = []
        for _ in range(iterations):
            t0 = time.perf_counter()
            out, _ = ctx.sql(sql).collect()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        rows = int(out.num_rows)
        results[name] = {"ms": round(sum(times) / len(times), 3),
                         "rows": rows}
        print(f"{name}  {results[name]['ms']:10.3f} ms  ({rows} rows)",
              flush=True)
    print(json.dumps({"n": n if not path else None, "queries": results}))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", default=None,
                    help="CSV file or directory of yellow-tripdata CSVs")
    ap.add_argument("--n", type=float, default=1e6,
                    help="synthetic rows when no --path")
    ap.add_argument("--iterations", type=int, default=3)
    args = ap.parse_args(argv)
    run(args.path, int(args.n), args.iterations)


if __name__ == "__main__":
    main()
