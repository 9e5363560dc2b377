"""h2o db-benchmark harness (groupby + join), port of
ballista_tpu/benchmarks/h2o.py.

Reference parity: `benchmarks/db-benchmark/{groupby,join}-datafusion.py` —
the standard 10 groupby and 5 join questions over the G1/J1 synthetic
datasets, timed per question. Data is generated in-process (the upstream
benchmark's R generator layout: id1-3 low-cardinality strings, id4-6
ints, v1-3 values; join x/small/medium/large tables keyed on id1/id2/id3)
as dicts of numpy arrays: the same generator calls in the same order as
the JAX package's, so a seed gives the same rows, and no pyarrow.

Usage:
  python -m ballista_tpu_torch.benchmarks.h2o --task groupby --n 1e7
  python -m ballista_tpu_torch.benchmarks.h2o --task join --n 1e6
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def id_strings(ids: np.ndarray, hi: int, width: int) -> np.ndarray:
    """"id<k>" for every k of `ids` (1..hi): what np.char.add("id",
    ids.astype("U<width>")) gives, through the `hi` distinct strings
    instead of one string conversion per row."""
    names = np.char.add("id", np.arange(1, hi + 1).astype(f"U{width}"))
    return names[ids - 1]


def groupby_table(n: int, k: int = 100, seed: int = 42) -> dict:
    """G1 dataset: N rows, K id1/id2 groups, N/K id3 groups."""
    rng = np.random.default_rng(seed)
    nk = max(n // k, 1)
    return {
        "id1": id_strings(rng.integers(1, k + 1, n), k, 8),
        "id2": id_strings(rng.integers(1, k + 1, n), k, 8),
        "id3": id_strings(rng.integers(1, nk + 1, n), nk, 12),
        "id4": rng.integers(1, k + 1, n),
        "id5": rng.integers(1, k + 1, n),
        "id6": rng.integers(1, nk + 1, n),
        "v1": rng.integers(1, 6, n),
        "v2": rng.integers(1, 16, n),
        "v3": np.round(rng.uniform(0, 100, n), 6),
    }


GROUPBY_QUERIES = {
    1: "SELECT id1, SUM(v1) AS v1 FROM x GROUP BY id1",
    2: "SELECT id1, id2, SUM(v1) AS v1 FROM x GROUP BY id1, id2",
    3: "SELECT id3, SUM(v1) AS v1, AVG(v3) AS v3 FROM x GROUP BY id3",
    4: "SELECT id4, AVG(v1) AS v1, AVG(v2) AS v2, AVG(v3) AS v3 FROM x "
       "GROUP BY id4",
    5: "SELECT id6, SUM(v1) AS v1, SUM(v2) AS v2, SUM(v3) AS v3 FROM x "
       "GROUP BY id6",
    6: "SELECT id4, id5, approx_percentile_cont(v3, 0.5) AS median_v3, "
       "stddev(v3) AS stddev_v3 FROM x GROUP BY id4, id5",
    7: "SELECT id3, MAX(v1) - MIN(v2) AS range_v1_v2 FROM x GROUP BY id3",
    8: "SELECT id6, v3 FROM (SELECT id6, v3, row_number() OVER "
       "(PARTITION BY id6 ORDER BY v3 DESC) AS rn FROM x) t WHERE rn <= 2",
    9: "SELECT id2, id4, corr(v1, v2) AS corr FROM x GROUP BY id2, id4",
    10: "SELECT id1, id2, id3, id4, id5, id6, SUM(v3) AS v3, COUNT(*) AS "
        "cnt FROM x GROUP BY id1, id2, id3, id4, id5, id6",
}


def join_tables(n: int, seed: int = 42) -> dict:
    """J1 datasets: x (N rows) + small (N/1e6), medium (N/1e3), large (N)."""
    rng = np.random.default_rng(seed)

    def ids(m, hi):
        return rng.integers(1, hi + 1, m)

    n_small = max(n // 10**6, 10)
    n_medium = max(n // 10**3, 100)
    x = {
        "id1": ids(n, n_small), "id2": ids(n, n_medium), "id3": ids(n, n),
        "id4": id_strings(ids(n, n_small), n_small, 8),
        "id5": id_strings(ids(n, n_medium), n_medium, 8),
        "id6": id_strings(ids(n, n), n, 10),
        "v1": np.round(rng.uniform(0, 100, n), 6),
    }
    small = {
        "id1": np.arange(1, n_small + 1),
        "id4": id_strings(np.arange(1, n_small + 1), n_small, 8),
        "v2": np.round(rng.uniform(0, 100, n_small), 6),
    }
    medium = {
        "id1": ids(n_medium, n_small),
        "id2": np.arange(1, n_medium + 1),
        "id4": id_strings(ids(n_medium, n_small), n_small, 8),
        "id5": id_strings(np.arange(1, n_medium + 1), n_medium, 8),
        "v2": np.round(rng.uniform(0, 100, n_medium), 6),
    }
    large = {
        "id1": ids(n, n_small), "id2": ids(n, n_medium),
        "id3": np.arange(1, n + 1),
        "id4": id_strings(ids(n, n_small), n_small, 8),
        "id5": id_strings(ids(n, n_medium), n_medium, 8),
        "id6": id_strings(np.arange(1, n + 1), n, 10),
        "v2": np.round(rng.uniform(0, 100, n), 6),
    }
    return {"x": x, "small": small, "medium": medium, "large": large}


JOIN_QUERIES = {
    1: "SELECT x.id1, x.id2, x.id3, x.id4 AS xid4, small.id4 AS smallid4, "
       "x.id5, x.id6, x.v1, small.v2 FROM x INNER JOIN small ON "
       "x.id1 = small.id1",
    2: "SELECT x.id1 AS xid1, medium.id1 AS mediumid1, x.id2, x.id3, "
       "x.id4 AS xid4, medium.id4 AS mediumid4, x.id5 AS xid5, "
       "medium.id5 AS mediumid5, x.id6, x.v1, medium.v2 FROM x "
       "INNER JOIN medium ON x.id2 = medium.id2",
    3: "SELECT x.id1 AS xid1, medium.id1 AS mediumid1, x.id2, x.id3, "
       "x.id4 AS xid4, medium.id4 AS mediumid4, x.id5 AS xid5, "
       "medium.id5 AS mediumid5, x.id6, x.v1, medium.v2 FROM x "
       "LEFT JOIN medium ON x.id2 = medium.id2",
    4: "SELECT x.id1 AS xid1, medium.id1 AS mediumid1, x.id2, x.id3, "
       "x.id4 AS xid4, medium.id4 AS mediumid4, x.id5 AS xid5, "
       "medium.id5 AS mediumid5, x.id6, x.v1, medium.v2 FROM x "
       "LEFT JOIN medium ON x.id5 = medium.id5",
    5: "SELECT x.id1 AS xid1, large.id1 AS largeid1, x.id2 AS xid2, "
       "large.id2 AS largeid2, x.id3, x.id4 AS xid4, large.id4 AS largeid4, "
       "x.id5 AS xid5, large.id5 AS largeid5, x.id6 AS xid6, "
       "large.id6 AS largeid6, x.v1, large.v2 FROM x LEFT JOIN large ON "
       "x.id3 = large.id3",
}


def run(task: str, n: int, iterations: int = 2, queries=None):
    """Register the task's tables on the card, then time every question:
    one run to warm up, then `iterations` timed runs of
    `ctx.sql(text).collect()` with the device drained around each."""
    import torch

    from ..client import SessionContext

    ctx = SessionContext()
    print(f"# device {torch.cuda.get_device_name(0)}", file=sys.stderr)
    t0 = time.time()
    if task == "groupby":
        ctx.register_numpy("x", groupby_table(n))
        qset = GROUPBY_QUERIES
    else:
        for name, tbl in join_tables(n).items():
            ctx.register_numpy(name, tbl)
        qset = JOIN_QUERIES
    print(f"# datagen + ingest {time.time() - t0:.1f}s", file=sys.stderr)

    results = {}
    for q in (queries or sorted(qset)):
        out, _ = ctx.sql(qset[q]).collect()
        torch.cuda.synchronize()
        times = []
        for _ in range(iterations):
            t0 = time.perf_counter()
            out, _ = ctx.sql(qset[q]).collect()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1000)
        rows = int(out.num_rows)
        results[q] = {"ms": round(sum(times) / len(times), 3), "rows": rows}
        print(f"{task} q{q}  {results[q]['ms']:10.3f} ms  ({rows} rows)",
              flush=True)
    total = sum(r["ms"] for r in results.values())
    print(json.dumps({"task": task, "n": n, "total_ms": round(total, 3),
                      "queries": results}))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--task", choices=["groupby", "join"], default="groupby")
    ap.add_argument("--n", type=float, default=1e6)
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--queries", default=None)
    args = ap.parse_args(argv)
    queries = ([int(x) for x in args.queries.split(",")]
               if args.queries else None)
    run(args.task, int(args.n), args.iterations, queries)


if __name__ == "__main__":
    main()
