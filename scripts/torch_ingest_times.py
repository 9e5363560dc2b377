"""Seconds `ballista_tpu_torch.batch.ingest_column` takes on the string
columns of h2o's G1_1e7_1e2_0_0 (id1, id2, id3) and of J1_1e7's table x
(id4, id5, id6), generated as chip_smoke.py phase 11 generates them
(seed 42), and seconds `batch._sorted_distinct` takes on the same values
(the sort of a sorted ingest, and of a RAW column's recode at its first
use as a key), each the median of --reps runs. With --root, the port is
imported from that checkout instead of this one, so that two trees can
be timed on one host, each in a process of its own:

    python3 scripts/torch_ingest_times.py [--root DIR] [--reps 3] [--n N]

One JSON line per column: {"tree", "table", "column", "dtype", "rows",
"seconds": [...], "median_s", "kind": "sorted" | "raw" | error name,
"dictionary", "sort_s": [...], "sort_median_s", "distinct"}. Both are
host work: the card is not used.
"""

import argparse
import json
import os
import statistics
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--n", type=int, default=10 ** 7)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from ballista_tpu_torch import batch
    from ballista_tpu_torch.benchmarks import h2o

    groupby = h2o.groupby_table(args.n, 100, 42)
    x = h2o.join_tables(args.n, 42)["x"]
    columns = [("G1", name, groupby[name]) for name in ("id1", "id2", "id3")]
    columns += [("J1.x", name, x[name]) for name in ("id4", "id5", "id6")]
    del groupby
    for table, name, values in columns:
        took, kind, entries = [], None, None
        for _ in range(args.reps):
            t0 = time.perf_counter()
            try:
                hc = batch.ingest_column(values)
            except NotImplementedError as e:
                took.append(time.perf_counter() - t0)
                kind = type(e).__name__
                continue
            took.append(time.perf_counter() - t0)
            kind = "raw" if getattr(hc, "raw", False) else "sorted"
            entries = len(hc.dictionary)
            del hc
        sort_took = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            uniq, _inv = batch._sorted_distinct(values)
            sort_took.append(time.perf_counter() - t0)
        print(json.dumps({"tree": args.root, "table": table, "column": name,
                          "dtype": str(values.dtype), "rows": len(values),
                          "seconds": took,
                          "median_s": statistics.median(took),
                          "kind": kind, "dictionary": entries,
                          "sort_s": sort_took,
                          "sort_median_s": statistics.median(sort_took),
                          "distinct": len(uniq)}), flush=True)


if __name__ == "__main__":
    main()
