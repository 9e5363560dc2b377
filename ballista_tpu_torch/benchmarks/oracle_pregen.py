"""Fill the oracle cache with the pandas oracle's TPC-H answers (port of
scripts/oracle_pregen.py).

Reads the chunked parquet dataset the engine mounts (--dataset-dir, as
written by `python -m ballista_tpu_torch.datagen --chunks N`) on the host
into a CPU context, makes the oracle's pandas tables from it once, and
computes each query's frame whose files are missing through the runner's
own `_oracle`, which writes `oracle_sf{sf}_q{q}.pkl` and its `.json`
under BALLISTA_ORACLE_CACHE. `runner --verify` over the same dataset at
the same --sf (`--isolate` with `--oracle-cache DIR` included) then reads
them instead of paying the oracle per query and process. A CPU tool:
pyarrow and pandas, no device.

Usage:
  BALLISTA_ORACLE_CACHE=DIR python -m ballista_tpu_torch.benchmarks.oracle_pregen \\
      --dataset-dir DIR --sf 10 [--queries 1,3,6]
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv=None) -> list:
    """Compute the missing frames; returns the queries it computed."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-dir", required=True)
    ap.add_argument("--sf", type=float, required=True,
                    help="scale factor used in the cache key (must match "
                         "the runner's --sf)")
    ap.add_argument("--queries", default=None,
                    help="comma-separated query numbers (default: all)")
    args = ap.parse_args(argv)
    cache = os.environ.get("BALLISTA_ORACLE_CACHE")
    assert cache, "set BALLISTA_ORACLE_CACHE to the cache directory"

    from ..client import SessionContext
    from ..datagen import TPCH_TABLES
    from .oracle import ORACLES, to_pd
    from .runner import _oracle, oracle_paths

    queries = ([int(x) for x in args.queries.split(",")] if args.queries
               else sorted(ORACLES))
    missing = [q for q in queries if not all(
        os.path.exists(p) for p in oracle_paths(cache, args.sf, q))]
    if not missing:
        print("all cached", flush=True)
        return []

    t0 = time.perf_counter()
    ctx = SessionContext(device="cpu")
    for name in TPCH_TABLES:
        d = os.path.join(args.dataset_dir, name)
        if os.path.isdir(d):
            ctx.register_parquet_dataset(name, d, TPCH_TABLES[name][1])
            print(f"# mounted {name}: {ctx.tables[name].num_rows} rows "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    tables = to_pd(ctx.tables)
    del ctx
    print(f"# pandas tables ready {time.perf_counter() - t0:.0f}s",
          flush=True)

    for q in missing:
        t1 = time.perf_counter()
        _oracle(q, args.sf, lambda: tables, cache)
        print(f"q{q:2d} oracle cached in {time.perf_counter() - t1:.1f}s",
              flush=True)
    print(f"done {time.perf_counter() - t0:.0f}s", flush=True)
    return missing


if __name__ == "__main__":
    main()
