"""The memory model's estimate and route for each TPC-H query (port of
scripts/hbm_estimate.py).

Per query it plans the query as `collect()` would (`ctx.physical_plan` of
the rebound plan) and prints `exec.memory.estimate_plan_hbm` of that plan
with the route `collect()` takes: in-core, or the serial runtime at N
partitions (`SessionContext.serial_route`: `exec.memory.route_serial`
against `hbm_budget_bytes(device)`, an out-of-memory memo included). No
query runs. BALLISTA_HBM_BYTES sets the budget, also where there is no
card (`--device cpu`); without it a CPU context routes nothing.

Usage:
  python -m ballista_tpu_torch.benchmarks.hbm_estimate [--sf 1] \\
      [--dataset-dir DIR] [--queries 1,3,6] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import time


def _parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dataset-dir", default=None,
                    help="mount chunked parquet part files (one directory "
                         "per table, pyarrow) instead of generating")
    ap.add_argument("--sf", type=float, default=None,
                    help="scale factor to generate (default 1)")
    ap.add_argument("--queries", default=None,
                    help="comma-separated query numbers (default: all)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device whose budget routes the plans")
    return ap


def main(argv=None) -> dict:
    """Print and return {q: {"bytes", "route"}} ("route" the serial
    partition count, 0 for in-core; a query that cannot be planned has
    "error" instead)."""
    args = _parser().parse_args(argv)
    from ..client import SessionContext
    from ..client.context import rebind_scans
    from ..datagen import TPCH_TABLES, register_tpch
    from ..exec import memory
    from .queries import TPCH_QUERIES

    ctx = SessionContext(device=args.device)
    if args.dataset_dir:
        for name in TPCH_TABLES:
            d = os.path.join(args.dataset_dir, name)
            if os.path.isdir(d):
                ctx.register_parquet_dataset(name, d, TPCH_TABLES[name][1])
    else:
        register_tpch(ctx, args.sf or 1.0)
    budget = memory.hbm_budget_bytes(ctx.device)
    print("# budget " + ("none: nothing is routed" if budget is None
                         else f"{budget} B ({budget / 1e9:.3f} GB)"),
          flush=True)
    queries = ([int(x) for x in args.queries.split(",")] if args.queries
               else sorted(TPCH_QUERIES))
    out = {}
    for q in queries:
        t0 = time.perf_counter()
        try:
            plan = ctx.sql(TPCH_QUERIES[q]).plan
            est = memory.estimate_plan_hbm(
                ctx.physical_plan(rebind_scans(plan, ctx)))
            route = ctx.serial_route(plan)
            ctx.take_warnings()
            out[q] = {"bytes": est, "route": route}
            shown = f"serial@{route}" if route else "in-core"
            print(f"q{q:2d}  {est / 1e9:9.3f} GB  {shown:12s} "
                  f"({time.perf_counter() - t0:.1f}s plan)", flush=True)
        except Exception as e:  # noqa: BLE001 - the other queries go on
            out[q] = {"error": f"{type(e).__name__}: {e}"}
            print(f"q{q:2d}  ERROR {type(e).__name__}: {e}", flush=True)
    return out


if __name__ == "__main__":
    main()
