"""Scaling harness (port of ballista_tpu/benchmarks/scaling.py; BASELINE.md
protocol item 4).

Runs a TPC-H query through the partitioned runtime (`execute_distributed`)
at increasing partition counts P and reports per-P wall time, rows/s and
parallel efficiency against the first point. Where there are at least P
devices of the context's type, partition p runs on device p. With fewer,
the P partitions share the first device (`make_mesh(P, devices=[dev0] *
P)`): such a point says `"devices": 1` and its efficiency is null, since
one device makes no scaling claim.

Usage:
  python -m ballista_tpu_torch.benchmarks.scaling --sf 0.1 --query 1 \
      --devices 1,2,4,8 [--device cuda]
Prints one JSON line: {"query": q, "sf": s, "points": [...]}.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch


def run(sf: float, query: int, device_counts, iterations: int,
        device="cuda", ctx=None, answers=None):
    """The points, one per partition count. `ctx` is a context whose
    TPC-H tables are registered (else SF `sf` is generated on `device`);
    a dict `answers` receives each P's result as `batch.to_numpy` gives
    it."""
    from ..batch import to_numpy
    from ..client import SessionContext
    from ..datagen import register_tpch
    from ..parallel.mesh import make_mesh, visible_devices
    from ..scheduler.runtime import execute_distributed
    from .queries import TPCH_QUERIES

    if ctx is None:
        ctx = SessionContext(device=device)
        register_tpch(ctx, sf)
    dev = ctx.device
    visible = visible_devices(dev.type) if dev.type == "cuda" else [dev]
    input_rows = sum(tp.num_rows for name, tp in ctx.tables.items()
                     if not name.startswith("__"))

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    points = []
    base = None
    for n in device_counts:
        shared = n > len(visible)
        mesh = make_mesh(n, devices=[visible[0]] * n if shared else visible)
        n_devices = len(set(mesh))
        plan = ctx.sql(TPCH_QUERIES[query]).plan
        out, schema = execute_distributed(ctx, plan, mesh)  # warm
        nrows = int(out.num_rows)
        if answers is not None:
            answers[n] = to_numpy(out, schema)
        sync()
        t0 = time.perf_counter()
        for _ in range(iterations):
            out, schema = execute_distributed(ctx, plan, mesh)
        sync()
        dt = (time.perf_counter() - t0) / iterations
        rows_s = input_rows / dt
        eff = None
        if n_devices == n:
            if base is None:
                base = (rows_s, n)
            eff = round(rows_s / (base[0] * n / base[1]), 3)
        points.append({"devices": n_devices, "partitions": n,
                       "ms": round(dt * 1000, 3),
                       "rows_per_s": round(rows_s),
                       "efficiency_vs_linear": eff, "out_rows": nrows})
        print(f"# P={n} on {n_devices} device(s): {dt * 1000:9.3f} ms  "
              f"{rows_s / 1e6:8.1f}M rows/s  eff={eff}", file=sys.stderr)
    print(json.dumps({"query": query, "sf": sf, "points": points}))
    return points


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sf", type=float, default=0.1)
    ap.add_argument("--query", type=int, default=1)
    ap.add_argument("--devices", default="1,2,4,8",
                    help="comma-separated partition counts")
    ap.add_argument("--iterations", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.sf, args.query, [int(x) for x in args.devices.split(",")],
               args.iterations, device=args.device)


if __name__ == "__main__":
    main()
