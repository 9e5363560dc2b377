"""Where a TPC-H query's time goes on one CUDA device, operator by operator.

    python -m ballista_tpu_torch.benchmarks.op_profile --sf 1 --queries 3 5
    python -m ballista_tpu_torch.benchmarks.op_profile --queries \
        --analytic window_running moments_sorted
    python -m ballista_tpu_torch.benchmarks.op_profile --queries \
        --h2o 4 6 9 taxi --h2o-n 1e7

`--analytic` takes names of `benchmarks.queries.ANALYTIC_QUERIES` (window
functions, statistical aggregates, bag set operations); a bare `--queries`
leaves the TPC-H queries out. `--h2o` takes h2o groupby question numbers
and `taxi`, over `benchmarks.h2o.groupby_table` and
`benchmarks.nyctaxi.synthetic_tripdata` at `--h2o-n` rows, registered
from numpy arrays. For each query, over tables generated at
`--sf` (seed 19940101) and uploaded before timing:
- `collect()` and `run_plan` wall times (host clock around work that ends
  in a synchronize; median of `--reps`). `run_plan` runs the plan built
  with the context's options; where that plan overflows (`overflowed`),
  `collect()` runs it and then one rebuilt with the capacities it counted, and
  the per-run numbers below are those of the first;
- device-busy time per `run_plan` (sum of kernel times from
  torch.profiler) and its share of the `run_plan` wall time;
- each operator's exclusive wall and device-busy time, and its costliest
  kernels: the node runs alone on its children's kept outputs; beside
  them its floor bytes (`exec.plan.piece_bytes`: its inputs and output at
  their live rows), its bound at the HBM rate (`BALLISTA_HBM_GBPS`,
  default the H100 SXM's 3350) and the share of its device time the bound
  is;
- the kernels that took the most device time, and the device time under
  each of the torch ops the join and aggregate paths are built from
  (sort, searchsorted, index_select, cumsum, ...; inclusive, so an op
  that calls another counts its kernels too).
It prints one line per number and writes them all as JSON to `--out`.
Needs a CUDA device; it fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..client import SessionContext
from ..datagen import register_tpch
from ..exec.plan import (InputLeaf, Run, hbm_bytes_per_s, piece_bytes,
                         run_plan)
from . import h2o, nyctaxi
from .queries import ANALYTIC_QUERIES, TPCH_QUERIES


def _wall_ms(fn, reps):
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# torch ops whose device time (their kernels') is reported per query
OPS = ("aten::sort", "aten::searchsorted", "aten::index_select",
       "aten::gather", "aten::cumsum", "aten::scatter_reduce_",
       "aten::where", "aten::arange", "aten::cat", "aten::cummax",
       "aten::cummin", "aten::index_copy_", "aten::index_add_")


def _device_ms(fn, reps, ops=None):
    """(device-busy ms per call, {kernel name: ms per call}); fills `ops`
    with {torch op: device ms per call under it} when given."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        # device-side events only: the CPU op that launched a kernel also
        # reports the kernel's time, and would count it twice
        if e.device_type != DeviceType.CPU:
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
            kernels[e.key] = us / 1e3 / reps
        elif ops is not None and e.key in OPS:
            us = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0))
            ops[e.key] = us / 1e3 / reps
    return sum(kernels.values()), kernels


def _top(kernels, k):
    return dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:k])


def _post_order(node):
    for c in node.children:
        yield from _post_order(c)
    yield node


def profile_query(ctx, sql, reps):
    df = ctx.sql(sql)
    plan = ctx.physical_plan(df.plan)
    inputs = ctx.bind_inputs([leaf.input_id for leaf in plan.leaves()])
    df.collect()
    out = {"collect_ms": _wall_ms(df.collect, reps),
           "run_plan_ms": _wall_ms(lambda: run_plan(plan, inputs), reps)}
    overflow = run_plan(plan, inputs)[1]
    out["overflowed"] = overflow is not None and bool(overflow)
    ops = {}
    busy, kernels = _device_ms(lambda: run_plan(plan, inputs), reps, ops)
    out["device_busy_ms"] = busy
    out["torch_ops_device_ms"] = ops
    out["masked_slot_sums_ms"] = sum(ms for name, ms in kernels.items()
                                     if "slot_sums" in name)
    out["device_busy_share"] = busy / out["run_plan_ms"]
    out["top_kernels_ms"] = _top(kernels, 12)
    # each node alone, on its children's outputs (`Run.kept`)
    run = Run(inputs)
    outputs = run.kept
    ops = []
    for node in _post_order(plan):
        if id(node) in outputs:     # a subtree shared by several parents
            continue
        got = node.evaluate(run)
        wall = _wall_ms(lambda: node.evaluate(run), reps)
        dev, kernels = _device_ms(lambda: node.evaluate(run), reps)
        # a leaf hands its bound input on and moves nothing
        nbytes, cap = ((0, 0) if isinstance(node, InputLeaf) else
                       piece_bytes([outputs[id(c)] for c in node.children],
                                   got))
        outputs[id(node)] = got
        bound = nbytes / hbm_bytes_per_s() * 1e3
        ops.append({"op": node._label()[:110], "wall_ms": wall,
                    "device_ms": dev, "bytes": nbytes, "cap_bytes": cap,
                    "bound_ms": bound,
                    "roofline_share": bound / dev if dev > 0 else None,
                    "kernels_ms": _top(kernels, 4)})
    out["operators"] = ops
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--queries", type=int, nargs="*", default=[3, 5])
    ap.add_argument("--analytic", nargs="*", default=[],
                    choices=sorted(ANALYTIC_QUERIES), metavar="NAME")
    ap.add_argument("--h2o", nargs="*", default=[], metavar="Q",
                    help="h2o groupby question numbers and 'taxi'")
    ap.add_argument("--h2o-n", type=float, default=1e7)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="build/op_profile.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("op_profile: needs a CUDA device")
    ctx = SessionContext(device="cuda")
    if args.queries or args.analytic:
        register_tpch(ctx, args.sf)
    result = {"device": torch.cuda.get_device_name(0), "sf": args.sf}
    queries = [(f"q{q}", TPCH_QUERIES[q]) for q in args.queries] \
        + [(name, ANALYTIC_QUERIES[name]) for name in args.analytic]
    n = int(args.h2o_n)
    if [q for q in args.h2o if q != "taxi"]:
        ctx.register_numpy("x", h2o.groupby_table(n))
    if "taxi" in args.h2o:
        ctx.register_numpy("tripdata", nyctaxi.synthetic_tripdata(n))
    queries += [("taxi", nyctaxi.QUERIES["fare_amt_by_passenger"])
                if q == "taxi" else
                (f"h2o_q{q}", h2o.GROUPBY_QUERIES[int(q)]) for q in args.h2o]
    for q, sql in queries:
        r = profile_query(ctx, sql, args.reps)
        result[q] = r
        print(f"{q}: collect {r['collect_ms']:.3f} ms, run_plan "
              f"{r['run_plan_ms']:.3f} ms, device busy "
              f"{r['device_busy_ms']:.3f} ms "
              f"({100 * r['device_busy_share']:.1f} %)"
              f"{', run_plan overflowed' if r['overflowed'] else ''}",
              flush=True)
        for op in r["operators"]:
            share = op["roofline_share"]
            print(f"  {op['device_ms']:9.3f} dev ms {op['wall_ms']:9.3f} "
                  f"wall ms {op['bytes'] / 2 ** 20:9.1f} MiB "
                  f"{op['bound_ms']:8.3f} bound ms "
                  f"{'-' if share is None else f'{100 * share:5.1f} %'}  "
                  f"{op['op']}", flush=True)
            for name, ms in op["kernels_ms"].items():
                print(f"      {ms:9.3f} ms  {name[:90]}", flush=True)
        for name, ms in r["top_kernels_ms"].items():
            print(f"  kernel {ms:9.3f} ms  {name[:100]}", flush=True)
        for name, ms in r["torch_ops_device_ms"].items():
            print(f"  under {name}: {ms:.3f} device ms", flush=True)
        print(f"  masked_slot_sums kernel: {r['masked_slot_sums_ms']:.4f} "
              "device ms", flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)


if __name__ == "__main__":
    main()
