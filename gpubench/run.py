#!/usr/bin/env python3
"""Run one benchmark cell once on the card and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in `setup_s`, from process start): the cell's tables are
generated from the seed, registered in one `SessionContext(device="cuda")`
of the system under test, the kernel is built or loaded, and each query
of the mix runs twice: a first run, then a pass of the mix whose time
predicts how many passes the window holds. The window then drives
`ctx.sql(text).collect()` in a closed loop with one client, through the
mix's order again and again, each query timed from the call of
`ctx.sql` to the synchronize after `collect()`, until the window's
seconds have passed. For each query of the mix two answers of the window
are copied to the host (the copies are left out of the window's time):
its first, and the one of a pass drawn from the seed among the first
four fifths of the passes predicted; each column of a sampled copy equal
to the first's byte for byte is dropped as it is made and the first's
held for both (`host_copy`). After the window the program's state is
freed and the plain reference, on the card, judges every kept answer.
The kept answers' host bytes and the process's peak resident memory are
logged after the window and after judging.

With `--trace 0` the result's metrics are the cell's end-to-end metrics,
with `--trace 1` its per-layer ones, read from a profiler trace of the
window. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error.

It exits non-zero, printing no result, without a CUDA card (or with
fewer than the cell asks for), and where JAX or the JAX package is
loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import NamedTuple, Optional  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "ballista_tpu")


def _environment() -> None:
    """A run depends on its seed and the checkout alone: the program's
    BALLISTA_* settings are cleared (each takes its default), and the
    build caches of torch and triton live inside the checkout at fixed
    paths."""
    for key in [k for k in os.environ if k.startswith("BALLISTA_")]:
        del os.environ[key]
    cache = os.path.join(ROOT, "build", "gpubench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


class Record(NamedTuple):
    """What the metric readers (`gpubench/metrics/*.py`) read."""
    latencies_s: list       # every query answered in the window, in order
    sql_s: list             # its ctx.sql() seconds
    window_s: float
    setup_s: float
    peak_bytes: int
    reruns: int             # whole-plan re-runs after an overflow
    trace: Optional[object]  # trace.Summary of a traced run
    entries: dict            # metric -> Entry, for the entries metrics wrap


class Entry(NamedTuple):
    """A wrapped entry's calls in a traced window."""
    calls: int
    bytes: int              # what its calls must move (the metric's count)
    device_s: float         # device time of the operations launched in it
    ops: int                # how many such operations


def _power_limit() -> Optional[float]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout
        return float(out.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def _same_bytes(u, v, step: int = 1 << 24) -> bool:
    """Two arrays equal byte for byte (object arrays: entry by entry),
    compared a block at a time as integers of their width."""
    import numpy as np
    if u.dtype != v.dtype or u.shape != v.shape:
        return False
    if u.dtype == object:
        return np.array_equal(u, v)
    width = f"i{u.itemsize}" if u.itemsize in (1, 2, 4, 8) else np.uint8
    u, v = (np.ascontiguousarray(w).reshape(-1).view(width) for w in (u, v))
    return all(np.array_equal(u[i:i + step], v[i:i + step])
               for i in range(0, len(u), step))


def same_column(x: dict, y: dict) -> bool:
    """Whether two host copies of a column (`port.host_columns`) are equal
    byte for byte: name, kind, scale, values and validity, and the
    dictionary the same object or equal."""
    import numpy as np
    if x.keys() != y.keys():
        return False
    for u, v in ((x[k], y[k]) for k in x):
        if u is v:
            continue
        arrays = isinstance(u, np.ndarray) + isinstance(v, np.ndarray)
        if (arrays == 2 and not _same_bytes(u, v)) or arrays == 1 or \
                (arrays == 0 and u != v):
            return False
    return True


def host_copy(batch, schema, first: Optional[list] = None) -> list:
    """The answer on the host (`port.answer_to_host`), a column at a time:
    a column equal byte for byte to the same column of `first`, another
    pass's copy of the same query, is dropped as soon as it is made and
    `first`'s is held in its place; a copy equal to `first` in every
    column is `first` itself."""
    from gpubench import port
    copy = []
    for i, entry in enumerate(port.host_columns(batch, schema)):
        if first is not None and i < len(first) and \
                same_column(first[i], entry):
            entry = first[i]
        copy.append(entry)
    if first is not None and len(copy) == len(first) and \
            all(a is b for a, b in zip(copy, first)):
        return first
    return copy


def host_bytes(kept: dict) -> int:
    """Bytes of the kept answers' values and validities, each array once
    (the dictionaries are the program's own objects)."""
    arrays = {id(e[k]): e[k] for passes in kept.values()
              for a in passes.values() for e in a for k in ("values", "valid")}
    return sum(getattr(v, "nbytes", 0) for v in arrays.values())


def peak_resident() -> int:
    """The process's peak resident memory in bytes (Linux counts KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def sample_passes(seed: int, order, passes: int) -> dict:
    """The passes whose answer of each query is kept: the first, and one
    drawn from the seed among the first four fifths of the `passes` the
    set-up predicts (the window may run a little slower than its pass)."""
    from gpubench.tables import rng
    top = max(1, int(0.8 * passes))
    return {q: sorted({0, int(rng(seed, "sample", q).integers(0, top))})
            for q in dict.fromkeys(order)}


def window(ctx, cell, seed: int, seconds: float, passes: int, traced: bool,
           sync):
    """The closed loop: returns (latencies, sql seconds, window seconds,
    overflow re-runs, failed, attempted, kept answers by query and pass)."""
    import torch
    from torch.autograd.profiler import record_function

    from gpubench import port, trace

    order = cell.traffic["order"]
    keep_at = sample_passes(seed, order, passes)
    kept, done = {q: {} for q in keep_at}, {q: 0 for q in keep_at}
    lat, sqls = [], []
    reruns = failed = attempted = 0
    clock = time.perf_counter
    paused = 0.0

    def spans(q):
        if not traced:
            return lambda kind: contextlib.nullcontext()
        return lambda kind: record_function(f"{trace.SPAN}{kind} {q}")
    rf = record_function if traced else (lambda name: contextlib.nullcontext())
    i = 0
    with rf(trace.WINDOW):
        start = clock()
        while clock() - start - paused < seconds:
            q = order[i % len(order)]
            i += 1
            attempted += 1
            n_warn = len(ctx.warnings)
            t0 = clock()
            try:
                out, schema, sql_s = port.run_query(ctx, cell.queries[q], clock,
                                                    spans(q))
                sync()
            except Exception as e:  # a query that raises is a failed query
                failed += 1
                log(f"window: {q} raised {type(e).__name__}: {e}")
                if isinstance(e, torch.cuda.OutOfMemoryError):
                    gc.collect()
                    torch.cuda.empty_cache()
                continue
            lat.append(clock() - t0)
            sqls.append(sql_s)
            reruns += port.overflow_reruns(ctx.warnings[n_warn:])
            j, done[q] = done[q], done[q] + 1
            if j in keep_at[q]:
                p0 = clock()
                with rf(trace.PAUSE):
                    kept[q][j] = host_copy(out, schema, kept[q].get(0))
                paused += clock() - p0
            del out, schema
        window_s = clock() - start - paused
    return lat, sqls, window_s, reruns, failed, attempted, kept


def judge(cell, tables, kept, device, reference_module, failed: int) -> dict:
    """Every kept answer against the plain reference: the numbers compared,
    each with its limit."""
    from gpubench.answer import DictMaps, compare
    ref = reference_module.Reference(tables, device)
    limits = cell.config["limits"]
    maps = DictMaps()
    wrong, err, notes = 0, 0.0, []
    for q in dict.fromkeys(cell.traffic["order"]):
        if not kept.get(q):
            wrong += 1
            notes.append(f"{q}: no answer in the window")
            continue
        want = ref.answer(q)
        verdicts = {}
        for j, answer in sorted(kept[q].items()):
            # a pass held once reads what pass 0 reads
            if id(answer) not in verdicts:
                verdicts[id(answer)] = compare(answer, want, device, maps)
            v = verdicts[id(answer)]
            wrong += v.wrong_cells
            err = max(err, v.float_err)
            if v.wrong_cells or v.note:
                notes.append(f"{q} pass {j}: {v.wrong_cells} wrong cells "
                             f"{v.note}".strip())
        once = [j for j, a in kept[q].items() if j and a is kept[q].get(0)]
        notes.append(f"{q}: passes {sorted(kept[q])} compared" + "".join(
            f"; pass {j} equal to pass 0, held once" for j in once))
    checks = {"wrong_cells": {"value": wrong, "limit": limits["wrong_cells"]},
              "failed_queries": {"value": failed, "limit": 0}}
    if "float_err" in limits:
        checks["float_err"] = {"value": err, "limit": limits["float_err"]}
    return checks, notes


def main(argv=None, device: Optional[str] = None) -> int:
    """`device` is for the CPU tests alone: the command line always runs on
    "cuda" and refuses without a card."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from gpubench import port, spec, trace
    cell = spec.cell(args.workload)
    on_card = device is None
    if on_card:
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark runs on the card only")
            return 2
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} CUDA devices, "
                f"{torch.cuda.device_count()} visible")
            return 2
        device = "cuda"
    sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
    data = spec.module("data", cell.config["family"])
    reference = spec.module("reference", cell.config["family"])

    t0 = time.time()
    tables = data.generate(cell.config, args.seed)
    log(f"set-up: generated {cell.config['name']} in {time.time() - t0:.3f} s")
    port.build_kernels(device)
    ctx = port.make_context(device)
    data.register(ctx, tables, cell.config)
    clock = time.perf_counter
    no_spans = lambda kind: contextlib.nullcontext()  # noqa: E731
    for q in dict.fromkeys(cell.traffic["order"]):
        t0 = clock()
        out, schema, _ = port.run_query(ctx, cell.queries[q], clock, no_spans)
        sync()
        log(f"set-up: first run of {q} {clock() - t0:.4f} s, "
            f"{int(out.num_rows)} rows")
        del out, schema
    t0 = clock()
    for q in cell.traffic["order"]:
        out, schema, _ = port.run_query(ctx, cell.queries[q], clock, no_spans)
        sync()
        del out, schema
    pass_s = clock() - t0
    passes = max(1, int(args.seconds / pass_s))
    log(f"set-up: a pass of the mix {pass_s:.4f} s, {passes} passes "
        "predicted")
    ctx.take_warnings()
    power = _power_limit() if on_card else None
    setup_s = time.time() - T_START
    log(f"set-up: {setup_s:.3f} s")

    traced = bool(args.trace)
    prof, wraps = None, {}
    if traced:
        from torch.profiler import ProfilerActivity, profile
        for m in cell.per_layer:
            mod = spec.module("metrics", m["name"])
            if hasattr(mod, "ENTRY"):
                wraps[m["name"]] = port.EntryWrap(
                    trace.ENTRY + m["name"], *mod.ENTRY, mod.call_bytes)
        acts = [ProfilerActivity.CPU]
        if device.startswith("cuda"):
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
    lat, sqls, window_s, reruns, failed, attempted, kept = window(
        ctx, cell, args.seed, args.seconds, passes, traced, sync)
    summary, entries = None, {}
    if traced:
        sync()
        prof.__exit__(None, None, None)
        for w in wraps.values():
            w.restore()
        t0 = time.time()
        summary = trace.summarize(prof.profiler.kineto_results.events(),
                                  [w.range for w in wraps.values()])
        log(f"trace: reduced in {time.time() - t0:.3f} s; window "
            f"{summary.window_s:.3f} s, busy {summary.busy_s:.3f} s")
        for name, w in wraps.items():
            if w.range in summary.entries:
                device_s, ops = summary.entries[w.range]
                entries[name] = Entry(w.calls, w.total_bytes(), device_s, ops)
            log(f"trace: {w.name} for {name}: {entries.get(name)}")
        del prof
    peak = (torch.cuda.max_memory_allocated() if device.startswith("cuda")
            else 0)
    rec = Record(lat, sqls, window_s, setup_s, peak, reruns, summary,
                 entries)
    log(f"window: {len(lat)} answered of {attempted}, {window_s:.3f} s, "
        f"{reruns} overflow re-runs, {failed} failed")
    log(f"host: kept answers {host_bytes(kept)} bytes, peak resident "
        f"{peak_resident()} bytes after the window")

    # the program's state freed before the reference takes the card
    ctx.evict_device()
    del ctx
    gc.collect()
    if device.startswith("cuda"):
        torch.cuda.empty_cache()
    t0 = time.time()
    checks, notes = judge(cell, tables, kept, device, reference, failed)
    log(f"reference: {time.time() - t0:.3f} s")
    log(f"host: peak resident {peak_resident()} bytes after judging")
    for n in notes:
        log(f"check: {n}")
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak),
           "power_limit_w": power}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks

    loaded = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if loaded:
        log(f"refused: {loaded} loaded in the benchmark's process")
        return 3
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
