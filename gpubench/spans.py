#!/usr/bin/env python3
"""The program's own spans in a traced window, reduced per span name.

`ballista_tpu_torch` opens profiler ranges named `ballista.*` at its layer
boundaries while a profiler records (`ballista_tpu_torch/tracing.py`):
`ballista.sql` (with `.sql.parse`, `.sql.plan`), `ballista.collect` (with
`ballista.route`), one `ballista.attempt` per pass of `converge` (with
`ballista.plan.physical`, `ballista.plan.bind`, the operators and
`ballista.verdict`, the attempt's one read of its overflow flags),
`ballista.exec.<OperatorClass>` per operator evaluated, nested as the
plan, and `ballista.kernel.masked_slot_sums`. They are CPU ranges with no
copy on the device's timeline, so `trace.summarize` passes over them.

`reduce(events)` takes the same profiler events as `trace.summarize`
and, for the ranges of the window's thread inside the window and out of
its pauses, gives per span name its calls, host self time (its length
less its child spans'), the device seconds of the operations launched
in its self time (by correlation id) and the idle seconds of the window
it holds, each span taking its query from the benchmark's `sql qN` or
`collect qN` range around it. From those come four readings
(`Program.readings`):

- `plan_ms_per_query`: host time of `ballista.plan.physical` and
  `ballista.plan.bind` over every attempt, per query;
- `rerun_device_pct`: device seconds launched inside the attempts that
  overflowed (every attempt of a collect but its last) over those
  launched inside all attempts;
- `exec_idle_pct`: the window's idle time inside the union of the
  operator spans, over the window;
- `host_syncs_per_query`: synchronizing CUDA calls that start inside a
  `ballista.collect` span, per query.

Run a cell traced with the reduction written beside its result line:

    python3 gpubench/spans.py --workload <name> --seed <n> --seconds <s> \
        [--out build/spans.json]

which is `run.py --trace 1` with `trace.summarize` also handing its
events to `reduce`. No metric of `BENCHMARK.json` reads this yet.

A stopgap: `reduce` parses the events a second time and recomputes the
window, its pauses, the busy union and the idle stretches as
`trace.summarize` does. Once `trace.summarize` hands those to `reduce`
and `Summary` carries its result for the metric files, the second pass,
`capture` and this command line go.
"""

from __future__ import annotations

import bisect
import json
import os
import sys
from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from gpubench import trace  # noqa: E402
from gpubench.trace import _subtract, _union  # noqa: E402

PROGRAM = "ballista."
COLLECT = "ballista.collect"
ATTEMPT = "ballista.attempt"
EXEC = "ballista.exec."
PLAN = ("ballista.plan.physical", "ballista.plan.bind")
# CUDA runtime calls that wait for the device (a `.item()`, `nonzero` or
# pageable copy shows as cudaMemcpyAsync then cudaStreamSynchronize)
SYNCS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                   "cudaEventSynchronize", "cudaMemcpy"})
HARNESS = "harness"
READINGS = ("plan_ms_per_query", "rerun_device_pct", "exec_idle_pct",
            "host_syncs_per_query")


class SpanStats(NamedTuple):
    calls: int
    host_s: float       # self time: the span's length less its children's
    device_s: float     # device operations launched in its self time
    idle_s: float       # the window's idle time in its self time


class Program(NamedTuple):
    window_s: float
    idle_s: float
    queries: int                        # collect ranges in the window
    spans: Dict[str, SpanStats]
    plan_s: float                       # ballista.plan.* over all attempts
    attempts: int
    overflowed: int                     # attempts a later one re-ran
    attempt_device_s: float             # launched inside any attempt
    rerun_device_s: float               # launched inside overflowed ones
    exec_idle_s: float                  # idle inside the operator spans
    syncs: int                          # sync calls inside collect spans
    syncs_by_span: Dict[str, int]       # by the innermost program span
    runtime_calls: Dict[str, int]       # every CUDA call inside collect
    idle_by_label: Dict[str, float]     # "<span> qN", "collect qN", harness
    device_by_span_op: List[Tuple[str, str, float]]  # most first
    # query -> (overflowed attempts, device seconds launched in them)
    reruns_by_query: Dict[str, Tuple[int, float]]

    def readings(self) -> Dict[str, Optional[float]]:
        """The four readings; None where the program opened no span (a
        program without them) or nothing was answered."""
        q = self.queries
        if not (self.spans and q and self.window_s > 0):
            return dict.fromkeys(READINGS)
        return {
            "plan_ms_per_query": self.plan_s / q * 1e3,
            "rerun_device_pct": (100.0 * self.rerun_device_s
                                 / self.attempt_device_s
                                 if self.attempt_device_s > 0 else None),
            "exec_idle_pct": 100.0 * self.exec_idle_s / self.window_s,
            "host_syncs_per_query": self.syncs / q,
        }

    def idle_gaps(self, n: int = 10) -> List[Tuple[str, float]]:
        return sorted(self.idle_by_label.items(), key=lambda x: -x[1])[:n]


def _innermost(spans) -> List[Tuple[int, int, int]]:
    """`spans` (start, end, ...) sorted by (start, -end) and nested as one
    thread's ranges are: the pieces (start, end, i) of the timeline, in
    order, where span i is the innermost one open."""
    pieces, stack, t = [], [], 0
    for i, (s, e, *_) in enumerate(spans):
        while stack and stack[-1][0] <= s:
            end, j = stack.pop()
            if t < end:
                pieces.append((t, end, j))
            t = max(t, end)
        if stack and t < s:
            pieces.append((t, s, stack[-1][1]))
        t = s
        stack.append((min(e, stack[-1][0]) if stack else e, i))
    while stack:
        end, j = stack.pop()
        if t < end:
            pieces.append((t, end, j))
        t = max(t, end)
    return pieces


def _meet(a, b):
    """Overlaps of two sorted lists of disjoint intervals: (start, end,
    index in a, index in b)."""
    i = j = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            yield s, e, i, j
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1


def _holder(intervals, starts, t):
    """Index of the interval of the sorted disjoint `intervals` that holds
    `t`, or None."""
    i = bisect.bisect_right(starts, t) - 1
    return i if i >= 0 and t <= intervals[i][1] else None


def reduce(events) -> Program:
    """The program spans of a traced window (see the module's doc)."""
    window, thread, pauses, bench, program = None, None, [], [], []
    device, launches, calls = [], {}, []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if "CUDA" in str(ev.device_type()):
            if not name.startswith(("gpubench.", PROGRAM)):
                device.append((start, end, name, ev.correlation_id()))
        elif name == trace.WINDOW:
            window = (start, end)
            thread = ev.start_thread_id()
        elif name == trace.PAUSE:
            pauses.append([start, end])
        elif name.startswith(trace.SPAN):
            bench.append((start, end, name[len(trace.SPAN):]))
        elif name.startswith(PROGRAM):
            program.append((start, end, name, ev.start_thread_id()))
        elif name.startswith("cu"):
            launches[ev.correlation_id()] = start
            calls.append((start, name))
    if window is None:
        raise RuntimeError("the traced run recorded no window range")
    w0, w1 = window
    holes = _union(pauses)
    hole_starts = [h[0] for h in holes]
    kept = _subtract([[w0, w1]], holes)
    kept_starts = [k[0] for k in kept]
    busy = _subtract(_union([[max(s, w0), min(e, w1)] for s, e, _, _ in device
                             if e > w0 and s < w1]), holes)
    idle = _subtract(kept, busy)
    # the operations trace.summarize lists: in the window, not in a pause
    device = [d for d in device if d[1] > w0 and d[0] < w1
              and _holder(holes, hole_starts, d[0]) is None]

    def in_window(t):
        return _holder(kept, kept_starts, t) is not None

    bench.sort()
    bench_starts = [b[0] for b in bench]
    program = sorted((p for p in program if p[3] == thread
                      and p[1] > w0 and p[0] < w1),
                     key=lambda p: (p[0], -p[1]))
    pieces = _innermost(program)
    piece_starts = [p[0] for p in pieces]

    def innermost(t):
        i = _holder(pieces, piece_starts, t)
        return None if i is None else program[pieces[i][2]][2]

    stats = defaultdict(lambda: [0, 0, 0, 0])     # calls, host, device, idle
    for s, _, name, _ in program:
        if in_window(s):
            stats[name][0] += 1
    for s, e, i, _ in _meet(pieces, kept):
        stats[program[pieces[i][2]][2]][1] += e - s

    # idle time: inside a program span by that span and its query, the
    # rest by the benchmark range holding its middle, as trace.summarize
    by_label: Dict[str, int] = defaultdict(int)
    in_spans = []
    for s, e, i, _ in _meet(pieces, idle):
        name = program[pieces[i][2]][2]
        stats[name][3] += e - s
        b = _holder(bench, bench_starts, s)
        by_label[name if b is None else
                 f"{name} {bench[b][2].split()[-1]}"] += e - s
        in_spans.append([s, e])
    for s, e in _subtract(idle, in_spans):
        b = _holder(bench, bench_starts, (s + e) // 2)
        by_label[HARNESS if b is None else bench[b][2]] += e - s

    # device work by the span whose self time launched it, and by attempt:
    # a collect's attempts before its last overflowed and were re-run
    collects = [p[:2] for p in program if p[2] == COLLECT]
    collect_starts = [c[0] for c in collects]
    attempts = [p[:2] for p in program if p[2] == ATTEMPT]
    attempt_starts = [a[0] for a in attempts]
    rerun = set()
    for c0, c1 in collects:
        rerun.update(range(bisect.bisect_left(attempt_starts, c0),
                           bisect.bisect_right(attempt_starts, c1) - 1))
    by_span_op: Dict[Tuple[str, str], int] = defaultdict(int)
    attempt_ns = 0
    rerun_of = dict.fromkeys(rerun, 0)
    for s, e, op, corr in device:
        t = launches.get(corr)
        if t is None:
            continue
        name = innermost(t)
        if name is not None:
            stats[name][2] += e - s
            by_span_op[(name, op[:80])] += e - s
        k = _holder(attempts, attempt_starts, t)
        if k is not None:
            attempt_ns += e - s
            if k in rerun:
                rerun_of[k] += e - s

    syncs, syncs_by_span, runtime = 0, Counter(), Counter()
    for t, name in calls:
        if not in_window(t) or _holder(collects, collect_starts, t) is None:
            continue
        runtime[name] += 1
        if name in SYNCS:
            syncs += 1
            syncs_by_span[innermost(t)] += 1

    plan_ns = sum(e - s for s, e, _, _ in _meet(
        [p for p in program if p[2] in PLAN], kept))
    execs = _union([list(p[:2]) for p in program if p[2].startswith(EXEC)])
    exec_idle = sum(e - s for s, e, _, _ in _meet(execs, idle))
    queries = sum(1 for s, _, label in bench
                  if label.startswith("collect ") and in_window(s))
    counted = [k for k, a in enumerate(attempts) if in_window(a[0])]
    reruns_by_query = defaultdict(lambda: [0, 0])
    for k in counted:
        b = _holder(bench, bench_starts, attempts[k][0])
        if k in rerun and b is not None:
            q = reruns_by_query[bench[b][2].split()[-1]]
            q[0] += 1
            q[1] += rerun_of[k]
    return Program(
        trace._length(kept) / 1e9, trace._length(idle) / 1e9, queries,
        {n: SpanStats(c, h / 1e9, d / 1e9, i / 1e9)
         for n, (c, h, d, i) in sorted(stats.items())},
        plan_ns / 1e9, len(counted), sum(1 for k in counted if k in rerun),
        attempt_ns / 1e9, sum(rerun_of.values()) / 1e9, exec_idle / 1e9, syncs,
        dict(syncs_by_span), dict(runtime.most_common(20)),
        {k: v / 1e9 for k, v in by_label.items()},
        sorted(((n, op, t / 1e9) for (n, op), t in by_span_op.items()),
               key=lambda x: -x[2])[:25],
        {q: (n, t / 1e9) for q, (n, t) in sorted(reruns_by_query.items())})


def to_json(p: Program) -> dict:
    out = p._asdict()
    out["spans"] = {n: s._asdict() for n, s in p.spans.items()}
    out["readings"] = p.readings()
    out["idle_gaps"] = p.idle_gaps(15)
    return out


def capture(path: str) -> None:
    """Make this process's traced `run.main` hand its profiler events to
    `reduce` as well, write the result to `path` as JSON and log a line
    per span name; the run's own result line is unchanged."""
    summarize = trace.summarize

    def summarize_and_reduce(events, entry_ranges=()):
        events = list(events)
        p = reduce(events)
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(to_json(p), f, indent=1)
        for name, s in sorted(p.spans.items(), key=lambda x: -x[1].host_s):
            _log(f"spans: {name} calls {s.calls} host {s.host_s:.6f} s "
                 f"device {s.device_s:.6f} s idle {s.idle_s:.6f} s")
        _log(f"spans: {json.dumps(p.readings())}")
        return summarize(events, entry_ranges)
    trace.summarize = summarize_and_reduce


def _log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def main(argv=None, device: Optional[str] = None) -> int:
    """`run.py`'s arguments and `--out`; the run is traced."""
    import argparse
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--out", default=None)
    args, rest = ap.parse_known_args(argv)
    capture(args.out or os.path.join("build", "spans.json"))
    from gpubench import run
    return run.main(rest + ["--trace", "1"], device=device)


if __name__ == "__main__":
    sys.exit(main())
