"""The traced run's profiler events reduced to what the per-layer metrics
and the breakdown read.

The profiler (`torch.profiler`, CPU and CUDA activities) records the
benchmark's own ranges (`record_function`): the window, each query's
`sql` and `collect`, each sampled answer's copy to the host, and each call
of an entry that a per-layer metric wraps (`port.EntryWrap`). Device
operations (kernels, copies, fills) come from CUPTI; each carries the
correlation id of the host call that launched it.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple

WINDOW = "gpubench.window"
PAUSE = "gpubench.sample_copy"
SPAN = "gpubench.span."
ENTRY = "gpubench.entry."


class Summary(NamedTuple):
    window_s: float                     # traced window, pauses left out
    busy_s: float                       # union of device operations in it
    # per wrapped entry's range: (device seconds of the operations
    # launched inside it, their count); absent where it was never called
    entries: Dict[str, Tuple[float, int]]
    device_ops: List[Tuple[str, float]]  # (name, seconds), most first
    idle_gaps: List[Tuple[str, float]]   # (host span, idle seconds), most first


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _subtract(intervals, holes):
    """intervals minus holes, both sorted and disjoint."""
    out, j = [], 0
    for s, e in intervals:
        cur = s
        while j < len(holes) and holes[j][1] <= cur:
            j += 1
        k = j
        while k < len(holes) and holes[k][0] < e:
            if holes[k][0] > cur:
                out.append([cur, holes[k][0]])
            cur = max(cur, holes[k][1])
            k += 1
        if cur < e:
            out.append([cur, e])
    return out


def _length(intervals) -> int:
    return sum(e - s for s, e in intervals)


def summarize(events, entry_ranges: Sequence[str] = ()) -> Summary:
    """`events`: the profiler's kineto events (`name()`, `device_type()`,
    `start_ns()`, `duration_ns()`, `correlation_id()`); `entry_ranges`:
    the ranges of the wrapped entries."""
    window, pauses, spans = None, [], []
    ranges = {r: [] for r in entry_ranges}
    launches: Dict[int, int] = {}
    device = []
    for ev in events:
        name = ev.name()
        start = ev.start_ns()
        end = start + ev.duration_ns()
        on_device = "CUDA" in str(ev.device_type())
        if on_device and name.startswith("gpubench."):
            continue        # the device-side copy of a benchmark range
        if on_device:
            device.append((start, end, name, ev.correlation_id()))
        elif name == WINDOW:
            window = (start, end)
        elif name == PAUSE:
            pauses.append([start, end])
        elif name.startswith(SPAN):
            spans.append((start, end, name[len(SPAN):]))
        elif name in ranges:
            ranges[name].append((start, end))
        elif name.startswith("cu"):
            # a CUDA runtime or driver-API call that may launch device work
            launches[ev.correlation_id()] = start
    if window is None:
        raise RuntimeError("the traced run recorded no window range")
    w0, w1 = window
    holes = _union(pauses)
    kept = _subtract([[w0, w1]], holes)
    window_ns = _length(kept)
    busy = _subtract(_union([[max(s, w0), min(e, w1)] for s, e, _, _ in device
                             if e > w0 and s < w1]), holes)
    busy_ns = _length(busy)

    # device time by operation name, in the window and out of the pauses
    # (the sampled answers' copies to the host)
    hole_starts = [h[0] for h in holes]
    by_name: Dict[str, int] = defaultdict(int)
    for s, e, name, _ in device:
        i = bisect.bisect_right(hole_starts, s) - 1
        if e > w0 and s < w1 and not (i >= 0 and s < holes[i][1]):
            by_name[name[:160]] += e - s
    device_ops = sorted(((n, t / 1e9) for n, t in by_name.items()),
                        key=lambda x: -x[1])[:10]

    # device work launched inside each entry's ranges
    entries = {}
    for rname, spans_of in ranges.items():
        if not spans_of:
            continue
        spans_of.sort()
        starts = [s for s, _ in spans_of]
        total = ops = 0
        for s, e, _, corr in device:
            t = launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans_of[i][1]:
                total += e - s
                ops += 1
        entries[rname] = (total / 1e9, ops)

    # idle stretches of the window, by the benchmark span the host was in
    idle = _subtract(kept, busy)
    spans.sort()
    span_starts = [s for s, _, _ in spans]
    by_span: Dict[str, int] = defaultdict(int)
    for s, e in idle:
        mid = (s + e) // 2
        i = bisect.bisect_right(span_starts, mid) - 1
        label = "harness"
        if i >= 0 and mid <= spans[i][1]:
            label = spans[i][2]
        by_span[label] += e - s
    idle_gaps = sorted(((n, t / 1e9) for n, t in by_span.items()),
                       key=lambda x: -x[1])[:10]
    return Summary(window_ns / 1e9, busy_ns / 1e9, entries, device_ops,
                   idle_gaps)
