"""Plan-level device-memory model and in-core vs out-of-core routing (port
of ballista_tpu/exec/memory.py).

The reference engine streams batches so a query's working set is bounded
and spills to disk otherwise; this engine holds whole columns on the
device, so a plan whose buffers outgrow the card fails with an
out-of-memory error. This module prices a physical plan's peak device
bytes, so that `SessionContext.collect` can send a plan that would not fit
to the serial runtime (`scheduler/serial.py`) at once, and keeps a memo of
the plans that ran out of memory anyway.

The reference prices XLA's piecewise-compiled programs; the port runs a
plan eagerly (`exec.plan.run_plan`), node by node, depth first, so the
model follows that order. While a node runs, the live bytes are: the bound
table columns (each column once), the outputs of shared nodes
(`n_parents` > 1) that a parent has yet to read, the outputs its
ancestors already hold (earlier siblings on the recursion), and the
node's own inputs, output and transients (sort keys and permutations,
gathered copies, slot tables). The peak is the largest such sum. The
model errs high, and the route factor below (estimate over measured peak)
is calibrated on the card.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path
from typing import Dict, Optional

import torch

from ..exprs import Alias, Col, device_lut_bytes
from ..schema import Schema, TypeKind

_DTYPE_BYTES = {
    TypeKind.BOOL: 1,
    TypeKind.INT32: 4,
    TypeKind.INT64: 8,
    TypeKind.FLOAT32: 4,
    TypeKind.FLOAT64: 8,
    TypeKind.DATE32: 4,
    TypeKind.DECIMAL: 8,
    TypeKind.STRING: 4,      # dictionary codes (int32) on device
}


def _dtype_bytes(dtype) -> int:
    """Device bytes per value (a wide decimal's two words)."""
    return 16 if dtype.is_wide else _DTYPE_BYTES[dtype.kind]


# Share of the card's memory a plan may allocate: the caching allocator
# reserved at most 1.131x what the 16 TPC-H SF10 queries above 4 GiB
# allocated at their peaks (`chip_smoke.py` phase 12 (a) on the H100;
# PERF.md), so 1 / 1.131, rounded down.
SLACK = 0.88
# Route a plan out-of-core when its estimate exceeds the budget by this
# factor, the model's estimate over its measured peak: at SF10 the
# estimates of the queries that fit a 10 GiB cap reach 1.091x the cap,
# those of the queries that do not start at 1.123x (Q18 aside, whose
# first plan overflows and is re-planned larger), so 1.1 (phase 12 (a);
# PERF.md). BALLISTA_ROUTE_FACTOR overrides it; 0 turns routing off.
ROUTE_FACTOR = 1.1


def row_bytes(schema: Schema) -> int:
    """Per-row device bytes of one batch: data plane + validity bool."""
    return sum(_dtype_bytes(f.dtype) + 1 for f in schema.fields)


def batch_bytes(schema: Schema, capacity: int) -> int:
    return capacity * row_bytes(schema)


def _is_col(e) -> bool:
    return isinstance(e.child if isinstance(e, Alias) else e, Col)


def _out_bytes(node) -> int:
    """New device bytes a node's output holds (columns it passes through
    from its input are not new)."""
    from .plan import (FilterExec, HashJoinExec, InputLeaf, LimitExec,
                       ProjectExec)
    if isinstance(node, InputLeaf):
        return 0        # bound table columns, counted once for the plan
    if isinstance(node, ProjectExec):
        # every column gets a new validity; a bare column keeps its data
        return node.capacity * sum(
            1 + (0 if _is_col(e) else _dtype_bytes(f.dtype))
            for e, f in zip(node.exprs, node.schema.fields))
    if isinstance(node, FilterExec) and node.emit_sparse:
        return node.capacity                 # the keep mask
    if isinstance(node, HashJoinExec) and node.emit_sparse:
        build = node.children[0]
        return node.capacity * (1 + row_bytes(build.schema))
    if isinstance(node, LimitExec):
        return node.capacity * len(node.schema.fields)
    return batch_bytes(node.schema, node.capacity)


def _node_transient(node) -> int:
    """Device bytes of a node's working set beyond its inputs and output:
    sort keys and permutations, gathered copies, slot tables."""
    from .plan import (CoalesceExec, CrossJoinExec, FilterExec,
                       HashAggregateExec, HashJoinExec, NestedLoopJoinExec,
                       SortExec)
    from .window import WindowExec

    if isinstance(node, FilterExec):
        # the predicate column, the keep mask and, when compacting, the
        # stable sort of the mask (key + int64 permutation)
        return node.capacity * (10 if node.emit_sparse else 26)
    if isinstance(node, HashAggregateExec):
        child = node.children[0]
        n = child.capacity
        computed = sum(1 for a in node.aggs
                       if a.arg is not None and not _is_col(a.arg))
        nk = len(node.group_exprs)
        per_row = 5 + 9 * computed + 16 * nk
        if not node._masked:
            # normalised keys, the chained sort, the sorted copy of the
            # batch and the run layout
            per_row += 32 * nk + 24
            return (n * per_row + batch_bytes(child.schema, n)
                    + node.table_size * 8 * (nk + 2 * len(node.aggs) + 2))
        return n * per_row
    if isinstance(node, HashJoinExec):
        build, probe = node.children
        t = build.capacity * 24 + probe.capacity * 32
        if not node.unique_build:
            # expand_join's row maps and the gathered pairs
            t += node.out_capacity * 32
        elif not node.emit_sparse and node.join_type not in ("semi", "anti"):
            t += batch_bytes(node.schema, probe.capacity) + probe.capacity * 9
        if node.join_type == "full_outer":
            t += batch_bytes(node.schema, node.capacity)
        return t
    if isinstance(node, CrossJoinExec):
        if node._bcast is not None:
            return 0
        cells = node.children[0].capacity * node.children[1].capacity
        return cells * (33 + row_bytes(node.schema))
    if isinstance(node, NestedLoopJoinExec):
        cells = node.chunk_b * node.children[1].capacity
        return cells * (32 + 3 * row_bytes(node.schema))
    if isinstance(node, (SortExec, WindowExec)):
        keys = len(node.keys) if isinstance(node, SortExec) else 2
        return node.capacity * (25 * keys + 8) + (
            batch_bytes(node.schema, node.capacity)
            if isinstance(node, WindowExec) else 0)
    if isinstance(node, CoalesceExec):
        return sum(batch_bytes(c.schema, c.capacity)
                   for c in node.children) + node.capacity * 9
    return 0


def _leaf_bytes(root) -> int:
    """The bound table columns: each (table, column) once, as
    `SessionContext.bind_inputs` uploads them."""
    from .plan import InputLeaf
    cols: Dict[tuple, int] = {}
    seen = set()

    def walk(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        if isinstance(n, InputLeaf):
            table = n.input_id.partition("::")[0]
            for f in n.schema.fields:
                cols[(table, f.name)] = n.capacity * (
                    _dtype_bytes(f.dtype) + 1)
        for c in n.children:
            walk(c)

    walk(root)
    return sum(cols.values())


def estimate_plan_hbm(root, detail: bool = False):
    """Peak device bytes of `run_plan(root, ...)`, following `Run.eval`'s
    depth-first order (see the module docstring). With `detail`, returns
    (peak, [(node label, live bytes while it runs, output, transient)])."""
    leaves = _leaf_bytes(root)
    shared: Dict[int, list] = {}      # id -> [bytes, unread parent edges]
    peak, rows = leaves, []

    def read(node, held: int) -> int:
        """Evaluate `node` for a parent (as Run.eval does); returns the
        bytes the parent now holds for it."""
        if node.n_parents <= 1:
            visit(node, held)
            return _out_bytes(node)
        entry = shared.get(id(node))
        if entry is None:
            visit(node, held)
            entry = shared[id(node)] = [_out_bytes(node), node.n_parents]
        entry[1] -= 1
        if entry[1] == 0:
            del shared[id(node)]
            return entry[0]
        return 0                      # still counted among the shared

    def visit(node, held: int) -> None:
        nonlocal peak
        kids = 0
        for c in node.children:
            kids += read(c, held + kids)
        if not node.children:
            return
        out, trans = _out_bytes(node), _node_transient(node)
        total = (leaves + held + kids + out + trans
                 + sum(v for v, _ in shared.values()))
        rows.append((node._label(), total, out, trans))
        peak = max(peak, total)

    read(root, 0)
    return (peak, rows) if detail else peak


def estimate_stage_hbm(root) -> int:
    """Peak device bytes of one partition of a serial stage: its body's
    run, the stage inputs counted as the bound columns, and at an exchange
    the send rows made from the body's output (`exchange_send_rows`: the
    rows grouped by destination, S copies under replicate salting, with
    the destination sort and the row maps, 40 bytes a row)."""
    from .distributed import ExchangeExec, GatherExec
    if not isinstance(root, (ExchangeExec, GatherExec)):
        return estimate_plan_hbm(root)
    body = root.children[0]
    peak = estimate_plan_hbm(body)
    if isinstance(root, ExchangeExec):
        rows = body.capacity * root.salt
        peak = max(peak, _leaf_bytes(body) + _out_bytes(body)
                   + batch_bytes(root.schema, rows) + 40 * rows)
    return peak


def hbm_budget_bytes(device) -> Optional[int]:
    """Device bytes a plan may use: BALLISTA_HBM_BYTES where set (as the
    reference), else the CUDA device's total memory times SLACK, less
    what the binder's device LUT cache holds there (up to 512 MiB,
    `exprs.device_lut_bytes`). None for a device that is not a CUDA
    device (nothing to route against)."""
    env = os.environ.get("BALLISTA_HBM_BYTES")
    device = torch.device(device)
    if env:
        return int(float(env)) - device_lut_bytes(device)
    if device.type != "cuda":
        return None
    return (int(torch.cuda.mem_get_info(device)[1] * SLACK)
            - device_lut_bytes(device))


def route_serial(exec_plan, budget: int) -> int:
    """In-core or out-of-core for a physical plan: 0 (run in-core) or a
    serial partition count N > 0. A plan that ran out of memory before
    (the OOM memo) goes out-of-core at the count learned then; any other
    goes when its estimate exceeds `budget` x the route factor
    (BALLISTA_ROUTE_FACTOR, default ROUTE_FACTOR; 0 turns routing off,
    memo included). A borderline plan runs in-core first and relies on
    the caller's out-of-memory fallback and the memo."""
    factor = float(os.environ.get("BALLISTA_ROUTE_FACTOR", ROUTE_FACTOR))
    if factor <= 0:
        return 0
    memo_n = oom_memo_lookup(plan_fingerprint(exec_plan))
    if memo_n:
        return memo_n
    est = estimate_plan_hbm(exec_plan)
    if est <= budget * factor:
        return 0
    return plan_serial_partitions(est, budget)


def _oom_memo_path() -> str:
    """The memo file, under the checkout's build directory (gitignored)."""
    return str(Path(__file__).resolve().parents[2] / "build"
               / "oom_memo.json")


def plan_fingerprint(exec_plan) -> str:
    """Stable id of a physical plan's shape (operators and capacities:
    display() shows both)."""
    return hashlib.sha256(exec_plan.display().encode()).hexdigest()[:24]


def oom_memo_lookup(fingerprint: str) -> int:
    """The serial partition count a run learned for this plan shape after
    an in-core out-of-memory error; 0 = no memo. A borderline plan can
    only be learned, not predicted: the memo makes the failed in-core run
    a once-per-shape cost instead of once per process."""
    try:
        with open(_oom_memo_path()) as f:
            return int(json.load(f).get(fingerprint, 0))
    except (OSError, ValueError):      # no memo, or an unreadable one
        return 0


def oom_memo_record(fingerprint: str, n_parts: int) -> None:
    path = _oom_memo_path()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        with open(path) as f:
            memo = json.load(f)
    except (OSError, ValueError):
        memo = {}
    memo[fingerprint] = int(n_parts)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(memo, f)
    os.replace(tmp, path)


def plan_serial_partitions(estimate: int, budget: int,
                           max_parts: int = 64) -> int:
    """Partition count for the serial runtime: each partition's working
    set should land around half the budget (headroom for the exchange
    buffers, which do not shrink with P)."""
    n = 2
    while n < max_parts and estimate / n > budget * 0.5:
        n *= 2
    return n
