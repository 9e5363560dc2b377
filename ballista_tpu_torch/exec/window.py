"""Window functions: sorted-space, positional (port of
ballista_tpu/exec/window.py; DataFusion's WindowAggExec family).

One lexicographic sort by (partition keys, order keys) per distinct
(PARTITION BY, ORDER BY) clause; every function is then a few
cumsum/gather passes over the sorted arrays. Results route back
through the inverse permutation, so the operator is positional: rows in,
same rows + window columns out.

Frames follow SQL defaults:
  - with ORDER BY:    RANGE UNBOUNDED PRECEDING .. CURRENT ROW (peers
                      share the frame end -> running sum at peer-run end)
  - without ORDER BY: whole partition

Explicit frames: full ROWS BETWEEN support (UNBOUNDED/CURRENT/k
PRECEDING/FOLLOWING — sums via prefix-sum differences at the frame
bounds, extrema via a sparse-table range query: log n shifted-combine
levels + two overlapping power-of-two windows per position). RANGE frames
support UNBOUNDED/CURRENT bounds (value-offset RANGE bounds are not
implemented, matching DataFusion's common subset).

Sums and counts are differences of running sums: exact for int64 and
decimal arguments, and for floats equal to a direct sum only up to the
rounding of an f64 running sum over the whole sorted column.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..batch import Batch, Column, row_mask
from ..exprs import (Bound, Expr, _div_scaled, bind_expr, expr_name,
                     sorted_recode)
from ..ops.hash import _norm_keys
from ..ops.sort import SortKeySpec, _rankable
from ..ops.vsort import lex_perm
from ..schema import FLOAT64, INT64, Field, Schema, TypeKind
from .aggregate import _avg_dtype, _sum_dtype
from .plan import ExecNode

RANKING = ("row_number", "rank", "dense_rank", "ntile", "percent_rank",
           "cume_dist")
AGGS = ("sum", "avg", "min", "max", "count", "count_star")
NAVIGATION = ("lag", "lead", "first_value", "last_value", "nth_value")


def _sentinel(dtype: torch.dtype, is_max: bool):
    """The value no valid value beats: the identity of max (or min)."""
    if dtype.is_floating_point:
        return float("-inf") if is_max else float("inf")
    info = torch.iinfo(dtype)
    return info.min if is_max else info.max


def _shift_down(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """y[p] = x[p - k], `fill` for p < k."""
    return torch.cat([x.new_full((k,), fill), x[:-k]])


def _shift_up(x: torch.Tensor, k: int, fill) -> torch.Tensor:
    """y[p] = x[p + k], `fill` past the end."""
    return torch.cat([x[k:], x.new_full((k,), fill)])


def _segmented_prefix_extremum(vals: torch.Tensor, valid: torch.Tensor,
                               seg_start: torch.Tensor, is_max: bool):
    """Per position p: extremum of valid vals over [seg_start[p], p].

    Binary lifting: after pass k, m[p] covers a window of 2^(k+1) trailing
    positions clipped to p's segment — combining m[p] with m[p-2^k] is
    safe because p-2^k >= seg_start[p] implies both lie in one segment.
    O(log n) masked shift+combine passes."""
    n = vals.shape[0]
    sent = _sentinel(vals.dtype, is_max)
    m = torch.where(valid, vals, sent)
    av = valid
    pos = torch.arange(n, dtype=torch.int64, device=vals.device)
    combine = torch.maximum if is_max else torch.minimum
    k = 1
    while k < n:
        ok = (pos - k) >= seg_start
        m = combine(m, torch.where(ok, _shift_down(m, k, sent), sent))
        av = av | (ok & _shift_down(av, k, False))
        k *= 2
    return m, av


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for int64 1 <= x < 2^52 (frame lengths): the f64
    logarithm, corrected by one where its rounding missed a power of two."""
    j = torch.log2(x.to(torch.float64)).floor().to(torch.int64)
    one = torch.ones_like(j)
    j = j + ((one << (j + 1)) <= x).to(torch.int64)
    return j - ((one << j) > x).to(torch.int64)


def _range_extremum(vals: torch.Tensor, valid: torch.Tensor, fs: torch.Tensor,
                    fe: torch.Tensor, is_max: bool):
    """Per position p: extremum of valid vals over [fs[p], fe[p]] (empty
    when fs>fe). Sparse table: level j covers [p, p+2^j-1]; a query range
    of length L is the combine of two (overlapping) level-floor(log2 L)
    windows anchored at fs and fe-2^j+1. O(n log n) build, 4 gathers per
    query. The table holds ceil(log2 n) + 1 levels of n values (and as
    many bools)."""
    n = vals.shape[0]
    sent = _sentinel(vals.dtype, is_max)
    combine = torch.maximum if is_max else torch.minimum
    levels = 1
    while (1 << (levels - 1)) < n:
        levels += 1
    st = vals.new_empty((levels, n))
    sv = valid.new_empty((levels, n))
    st[0] = torch.where(valid, vals, sent)
    sv[0] = valid
    for lv in range(1, levels):
        k = 1 << (lv - 1)
        st[lv] = combine(st[lv - 1], _shift_up(st[lv - 1], k, sent))
        sv[lv] = sv[lv - 1] | _shift_up(sv[lv - 1], k, False)
    length = fe - fs + 1
    nonempty = length > 0
    j = torch.where(nonempty, _floor_log2(length.clamp(min=1)), 0)
    pw = torch.ones_like(j) << j
    flat_a = j * n + fs.clamp(0, n - 1)
    flat_b = j * n + (fe - pw + 1).clamp(0, n - 1)
    st, sv = st.reshape(-1), sv.reshape(-1)
    out = combine(st.index_select(0, flat_a), st.index_select(0, flat_b))
    ok = sv.index_select(0, flat_a) | sv.index_select(0, flat_b)
    return out, ok & nonempty


@dataclasses.dataclass(frozen=True)
class WindowFnSpec:
    kind: str                       # RANKING | AGGS | NAVIGATION
    arg: Optional[Expr]             # None for row_number/rank/.../count(*)
    partition_by: Tuple[Expr, ...]
    order_by: Tuple[Tuple[Expr, bool, Optional[bool]], ...]
    offset: int = 1                 # lag/lead distance; ntile N; nth_value k
    frame: Optional[Tuple[str, Optional[int], Optional[int]]] = None
    alias: Optional[str] = None

    @property
    def name(self) -> str:
        if self.alias:
            return self.alias
        a = expr_name(self.arg) if self.arg is not None else ""
        return f"{self.kind}({a})"


def _out_field(spec: WindowFnSpec, in_schema: Schema) -> Field:
    k = spec.kind
    if k in ("row_number", "rank", "dense_rank", "ntile"):
        return Field(spec.name, INT64, nullable=False)
    if k in ("count", "count_star"):
        return Field(spec.name, INT64, nullable=False)
    if k in ("percent_rank", "cume_dist"):
        return Field(spec.name, FLOAT64, nullable=False)
    b = bind_expr(spec.arg, in_schema)
    if k == "sum":
        return Field(spec.name, _sum_dtype(b.dtype), nullable=True)
    if k == "avg":
        return Field(spec.name, _avg_dtype(b.dtype), nullable=True)
    if k in ("min", "max", "lag", "lead", "first_value", "last_value",
             "nth_value"):
        return Field(spec.name, b.dtype, nullable=True)
    raise NotImplementedError(f"window function {k}")


def _run_first(sorted_keys: Sequence[torch.Tensor], n: int, device):
    """True where a sorted row differs from the row before it in any of
    `sorted_keys` (row 0 is always first)."""
    same = torch.ones(n, dtype=torch.bool, device=device)
    for sk in sorted_keys:
        same = same & (sk == torch.cat([sk[:1], sk[:-1]]))
    same[0] = False
    return ~same


def _run_bounds(first: torch.Tensor, pos: torch.Tensor):
    """Per position, the positions of its run's first and last row, from
    the run-first flags. (The reference takes a running maximum of the
    flagged positions and a reversed running minimum; `torch.cummax` scans
    a 1-D tensor in one block, 17.5 ms per 6M rows on an H100, so here a
    running count numbers the runs and each run's first row writes its
    position into that run's cell.)"""
    n = pos.shape[0]
    run = torch.cumsum(first, 0) - 1
    # cell r: where run r starts; cells past the last run keep n; every
    # row that is not a run's first writes to the spare cell n + 1
    starts = pos.new_full((n + 2,), n)
    starts.index_copy_(0, torch.where(first, run, n + 1), pos)
    return starts.index_select(0, run), starts.index_select(0, run + 1) - 1


class WindowExec(ExecNode):
    """Positional operator: child rows + one new column per window spec.

    Specs sharing (partition_by, order_by) reuse one sort. min/max without
    ORDER BY use a second value-keyed sort per spec (partition extremum =
    run head of that sort)."""

    def __init__(self, child: ExecNode, specs: Sequence[WindowFnSpec]):
        self.children = (child,)
        self.specs = tuple(specs)
        self.capacity = child.capacity
        in_schema = child.schema
        new_fields = []
        for s in self.specs:
            if s.kind in RANKING + NAVIGATION and not s.order_by:
                raise ValueError(f"{s.kind} requires OVER(... ORDER BY ...)")
            if s.frame is not None:
                mode, lo, hi = s.frame
                if mode == "range" and ((lo not in (None, 0))
                                        or (hi not in (None, 0))):
                    raise NotImplementedError(
                        "RANGE frames with value offsets; use ROWS")
            new_fields.append(_out_field(s, in_schema))
        names = [f.name for f in in_schema.fields] + [f.name for f in new_fields]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate column names in window output: {names}")
        self.schema = Schema(in_schema.fields + tuple(new_fields),
                             dict(in_schema.dictionaries),
                             in_schema.int_bounds, in_schema.unsorted)
        # group specs by shared clause
        self._groups: Dict[Tuple, List[int]] = {}
        for i, s in enumerate(self.specs):
            self._groups.setdefault((s.partition_by, s.order_by), []).append(i)
        # RAW string partition and order keys re-encode: dense-rank codes
        # restore value equality (partitions) and lexicographic order
        self._bound_parts = [tuple(sorted_recode(bind_expr(e, in_schema))
                                   for e in s.partition_by)
                             for s in self.specs]
        self._bound_orders = [tuple((sorted_recode(bind_expr(e, in_schema)),
                                     asc, nf)
                                    for e, asc, nf in s.order_by)
                              for s in self.specs]
        self._bound_args = [bind_expr(s.arg, in_schema) if s.arg is not None
                            else None for s in self.specs]

    def _label(self):
        return f"WindowExec({[s.name for s in self.specs]})"

    # -- evaluation --

    def evaluate(self, run) -> Batch:
        b = run.eval(self.children[0])
        live = row_mask(b)
        out_cols: List[Column] = [None] * len(self.specs)
        for idxs in self._groups.values():
            rep = idxs[0]
            lay = self._sorted_layout(b, live, self._bound_parts[rep],
                                      self._bound_orders[rep])
            for i in idxs:
                out_cols[i] = self._compute(b, live, i, lay)
        live_cols = [Column(c.data, c.validity & live) for c in out_cols]
        return Batch(b.columns + tuple(live_cols), b.num_rows)

    @staticmethod
    def _sort_by(live, pnorm, ranks):
        """Stable sort by (liveness, partition keys, `ranks`): returns
        (perm, sorted position of each row's partition start)."""
        n = live.shape[0]
        keys = [(~live).to(torch.uint8)] + list(pnorm) + list(ranks)
        perm = lex_perm(keys)
        pos = torch.arange(n, dtype=torch.int64, device=live.device)
        s_part = [k.index_select(0, perm) for k in keys[:1 + len(pnorm)]]
        part_first = _run_first(s_part, n, live.device)
        return perm, pos, part_first

    def _sorted_layout(self, b: Batch, live, parts: Tuple[Bound, ...],
                       orders):
        """Sort by (liveness, partition keys, order keys); return run info."""
        n = b.capacity
        pcols = [p.fn(b) for p in parts]
        pnorm = _norm_keys([c.data for c in pcols],
                           [c.validity for c in pcols])
        oranks = []
        for ob, asc, nf in orders:
            c = ob.fn(b)
            oranks.append(_rankable(c.data, c.validity,
                                    SortKeySpec(0, asc, nf)))
        perm, pos, part_first = self._sort_by(live, pnorm, oranks)
        # the inverse permutation is one scatter of the positions
        inv = torch.empty_like(perm).index_copy_(0, perm, pos)
        s_orders = [k.index_select(0, perm) for k in oranks]
        peer_first = part_first | _run_first(s_orders, n, live.device)
        seg_start, seg_end = _run_bounds(part_first, pos)
        peer_start, peer_end = _run_bounds(peer_first, pos)
        return dict(perm=perm, inv=inv, pos=pos, has_order=bool(orders),
                    seg_start=seg_start, seg_end=seg_end,
                    peer_start=peer_start, peer_end=peer_end,
                    peer_first=peer_first)

    @staticmethod
    def _frame_bounds(spec, lay):
        """Per sorted position: the frame [fs, fe] (fs > fe = empty)."""
        seg_start, seg_end = lay["seg_start"], lay["seg_end"]
        if spec.frame is None:
            if lay["has_order"]:
                return seg_start, lay["peer_end"]   # RANGE UNBOUNDED..CURRENT
            return seg_start, seg_end
        mode, lo, hi = spec.frame
        pos = lay["pos"]
        if mode == "range":
            fs = seg_start if lo is None else lay["peer_start"]
            fe = seg_end if hi is None else lay["peer_end"]
        else:  # rows
            fs = seg_start if lo is None else torch.minimum(
                torch.maximum(pos + lo, seg_start), seg_end + 1)
            fe = seg_end if hi is None else torch.minimum(
                torch.maximum(pos + hi, seg_start - 1), seg_end)
        return fs, fe

    def _compute(self, b, live, i, lay) -> Column:
        spec = self.specs[i]
        k = spec.kind
        n = b.capacity
        perm, inv, pos = lay["perm"], lay["inv"], lay["pos"]
        seg_start, seg_end = lay["seg_start"], lay["seg_end"]
        peer_start, peer_end = lay["peer_start"], lay["peer_end"]
        seg_size = seg_end - seg_start + 1
        all_valid = torch.ones(n, dtype=torch.bool, device=b.device)

        def back(x):
            return x.index_select(0, inv)

        if k == "row_number":
            return Column(back(pos - seg_start + 1), all_valid)
        if k == "rank":
            return Column(back(peer_start - seg_start + 1), all_valid)
        if k == "dense_rank":
            pf = torch.cumsum(lay["peer_first"].to(torch.int64), 0)
            return Column(back(pf - pf.index_select(0, seg_start) + 1),
                          all_valid)
        if k == "ntile":
            # SQL ntile(N): first (size mod N) buckets get one extra row
            N = spec.offset
            r = pos - seg_start
            base = torch.div(seg_size, N, rounding_mode="floor")
            rem = seg_size % N
            cut = rem * (base + 1)
            lo_b = torch.div(r, (base + 1).clamp(min=1), rounding_mode="floor")
            hi_b = rem + torch.div(r - cut, base.clamp(min=1),
                                   rounding_mode="floor")
            return Column(back(torch.where(r < cut, lo_b, hi_b) + 1), all_valid)
        if k == "percent_rank":
            rank0 = (peer_start - seg_start).to(torch.float64)
            v = torch.where(seg_size > 1,
                            rank0 / (seg_size - 1).clamp(min=1)
                            .to(torch.float64), 0.0)
            return Column(back(v), all_valid)
        if k == "cume_dist":
            v = ((peer_end - seg_start + 1).to(torch.float64)
                 / seg_size.to(torch.float64))
            return Column(back(v), all_valid)

        fs, fe = self._frame_bounds(spec, lay)

        if k in ("min", "max") and not lay["has_order"] and spec.frame is None:
            return self._partition_extremum(b, live, i, spec)

        arg = self._bound_args[i]
        if arg is not None:
            c = arg.fn(b)
            sdata = c.data.index_select(0, perm)
            svalid = (c.validity & live).index_select(0, perm)
        else:
            sdata = torch.zeros(n, dtype=torch.int64, device=b.device)
            svalid = live.index_select(0, perm)

        if k in ("min", "max"):
            if spec.frame is None or spec.frame[1] is None:
                # frame start is the partition start (constant over the
                # span [p, fe]): segmented prefix extremum by binary
                # lifting, read at the frame end
                pm, pv = _segmented_prefix_extremum(sdata, svalid, fs,
                                                    k == "max")
                end = fe.clamp(0, n - 1)
                ok = pv.index_select(0, end) & (fs <= fe)
                return Column(back(pm.index_select(0, end)), back(ok))
            pm, pv = _range_extremum(sdata, svalid, fs, fe, k == "max")
            return Column(back(pm), back(pv))

        if k in ("lag", "lead"):
            src = pos - (spec.offset if k == "lag" else -spec.offset)
            in_part = (src >= seg_start) & (src <= seg_end)
            srcc = src.clamp(0, n - 1)
            return Column(back(sdata.index_select(0, srcc)),
                          back(svalid.index_select(0, srcc) & in_part))
        if k in ("first_value", "last_value", "nth_value"):
            nonempty = fs <= fe
            if k == "first_value":
                idx = fs
            elif k == "last_value":
                idx = fe
            else:
                idx = fs + (spec.offset - 1)
                nonempty = nonempty & (idx <= fe)
            idx = idx.clamp(0, n - 1)
            return Column(back(sdata.index_select(0, idx)),
                          back(svalid.index_select(0, idx) & nonempty))

        # framed / cumulative / whole-partition sum, count, avg: prefix-sum
        # differences at the frame bounds (csum0[i] = sum over [0, i))
        out_dt = self.schema.fields[len(b.columns) + i].dtype
        if k in ("sum", "avg") and out_dt.kind in (TypeKind.DECIMAL,
                                                   TypeKind.INT64):
            acc = torch.where(svalid, sdata.to(torch.int64), 0)
        elif k in ("count", "count_star"):
            acc = svalid.to(torch.int64)
        else:
            acc = torch.where(svalid, sdata, torch.zeros_like(sdata))
        csum0 = torch.cat([acc.new_zeros(1), torch.cumsum(acc, 0)])
        ccnt0 = torch.cat([pos.new_zeros(1),
                           torch.cumsum(svalid.to(torch.int64), 0)])
        nonempty = fs <= fe
        hi_i = (fe + 1).clamp(0, n)
        lo_i = fs.clamp(0, n)
        total = csum0.index_select(0, hi_i) - csum0.index_select(0, lo_i)
        count = ccnt0.index_select(0, hi_i) - ccnt0.index_select(0, lo_i)
        total = torch.where(nonempty, total, torch.zeros_like(total))
        count = torch.where(nonempty, count, 0)

        if k in ("count", "count_star"):
            return Column(back(count), all_valid)
        if k == "sum":
            return Column(back(total).to(out_dt.torch_dtype), back(count > 0))
        # avg
        if out_dt.kind is TypeKind.DECIMAL:
            in_scale = _sum_dtype(self._bound_args[i].dtype).scale
            q = _div_scaled(total, count.clamp(min=1), out_dt.scale - in_scale)
            return Column(back(q), back(count > 0))
        td = out_dt.torch_dtype
        d = total.to(td) / count.clamp(min=1).to(td)
        return Column(back(d), back(count > 0))

    def _partition_extremum(self, b, live, i, spec) -> Column:
        """min/max over the whole partition: second sort keyed by
        (partition keys, value) — the extremum is each run's head value."""
        c = self._bound_args[i].fn(b)
        pcols = [p.fn(b) for p in self._bound_parts[i]]
        pnorm = _norm_keys([x.data for x in pcols],
                           [x.validity for x in pcols])
        valid = c.validity & live
        vrank = _rankable(c.data, valid,
                          SortKeySpec(0, spec.kind == "min", False))
        perm, pos, part_first = self._sort_by(live, pnorm, [vrank])
        head = perm.index_select(0, _run_bounds(part_first, pos)[0])
        # nulls sort last: the head is valid iff any value of the run is
        v = c.data.index_select(0, head)
        ok = valid.index_select(0, head)
        # back to the original row order: one scatter through perm
        return Column(torch.empty_like(v).index_copy_(0, perm, v),
                      torch.empty_like(ok).index_copy_(0, perm, ok))
