"""Logical optimizer rules.

Reference parity: DataFusion's optimizer (the engine kernel's
projection-pushdown / pruning rules that Ballista inherits). The one that
matters most on the device is COLUMN PRUNING: scans otherwise carry every
table column through joins — at SF1 that is ~1 GB of lineitem columns
resident for queries that read four of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

from ..exprs import expr_columns
from . import logical as L


def prune_columns(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Push required-column sets down to TableScans (projection pushdown)."""
    return _prune(plan, None)


def _all_names(p: L.LogicalPlan) -> Set[str]:
    return {f.name for f in p.schema().fields}


def _prune(p: L.LogicalPlan, needed: Optional[Set[str]]) -> L.LogicalPlan:
    """needed=None means every output column is required."""
    if isinstance(p, L.TableScan):
        if needed is None:
            return p
        cols = [f.name for f in p.table_schema.fields if f.name in needed]
        if not cols:
            # count(*)-style: keep one column so the scan still carries rows
            cols = [p.table_schema.fields[0].name]
        if len(cols) == len(p.table_schema.fields):
            return p
        return dataclasses.replace(p, projection=tuple(cols))

    if isinstance(p, L.Projection):
        names = p.names or tuple(str(e) for e in p.exprs)
        if needed is None:
            keep = list(zip(p.exprs, names))
        else:
            keep = [(e, n) for e, n in zip(p.exprs, names) if n in needed]
            if not keep:  # keep at least one column (row counting)
                keep = [(p.exprs[0], names[0])]
        child_needed = set()
        for e, _ in keep:
            child_needed |= expr_columns(e)
        child = _prune(p.input, child_needed)
        return L.Projection(child, tuple(e for e, _ in keep),
                            tuple(n for _, n in keep))

    if isinstance(p, L.Filter):
        child_needed = (None if needed is None
                        else needed | expr_columns(p.predicate))
        return L.Filter(_prune(p.input, child_needed), p.predicate)

    if isinstance(p, L.Aggregate):
        child_needed = set()
        for g in p.group_exprs:
            child_needed |= expr_columns(g)
        for a in p.aggs:
            if a.arg is not None:
                child_needed |= expr_columns(a.arg)
            if a.arg2 is not None:
                child_needed |= expr_columns(a.arg2)
        return dataclasses.replace(p, input=_prune(p.input, child_needed))

    if isinstance(p, (L.Sort,)):
        child_needed = None
        if needed is not None:
            child_needed = set(needed)
            for e, _, _ in p.keys:
                child_needed |= expr_columns(e)
        return dataclasses.replace(p, input=_prune(p.input, child_needed))

    if isinstance(p, L.Limit):
        return dataclasses.replace(p, input=_prune(p.input, needed))

    if isinstance(p, L.Distinct):
        # distinct is over all columns of its input
        return dataclasses.replace(p, input=_prune(p.input, None))

    if isinstance(p, L.Join):
        lnames = _all_names(p.left)
        rnames = _all_names(p.right)
        if needed is None:
            lneed: Optional[Set[str]] = None
            rneed: Optional[Set[str]] = None
        else:
            lneed = {n for n in needed if n in lnames}
            rneed = {n for n in needed if n in rnames}
        for a, b in p.on:
            if lneed is not None:
                lneed.add(a)
            if rneed is not None:
                rneed.add(b)
        if p.how in ("semi", "anti"):
            # output is the probe (right) side only; build still needs keys
            lneed = {a for a, _ in p.on} if lneed is not None else None
        joined = dataclasses.replace(p, left=_prune(p.left, lneed),
                                     right=_prune(p.right, rneed))
        if needed is not None and p.how not in ("semi", "anti"):
            # drop columns the join itself needed (its keys) but nothing
            # above reads: every dead column otherwise rides the join's
            # materialization gather and downstream sort payloads, and
            # blocks the build-payload fast path's bit budget
            out_names = [f.name for f in joined.schema().fields]
            keep = [n for n in out_names if n in needed]
            if keep and len(keep) < len(out_names):
                from ..exprs import Col
                return L.Projection(joined, tuple(Col(n) for n in keep),
                                    tuple(keep))
        return joined

    if isinstance(p, L.Union):
        # positional semantics: prune each input to its own projection
        # (inputs are Projections aligned by _plan_union / align helper)
        return dataclasses.replace(
            p, inputs=tuple(_prune(c, needed) for c in p.inputs))

    return p


def mark_carried(plan: L.LogicalPlan) -> L.LogicalPlan:
    """Mark each SUM whose output no operator above reads as a value
    (`AggExpr.carried`): it is only projected, limited, exchanged, carried
    by a join or by a sort on other keys, or returned. A wide SUM keeps its
    two words there alone. One that is read (by an expression, a filter, a
    sort, group or join key, an aggregate other than COUNT, or a window)
    is narrowed at its aggregate's output to the JAX package's type
    (`exec.aggregate.narrows`), under the name the query shows it by
    (`AggExpr.shown`). Every lowering of a plan calls this."""
    return _mark(plan, {})


def _mark(p: L.LogicalPlan, reads: Dict[str, Optional[str]]
          ) -> L.LogicalPlan:
    """`reads`: p's output columns that an operator above reads, each with
    the alias a projection above shows it by (None: its own name)."""
    from ..exprs import Alias, Col, expr_name
    if isinstance(p, (L.TableScan, L.OneRow)):
        return p
    if isinstance(p, (L.Filter, L.Sort, L.Limit, L.Window)):
        below = dict.fromkeys(_columns(_operands(p)))
        below.update(reads)
        return dataclasses.replace(p, input=_mark(p.input, below))
    if isinstance(p, L.Projection):
        below = {}
        for e, n in zip(p.exprs, p.names or [expr_name(e) for e in p.exprs]):
            base = e.child if isinstance(e, Alias) else e
            if not isinstance(base, Col):
                for c in expr_columns(base):
                    below.setdefault(c, None)
            elif n in reads:
                below[base.name] = reads[n] or n
        return dataclasses.replace(p, input=_mark(p.input, below))
    if isinstance(p, L.Aggregate):
        args = [x for a in p.aggs if a.kind not in ("count", "count_star")
                for x in (a.arg, a.arg2)]
        aggs = tuple(dataclasses.replace(
            a, carried=a.name not in reads, shown=reads.get(a.name))
            if a.kind == "sum" else a for a in p.aggs)
        below = dict.fromkeys(_columns(list(p.group_exprs) + args))
        return dataclasses.replace(p, aggs=aggs, input=_mark(p.input, below))
    if isinstance(p, L.Join):
        def side(child, keys):
            names = _all_names(child)
            below = dict.fromkeys(keys)
            below.update((n, a) for n, a in reads.items() if n in names)
            return below
        lkeys = [a for a, _ in p.on]
        left = (dict.fromkeys(lkeys) if p.how in ("semi", "anti")
                else side(p.left, lkeys))
        return dataclasses.replace(
            p, left=_mark(p.left, left),
            right=_mark(p.right, side(p.right, [b for _, b in p.on])))
    if isinstance(p, L.Union):
        # positional: the first input's names are the union's
        first = [f.name for f in p.inputs[0].schema().fields]
        at = [i for i, n in enumerate(first) if n in reads]
        return dataclasses.replace(p, inputs=tuple(
            _mark(c, dict.fromkeys(c.schema().fields[i].name for i in at))
            for c in p.inputs))
    # DISTINCT groups by every column: so does any other node
    return dataclasses.replace(p, **{
        f.name: _mark(child, dict.fromkeys(_all_names(child)))
        for f in dataclasses.fields(p)
        for child in [getattr(p, f.name)]
        if isinstance(child, L.LogicalPlan)})


def _operands(p: L.LogicalPlan) -> list:
    """The expressions a filter, sort, limit or window reads."""
    if isinstance(p, L.Filter):
        return [p.predicate]
    if isinstance(p, L.Sort):
        return [e for e, _, _ in p.keys]
    if isinstance(p, L.Window):
        return [e for s in p.specs
                for e in (s.arg, *s.partition_by, *(o[0] for o in s.order_by))]
    return []


def _columns(exprs) -> Set[str]:
    out: Set[str] = set()
    for e in exprs:
        if e is not None:
            out |= expr_columns(e)
    return out


# ---------------------------------------------------------------------------
# GROUP BY key elimination via functional dependencies.
#
# TPC-H q10 groups by c_custkey plus six more customer columns; q18 by five
# columns that one key determines. Every surplus group key is one more sort
# operand in the aggregate's grouping sort (sort COMPILE time is superlinear
# in operand count; runtime pays ~11ms per operand at 6M rows on v5e) and
# one more rolled compare in run detection. A base table's single-column
# unique key determines every column of that table in any derived relation
# (each row's T-part is one T tuple), and join equalities extend this
# transitively (probe key = unique build key => probe key determines the
# build row). Keys determined by a kept key demote to carry() aggregates —
# any value of the group, all equal by construction (an O(T) run-end read
# in the sorted layout; dictionary codes round-trip exactly). (DataFusion
# has the same rule for declared PKs; the reference inherits it.)
# ---------------------------------------------------------------------------

def reduce_group_keys(plan: L.LogicalPlan) -> L.LogicalPlan:
    kids = plan.children()
    if kids:
        new = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
        changed = False
        for key, val in list(new.items()):
            if isinstance(val, L.LogicalPlan):
                r = reduce_group_keys(val)
                changed |= r is not val
                new[key] = r
            elif (isinstance(val, tuple) and val
                  and all(isinstance(v, L.LogicalPlan) for v in val)):
                r = tuple(reduce_group_keys(v) for v in val)
                changed |= any(a is not b for a, b in zip(r, val))
                new[key] = r
        if changed:
            plan = type(plan)(**new)
    if not (isinstance(plan, L.Aggregate) and len(plan.group_exprs) > 1):
        return plan

    from ..exprs import Alias, Col
    fds = _fds(plan.input)
    if not fds:
        return plan
    names = plan.group_names or tuple(
        L.expr_name(e) for e in plan.group_exprs)
    base = []
    for e in plan.group_exprs:
        b = e.child if isinstance(e, Alias) else e
        base.append(b.name if isinstance(b, Col) else None)
    demoted = [False] * len(base)
    for i, bi in enumerate(base):
        if demoted[i] or bi is None or bi not in fds:
            continue
        det = fds[bi]
        for j, bj in enumerate(base):
            if j == i or demoted[j] or bj is None:
                continue
            if bj in det:
                demoted[j] = True
    if not any(demoted):
        return plan
    keys, knames, carries = [], [], []
    for i, (e, n) in enumerate(zip(plan.group_exprs, names)):
        if demoted[i]:
            carries.append(L.AggExpr("carry", arg=Col(base[i]), alias=n))
        else:
            keys.append(e)
            knames.append(n)
    return dataclasses.replace(plan, group_exprs=tuple(keys),
                               group_names=tuple(knames),
                               aggs=tuple(carries) + plan.aggs)


def _fds(p: L.LogicalPlan):
    """{col -> set of columns it determines} in p's output, single-column
    determinants only. Sound under row subsetting (filter/limit/distinct),
    row duplication (expanding joins), and NULL-extension on the build
    side (unmatched rows take consistently-NULL build columns)."""
    if isinstance(p, L.TableScan):
        cols = [f.name for f in p.schema().fields]
        out = {}
        for u in p.unique_cols or ():
            u = tuple(u)
            if len(u) == 1 and u[0] in cols:
                out[u[0]] = set(cols)
        return out
    if isinstance(p, (L.Filter, L.Limit, L.Sort, L.Distinct, L.Window)):
        return _fds(p.input)
    if isinstance(p, L.Projection):
        from ..exprs import Alias, Col
        child = _fds(p.input)
        names = p.names or tuple(L.expr_name(e) for e in p.exprs)
        base_of = {}
        for e, n in zip(p.exprs, names):
            b = e.child if isinstance(e, Alias) else e
            if isinstance(b, Col):
                base_of[n] = b.name
        outs_of = {}
        for o, b in base_of.items():
            outs_of.setdefault(b, []).append(o)
        out = {}
        for det, det_set in child.items():
            for det_out in outs_of.get(det, ()):
                out[det_out] = {o for o in names
                                if base_of.get(o) in det_set}
        return out
    if isinstance(p, L.Aggregate):
        from ..exprs import Alias, Col
        if len(p.group_exprs) == 1:
            e = p.group_exprs[0]
            b = e.child if isinstance(e, Alias) else e
            if isinstance(b, Col):
                names = p.group_names or (L.expr_name(e),)
                return {names[0]: {f.name for f in p.schema().fields}}
        return {}
    if isinstance(p, L.Join):
        if p.how in ("semi", "anti"):
            return _fds(p.right)
        if p.how == "full_outer":
            return {}
        fds = {**_fds(p.left), **_fds(p.right)}
        # join equalities: probe col determines the (unique-)build key in
        # inner AND left_outer (unmatched rows see NULL build cols,
        # consistently per probe key); build determines probe only in
        # inner (left_outer pads build cols with NULL across distinct
        # probe rows)
        if p.how in ("inner", "left_outer"):
            for a, b in p.on:  # (build col, probe col)
                fds.setdefault(b, {b}).add(a)
                if p.how == "inner":
                    fds.setdefault(a, {a}).add(b)
        changed = True
        while changed:
            changed = False
            for d, s in fds.items():
                grow = set()
                for c in list(s):
                    if c != d and c in fds and not fds[c] <= s:
                        grow |= fds[c]
                if grow - s:
                    s |= grow
                    changed = True
        return fds
    return {}
