"""SQL AST -> LogicalPlan.

Reference parity: DataFusion's SQL planner + the optimizer rules TPC-H
leans on (predicate pushdown into scans, equi-join extraction from WHERE
conjuncts, OR-factoring, subquery decorrelation, distinct-aggregate
rewrite, two-phase aggregate preparation).

Join build-side selection is uniqueness-driven: the unique-key hash join is
the fast path (FK->PK), tracked via registered PKs / group-by keys; joins
with no unique side use the expanding join (ops.expand_join).

Subquery handling (all decorrelated to joins — no per-row re-execution):
- EXISTS/NOT EXISTS, equi-correlated        -> distinct build + semi/anti join
- EXISTS with extra correlated predicates   -> expand join + residual filter
  + distinct on the outer relation's unique key + semi/anti join (Q21)
- IN (subquery), uncorrelated               -> full subplan + semi/anti join
- scalar subquery, uncorrelated             -> eager evaluation to a literal
- scalar subquery, equi-correlated          -> aggregate grouped by the
  correlation keys + join + comparison filter (Q2/Q17/Q20)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from ..exprs import (Alias, BinOp, Col, Expr, Lit, Not, expr_columns,
                     expr_name)
from ..exec.aggregate import AggExpr
from ..planner import logical as L
from .parser import (AggCall, ExistsExpr, InSubquery, SelectStmt,
                     Star, SubqueryExpr, TableRef, WindowCall, parse_sql)


# ---------------------------------------------------------------------------
# Scope: name resolution across the relations of one SELECT
# ---------------------------------------------------------------------------


class Relation:
    def __init__(self, rel_id: int, names: List[str], plan: L.LogicalPlan,
                 alias: Optional[str], unique_sets: List[frozenset],
                 table: Optional[str] = None):
        self.rel_id = rel_id
        self.names = names          # original column names
        self.plan = plan
        self.alias = alias          # table alias (or table name)
        self.out_names = dict(zip(names, names))  # orig -> output name
        self.unique_sets = unique_sets
        self.table = table          # the registered table it scans

    def rename_for_collisions(self, collisions: Set[str]):
        if not any(n in collisions for n in self.names):
            return
        mapping = {}
        for n in self.names:
            if n in collisions:
                mapping[n] = f"{self.alias}.{n}" if self.alias else f"r{self.rel_id}.{n}"
        schema = self.plan.schema()
        new_names = [mapping.get(f.name, f.name) for f in schema.fields]
        self.plan = L.Projection(self.plan, tuple(Col(f.name) for f in schema.fields),
                                 tuple(new_names))
        self.out_names = {n: mapping.get(n, n) for n in self.names}
        self.unique_sets = [frozenset(mapping.get(c, c) for c in s)
                            for s in self.unique_sets]


class Scope:
    def __init__(self, relations: List[Relation], outer: Optional["Scope"] = None):
        self.relations = relations
        self.outer = outer

    def resolve(self, name: str) -> Optional[str]:
        if "." in name:
            qual, col = name.split(".", 1)
            for r in self.relations:
                if r.alias == qual and col in r.out_names:
                    return r.out_names[col]
            return None
        hits = [r.out_names[name] for r in self.relations if name in r.out_names]
        if len(hits) == 1:
            return hits[0]
        if len(hits) > 1:
            raise ValueError(f"ambiguous column {name!r}")
        return None

    def resolve_or_outer(self, name: str):
        local = self.resolve(name)
        if local is not None:
            return "local", local
        if self.outer is not None:
            kind, out = self.outer.resolve_or_outer(name)
            if kind is not None:
                return "outer", out
        return None, None


def _rewrite_cols(e: Expr, mapping) -> Expr:
    if isinstance(e, Col):
        return Col(mapping(e.name))
    if isinstance(e, Alias):
        return Alias(_rewrite_cols(e.child, mapping), e.name)
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            changes[f.name] = _rewrite_cols(v, mapping)
        elif isinstance(v, tuple):
            new_items = []
            dirty = False
            for item in v:
                if isinstance(item, Expr):
                    new_items.append(_rewrite_cols(item, mapping))
                    dirty = True
                elif isinstance(item, tuple):
                    sub = tuple(_rewrite_cols(s, mapping) if isinstance(s, Expr) else s
                                for s in item)
                    new_items.append(sub)
                    dirty = True
                else:
                    new_items.append(item)
            if dirty:
                changes[f.name] = tuple(new_items)
    if changes:
        return dataclasses.replace(e, **changes)
    return e


def _split_conjuncts(e: Optional[Expr]) -> List[Expr]:
    if e is None:
        return []
    if isinstance(e, BinOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    if isinstance(e, BinOp) and e.op == "or":
        # factor conjuncts common to every OR branch:
        #   (A and X) or (A and Y)  ->  A and (X or Y)   (TPC-H Q19)
        branches = _split_disjuncts(e)
        branch_conjs = [_split_conjuncts(b) for b in branches]
        common = [c for c in branch_conjs[0]
                  if all(c in bc for bc in branch_conjs[1:])]
        if common:
            residual = []
            for bc in branch_conjs:
                rest = [c for c in bc if c not in common]
                residual.append(_conjoin(rest) or Lit(True))
            out = list(common)
            disj = residual[0]
            for r in residual[1:]:
                disj = BinOp("or", disj, r)
            out.append(disj)
            return out
    return [e]


def _split_disjuncts(e: Expr) -> List[Expr]:
    if isinstance(e, BinOp) and e.op == "or":
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _conjoin(parts: List[Expr]) -> Optional[Expr]:
    if not parts:
        return None
    out = parts[0]
    for p in parts[1:]:
        out = BinOp("and", out, p)
    return out


def _find_aggs(e: Expr, out: List[AggCall]):
    if isinstance(e, AggCall):
        if e not in out:
            out.append(e)
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            _find_aggs(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, Expr):
                    _find_aggs(item, out)
                elif isinstance(item, tuple):
                    for s in item:
                        if isinstance(s, Expr):
                            _find_aggs(s, out)


def _find_windows(e: Expr, out: List["WindowCall"]):
    if isinstance(e, WindowCall):
        if e not in out:
            out.append(e)
        return
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            _find_windows(v, out)
        elif isinstance(v, tuple):
            for item in v:
                if isinstance(item, Expr):
                    _find_windows(item, out)
                elif isinstance(item, tuple):
                    for s in item:
                        if isinstance(s, Expr):
                            _find_windows(s, out)


def _replace_subtree(e: Expr, target: Expr, replacement: Expr) -> Expr:
    if e == target:
        return replacement
    changes = {}
    for f in dataclasses.fields(e):
        v = getattr(e, f.name)
        if isinstance(v, Expr):
            changes[f.name] = _replace_subtree(v, target, replacement)
        elif isinstance(v, tuple):
            new_items = []
            for item in v:
                if isinstance(item, Expr):
                    new_items.append(_replace_subtree(item, target, replacement))
                elif isinstance(item, tuple):
                    new_items.append(tuple(
                        _replace_subtree(s, target, replacement) if isinstance(s, Expr) else s
                        for s in item))
                else:
                    new_items.append(item)
            changes[f.name] = tuple(new_items)
    if changes:
        return dataclasses.replace(e, **changes)
    return e


OUTER_MARK = "@outer:"


def _classify_cols(e: Expr, scope: Scope):
    """Resolve every column of e: returns (kind, resolved_expr) where kind is
    'local' (all local), 'outer' (references outer scope), or None
    (unresolvable). Outer references are marked with OUTER_MARK so a later
    join of inner+outer relations can tell them apart even when the
    resolved names collide (e.g. Q21's l2.l_suppkey <> l1.l_suppkey)."""
    has_outer = False

    def mapping(name: str) -> str:
        nonlocal has_outer
        kind, out = scope.resolve_or_outer(name)
        if kind is None:
            raise KeyError(name)
        if kind == "outer":
            has_outer = True
            return OUTER_MARK + out
        return out

    try:
        re_ = _rewrite_cols(e, mapping)
    except KeyError:
        return None, None
    return ("outer" if has_outer else "local"), re_


# ---------------------------------------------------------------------------
# Planner
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FromWhere:
    """Result of planning a statement's FROM + WHERE."""
    plan: L.LogicalPlan
    scope: Scope
    uniq: List[frozenset]
    corr_equi: List[Tuple[str, str]]     # (local out col, outer out col)
    corr_residual: List[Expr]            # resolved exprs mixing local+outer cols


class SqlPlanner:
    def __init__(self, ctx):
        self.ctx = ctx
        self._sq_counter = 0
        # name -> (SelectStmt, col_aliases); lexically scoped per WITH
        self._ctes: Dict[str, tuple] = {}

    # -- catalog --
    def _scan(self, rel_id: int, ref: TableRef, outer: Optional[Scope]) -> Relation:
        if ref.subquery is not None:
            plan = self.plan_select(ref.subquery, outer)
            schema = plan.schema()
            names = [f.name for f in schema.fields]
            if ref.col_aliases:
                if len(ref.col_aliases) != len(names):
                    raise ValueError("derived-table column alias count mismatch")
                plan = L.Projection(plan, tuple(Col(n) for n in names),
                                    tuple(ref.col_aliases))
                names = list(ref.col_aliases)
            uniq = []
            inner = plan
            while isinstance(inner, L.Projection):
                inner = inner.input
            if isinstance(inner, (L.Aggregate, L.Distinct)):
                # group keys are unique; map through projections by position
                schema2 = plan.schema()
                if isinstance(inner, L.Aggregate):
                    nkeys = len(inner.group_exprs)
                    keys = [f.name for f in schema2.fields[:nkeys]]
                    if keys:
                        uniq = [frozenset(keys)]
            return Relation(rel_id, names, plan, ref.alias, uniq)
        name = ref.name
        if name.lower().startswith("information_schema."):
            # virtual catalog tables (config.rs with_information_schema)
            kind = name.split(".", 1)[1].lower()
            if kind == "tables":
                df = self.ctx._show_tables()
            elif kind == "columns":
                df = self.ctx._info_columns()
            else:
                raise KeyError(f"unknown catalog table {name!r}")
            plan = df.plan
            names = [f.name for f in plan.schema().fields]
            return Relation(rel_id, names, plan, ref.alias or kind, [])
        if name in self._ctes:
            # pop while planning: a self-reference resolves to the base
            # table/KeyError instead of infinite recursion (WITH RECURSIVE
            # is rejected at parse time)
            q, cols = self._ctes.pop(name)
            try:
                vref = TableRef(subquery=q, alias=ref.alias or name,
                                col_aliases=cols)
                return self._scan(rel_id, vref, outer)
            finally:
                self._ctes[name] = (q, cols)
        if hasattr(self.ctx, "views") and name in self.ctx.views:
            view_stmt, view_cols = self.ctx.views[name]
            vref = TableRef(subquery=view_stmt, alias=ref.alias or name,
                            col_aliases=view_cols)
            return self._scan(rel_id, vref, outer)
        tp = self.ctx.tables[name]
        schema = tp.schema
        names = [f.name for f in schema.fields]
        uniq = [frozenset(k) for k in self.ctx.unique_keys(name)]
        plan = L.TableScan(name, schema,
                           unique_cols=tuple(tuple(k)
                                             for k in self.ctx.unique_keys(name)))
        return Relation(rel_id, names, plan, ref.alias or name, uniq, name)

    def _unique_join_keys(self, relations: List[Relation], join_edges,
                          uniq_by_rel: Dict[int, List[frozenset]]) -> None:
        """For each pair of relations an equi-join links where neither
        side is known unique on its join columns, ask the context whether
        a scanned table's join column is unique (`join_unique_keys`
        checks a large table's there, on the device, once); the later
        relation first, the earlier only where the later is not. Found
        columns join `uniq_by_rel` under their output names."""
        pairs: Dict[Tuple[int, int], Tuple[set, set]] = {}
        for a, ca, b, cb in join_edges:
            if a > b:
                a, ca, b, cb = b, cb, a, ca
            cols_a, cols_b = pairs.setdefault((a, b), (set(), set()))
            cols_a.add(ca)
            cols_b.add(cb)
        by_id = {r.rel_id: r for r in relations}
        for (a, b), (cols_a, cols_b) in pairs.items():
            if any(s <= cols_a for s in uniq_by_rel[a]) or \
                    any(s <= cols_b for s in uniq_by_rel[b]):
                continue
            for rid, cols in ((b, cols_b), (a, cols_a)):
                rel = by_id[rid]
                if rel.table is None:
                    continue
                orig = {out: n for n, out in rel.out_names.items()}
                found = [frozenset(rel.out_names[c] for c in k)
                         for k in self.ctx.join_unique_keys(
                             rel.table, [orig[c] for c in sorted(cols)])]
                found = [s for s in found if s <= cols]
                if found:
                    uniq_by_rel[rid] += found
                    break

    def _mangle(self) -> str:
        self._sq_counter += 1
        return f"__sq{self._sq_counter}"

    # -- FROM + WHERE assembly (shared by top level and all subqueries) --
    def plan_from_where(self, stmt: SelectStmt,
                        outer: Optional[Scope]) -> FromWhere:
        relations: List[Relation] = []
        for i, ref in enumerate(stmt.from_tables):
            relations.append(self._scan(i, ref, outer))
        explicit_joins = list(stmt.joins)
        for j, jc in enumerate(explicit_joins):
            relations.append(self._scan(len(stmt.from_tables) + j, jc.table, outer))
        if not relations:
            # FROM-less SELECT: a one-row source with no referencable
            # columns; literal expressions evaluate against it
            relations.append(Relation(0, [], L.OneRow(), None, []))

        seen: Dict[str, int] = {}
        for r in relations:
            for n in r.names:
                seen[n] = seen.get(n, 0) + 1
        collisions = {n for n, c in seen.items() if c > 1}
        for r in relations:
            r.rename_for_collisions(collisions)

        scope = Scope(relations, outer)

        conjuncts = _split_conjuncts(stmt.where)
        for jc in explicit_joins:
            conjuncts.extend(_split_conjuncts(jc.on))

        join_edges: List[Tuple[int, str, int, str]] = []
        per_rel_filters: Dict[int, List[Expr]] = {r.rel_id: [] for r in relations}
        post_filters: List[Expr] = []
        semi_subqs: List[Tuple[SelectStmt, bool, Optional[Expr]]] = []
        scalar_conjs: List[Tuple[str, Expr, SelectStmt, bool]] = []  # (op, lhs, sub, lhs_is_left)
        corr_equi: List[Tuple[str, str]] = []
        corr_residual: List[Expr] = []

        def rel_of(col_out_name: str) -> Optional[int]:
            for r in relations:
                if col_out_name in r.out_names.values():
                    return r.rel_id
            return None

        for c in conjuncts:
            if isinstance(c, ExistsExpr):
                semi_subqs.append((c.query, c.negated, None))
                continue
            if isinstance(c, Not) and isinstance(c.child, ExistsExpr):
                semi_subqs.append((c.child.query, not c.child.negated, None))
                continue
            if isinstance(c, InSubquery):
                semi_subqs.append((c.query, c.negated, c.child))
                continue
            if isinstance(c, BinOp) and isinstance(c.right, SubqueryExpr):
                scalar_conjs.append((c.op, c.left, c.right.query, True))
                continue
            if isinstance(c, BinOp) and isinstance(c.left, SubqueryExpr):
                scalar_conjs.append((c.op, c.right, c.left.query, False))
                continue
            if isinstance(c, BinOp) and c.op == "=" and isinstance(c.left, Col) \
                    and isinstance(c.right, Col):
                ln = scope.resolve(c.left.name)
                rn = scope.resolve(c.right.name)
                if ln is not None and rn is not None:
                    ra, rb = rel_of(ln), rel_of(rn)
                    if ra is not None and rb is not None and ra != rb:
                        join_edges.append((ra, ln, rb, rn))
                        continue
                # correlated equality?
                lk, lo = scope.resolve_or_outer(c.left.name)
                rk, ro = scope.resolve_or_outer(c.right.name)
                if lk == "local" and rk == "outer":
                    corr_equi.append((lo, ro))
                    continue
                if lk == "outer" and rk == "local":
                    corr_equi.append((ro, lo))
                    continue
            kind, resolved = _classify_cols(c, scope)
            if kind == "local":
                cols = expr_columns(resolved)
                rels = {rel_of(n) for n in cols}
                if len(rels) == 1 and None not in rels:
                    per_rel_filters[next(iter(rels))].append(resolved)
                else:
                    post_filters.append(resolved)
            elif kind == "outer":
                corr_residual.append(resolved)
            else:
                raise KeyError(f"cannot resolve columns in {c}")

        # pushed-down filters
        plans: Dict[int, L.LogicalPlan] = {}
        uniq_by_rel: Dict[int, List[frozenset]] = {}
        for r in relations:
            p = r.plan
            f = _conjoin(per_rel_filters[r.rel_id])
            if f is not None:
                p = L.Filter(p, f)
            plans[r.rel_id] = p
            uniq_by_rel[r.rel_id] = list(r.unique_sets)
        self._unique_join_keys(relations, join_edges, uniq_by_rel)

        # greedy join assembly (build side = unique side; else expanding)
        how_by_rel = {}
        for j, jc in enumerate(explicit_joins):
            how_by_rel[len(stmt.from_tables) + j] = jc.how
        joined_ids = {relations[0].rel_id}
        current = plans[relations[0].rel_id]
        current_uniq = uniq_by_rel[relations[0].rel_id]
        remaining = [r.rel_id for r in relations[1:]]

        def edges_between(done: Set[int], rid: int):
            out = []
            for (a, ca, b, cb) in join_edges:
                if a in done and b == rid:
                    out.append((ca, cb))
                elif b in done and a == rid:
                    out.append((cb, ca))
            return out

        while remaining:
            pick = None
            for rid in remaining:
                if edges_between(joined_ids, rid):
                    pick = rid
                    break
            if pick is None:
                # no equi path: cartesian product (explicit CROSS JOIN,
                # comma-join without equality, or theta-only conditions —
                # residual WHERE predicates filter the product afterwards)
                pick = remaining[0]
                current = L.Join(plans[pick], current, (), "cross")
                current_uniq = []
                joined_ids.add(pick)
                remaining.remove(pick)
                continue
            pairs = edges_between(joined_ids, pick)
            cur_cols = frozenset(p[0] for p in pairs)
            new_cols = frozenset(p[1] for p in pairs)
            how = how_by_rel.get(pick, "inner")
            new_plan = plans[pick]
            new_uniq = uniq_by_rel[pick]
            if how == "inner":
                if any(s <= new_cols for s in new_uniq):
                    current = L.Join(new_plan, current,
                                     tuple((b, a) for a, b in pairs), "inner")
                elif any(s <= cur_cols for s in current_uniq):
                    current = L.Join(current, new_plan, tuple(pairs), "inner")
                    current_uniq = list(new_uniq)
                else:
                    current = L.Join(new_plan, current,
                                     tuple((b, a) for a, b in pairs), "inner",
                                     unique_build=False)
                    current_uniq = []
            elif how == "left":
                uniq = any(s <= new_cols for s in new_uniq)
                current = L.Join(new_plan, current,
                                 tuple((b, a) for a, b in pairs), "left_outer",
                                 unique_build=uniq)
                if not uniq:
                    current_uniq = []
            elif how == "right":
                # preserve the NEW relation's rows: probe=new, build=current
                uniq = any(s <= cur_cols for s in current_uniq)
                current = L.Join(current, new_plan, tuple(pairs), "left_outer",
                                 unique_build=uniq)
                current_uniq = list(new_uniq)
            elif how == "full":
                # build = new side (unique if possible), probe = current;
                # null-extended rows void uniqueness on both sides
                uniq = any(s <= new_cols for s in new_uniq)
                current = L.Join(new_plan, current,
                                 tuple((b, a) for a, b in pairs), "full_outer",
                                 unique_build=uniq)
                current_uniq = []
            else:
                raise NotImplementedError(f"join type {how}")
            joined_ids.add(pick)
            remaining.remove(pick)

        # EXISTS / IN -> semi/anti joins
        for sub_stmt, negated, in_lhs in semi_subqs:
            current = self._plan_semi(sub_stmt, negated, in_lhs, scope,
                                      current, current_uniq)

        # scalar subqueries -> literal or aggregate join + filter
        for op, lhs, sub_stmt, lhs_left in scalar_conjs:
            current, pred = self._plan_scalar(op, lhs, sub_stmt, lhs_left,
                                              scope, current)
            post_filters.append(pred)

        pf = _conjoin(post_filters)
        if pf is not None:
            current = L.Filter(current, pf)

        return FromWhere(current, scope, current_uniq, corr_equi, corr_residual)

    # -- subquery machinery --

    def _plan_semi(self, sub_stmt: SelectStmt, negated: bool,
                   in_lhs: Optional[Expr], scope: Scope,
                   current: L.LogicalPlan,
                   current_uniq: List[frozenset]) -> L.LogicalPlan:
        how = "anti" if negated else "semi"
        fw = self.plan_from_where(sub_stmt, scope)

        def _lhs_as_col(lhs, current):
            """`<expr> IN (subquery)`: materialize a non-column lhs as a
            synthetic projected column so the membership join has a key
            (downstream projections select by name, so the extra column
            is harmless)."""
            if isinstance(lhs, Col):
                return lhs, current
            lname = self._mangle() + "_lhs"
            sch = current.schema()
            cur_names = tuple(f.name for f in sch.fields)
            current = L.Projection(
                current, tuple(Col(n) for n in cur_names) + (lhs,),
                cur_names + (lname,))
            return Col(lname), current

        if in_lhs is not None and not fw.corr_equi and not fw.corr_residual:
            # uncorrelated IN: full subplan (aggregates/having included)
            inner = self._plan_projection(sub_stmt, fw)
            # strip top-level sorts (order is irrelevant for membership)
            # but KEEP any Limit — `IN (... ORDER BY ... LIMIT k)` is a
            # top-k membership set, and a Limit below retains its Sort
            while isinstance(inner, L.Sort):
                inner = inner.input
            inner_col = inner.schema().fields[0].name
            lhs = _rewrite_cols(in_lhs, self._resolver(scope))
            lhs, current = _lhs_as_col(lhs, current)
            key = self._mangle() + "_k"
            dedup = L.Distinct(L.Projection(inner, (Col(inner_col),), (key,)))
            join = L.Join(dedup, current, ((key, lhs.name),), how)
            if how != "anti":
                return join
            # NOT IN three-valued logic: if the subquery produces ANY
            # NULL, no row qualifies (x <> NULL is never true), and a
            # NULL lhs never qualifies either. Cross-join a 1-row
            # (count(*), count(col)) aggregate and require equality.
            t, nn = f"{key}t", f"{key}n"
            cnt = L.Aggregate(inner, (), (
                AggExpr("count_star", alias=t),
                AggExpr("count", Col(inner_col), alias=nn)))
            crossed = L.Join(cnt, join, (), "cross")
            from ..exprs import IsNull
            # empty subquery: NOT IN () is TRUE for every row, even a
            # NULL lhs; otherwise require a null-free subquery AND a
            # non-null lhs
            pred = BinOp("or", BinOp("=", Col(t), Lit(0)),
                         BinOp("and", BinOp("=", Col(t), Col(nn)),
                               Not(IsNull(Col(lhs.name)))))
            return L.Filter(crossed, pred)

        corr = list(fw.corr_equi)
        if in_lhs is not None:
            assert len(sub_stmt.projections) == 1
            item, _ = sub_stmt.projections[0]
            item_r = _rewrite_cols(item, self._resolver(fw.scope))
            if not isinstance(item_r, Col):
                # expression output: project it as a synthetic column of
                # the subquery plan so the membership join has a key
                iname = self._mangle() + "_itm"
                sch = fw.plan.schema()
                in_names = tuple(f.name for f in sch.fields)
                fw.plan = L.Projection(
                    fw.plan, tuple(Col(n) for n in in_names) + (item_r,),
                    in_names + (iname,))
                item_r = Col(iname)
            lhs = _rewrite_cols(in_lhs, self._resolver(scope))
            lhs, current = _lhs_as_col(lhs, current)
            corr.append((item_r.name, lhs.name))
        if not corr and not fw.corr_residual:
            # uncorrelated EXISTS: the subquery's row count is a global
            # fact — cross-join a 1-row count(*) aggregate and keep
            # all rows iff it is non-zero (zero for NOT EXISTS). The
            # reference gets this from DataFusion's decorrelation; same
            # observable semantics.
            inner = self._plan_projection(sub_stmt, fw)
            while isinstance(inner, L.Sort):
                inner = inner.input
            t = self._mangle() + "_ct"
            cnt = L.Aggregate(inner, (), (AggExpr("count_star", alias=t),))
            crossed = L.Join(cnt, current, (), "cross")
            op = "=" if negated else ">"
            return L.Filter(crossed, BinOp(op, Col(t), Lit(0)))

        tag = self._mangle()
        inner_keys = [k for k, _ in corr]
        outer_keys = [k for _, k in corr]
        mangled = [f"{tag}_k{i}" for i in range(len(inner_keys))]

        if not fw.corr_residual:
            inner = L.Distinct(L.Projection(
                fw.plan, tuple(Col(k) for k in inner_keys), tuple(mangled)))
            join = L.Join(inner, current, tuple(zip(mangled, outer_keys)),
                          how)
            if how != "anti" or in_lhs is None:
                return join
            # correlated NOT IN three-valued logic per correlation group:
            # row kept iff its group is EMPTY (incl. NULL outer corr key),
            # or the group is null-free, x is non-null, and x has no
            # match (the anti join above). A per-group
            # (count(*), count(item)) aggregate left-joins on the corr
            # keys; group-miss => ct IS NULL => empty group => keep.
            from ..exprs import IsNull
            item_name = inner_keys[-1]       # corr list ends with the item
            grp_in = inner_keys[:-1]
            grp_out = outer_keys[:-1]
            gnames = [f"{tag}_g{i}" for i in range(len(grp_in))]
            ct, cy = f"{tag}_ct", f"{tag}_cy"
            grp = L.Aggregate(fw.plan, tuple(Col(k) for k in grp_in),
                              (AggExpr("count_star", alias=ct),
                               AggExpr("count", Col(item_name), alias=cy)),
                              group_names=tuple(gnames))
            joined = L.Join(grp, join, tuple(zip(gnames, grp_out)),
                            "left_outer", unique_build=True)
            pred = BinOp("or", IsNull(Col(ct)),
                         BinOp("and", BinOp("=", Col(ct), Col(cy)),
                               Not(IsNull(Col(outer_keys[-1])))))
            return L.Filter(joined, pred)

        # <>-correlated EXISTS fast path (the Q21 shape):
        #   EXISTS(SELECT .. WHERE inner.k = outer.k AND inner.d <> outer.d)
        # holds iff the k-group's distinct non-null d values include one
        # different from outer.d:  cd >= 2  OR  (cd >= 1 AND min_d <> d),
        # with cd = count(distinct d) per k. One dedup aggregate + a
        # unique-build left join REPLACES the expanding self-join +
        # unique-key dedup of the general path (lineitem x lineitem at
        # SF1 was the single most expensive piece of the whole suite).
        res = fw.corr_residual
        # the <> fast path is null-rejecting EXISTS semantics; NOT IN
        # needs three-valued logic, handled by the general path below
        if ((in_lhs is None or how == "semi")
                and len(res) == 1 and isinstance(res[0], BinOp)
                and res[0].op in ("!=", "<>")):
            lcol, rcol = res[0].left, res[0].right
            if isinstance(lcol, Col) and isinstance(rcol, Col):
                lo = lcol.name.startswith(OUTER_MARK)
                ro = rcol.name.startswith(OUTER_MARK)
                if lo != ro:
                    from ..exprs import IsNull
                    outer_d = (lcol if lo else rcol).name[len(OUTER_MARK):]
                    inner_d = (rcol if lo else lcol).name
                    td, cd, md = f"{tag}_d", f"{tag}_cd", f"{tag}_md"
                    dedup = L.Distinct(L.Projection(
                        fw.plan,
                        tuple(Col(k) for k in inner_keys) + (Col(inner_d),),
                        tuple(mangled) + (td,)))
                    agg = L.Aggregate(
                        dedup, tuple(Col(m) for m in mangled),
                        (AggExpr("count", Col(td), alias=cd),
                         AggExpr("min", Col(td), alias=md)),
                        group_names=tuple(mangled))
                    joined = L.Join(agg, current,
                                    tuple(zip(mangled, outer_keys)),
                                    "left_outer", unique_build=True)
                    # every branch is definite (non-NULL) under the guards,
                    # so Not() for anti is safe
                    pred = BinOp(
                        "and",
                        BinOp("and", Not(IsNull(Col(cd))),
                              Not(IsNull(Col(outer_d)))),
                        BinOp("or",
                              BinOp(">=", Col(cd), Lit(2)),
                              BinOp("and", BinOp(">=", Col(cd), Lit(1)),
                                    BinOp("!=", Col(md), Col(outer_d)))))
                    return L.Filter(joined,
                                    pred if how == "semi" else Not(pred))

        # residual-correlated EXISTS (Q21): join pairs, filter residual,
        # dedupe on the outer relation's unique key, then semi/anti join
        ukey = next((sorted(s) for s in current_uniq), None)
        if ukey is None:
            raise NotImplementedError(
                "correlated EXISTS with non-equi predicates needs a unique "
                "key on the outer relation")
        # project the inner columns the residual needs, mangled (outer
        # references carry OUTER_MARK and resolve to the probe side)
        residual_inner_cols = set()
        for rexp in fw.corr_residual:
            for n in expr_columns(rexp):
                if not n.startswith(OUTER_MARK):
                    residual_inner_cols.add(n)
        extra = sorted(residual_inner_cols - set(inner_keys))
        extra_mangled = {n: f"{tag}_c{i}" for i, n in enumerate(extra)}
        proj_cols = list(inner_keys) + extra
        proj_names = list(mangled) + [extra_mangled[n] for n in extra]
        inner = L.Projection(fw.plan, tuple(Col(c) for c in proj_cols),
                             tuple(proj_names))
        pairs = tuple(zip(mangled, outer_keys))
        # no equi correlation (pure non-equi EXISTS) degenerates to a
        # cross join of the pairs; the residual filter below does the work
        joined = L.Join(inner, current, pairs, "inner" if pairs else "cross",
                        unique_build=False)

        def remap(name: str) -> str:
            if name.startswith(OUTER_MARK):
                return name[len(OUTER_MARK):]
            if name in extra_mangled:
                return extra_mangled[name]
            if name in inner_keys:
                return mangled[inner_keys.index(name)]
            return name
        residual = _conjoin([_rewrite_cols(r, remap) for r in fw.corr_residual])
        filtered = L.Filter(joined, residual)
        dedup = L.Distinct(L.Projection(filtered, tuple(Col(c) for c in ukey)))
        # rename dedup cols to avoid collision in the final semi join
        dkeys = [f"{tag}_u{i}" for i in range(len(ukey))]
        dedup = L.Projection(dedup, tuple(Col(c) for c in ukey), tuple(dkeys))
        out = L.Join(dedup, current, tuple(zip(dkeys, ukey)), how)
        if how != "anti" or in_lhs is None:
            return out
        # three-valued NOT IN with residual predicates. The anti join
        # above removed rows with an exact item match; among survivors,
        # keep a row iff its group (subquery rows matching the equi
        # correlation AND the residual, item equality excluded) is
        # empty, or is null-free with a non-null lhs. Per-outer-row
        # groups are keyed by the outer unique key.
        from ..exprs import IsNull
        corr_pairs = pairs[:-1]      # corr list ends with the item pair
        gjoin = (L.Join(inner, out, corr_pairs, "inner", unique_build=False)
                 if corr_pairs else L.Join(inner, out, (), "cross"))
        gfilt = L.Filter(gjoin, residual)
        gt, gy = f"{tag}_gt", f"{tag}_gy"
        gukeys = tuple(f"{tag}_w{i}" for i in range(len(ukey)))
        agg = L.Aggregate(gfilt, tuple(Col(c) for c in ukey),
                          (AggExpr("count_star", alias=gt),
                           AggExpr("count", Col(mangled[-1]), alias=gy)),
                          group_names=gukeys)
        joined_ct = L.Join(agg, out, tuple(zip(gukeys, ukey)),
                           "left_outer", unique_build=True)
        pred = BinOp("or", IsNull(Col(gt)),
                     BinOp("and", BinOp("=", Col(gt), Col(gy)),
                           Not(IsNull(Col(outer_keys[-1])))))
        return L.Filter(joined_ct, pred)

    def _plan_scalar(self, op: str, lhs: Expr, sub_stmt: SelectStmt,
                     lhs_left: bool, scope: Scope,
                     current: L.LogicalPlan) -> Tuple[L.LogicalPlan, Expr]:
        """Returns (new_current, predicate_expr)."""
        fw = self.plan_from_where(sub_stmt, scope)
        if fw.corr_residual:
            raise NotImplementedError("scalar subquery with non-equi correlation")
        lhs_r = _rewrite_cols(lhs, self._resolver(scope))

        if not fw.corr_equi:
            # uncorrelated: evaluate eagerly to a literal (Q11/Q15/Q22)
            value = self._eval_scalar(sub_stmt)
            pred = (BinOp(op, lhs_r, value) if lhs_left
                    else BinOp(op, value, lhs_r))
            return current, pred

        assert len(sub_stmt.projections) == 1
        item, _ = sub_stmt.projections[0]
        aggs: List[AggCall] = []
        _find_aggs(item, aggs)
        if not aggs:
            raise NotImplementedError("correlated scalar subquery without aggregate")
        tag = self._mangle()
        inner_keys = [k for k, _ in fw.corr_equi]
        outer_keys = [k for _, k in fw.corr_equi]
        mangled = [f"{tag}_k{i}" for i in range(len(inner_keys))]
        vname = f"{tag}_v"

        agg_specs = []
        agg_names = {}
        for i, a in enumerate(aggs):
            arg = (_rewrite_cols(a.arg, self._resolver(fw.scope))
                   if a.arg is not None else None)
            arg2 = (_rewrite_cols(a.arg2, self._resolver(fw.scope))
                    if a.arg2 is not None else None)
            nm = f"{tag}_a{i}"
            agg_names[a] = nm
            agg_specs.append(AggExpr(a.kind, arg, alias=nm,
                                     distinct=a.distinct, arg2=arg2,
                                     frac=a.frac))
        agg_plan = L.Aggregate(fw.plan, tuple(Col(k) for k in inner_keys),
                               tuple(agg_specs), tuple(mangled))
        item_r = _rewrite_cols(item, lambda n: n)  # cols inside aggs already handled
        out_expr = item
        for a, nm in agg_names.items():
            out_expr = _replace_subtree(out_expr, a, Col(nm))
        # remaining columns in out_expr must be agg outputs only
        proj = L.Projection(agg_plan,
                            tuple([Col(m) for m in mangled] + [out_expr]),
                            tuple(mangled + [vname]))
        # group keys unique -> unique-build join against the outer plan
        new_current = L.Join(proj, current, tuple(zip(mangled, outer_keys)),
                             "inner")
        pred = (BinOp(op, lhs_r, Col(vname)) if lhs_left
                else BinOp(op, Col(vname), lhs_r))
        return new_current, pred

    def _fold_scalars(self, e: Expr) -> Expr:
        """Replace uncorrelated scalar subqueries inside an expression
        (SELECT list / HAVING position — Q11) with eagerly evaluated
        literals."""
        found: List[SubqueryExpr] = []

        def walk(x):
            if isinstance(x, SubqueryExpr):
                found.append(x)
                return
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if isinstance(v, Expr):
                    walk(v)
                elif isinstance(v, tuple):
                    for item in v:
                        if isinstance(item, Expr):
                            walk(item)
                        elif isinstance(item, tuple):
                            for s in item:
                                if isinstance(s, Expr):
                                    walk(s)
        walk(e)
        for sq in found:
            e = _replace_subtree(e, sq, self._eval_scalar(sq.query))
        return e

    def _eval_scalar(self, sub_stmt: SelectStmt) -> Lit:
        """Execute an uncorrelated scalar subquery now; fold to a literal."""
        from .. import batch as B
        from ..schema import TypeKind

        plan = self.plan_select(sub_stmt, None)
        batch, schema = self.ctx.collect(plan)
        f = schema.fields[0]
        n = int(batch.num_rows)
        if n == 0:
            return Lit(None, f.dtype)
        data, valid = B.to_numpy(batch, schema)[f.name]
        if not valid[0]:
            return Lit(None, f.dtype)
        v = data[0]
        if f.dtype.kind is TypeKind.DECIMAL:
            from decimal import Decimal
            return Lit(Decimal(int(v)).scaleb(-f.dtype.scale), f.dtype)
        if f.dtype.kind is TypeKind.STRING:
            return Lit(str(v))
        if f.dtype.kind is TypeKind.DATE32:
            return Lit(int(v), f.dtype)
        return Lit(v.item() if hasattr(v, "item") else v, f.dtype)

    # -- top level --

    def plan_select(self, stmt, outer: Optional[Scope] = None) -> L.LogicalPlan:
        ctes = getattr(stmt, "ctes", None)
        if not ctes:
            return self._plan_select_body(stmt, outer)
        saved = dict(self._ctes)
        try:
            for name, cols, q in ctes:
                self._ctes[name] = (q, cols)   # later CTEs see earlier ones
            return self._plan_select_body(stmt, outer)
        finally:
            self._ctes = saved

    def _plan_select_body(self, stmt, outer) -> L.LogicalPlan:
        from .parser import SetOpStmt, UnionStmt
        if isinstance(stmt, SetOpStmt):
            return self._plan_setop(stmt, outer)
        if isinstance(stmt, UnionStmt):
            return self._plan_union(stmt, outer)
        fw = self.plan_from_where(stmt, outer)
        if fw.corr_equi or fw.corr_residual:
            raise ValueError("unexpected correlated references at top level")
        return self._plan_projection(stmt, fw)

    def _plan_union(self, stmt, outer) -> L.LogicalPlan:
        parts = [self.plan_select(s, outer) for s in stmt.inputs]
        first = parts[0].schema()
        names = [f.name for f in first.fields]
        aligned = [parts[0]]
        for p in parts[1:]:
            s = p.schema()
            if len(s.fields) != len(names):
                raise ValueError("UNION inputs have different column counts")
            aligned.append(L.Projection(
                p, tuple(Col(f.name) for f in s.fields), tuple(names)))
        out: L.LogicalPlan = L.Union(tuple(aligned))
        if not stmt.all:
            out = L.Distinct(out)
        if stmt.order_by:
            keys = []
            for key, asc, nf in stmt.order_by:
                if isinstance(key, int):
                    keys.append((Col(names[key - 1]), asc, nf))
                elif isinstance(key, Col) and key.name in names:
                    keys.append((key, asc, nf))
                else:
                    raise NotImplementedError(
                        "UNION ORDER BY must reference output columns")
            out = L.Sort(out, tuple(keys))
        if stmt.limit is not None or getattr(stmt, "offset", None):
            out = L.Limit(out, stmt.limit if stmt.limit is not None
                          else (1 << 31) - 1,
                          offset=getattr(stmt, "offset", 0) or 0)
        return out

    def _plan_setop(self, stmt, outer) -> L.LogicalPlan:
        """INTERSECT/EXCEPT: Distinct(left) semi/anti-joined against the
        right on NULL-SAFE normalized keys — set operations treat NULLs
        as equal, so each column joins as (is-null flag, null-coalesced
        value); both sides normalize identically, so the coalesce
        default only needs dtype consistency."""
        import datetime as _dt

        from ..exprs import Case, IsNull
        from ..schema import TypeKind

        left = self.plan_select(stmt.left, outer)
        right = self.plan_select(stmt.right, outer)
        ls, rs = left.schema(), right.schema()
        if len(ls.fields) != len(rs.fields):
            raise ValueError(f"{stmt.op.upper()} inputs have different "
                             "column counts")
        names = [f.name for f in ls.fields]
        right = L.Projection(right, tuple(Col(f.name) for f in rs.fields),
                             tuple(names))

        def default_for(f):
            k = f.dtype.kind
            if k is TypeKind.STRING:
                return Lit("")
            if k is TypeKind.BOOL:
                return Lit(False)
            if k in (TypeKind.FLOAT32, TypeKind.FLOAT64):
                return Lit(0.0)
            if k is TypeKind.DATE32:
                return Lit(_dt.date(1970, 1, 1))
            return Lit(0)

        tag = self._mangle()

        def with_keys(plan, prefix):
            sch = plan.schema()
            exprs = [Col(n) for n in names]
            out_names = list(names)
            for i, f in enumerate(sch.fields):
                exprs.append(Case(((IsNull(Col(f.name)), default_for(f)),),
                                  Col(f.name)))
                out_names.append(f"{tag}{prefix}v{i}")
                exprs.append(IsNull(Col(f.name)))
                out_names.append(f"{tag}{prefix}f{i}")
            return L.Projection(plan, tuple(exprs), tuple(out_names))

        key_names_r = [f"{tag}r{x}{i}" for i in range(len(names))
                       for x in ("v", "f")]
        pairs = tuple((f"{tag}r{x}{i}", f"{tag}l{x}{i}")
                      for i in range(len(names)) for x in ("v", "f"))
        if getattr(stmt, "all", False):
            # Bag semantics: number each left row within its key group
            # (row_number over the null-safe keys) and compare against
            # the right side's per-key count — a row survives INTERSECT
            # ALL iff its occurrence number <= right count (min(l,r)
            # copies) and EXCEPT ALL iff it exceeds it (max(l-r,0)).
            from ..exec.window import WindowFnSpec
            key_names_l = [f"{tag}l{x}{i}" for i in range(len(names))
                           for x in ("v", "f")]
            lk_all = with_keys(left, "l")
            ln, rc = f"{tag}ln", f"{tag}rc"
            w = L.Window(lk_all, (WindowFnSpec(
                "row_number", None,
                tuple(Col(k) for k in key_names_l),
                ((Col(key_names_l[0]), True, None),), alias=ln),))
            rk_all = with_keys(right, "r")
            rcnt = L.Aggregate(
                L.Projection(rk_all, tuple(Col(n) for n in key_names_r),
                             tuple(key_names_r)),
                tuple(Col(k) for k in key_names_r),
                (AggExpr("count_star", alias=rc),),
                group_names=tuple(key_names_r))
            if stmt.op == "intersect":
                joined = L.Join(rcnt, w, pairs, "inner")
                keep = BinOp("<=", Col(ln), Col(rc))
            else:
                from ..exprs import IsNull
                joined = L.Join(rcnt, w, pairs, "left_outer")
                keep = BinOp("or", IsNull(Col(rc)),
                             BinOp(">", Col(ln), Col(rc)))
            out: L.LogicalPlan = L.Projection(
                L.Filter(joined, keep),
                tuple(Col(n) for n in names), tuple(names))
        else:
            lk = with_keys(L.Distinct(left), "l")
            rk_all = with_keys(right, "r")
            rk = L.Distinct(L.Projection(
                rk_all, tuple(Col(n) for n in key_names_r),
                tuple(key_names_r)))
            how = "semi" if stmt.op == "intersect" else "anti"
            joined = L.Join(rk, lk, pairs, how)
            out = L.Projection(
                joined, tuple(Col(n) for n in names), tuple(names))
        if stmt.order_by:
            keys = []
            for key, asc, nf in stmt.order_by:
                if isinstance(key, int):
                    keys.append((Col(names[key - 1]), asc, nf))
                elif isinstance(key, Col) and key.name in names:
                    keys.append((key, asc, nf))
                else:
                    from ..exprs import expr_columns
                    if expr_columns(key) <= set(names):
                        # expression over output columns (e.g. ORDER BY
                        # x + y) — Sort evaluates expressions directly
                        keys.append((key, asc, nf))
                    else:
                        raise NotImplementedError(
                            "set-op ORDER BY must reference output columns")
            out = L.Sort(out, tuple(keys))
        if stmt.limit is not None or getattr(stmt, "offset", None):
            out = L.Limit(out, stmt.limit if stmt.limit is not None
                          else (1 << 31) - 1,
                          offset=getattr(stmt, "offset", 0) or 0)
        return out

    def _resolver(self, scope: Scope):
        def f(name: str) -> str:
            kind, out = scope.resolve_or_outer(name)
            if kind is None:
                raise KeyError(f"cannot resolve column {name!r}")
            return out
        return f

    def _plan_projection(self, stmt: SelectStmt, fw: FromWhere) -> L.LogicalPlan:
        scope, current = fw.scope, fw.plan
        resolver = self._resolver(scope)
        items: List[Tuple[Expr, str]] = []
        cur_schema = current.schema()
        for e, alias in stmt.projections:
            if isinstance(e, Star):
                for f in cur_schema.fields:
                    items.append((Col(f.name), f.name))
                continue
            re_ = _rewrite_cols(e, resolver)
            if alias:
                name = alias
            elif isinstance(e, Col) and "." in e.name:
                # qualified reference: display name drops the qualifier
                # (select o.k -> column "k"), matching DataFusion
                name = e.name.split(".", 1)[1]
            else:
                name = expr_name(e)
            items.append((re_, name))

        agg_calls: List[AggCall] = []
        items = [(self._fold_scalars(e), nm) for e, nm in items]
        for e, _ in items:
            _find_aggs(e, agg_calls)
        having = (self._fold_scalars(_rewrite_cols(stmt.having, resolver))
                  if stmt.having is not None else None)
        if having is not None:
            _find_aggs(having, agg_calls)

        group_exprs: List[Expr] = []
        for g in stmt.group_by:
            if isinstance(g, int):
                group_exprs.append(items[g - 1][0])
            else:
                if isinstance(g, Col):
                    hit = next((it for it, nm in items if nm == g.name), None)
                    if hit is not None and scope.resolve(g.name) is None:
                        group_exprs.append(hit)
                        continue
                group_exprs.append(_rewrite_cols(g, resolver))

        if stmt.grouping_sets is not None:
            current = self._plan_grouping_sets(current, group_exprs,
                                               agg_calls, items, having,
                                               stmt.grouping_sets)
            items = self._agg_items
            having = None
        elif agg_calls or group_exprs:
            current = self._plan_aggregate(current, group_exprs, agg_calls,
                                           items, having)
            items = self._agg_items
            having = None

        # window functions evaluate after GROUP BY/HAVING, before the final
        # projection: lower each distinct WindowCall to a Window-node column
        win_calls: List[WindowCall] = []
        for e, _ in items:
            _find_windows(e, win_calls)
        if win_calls:
            from ..exec.window import WindowFnSpec
            specs = []
            current_names = {f.name for f in current.schema().fields}
            for i, w in enumerate(win_calls):
                nm = f"#win{i}"
                while nm in current_names:
                    nm = f"#{nm}"
                specs.append(WindowFnSpec(w.kind, w.arg, w.partition_by,
                                          w.order_by, w.offset,
                                          frame=w.frame, alias=nm))
                items = [(_replace_subtree(e, w, Col(nm)), n)
                         for e, n in items]
            current = L.Window(current, tuple(specs))

        proj = L.Projection(current, tuple(e for e, _ in items),
                            tuple(nm for _, nm in items))
        out: L.LogicalPlan = proj
        if stmt.distinct:
            out = L.Distinct(out)

        if stmt.order_by:
            keys = []
            out_names = [nm for _, nm in items]
            for key, asc, nf in stmt.order_by:
                if isinstance(key, int):
                    keys.append((Col(out_names[key - 1]), asc, nf))
                elif isinstance(key, Col) and key.name in out_names:
                    keys.append((key, asc, nf))
                elif isinstance(key, Col) and "." in key.name and \
                        key.name.split(".", 1)[1] in out_names:
                    # qualified ref to a projected column whose display name
                    # dropped the qualifier (order by o.k -> column "k")
                    keys.append((Col(key.name.split(".", 1)[1]), asc, nf))
                else:
                    try:
                        k = _rewrite_cols(
                            key, lambda n: n if n in out_names else resolver(n))
                    except KeyError:
                        k = key
                    keys.append((k, asc, nf))
            # ORDER BY columns outside the SELECT list: carry them through
            # the projection as hidden columns, sort, then drop them
            hidden: List[str] = []
            if not stmt.distinct and isinstance(out, L.Projection):
                avail = {f.name for f in current.schema().fields}
                for k, _, _ in keys:
                    for c in expr_columns(k):
                        if c not in out_names and c not in hidden:
                            if c not in avail:
                                raise KeyError(
                                    f"ORDER BY column {c!r} not available")
                            hidden.append(c)
            if hidden:
                widened = L.Projection(
                    current,
                    tuple(e for e, _ in items) + tuple(Col(c) for c in hidden),
                    tuple(out_names) + tuple(hidden))
                sorted_ = L.Sort(widened, tuple(keys))
                out = L.Projection(sorted_, tuple(Col(n) for n in out_names),
                                   tuple(out_names))
            else:
                out = L.Sort(out, tuple(keys))
        if stmt.limit is not None or getattr(stmt, "offset", None):
            out = L.Limit(out, stmt.limit if stmt.limit is not None
                          else (1 << 31) - 1,
                          offset=getattr(stmt, "offset", 0) or 0)
        return out

    def _plan_aggregate(self, current, group_exprs, agg_calls, items, having):
        """Build Aggregate (+ distinct-agg rewrite) and rewrite items/having
        over its output. Leaves rewritten items in self._agg_items."""
        distinct_aggs = [a for a in agg_calls if a.distinct]
        if distinct_aggs:
            # General two-level rewrite (DataFusion single_distinct_to_groupby
            # parity, extended to mixed plain/distinct):
            #   inner: Aggregate by (G, x) with partial states of plain aggs
            #   outer: Aggregate by G; distinct aggs act on the key column x,
            #          plain states merge (sum of sums/counts, min of mins...)
            if len({a.arg for a in distinct_aggs}) != 1:
                raise NotImplementedError(
                    "multiple DISTINCT aggregates with different arguments")
            x = distinct_aggs[0].arg
            grp_names = [g.name if isinstance(g, Col) else f"__grp{i}"
                         for i, g in enumerate(group_exprs)]
            xname = "__dx"
            inner_aggs: List[AggExpr] = []
            new_agg_calls: List[AggCall] = []
            rewrite: Dict[AggCall, Expr] = {}

            def outer(call: AggCall) -> AggCall:
                if call not in new_agg_calls:
                    new_agg_calls.append(call)
                return call

            def zero_if_null(e: Expr) -> Expr:
                from ..exprs import Case, IsNull
                return Case(((IsNull(e), Lit(0)),), e)

            for j, a in enumerate(agg_calls):
                if a.distinct:
                    if a.kind == "count":
                        rewrite[a] = outer(AggCall("count", Col(xname)))
                    elif a.kind in ("sum", "min", "max", "avg"):
                        rewrite[a] = outer(AggCall(a.kind, Col(xname)))
                    else:
                        raise NotImplementedError(
                            f"{a.kind}(DISTINCT) not supported")
                elif a.kind in ("sum", "count", "count_star"):
                    nm = f"__ps{j}"
                    inner_aggs.append(AggExpr(a.kind, a.arg, alias=nm))
                    oc = outer(AggCall("sum", Col(nm)))
                    rewrite[a] = (zero_if_null(oc)
                                  if a.kind != "sum" else oc)
                elif a.kind in ("min", "max"):
                    nm = f"__ps{j}"
                    inner_aggs.append(AggExpr(a.kind, a.arg, alias=nm))
                    rewrite[a] = outer(AggCall(a.kind, Col(nm)))
                elif a.kind == "avg":
                    from ..exprs import Cast
                    from ..schema import FLOAT64
                    sn, cn = f"__ps{j}s", f"__ps{j}c"
                    inner_aggs.append(AggExpr("sum", a.arg, alias=sn))
                    inner_aggs.append(AggExpr("count", a.arg, alias=cn))
                    os_ = outer(AggCall("sum", Col(sn)))
                    oc_ = outer(AggCall("sum", Col(cn)))
                    # float division: int sum / int count would truncate
                    rewrite[a] = BinOp("/", Cast(os_, FLOAT64), oc_)
                else:
                    raise NotImplementedError(f"aggregate {a.kind}")

            current = L.Aggregate(current, tuple(group_exprs) + (x,),
                                  tuple(inner_aggs),
                                  tuple(grp_names) + (xname,))
            group_exprs = [Col(n) for n in grp_names]
            agg_calls = new_agg_calls
            new_items = []
            for e, nm in items:
                for a, repl in rewrite.items():
                    e = _replace_subtree(e, a, repl)
                new_items.append((e, nm))
            items = new_items
            if having is not None:
                for a, repl in rewrite.items():
                    having = _replace_subtree(having, a, repl)

        aggs: List[AggExpr] = []
        agg_names: Dict[AggCall, str] = {}
        for i, a in enumerate(agg_calls):
            nm = f"__agg{i}"
            agg_names[a] = nm
            aggs.append(AggExpr(a.kind, a.arg, alias=nm, distinct=False,
                                arg2=a.arg2, frac=a.frac))
        grp_names = []
        for i, g in enumerate(group_exprs):
            grp_names.append(g.name if isinstance(g, Col) else f"__grp{i}")
        plan = L.Aggregate(current, tuple(group_exprs), tuple(aggs),
                           tuple(grp_names))

        def rew(e: Expr) -> Expr:
            for a, nm in agg_names.items():
                e = _replace_subtree(e, a, Col(nm))
            for g, nm in zip(group_exprs, grp_names):
                if not isinstance(g, Col):
                    e = _replace_subtree(e, g, Col(nm))
            return e

        self._agg_items = [(rew(e), nm) for e, nm in items]
        if having is not None:
            plan = L.Filter(plan, rew(having))
        return plan

    def _plan_grouping_sets(self, current, group_exprs, agg_calls, items,
                            having, sets):
        """GROUPING SETS/ROLLUP/CUBE as a union of per-set aggregates:
        each branch groups by its key subset and projects absent keys as
        typed NULLs, so all branches share the full key layout.
        (Reference parity: DataFusion PhysicalGroupBy grouping sets.)"""
        from ..exprs import bind_expr
        if any(a.distinct for a in agg_calls):
            raise NotImplementedError("DISTINCT aggregates with grouping sets")
        aggs = [AggExpr(a.kind, a.arg, alias=f"__agg{i}",
                        arg2=a.arg2, frac=a.frac)
                for i, a in enumerate(agg_calls)]
        agg_names = {a: f"__agg{i}" for i, a in enumerate(agg_calls)}
        grp_names = [g.name if isinstance(g, Col) else f"__grp{i}"
                     for i, g in enumerate(group_exprs)]
        cur_schema = current.schema()
        key_dtypes = [bind_expr(g, cur_schema).dtype for g in group_exprs]

        branches = []
        for s in sets:
            sub = set(s)
            ag = L.Aggregate(current,
                             tuple(group_exprs[i] for i in s),
                             tuple(aggs),
                             tuple(grp_names[i] for i in s))
            proj_exprs: List[Expr] = []
            proj_names: List[str] = []
            for i, nm in enumerate(grp_names):
                proj_exprs.append(Col(nm) if i in sub
                                  else Lit(None, key_dtypes[i]))
                proj_names.append(nm)
            for i in range(len(aggs)):
                proj_exprs.append(Col(f"__agg{i}"))
                proj_names.append(f"__agg{i}")
            branches.append(L.Projection(ag, tuple(proj_exprs),
                                         tuple(proj_names)))
        out = branches[0] if len(branches) == 1 else L.Union(tuple(branches))

        def rew(e: Expr) -> Expr:
            for a, nm in agg_names.items():
                e = _replace_subtree(e, a, Col(nm))
            for g, nm in zip(group_exprs, grp_names):
                if not isinstance(g, Col):
                    e = _replace_subtree(e, g, Col(nm))
            return e

        self._agg_items = [(rew(e), nm) for e, nm in items]
        if having is not None:
            out = L.Filter(out, rew(having))
        return out


def plan_sql(sql: str, ctx) -> L.LogicalPlan:
    stmt = parse_sql(sql)
    return SqlPlanner(ctx).plan_select(stmt)
