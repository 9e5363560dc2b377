"""SQL lexer + recursive-descent parser (TPC-H dialect).

Produces a SelectStmt AST over `ballista_tpu.exprs` expression nodes, with
SQL-only extensions (aggregate calls, subqueries) defined here and lowered
by `sql.planner`.
"""

from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union

from ..exprs import (Between, BinOp, Case, Cast, Col, Expr, InList,
                     IntervalLit, IsNull, Like, Lit, Neg, Not, ScalarFn)
from ..schema import DATE32, DataType, decimal as decimal_type

# ---------------------------------------------------------------------------
# SQL-only AST nodes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AggCall(Expr):
    kind: str                 # sum|avg|count|min|max|count_star|var_samp|
                              # var_pop|stddev_samp|stddev_pop|corr|median|
                              # percentile
    arg: Optional[Expr]
    distinct: bool = False
    arg2: Optional[Expr] = None     # corr second argument
    frac: Optional[float] = None    # percentile fraction


@dataclasses.dataclass(frozen=True)
class WindowCall(Expr):
    """fn(...) OVER (PARTITION BY ... ORDER BY ...) — lowered by sql.planner
    to a Window logical node + column reference."""
    kind: str                 # sum|avg|min|max|count|count_star|row_number|
                              # rank|dense_rank|lag|lead|first_value|last_value
                              # ntile|percent_rank|cume_dist|nth_value
    arg: Optional[Expr]
    partition_by: Tuple[Expr, ...] = ()
    order_by: Tuple[Tuple[Expr, bool, Optional[bool]], ...] = ()
    offset: int = 1           # lag/lead distance; ntile buckets; nth_value k
    # (mode, lo, hi): mode "rows"|"range"; lo/hi row offsets relative to the
    # current row (negative = PRECEDING), None = UNBOUNDED on that side
    frame: Optional[Tuple[str, Optional[int], Optional[int]]] = None


@dataclasses.dataclass(frozen=True)
class SubqueryExpr(Expr):
    """Scalar subquery usable where an expression is expected."""
    query: "SelectStmt"


@dataclasses.dataclass(frozen=True)
class ExistsExpr(Expr):
    query: "SelectStmt"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class InSubquery(Expr):
    child: Expr
    query: "SelectStmt"
    negated: bool = False


@dataclasses.dataclass(frozen=True)
class Star(Expr):
    pass


@dataclasses.dataclass
class TableRef:
    # either a named table or a derived table (subquery)
    name: Optional[str] = None
    subquery: Optional["SelectStmt"] = None
    alias: Optional[str] = None
    col_aliases: Optional[Tuple[str, ...]] = None  # "as t (c1, c2)"


@dataclasses.dataclass
class CreateView:
    name: str
    columns: Optional[Tuple[str, ...]]
    query: "SelectStmt"


@dataclasses.dataclass
class SetOpStmt:
    """INTERSECT / EXCEPT (distinct set semantics; NULLs compare equal,
    per the SQL set-operation rules). `all`=True keeps bag semantics:
    a row appears min(l,r) times (INTERSECT ALL) / max(l-r,0) times
    (EXCEPT ALL)."""
    left: object
    right: object
    op: str                     # 'intersect' | 'except'
    order_by: list = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    all: bool = False


@dataclasses.dataclass
class CreateTableAs:
    """CREATE TABLE t AS SELECT ... — materializes the result as a
    registered table (DataFusion CTAS parity)."""
    name: str
    query: "SelectStmt"


@dataclasses.dataclass
class DropView:
    name: str


@dataclasses.dataclass
class ExplainStmt:
    """EXPLAIN <select> — plan introspection as a statement (DataFusion
    surface; the reference inherits it). Yields (plan_type, plan) rows."""
    query: object   # SelectStmt | UnionStmt | SetOpStmt


@dataclasses.dataclass
class CreateExternalTable:
    """`CREATE EXTERNAL TABLE t [(col type,…)] STORED AS fmt
    [WITH HEADER ROW] LOCATION 'path'` — the DDL BallistaContext::sql
    intercepts locally (context.rs:362)."""
    name: str
    columns: Optional[Tuple[Tuple[str, object], ...]]
    fmt: str                 # csv | parquet | json
    location: str
    header: bool = False


@dataclasses.dataclass
class ShowTables:
    pass


@dataclasses.dataclass
class ShowColumns:
    name: str


@dataclasses.dataclass
class JoinClause:
    table: TableRef
    how: str          # inner | left | right | full
    on: Optional[Expr]


@dataclasses.dataclass
class UnionStmt:
    inputs: list          # List[SelectStmt]
    all: bool = False
    order_by: list = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None


@dataclasses.dataclass
class SelectStmt:
    projections: List[Tuple[Expr, Optional[str]]] = dataclasses.field(default_factory=list)
    from_tables: List[TableRef] = dataclasses.field(default_factory=list)
    joins: List[JoinClause] = dataclasses.field(default_factory=list)
    where: Optional[Expr] = None
    group_by: List[Union[Expr, int]] = dataclasses.field(default_factory=list)
    having: Optional[Expr] = None
    order_by: List[Tuple[Union[Expr, int], bool, Optional[bool]]] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    # GROUPING SETS/ROLLUP/CUBE: tuples of indices into group_by; None for a
    # plain GROUP BY
    grouping_sets: Optional[List[Tuple[int, ...]]] = None


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|--[^\n]*\n?)
  | (?P<num>\d+\.\d*|\.\d+|\d+)
  | (?P<str>'(?:[^']|'')*')
  | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
  | (?P<op><>|!=|<=|>=|\|\||[-+*/%(),.;<>=])
""", re.X)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "as", "and", "or", "not", "in", "like", "between", "is", "null",
    "case", "when", "then", "else", "end", "cast", "date", "interval",
    "exists", "distinct", "join", "inner", "left", "right", "full", "outer",
    "on", "asc", "desc", "nulls", "first", "last", "union", "all",
    "true", "false", "extract", "year", "create", "drop", "view", "for",
    "over", "partition", "grouping", "sets", "rollup", "cube", "cross",
    "rows", "range", "unbounded", "preceding", "following", "current", "row",
}

WINDOW_FNS = ("row_number", "rank", "dense_rank", "lag", "lead",
              "first_value", "last_value", "ntile", "percent_rank",
              "cume_dist", "nth_value")

BASIC_AGG_NAMES = ("sum", "avg", "min", "max", "count")

# name -> AggExpr kind for the statistics aggregates (DataFusion surface)
MOMENT_AGG_NAMES = {
    "stddev": "stddev_samp", "stddev_samp": "stddev_samp",
    "stddev_pop": "stddev_pop",
    "var": "var_samp", "variance": "var_samp", "var_samp": "var_samp",
    "var_pop": "var_pop",
    "median": "median", "corr": "corr",
    "approx_percentile_cont": "percentile", "percentile_cont": "percentile",
}


@dataclasses.dataclass
class Token:
    kind: str   # num | str | id | kw | op | eof
    value: str


def tokenize(sql: str) -> List[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = TOKEN_RE.match(sql, pos)
        if not m:
            raise SyntaxError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        if m.lastgroup == "id":
            low = text.lower()
            out.append(Token("kw" if low in KEYWORDS else "id", low if low in KEYWORDS else text))
        elif m.lastgroup == "str":
            out.append(Token("str", text[1:-1].replace("''", "'")))
        else:
            out.append(Token(m.lastgroup, text))
    out.append(Token("eof", ""))
    return out


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class Parser:
    def __init__(self, tokens: List[Token]):
        self.toks = tokens
        self.i = 0

    # -- token helpers --
    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            got = self.peek()
            raise SyntaxError(f"expected {value or kind}, got {got.kind} {got.value!r} (pos {self.i})")
        return t

    def at_kw(self, *words) -> bool:
        t = self.peek()
        return t.kind == "kw" and t.value in words

    # -- statement --
    def _hoist_trailing(self, so, right):
        """The LAST member's ORDER BY / LIMIT / OFFSET bind to the whole
        set-op chain (standard SQL)."""
        so.order_by = getattr(right, "order_by", [])
        right.order_by = []
        so.limit = getattr(right, "limit", None)
        right.limit = None
        so.offset = getattr(right, "offset", None)
        right.offset = None
        return so

    def parse_select(self):
        """SELECT with set operations at SQL-standard precedence:
        INTERSECT binds tighter than UNION and EXCEPT, which associate
        left pairwise (`a UNION b INTERSECT c` = a UNION (b INTERSECT c);
        mixed `UNION` / `UNION ALL` chains keep each pair's own ALL).
        A leading `WITH name [(cols)] AS (select), …` attaches CTEs to
        the returned statement (DataFusion SQL surface parity)."""
        ctes = self._parse_ctes()
        stmt = self._parse_intersect_term()
        while True:
            if self.at_kw("union"):
                self.next()
                is_all = bool(self.accept("kw", "all"))
                right = self._parse_intersect_term()
                stmt = self._hoist_trailing(
                    UnionStmt([stmt, right], all=is_all), right)
            elif (self.peek().kind == "id"
                    and self.peek().value.lower() == "except"):
                self.next()
                all_flag = False
                if self.at_kw("all"):
                    self.next()
                    all_flag = True
                right = self._parse_intersect_term()
                stmt = self._hoist_trailing(
                    SetOpStmt(stmt, right, "except", all=all_flag), right)
            else:
                if ctes:
                    stmt.ctes = ctes
                return stmt

    def _parse_ctes(self):
        """`WITH name [(col,…)] AS ( select ) [, …]` — returns a list of
        (name, col_aliases, stmt). WITH is not a reserved word here (it
        also appears in `WITH HEADER ROW`), so match it as an id."""
        t = self.peek()
        if not (t.kind == "id" and t.value.lower() == "with"
                and self.peek(1).kind == "id"):
            return []
        self.next()
        if self.peek().value.lower() == "recursive":
            raise NotImplementedError("WITH RECURSIVE")
        ctes = []
        while True:
            name = self._name()
            cols = None
            if self.accept("op", "("):
                names = [self._name()]
                while self.accept("op", ","):
                    names.append(self._name())
                self.expect("op", ")")
                cols = tuple(names)
            self.expect("kw", "as")
            self.expect("op", "(")
            q = self.parse_select()
            self.expect("op", ")")
            ctes.append((name, cols, q))
            if not self.accept("op", ","):
                return ctes

    def _parse_intersect_term(self):
        stmt = self._parse_select_one()
        while (self.peek().kind == "id"
               and self.peek().value.lower() == "intersect"):
            self.next()
            all_flag = False
            if self.at_kw("all"):
                self.next()
                all_flag = True
            right = self._parse_select_one()
            stmt = self._hoist_trailing(
                SetOpStmt(stmt, right, "intersect", all=all_flag), right)
        return stmt

    def _parse_select_one(self) -> SelectStmt:
        self.expect("kw", "select")
        stmt = SelectStmt()
        if self.accept("kw", "distinct"):
            stmt.distinct = True
        # projections
        while True:
            if self.accept("op", "*"):
                stmt.projections.append((Star(), None))
            else:
                e = self.parse_expr()
                alias = None
                if self.accept("kw", "as"):
                    alias = self._name()
                elif self.peek().kind == "id":
                    alias = self.next().value
                stmt.projections.append((e, alias))
            if not self.accept("op", ","):
                break
        # FROM
        if self.accept("kw", "from"):
            stmt.from_tables.append(self.parse_table_ref())
            while True:
                if self.accept("op", ","):
                    stmt.from_tables.append(self.parse_table_ref())
                    continue
                how = self._try_join_kw()
                if how:
                    tref = self.parse_table_ref()
                    on = None
                    if self.accept("kw", "on"):
                        on = self.parse_expr()
                    stmt.joins.append(JoinClause(tref, how, on))
                    continue
                break
        if self.accept("kw", "where"):
            stmt.where = self.parse_expr()
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            if self.at_kw("grouping", "rollup", "cube"):
                self._parse_grouping_sets(stmt)
            else:
                while True:
                    if self.peek().kind == "num":
                        stmt.group_by.append(int(self.next().value))
                    else:
                        stmt.group_by.append(self.parse_expr())
                    if not self.accept("op", ","):
                        break
        if self.accept("kw", "having"):
            stmt.having = self.parse_expr()
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                if self.peek().kind == "num" and self.peek(1).kind in ("op", "kw", "eof") \
                        and self.peek(1).value not in ("(", ".", "*", "/", "+", "-"):
                    key: Union[Expr, int] = int(self.next().value)
                else:
                    key = self.parse_expr()
                asc = True
                if self.accept("kw", "desc"):
                    asc = False
                else:
                    self.accept("kw", "asc")
                nulls_first = None
                if self.accept("kw", "nulls"):
                    if self.accept("kw", "first"):
                        nulls_first = True
                    else:
                        self.expect("kw", "last")
                        nulls_first = False
                stmt.order_by.append((key, asc, nulls_first))
                if not self.accept("op", ","):
                    break
        if self.accept("kw", "limit"):
            stmt.limit = int(self.expect("num").value)
        if self.peek().kind == "id" and self.peek().value.lower() == "offset":
            self.next()
            stmt.offset = int(self.expect("num").value)
        self.accept("op", ";")
        return stmt

    def _parse_grouping_sets(self, stmt: SelectStmt):
        """GROUPING SETS ((a,b),(a),()) | ROLLUP(a,b) | CUBE(a,b).
        Fills stmt.group_by (distinct key exprs, first-appearance order) and
        stmt.grouping_sets (index tuples)."""
        def key_index(e: Expr) -> int:
            for i, g in enumerate(stmt.group_by):
                if g == e:
                    return i
            stmt.group_by.append(e)
            return len(stmt.group_by) - 1

        if self.accept("kw", "grouping"):
            self.expect("kw", "sets")
            self.expect("op", "(")
            sets: List[Tuple[int, ...]] = []
            while True:
                if self.accept("op", "("):
                    idxs = []
                    if not self.accept("op", ")"):
                        idxs.append(key_index(self.parse_expr()))
                        while self.accept("op", ","):
                            idxs.append(key_index(self.parse_expr()))
                        self.expect("op", ")")
                    sets.append(tuple(idxs))
                else:
                    sets.append((key_index(self.parse_expr()),))
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
            stmt.grouping_sets = sets
            return
        kind = self.next().value  # rollup | cube
        self.expect("op", "(")
        idxs = [key_index(self.parse_expr())]
        while self.accept("op", ","):
            idxs.append(key_index(self.parse_expr()))
        self.expect("op", ")")
        if kind == "rollup":
            stmt.grouping_sets = [tuple(idxs[:k])
                                  for k in range(len(idxs), -1, -1)]
        else:  # cube: all subsets, fuller sets first
            n = len(idxs)
            subsets = sorted(range(1 << n),
                             key=lambda m: -bin(m).count("1"))
            stmt.grouping_sets = [
                tuple(idxs[i] for i in range(n) if m >> i & 1)
                for m in subsets]

    def _try_join_kw(self) -> Optional[str]:
        if self.accept("kw", "join"):
            return "inner"
        if self.at_kw("cross") and self.peek(1).value == "join":
            self.next(); self.next()
            return "cross"
        if self.at_kw("inner") and self.peek(1).value == "join":
            self.next(); self.next()
            return "inner"
        for how in ("left", "right", "full"):
            if self.at_kw(how):
                j = 1
                if self.peek(1).kind == "kw" and self.peek(1).value == "outer":
                    j = 2
                if self.peek(j).kind == "kw" and self.peek(j).value == "join":
                    for _ in range(j + 1):
                        self.next()
                    return how
        return None

    def parse_table_ref(self) -> TableRef:
        if self.accept("op", "("):
            sub = self.parse_select()
            self.expect("op", ")")
            alias, cols = self._alias_with_columns()
            return TableRef(subquery=sub, alias=alias, col_aliases=cols)
        name = self._name()
        # schema-qualified table names (information_schema.tables)
        while self.peek().kind == "op" and self.peek().value == ".":
            self.next()
            name = f"{name}.{self._name()}"
        alias, cols = self._alias_with_columns()
        return TableRef(name=name, alias=alias, col_aliases=cols)

    _NON_ALIAS_IDS = {"intersect", "except", "offset"}

    def _alias_with_columns(self):
        alias = None
        if self.accept("kw", "as"):
            alias = self._name()
        elif (self.peek().kind == "id"
              and self.peek().value.lower() not in self._NON_ALIAS_IDS):
            alias = self.next().value
        cols = None
        if alias is not None and self.peek().kind == "op" and self.peek().value == "(":
            # "as t (c1, c2)" column alias list — but don't swallow a
            # function call; only identifiers separated by commas
            save = self.i
            self.next()
            names = []
            ok = True
            while True:
                if self.peek().kind != "id":
                    ok = False
                    break
                names.append(self.next().value)
                if self.accept("op", ")"):
                    break
                if not self.accept("op", ","):
                    ok = False
                    break
            if ok:
                cols = tuple(names)
            else:
                self.i = save
        return alias, cols

    def _name(self) -> str:
        t = self.peek()
        if t.kind in ("id",):
            return self.next().value
        raise SyntaxError(f"expected name, got {t.kind} {t.value!r}")

    # -- expressions (precedence climbing) --
    def parse_expr(self) -> Expr:
        return self.parse_or()

    def parse_or(self) -> Expr:
        e = self.parse_and()
        while self.accept("kw", "or"):
            e = BinOp("or", e, self.parse_and())
        return e

    def parse_and(self) -> Expr:
        e = self.parse_not()
        while self.accept("kw", "and"):
            e = BinOp("and", e, self.parse_not())
        return e

    def parse_not(self) -> Expr:
        if self.accept("kw", "not"):
            return Not(self.parse_not())
        return self.parse_predicate()

    def parse_predicate(self) -> Expr:
        e = self.parse_add()
        while True:
            if self.at_kw("is"):
                self.next()
                negated = bool(self.accept("kw", "not"))
                self.expect("kw", "null")
                e = IsNull(e, negated=negated)
                continue
            negated = False
            if self.at_kw("not") and self.peek(1).kind == "kw" and \
                    self.peek(1).value in ("in", "like", "between"):
                self.next()
                negated = True
            if self.accept("kw", "between"):
                low = self.parse_add()
                self.expect("kw", "and")
                high = self.parse_add()
                e = Between(e, low, high, negated=negated)
                continue
            if self.accept("kw", "in"):
                self.expect("op", "(")
                if self.at_kw("select"):
                    sub = self.parse_select()
                    self.expect("op", ")")
                    e = InSubquery(e, sub, negated=negated)
                else:
                    vals = [self.parse_add()]
                    while self.accept("op", ","):
                        vals.append(self.parse_add())
                    self.expect("op", ")")
                    e = InList(e, tuple(vals), negated=negated)
                continue
            if self.accept("kw", "like"):
                pat = self.expect("str").value
                e = Like(e, pat, negated=negated)
                continue
            t = self.peek()
            if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
                self.next()
                e = BinOp(t.value, e, self.parse_add())
                continue
            return e

    def parse_add(self) -> Expr:
        e = self.parse_mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                e = BinOp(t.value, e, self.parse_mul())
            elif t.kind == "op" and t.value == "||":
                self.next()
                e = ScalarFn("concat", (e, self.parse_mul()))
            else:
                return e

    def parse_mul(self) -> Expr:
        e = self.parse_unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                e = BinOp(t.value, e, self.parse_unary())
            else:
                return e

    def parse_unary(self) -> Expr:
        if self.accept("op", "-"):
            return Neg(self.parse_unary())
        self.accept("op", "+")
        return self.parse_primary()

    def parse_primary(self) -> Expr:
        t = self.peek()
        if self.accept("op", "("):
            if self.at_kw("select"):
                sub = self.parse_select()
                self.expect("op", ")")
                return SubqueryExpr(sub)
            e = self.parse_expr()
            self.expect("op", ")")
            return e
        if t.kind == "num":
            self.next()
            if "." in t.value:
                scale = len(t.value.split(".")[1])
                digits = len(t.value.replace(".", "").lstrip("0")) or 1
                return Lit(t.value, decimal_type(max(digits, scale + 1), scale))
            return Lit(int(t.value))
        if t.kind == "str":
            self.next()
            return Lit(t.value)
        if self.accept("kw", "true"):
            return Lit(True)
        if self.accept("kw", "false"):
            return Lit(False)
        if self.accept("kw", "null"):
            return Lit(None, DATE32) if False else Lit(None, None)
        if self.accept("kw", "date"):
            s = self.expect("str").value
            return Lit(s, DATE32)
        if self.accept("kw", "interval"):
            s = self.expect("str").value
            unit = self._name().lower() if self.peek().kind == "id" else self.expect("kw", "year").value
            qty = int(s.split()[0])
            unit = unit.rstrip("s")
            if unit == "year":
                return IntervalLit(months=12 * qty)
            if unit == "month":
                return IntervalLit(months=qty)
            if unit == "day":
                return IntervalLit(days=qty)
            raise SyntaxError(f"unsupported interval unit {unit}")
        if self.accept("kw", "exists"):
            self.expect("op", "(")
            sub = self.parse_select()
            self.expect("op", ")")
            return ExistsExpr(sub)
        if self.accept("kw", "case"):
            whens = []
            otherwise = None
            operand = None
            if not self.at_kw("when"):
                operand = self.parse_expr()
            while self.accept("kw", "when"):
                cond = self.parse_expr()
                self.expect("kw", "then")
                val = self.parse_expr()
                if operand is not None:
                    cond = BinOp("=", operand, cond)
                whens.append((cond, val))
            if self.accept("kw", "else"):
                otherwise = self.parse_expr()
            self.expect("kw", "end")
            return Case(tuple(whens), otherwise)
        if self.accept("kw", "cast"):
            self.expect("op", "(")
            e = self.parse_expr()
            self.expect("kw", "as")
            dtype = self.parse_type()
            self.expect("op", ")")
            return Cast(e, dtype)
        if self.accept("kw", "extract"):
            self.expect("op", "(")
            part = self.next().value.lower()  # year | month | day (kw or id)
            if part not in ("year", "month", "day"):
                raise SyntaxError(f"EXTRACT: unsupported part {part!r}")
            self.expect("kw", "from")
            e = self.parse_expr()
            self.expect("op", ")")
            return ScalarFn(f"extract_{part}", (e,))
        if t.kind == "id":
            name = self.next().value
            # function call?
            if self.peek().kind == "op" and self.peek().value == "(":
                self.next()
                low = name.lower()
                if low == "substring":
                    e = self.parse_expr()
                    if self.accept("kw", "from"):
                        start = int(self.expect("num").value)
                        length = None
                        if self.accept("kw", "for"):
                            length = int(self.expect("num").value)
                    else:
                        self.expect("op", ",")
                        start = int(self.expect("num").value)
                        length = None
                        if self.accept("op", ","):
                            length = int(self.expect("num").value)
                    self.expect("op", ")")
                    return ScalarFn("substring",
                                    (e, Lit(start), Lit(length if length is not None else -1)))
                if low in BASIC_AGG_NAMES:
                    distinct = bool(self.accept("kw", "distinct"))
                    if self.accept("op", "*"):
                        self.expect("op", ")")
                        if self.at_kw("over"):
                            return self._parse_over("count_star", None)
                        return AggCall("count_star", None)
                    arg = self.parse_expr()
                    self.expect("op", ")")
                    if self.at_kw("over"):
                        return self._parse_over(low, arg)
                    return AggCall(low, arg, distinct=distinct)
                if low in MOMENT_AGG_NAMES:
                    arg = self.parse_expr()
                    arg2 = frac = None
                    if self.accept("op", ","):
                        second = self.parse_expr()
                        if low in ("approx_percentile_cont",
                                   "percentile_cont"):
                            if not isinstance(second, Lit):
                                raise SyntaxError(
                                    f"{low} percentile must be a literal")
                            frac = float(second.value)
                        else:
                            arg2 = second
                    self.expect("op", ")")
                    kind = MOMENT_AGG_NAMES[low]
                    if kind == "corr" and arg2 is None:
                        raise SyntaxError("corr requires two arguments")
                    if kind == "percentile" and frac is None:
                        raise SyntaxError(f"{low} requires a percentile")
                    return AggCall(kind, arg, arg2=arg2, frac=frac)
                args = []
                if not self.accept("op", ")"):
                    args.append(self.parse_expr())
                    while self.accept("op", ","):
                        args.append(self.parse_expr())
                    self.expect("op", ")")
                if low in WINDOW_FNS and self.at_kw("over"):
                    offset = 1
                    if low in ("lag", "lead") and len(args) > 1:
                        off = args[1]
                        if not isinstance(off, Lit) or not isinstance(off.value, int):
                            raise SyntaxError(f"{low} offset must be an integer literal")
                        offset = off.value
                    if low in ("ntile", "nth_value"):
                        off = args[0] if low == "ntile" else (
                            args[1] if len(args) > 1 else None)
                        if not isinstance(off, Lit) or not isinstance(off.value, int) \
                                or off.value < 1:
                            raise SyntaxError(
                                f"{low} requires a positive integer literal")
                        offset = off.value
                        args = [] if low == "ntile" else args[:1]
                    return self._parse_over(low, args[0] if args else None,
                                            offset=offset)
                return ScalarFn(low, tuple(args))
            # qualified name?
            if self.peek().kind == "op" and self.peek().value == ".":
                self.next()
                col = self._name()
                return Col(f"{name}.{col}")
            return Col(name)
        raise SyntaxError(f"unexpected token {t.kind} {t.value!r}")

    def _parse_over(self, kind: str, arg: Optional[Expr],
                    offset: int = 1) -> "WindowCall":
        self.expect("kw", "over")
        self.expect("op", "(")
        partition_by: List[Expr] = []
        if self.accept("kw", "partition"):
            self.expect("kw", "by")
            partition_by.append(self.parse_expr())
            while self.accept("op", ","):
                partition_by.append(self.parse_expr())
        order_by: List[Tuple[Expr, bool, Optional[bool]]] = []
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                e = self.parse_expr()
                asc = True
                if self.accept("kw", "desc"):
                    asc = False
                else:
                    self.accept("kw", "asc")
                nulls_first = None
                if self.accept("kw", "nulls"):
                    if self.accept("kw", "first"):
                        nulls_first = True
                    else:
                        self.expect("kw", "last")
                        nulls_first = False
                order_by.append((e, asc, nulls_first))
                if not self.accept("op", ","):
                    break
        frame = None
        if self.at_kw("rows") or self.at_kw("range"):
            mode = self.next().value
            if self.accept("kw", "between"):
                lo = self._parse_frame_bound(start=True)
                self.expect("kw", "and")
                hi = self._parse_frame_bound(start=False)
            else:
                lo = self._parse_frame_bound(start=True)
                hi = 0  # shorthand: frame ends at CURRENT ROW
            frame = (mode, lo, hi)
        self.expect("op", ")")
        return WindowCall(kind, arg, tuple(partition_by), tuple(order_by),
                          offset, frame)

    def _parse_frame_bound(self, start: bool) -> Optional[int]:
        """UNBOUNDED PRECEDING/FOLLOWING -> None; CURRENT ROW -> 0;
        k PRECEDING -> -k; k FOLLOWING -> +k."""
        if self.accept("kw", "unbounded"):
            if start:
                self.expect("kw", "preceding")
            else:
                self.expect("kw", "following")
            return None
        if self.accept("kw", "current"):
            self.expect("kw", "row")
            return 0
        n = int(self.expect("num").value)
        if self.accept("kw", "preceding"):
            return -n
        self.expect("kw", "following")
        return n

    def parse_type(self) -> DataType:
        from ..schema import FLOAT64, INT32, INT64, STRING
        t = self._name().lower() if self.peek().kind == "id" else self.next().value
        if t in ("int", "integer"):
            return INT32
        if t == "bigint":
            return INT64
        if t in ("double", "float8"):
            return FLOAT64
        if t in ("varchar", "text", "string"):
            return STRING
        if t == "decimal":
            if self.accept("op", "("):
                p = int(self.expect("num").value)
                self.expect("op", ",")
                s = int(self.expect("num").value)
                self.expect("op", ")")
                return decimal_type(p, s)
            return decimal_type(18, 2)
        if t == "date":
            return DATE32
        raise SyntaxError(f"unknown type {t}")


def parse_statements(sql: str):
    """Parse a script of ;-separated statements: SELECTs, CREATE VIEW,
    DROP VIEW (the TPC-H Q15 shape)."""
    p = Parser(tokenize(sql))
    out = []

    def accept_id(word: str) -> bool:
        t = p.peek()
        if t.kind == "id" and t.value.lower() == word:
            p.next()
            return True
        return False

    def expect_id(word: str):
        if not accept_id(word):
            t = p.peek()
            raise SyntaxError(f"expected {word.upper()}, got {t.value!r}")

    while p.peek().kind != "eof":
        if p.accept("op", ";"):
            continue
        if accept_id("show"):
            if accept_id("tables"):
                out.append(ShowTables())
            elif accept_id("columns"):
                p.expect("kw", "from")
                out.append(ShowColumns(p._name()))
            else:
                raise SyntaxError("expected TABLES or COLUMNS after SHOW")
            p.accept("op", ";")
            continue
        if accept_id("describe"):
            out.append(ShowColumns(p._name()))
            p.accept("op", ";")
            continue
        if accept_id("explain"):
            accept_id("verbose")  # accepted, same output
            out.append(ExplainStmt(p.parse_select()))
            p.accept("op", ";")
            continue
        if p.peek().kind == "kw" and p.peek().value == "create" and \
                p.peek(1).kind == "id" and p.peek(1).value.lower() == "external":
            p.next()  # create
            p.next()  # external
            expect_id("table")
            name = p._name()
            cols = None
            if p.accept("op", "("):
                cols = []
                while True:
                    cname = p._name()
                    cols.append((cname, p.parse_type()))
                    if not p.accept("op", ","):
                        break
                p.expect("op", ")")
                cols = tuple(cols)
            expect_id("stored")
            p.expect("kw", "as")
            fmt = p._name().lower()
            header = False
            while True:
                t = p.peek()
                if t.kind == "id" and t.value.lower() == "with":
                    p.next()
                    expect_id("header")
                    p.expect("kw", "row")
                    header = True
                elif t.kind == "id" and t.value.lower() == "location":
                    p.next()
                    break
                else:
                    raise SyntaxError(f"expected LOCATION, got {t.value!r}")
            loc = p.expect("str").value
            out.append(CreateExternalTable(name, cols, fmt, loc, header))
            p.accept("op", ";")
            continue
        if p.accept("kw", "create"):
            if p.peek().kind == "id" and p.peek().value.lower() == "table":
                p.next()
                name = p._name()
                p.expect("kw", "as")
                out.append(CreateTableAs(name, p.parse_select()))
                p.accept("op", ";")
                continue
            p.expect("kw", "view")
            name = p._name()
            cols = None
            if p.accept("op", "("):
                names = [p._name()]
                while p.accept("op", ","):
                    names.append(p._name())
                p.expect("op", ")")
                cols = tuple(names)
            p.expect("kw", "as")
            q = p.parse_select()
            out.append(CreateView(name, cols, q))
        elif p.accept("kw", "drop"):
            p.expect("kw", "view")
            out.append(DropView(p._name()))
            p.accept("op", ";")
        else:
            out.append(p.parse_select())
    return out


def parse_sql(sql: str) -> SelectStmt:
    return Parser(tokenize(sql)).parse_select()
