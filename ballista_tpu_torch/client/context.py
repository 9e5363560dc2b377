"""SessionContext — the user entry point (port of
ballista_tpu/client/context.py).

Local mode only: one device, one partition per table. Tables are
registered from host columns (`HostColumn`s, e.g. from `datagen`) and
uploaded to the device column by column, on first use.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import batch as B
from ..exec.plan import run_plan
from ..planner import logical as L
from ..planner.physical import PhysicalOptions, create_physical_plan
from ..schema import Field, Schema
from .dataframe import DataFrame


class TableProvider:
    """A registered table: host columns plus the device columns uploaded
    so far. A pruned scan uploads only the columns it reads."""

    def __init__(self, name: str, fields: Sequence[Field],
                 columns: Dict[str, B.HostColumn], device: torch.device,
                 primary_key=None):
        missing = [f.name for f in fields if f.name not in columns]
        if missing:
            raise ValueError(f"table {name!r}: no host data for {missing}")
        lengths = {len(columns[f.name].values) for f in fields}
        if len(lengths) > 1:
            raise ValueError(f"table {name!r}: columns differ in length "
                             f"{sorted(lengths)}")
        self.name = name
        self.fields = tuple(fields)
        self.host = dict(columns)
        self.device = device
        self.primary_key = tuple(primary_key) if primary_key else None
        self.num_rows = lengths.pop() if lengths else 0
        self._cols: Dict[str, B.Column] = {}
        self._inferred_unique = None

    @property
    def capacity(self) -> int:
        return B.round_capacity(self.num_rows)

    @property
    def schema(self) -> Schema:
        dicts = {f.name: self.host[f.name].dictionary for f in self.fields
                 if self.host[f.name].dictionary is not None}
        bounds = {f.name: self.host[f.name].bounds for f in self.fields
                  if self.host[f.name].bounds is not None}
        return Schema(self.fields, dicts, bounds)

    def column_batch(self, names) -> B.Batch:
        """Device batch of exactly `names`, in order."""
        dtypes = {f.name: f.dtype for f in self.fields}
        for name in names:
            if name not in self._cols:
                h = self.host[name]
                self._cols[name] = B.make_column(h.values, h.validity,
                                                 dtypes[name], self.capacity,
                                                 self.device)
        return B.Batch(tuple(self._cols[c] for c in names),
                       torch.tensor(self.num_rows, dtype=torch.int32,
                                    device=self.device))


class SessionContext:
    """One device, chosen explicitly. The default is "cuda", and that
    raises when no CUDA device is present: the port never carries on on
    the CPU unasked (the CPU tests pass device="cpu")."""

    def __init__(self, device="cuda",
                 options: Optional[PhysicalOptions] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SessionContext(device='cuda'): CUDA is not "
                               "available; pass device='cpu' to run on the CPU")
        self.options = options or PhysicalOptions()
        self.tables: Dict[str, TableProvider] = {}
        # CREATE VIEW: name -> (SelectStmt, column aliases), expanded by
        # the SQL planner wherever the name is scanned
        self.views: Dict[str, tuple] = {}
        self.warnings = []

    def register_host(self, name: str, fields: Sequence[Field],
                      columns: Dict[str, B.HostColumn],
                      primary_key=None) -> None:
        self.tables[name] = TableProvider(name, fields, columns, self.device,
                                          primary_key)

    def register_udf(self, name: str, fn, out_dtype,
                     propagate_nulls: bool = True) -> None:
        """Register a scalar UDF for SQL and expressions: fn(*data
        tensors) -> data tensor (`exprs.register_udf`)."""
        from ..exprs import register_udf
        register_udf(name, fn, out_dtype, propagate_nulls)

    def unique_keys(self, name: str):
        """Unique column sets for join build-side selection and
        functional-dependency reasoning: the declared primary key, else
        the single columns whose values are all distinct (tables of up to
        a million rows; a NULL counts as one value)."""
        tp = self.tables[name]
        if tp.primary_key:
            return [tp.primary_key]
        if tp._inferred_unique is None:
            tp._inferred_unique = []
            if tp.num_rows <= 1_000_000:
                for f in tp.fields:
                    h = tp.host[f.name]
                    n_distinct = (len(np.unique(h.values[h.validity]))
                                  + int(not h.validity.all()))
                    if n_distinct == tp.num_rows:
                        tp._inferred_unique.append((f.name,))
        return tp._inferred_unique

    def sql(self, query: str) -> DataFrame:
        """Plan a SQL script of SELECT, CREATE VIEW and DROP VIEW
        statements (the TPC-H Q15 shape); returns the last SELECT. Each
        SELECT is planned when it is read, so a view dropped after it has
        already been expanded into its plan."""
        from ..sql.parser import (CreateView, DropView, SelectStmt,
                                  SetOpStmt, UnionStmt, parse_statements)
        from ..sql.planner import SqlPlanner

        last = None
        for stmt in parse_statements(query):
            if isinstance(stmt, CreateView):
                self.views[stmt.name] = (stmt.query, stmt.columns)
                continue
            if isinstance(stmt, DropView):
                self.views.pop(stmt.name, None)
                continue
            if not isinstance(stmt, (SelectStmt, UnionStmt, SetOpStmt)):
                raise NotImplementedError(
                    f"{type(stmt).__name__} statements are not ported yet")
            last = DataFrame(self, SqlPlanner(self).plan_select(stmt))
        if last is None:
            raise ValueError("no SELECT statement in script")
        return last

    def bind_inputs(self, input_ids) -> dict:
        """Bind plan input ids to device batches. Column-scoped ids
        ("table::c1,c2", emitted for pruned scans) bind only those columns."""
        out = {}
        for i in set(input_ids):
            name, _, cols = i.partition("::")
            tp = self.tables[name]
            out[i] = tp.column_batch(cols.split(",") if cols
                                     else [f.name for f in tp.fields])
        return out

    def physical_plan(self, plan: L.LogicalPlan,
                      options: Optional[PhysicalOptions] = None):
        capacities = {name: tp.capacity for name, tp in self.tables.items()}
        return create_physical_plan(plan, capacities,
                                    options or self.options, self.device)

    def collect(self, plan: L.LogicalPlan, max_retries: int = 5):
        """Execute a logical plan: returns (Batch on the device, Schema)."""
        exec_plan, _, out = self.converge(plan, max_retries)
        return out, exec_plan.schema

    def converge(self, plan: L.LogicalPlan, max_retries: int = 5):
        """Plan and run until the output fits: returns (exec_plan, inputs,
        out), the first physical plan whose run did not overflow, its bound
        inputs and that run's Batch. `run_plan(exec_plan, inputs)` runs it
        again without planning (timing loops, repeated queries).

        A plan whose group table or expanding-join output outgrows its
        static capacity raises the run's overflow flag; it is read once per
        run and the plan is rebuilt with 4x the capacities. After
        `max_retries` runs that overflowed this raises: a clipped batch
        would be a wrong answer."""
        opts = self.options
        for attempt in range(max_retries):
            exec_plan = self.physical_plan(plan, opts)
            inputs = self.bind_inputs([leaf.input_id
                                       for leaf in exec_plan.leaves()])
            out, overflow = run_plan(exec_plan, inputs)
            if overflow is None or not bool(overflow):
                return exec_plan, inputs, out
            self.warnings.append(
                f"output overflowed capacity on attempt {attempt + 1} "
                f"(max_group_table {opts.max_group_table}, join_out_factor "
                f"{opts.join_out_factor})")
            opts = dataclasses.replace(
                opts, max_group_table=opts.max_group_table * 4,
                join_out_factor=opts.join_out_factor * 4)
        raise RuntimeError(
            f"join/group output overflowed capacity after {max_retries} "
            f"runs (last max_group_table {opts.max_group_table // 4}, "
            f"join_out_factor {opts.join_out_factor / 4}); raise "
            "max_retries, PhysicalOptions.max_group_table or "
            "PhysicalOptions.join_out_factor")
