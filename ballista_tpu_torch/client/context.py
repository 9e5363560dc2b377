"""SessionContext — the user entry point (port of
ballista_tpu/client/context.py).

One device. Tables are registered from numpy arrays (`register_numpy`,
which needs no pyarrow), from Avro files (`register_avro`, no pyarrow
either), from arrow tables, pandas frames, csv, parquet and json files
(converted onto it), or from ready `HostColumn`s (`register_host`, e.g.
from `datagen` or `datagen.tbl.read_tbl`). Each column is ingested on the
host when a query first needs it (`TableProvider`: per-column lazy ingest,
a `LazyColumn` holds its source until then) and uploaded to the context's
device on first use. A directory of parquet part files registers as a
dataset that is read range by range (`register_parquet_dataset`).

With `distributed=True` every query goes to the standalone cluster
(`cluster()`: the scheduler's control plane and the partitioned runtime
over the partitions of `mesh`). Otherwise a query runs in-core (the whole
plan at once over whole columns) unless the session asks for the serial
runtime (`serial_partitions=N`: one stage
x partition at a time, the shuffle on the host), or `collect` routes it
there: a plan whose estimated peak outgrows the device's budget
(`exec/memory.py`; BALLISTA_HBM_BYTES, BALLISTA_ROUTE_FACTOR), a plan the
out-of-memory memo names, and a plan whose in-core run raised
torch.cuda.OutOfMemoryError.
"""

from __future__ import annotations

import dataclasses
import gc
import glob
import logging
import os
import re
import threading
from collections.abc import Mapping
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import batch as B
from ..exec import memory
from ..exec.plan import Run, eval_plan
from ..exprs import drop_device_luts
from ..planner import logical as L
from ..planner.physical import PhysicalOptions, create_physical_plan
from ..scheduler.runtime import grow_capacities
from ..schema import STRING, Field, Schema, TypeKind
from ..tracing import span
from .dataframe import DataFrame


# tables of at most this many rows have every column's uniqueness inferred
# on the host (`SessionContext.unique_keys`); a larger one only its join
# columns', on the device (`SessionContext.join_unique_keys`)
INFER_UNIQUE_ROWS = 1_000_000


class LazyColumn(NamedTuple):
    """A registered column not ingested yet: its row count, and `make()`,
    which ingests it from its source (a numpy array, an arrow column, a
    `.tbl` column's field spans) into a `HostColumn`."""
    n: int
    make: Callable[[], B.HostColumn]


class HostColumns(Mapping):
    """A table's host columns by name: each ingested from its
    `LazyColumn` at first access, once, and kept. A ready `HostColumn` is
    taken as it is. `in` and iteration ingest nothing."""

    def __init__(self, columns: Dict[str, object]):
        self._sources = dict(columns)
        self._done: Dict[str, B.HostColumn] = {
            k: v for k, v in columns.items() if isinstance(v, B.HostColumn)}
        self._locks = {k: threading.Lock() for k in columns}

    def __getitem__(self, name: str) -> B.HostColumn:
        h = self._done.get(name)
        if h is None:
            src = self._sources[name]
            with self._locks[name]:
                h = self._done.get(name)
                if h is None:
                    h = self._done[name] = src.make()
                    # the source's buffers may go
                    self._sources[name] = h
        return h

    def __contains__(self, name) -> bool:
        return name in self._sources

    def __iter__(self):
        return iter(self._sources)

    def __len__(self) -> int:
        return len(self._sources)

    def length(self, name: str) -> int:
        src = self._sources[name]
        return src.n if isinstance(src, LazyColumn) else len(src.values)

    @property
    def ingested(self) -> set:
        """The names of the columns ingested so far."""
        return set(self._done)


def eager_meta_rows() -> int:
    """Tables of at most this many rows ingest every string column when
    their schema is first read (BALLISTA_EAGER_META_ROWS, default 5M)."""
    return int(os.environ.get("BALLISTA_EAGER_META_ROWS", "5000000"))


class TableProvider:
    """A registered table: host columns, each ingested on first use
    (`HostColumns`), plus the device columns uploaded so far. A pruned
    scan ingests and uploads only the columns it reads.

    Ingest is per column, as the reference's (`ensure_meta` /
    `ensure_columns`): eagerly encoding every string column cost the
    reference ~80 s of every SF10 query (lineitem's unread l_comment et
    al). A table of at most `eager_meta_rows()` rows ingests its string
    columns when its schema is first read, since expression binding at
    logical planning may need any dictionary; a bigger one ingests the
    columns that `SessionContext.sql`'s lexical pre-pass and
    `rebind_scans` name."""

    def __init__(self, name: str, fields: Sequence[Field],
                 columns: Dict[str, object], device: torch.device,
                 primary_key=None):
        missing = [f.name for f in fields if f.name not in columns]
        if missing:
            raise ValueError(f"table {name!r}: no host data for {missing}")
        self.host = HostColumns({f.name: columns[f.name] for f in fields})
        lengths = {self.host.length(f.name) for f in fields}
        if len(lengths) > 1:
            raise ValueError(f"table {name!r}: columns differ in length "
                             f"{sorted(lengths)}")
        self.name = name
        self.fields = tuple(fields)
        self.device = device
        self.primary_key = tuple(primary_key) if primary_key else None
        self.num_rows = lengths.pop() if lengths else 0
        self._cols: Dict[str, B.Column] = {}
        self._inferred_unique = None
        # column -> whether its live values are distinct (`SessionContext.
        # join_unique_keys`, tables above INFER_UNIQUE_ROWS)
        self._distinct: Dict[str, bool] = {}

    @property
    def capacity(self) -> int:
        return B.round_capacity(self.num_rows)

    @property
    def eager_meta(self) -> bool:
        """Whether reading the schema ingests every string column (a
        table of at most `eager_meta_rows()` rows); otherwise the lexical
        pre-pass and `rebind_scans` name what is ingested."""
        return self.num_rows <= eager_meta_rows()

    @property
    def schema(self) -> Schema:
        """The fields, with the dictionaries, bounds and RAW flags of the
        columns ingested so far (every string column's, for a table of at
        most `eager_meta_rows()` rows)."""
        if self.eager_meta:
            self.ensure_meta([f.name for f in self.fields
                              if f.dtype.kind is TypeKind.STRING])
        done = self.host.ingested
        cols = {f.name: self.host[f.name] for f in self.fields
                if f.name in done}
        return Schema(self.fields,
                      {n: h.dictionary for n, h in cols.items()
                       if h.dictionary is not None},
                      {n: h.bounds for n, h in cols.items()
                       if h.bounds is not None},
                      {n for n, h in cols.items() if h.raw}, self.num_rows,
                      {f.name for f in self.fields} - done)

    def ensure_meta(self, names) -> None:
        """Ingest the host half of the columns in `names` that are not
        yet ingested (dictionaries, bounds, RAW flags: what binding
        needs), in a pool of BALLISTA_INGEST_WORKERS threads (default 4;
        numpy and the native encoder let go of the GIL)."""
        done = self.host.ingested
        todo = [n for n in dict.fromkeys(names) if n not in done]
        workers = min(int(os.environ.get("BALLISTA_INGEST_WORKERS", "4")),
                      len(todo))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(self.host.__getitem__, todo))
        else:
            for n in todo:
                self.host[n]

    def ensure_columns(self, names) -> None:
        """Ingest and upload the columns in `names`."""
        self.ensure_meta(names)
        self.column_batch(names)

    def evict_device(self) -> None:
        """Drop the device columns; the host columns stay, and a column
        is uploaded again when a query next reads it."""
        self._cols.clear()

    def column_batch(self, names) -> B.Batch:
        """Device batch of exactly `names`, in order, kept on the device
        for later queries."""
        dtypes = {f.name: f.dtype for f in self.fields}
        for name in names:
            if name not in self._cols:
                h = self._host_column(name)
                self._cols[name] = B.make_column(h.values, h.validity,
                                                 dtypes[name], self.capacity,
                                                 self.device)
        return B.Batch(tuple(self._cols[c] for c in names),
                       torch.tensor(self.num_rows, dtype=torch.int32,
                                    device=self.device))

    def _host_column(self, name: str) -> B.HostColumn:
        return self.host[name]

    def range_batch(self, names, lo: int, hi: int, capacity: int,
                    device) -> B.Batch:
        """Rows [lo, hi) of `names` as a batch of `capacity` rows on
        `device`, uploaded from the host columns and kept nowhere (the
        serial runtime's table shard)."""
        dtypes = {f.name: f.dtype for f in self.fields}
        return B.host_range_batch([self.host[n] for n in names],
                                  [dtypes[n] for n in names], lo, hi,
                                  capacity, device)


class ParquetDatasetProvider(TableProvider):
    """A directory of parquet part files that is never read whole (the
    reference's out-of-core scan plane, `datagen --chunks` layout).

    Row counts and types come from parquet metadata. A column's
    dictionary and bounds (what binding needs) are read on first use
    (`ensure_meta`): bounds from the part files' column statistics where
    every row group has them, else one part file at a time; a string
    column's dictionary one part file at a time. A query that runs in-core
    reads each column it needs across the part files, one column at a
    time (`_host_column`: a single column fits host memory at scales where
    the whole table does not); the serial runtime reads one row range at a
    time (`range_table`). Strings are encoded against the table-wide
    dictionaries. `read_bytes` counts the decoded bytes read so far.
    `arrow_table` materializes the whole table: an escape hatch that no
    query path takes. pyarrow is imported where it is used."""

    def __init__(self, name: str, directory: str, device: torch.device,
                 primary_key=None):
        import pyarrow.parquet as pq
        files = sorted(glob.glob(os.path.join(directory, "*.parquet")))
        if not files:
            raise FileNotFoundError(f"no parquet part files in {directory}")
        super().__init__(name, (), {}, device, primary_key)
        self.files = files
        self._file_rows = [pq.ParquetFile(f).metadata.num_rows for f in files]
        self._arrow_schema = pq.ParquetFile(files[0]).schema_arrow
        self.fields = B.schema_from_arrow(self._arrow_schema).fields
        self.num_rows = sum(self._file_rows)
        # column -> (table-wide dictionary or None, bounds or None)
        self._meta: Dict[str, tuple] = {}
        self._materialized = None
        self.read_bytes = 0
        # column -> seconds its metadata took to read (`ensure_meta`;
        # columns read together share their call's seconds)
        self.meta_seconds: Dict[str, float] = {}
        self._lock = threading.Lock()

    # reading the schema reads nothing, whatever the row count
    eager_meta = False

    @property
    def schema(self) -> Schema:
        """The fields, with the dictionaries and bounds read so far."""
        dicts = {n: d for n, (d, _) in self._meta.items() if d is not None}
        bounds = {n: b for n, (_, b) in self._meta.items() if b is not None}
        return Schema(self.fields, dicts, bounds, rows=self.num_rows,
                      pending={f.name for f in self.fields} - set(self._meta))

    def _read(self, path: str, columns):
        """One part file's `columns` as an arrow table, counted; string
        columns as dictionary arrays (what the writer stored), so that no
        value is decoded per row."""
        import pyarrow.parquet as pq
        strings = {f.name for f in self.fields
                   if f.dtype.kind is TypeKind.STRING}
        t = pq.read_table(path, columns=list(columns),
                          read_dictionary=[c for c in columns
                                           if c in strings])
        with self._lock:
            self.read_bytes += t.nbytes
        return t

    def _per_file(self, fn, files=None):
        """fn(file index) for every part file (or the indices `files`), in
        a pool of BALLISTA_INGEST_WORKERS threads (default: one per core;
        parquet decoding lets go of the GIL); the results in order."""
        files = range(len(self.files)) if files is None else list(files)
        workers = min(int(os.environ.get("BALLISTA_INGEST_WORKERS",
                                         os.cpu_count() or 1)), len(files))
        if workers <= 1:
            return [fn(i) for i in files]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(fn, files))

    def _stat_bounds(self, name: str, dtype):
        """(min, max) of a numeric column from the part files' column
        statistics, in the engine's representation; None unless every
        row group of every file has them."""
        import pyarrow.parquet as pq
        lo = hi = None
        idx = self._arrow_schema.get_field_index(name)
        for f in self.files:
            md = pq.ParquetFile(f).metadata
            for g in range(md.num_row_groups):
                col = md.row_group(g).column(idx)
                st = col.statistics
                all_null = (st is not None and st.has_null_count
                            and st.null_count == col.num_values)
                if col.num_values == 0 or all_null:
                    continue
                if st is None or not st.has_min_max:
                    return None
                a, b = (_stat_value(v, dtype) for v in (st.min, st.max))
                if a is None or b is None:
                    return None
                lo = a if lo is None else min(lo, a)
                hi = b if hi is None else max(hi, b)
        return None if lo is None else (lo, hi)

    def ensure_meta(self, names) -> None:
        """Read the dictionary and bounds of each column in `names` that
        has none yet. A string column's dictionary is the sorted union of
        the part files' distinct values, whatever their count: the dataset
        is never read whole, so it has no RAW columns (a RAW code is a row
        index into the whole column). Nothing of a file is kept past it."""
        import time
        dtypes = {f.name: f.dtype for f in self.fields}
        todo = [n for n in dict.fromkeys(names) if n not in self._meta]
        for n in [n for n in todo if dtypes[n].kind in B._BOUNDED]:
            t0 = time.perf_counter()
            bounds = self._stat_bounds(n, dtypes[n])
            if bounds is not None:
                self._meta[n] = (None, bounds)
                self.meta_seconds[n] = time.perf_counter() - t0
        todo = [n for n in todo if n not in self._meta]
        if not todo:
            return
        t0 = time.perf_counter()

        def one(i):
            t = self._read(self.files[i], todo)
            return {n: (_distinct_strings(t.column(n))
                        if dtypes[n].kind is TypeKind.STRING
                        else B.ingest_arrow_column(t.column(n),
                                                   dtypes[n]).bounds)
                    for n in todo}
        parts = self._per_file(one)
        for n in todo:
            dictionary, bounds = None, None
            if dtypes[n].kind is TypeKind.STRING:
                dictionary = np.unique(np.concatenate(
                    [np.zeros(0, dtype=str)] + [p[n] for p in parts])
                ).astype(object)
            else:
                spans = [p[n] for p in parts if p[n] is not None]
                if spans:
                    bounds = (min(b[0] for b in spans),
                              max(b[1] for b in spans))
            self._meta[n] = (dictionary, bounds)
            self.meta_seconds[n] = time.perf_counter() - t0

    def dataset_dictionaries(self, columns=None) -> dict:
        """The table-wide sorted dictionary of each string column in
        `columns` (all, when None), read part file by part file."""
        names = [f.name for f in self.fields
                 if f.dtype.kind is TypeKind.STRING
                 and (columns is None or f.name in columns)]
        self.ensure_meta(names)
        return {n: self._meta[n][0] for n in names}

    def range_table(self, lo: int, hi: int, columns=None):
        """Global row range [lo, hi) as an arrow table, reading only the
        part files that overlap it."""
        import pyarrow as pa
        names = list(columns) if columns else self._arrow_schema.names
        starts = np.concatenate([[0], np.cumsum(self._file_rows)])
        overlap = [i for i in range(len(self.files))
                   if starts[i + 1] > lo and starts[i] < hi]

        def one(i):
            return self._read(self.files[i], names).slice(
                max(lo - starts[i], 0),
                min(hi, starts[i + 1]) - max(lo, starts[i]))
        pieces = self._per_file(one, overlap)
        if not pieces:
            sch = self._arrow_schema if columns is None else pa.schema(
                [self._arrow_schema.field(c) for c in columns])
            return sch.empty_table()
        return pa.concat_tables(pieces)

    @property
    def arrow_table(self):
        """The whole table, read once: an escape hatch for a caller that
        wants it; no query path reads it (in-core queries read column by
        column, the serial runtime range by range)."""
        if self._materialized is None:
            import pyarrow as pa
            import pyarrow.parquet as pq
            logging.getLogger("ballista_tpu_torch.context").warning(
                "materializing the parquet dataset %s (%d rows)", self.name,
                self.num_rows)
            self._materialized = pa.concat_tables(
                pq.read_table(f) for f in self.files)
        return self._materialized

    def _encode(self, table, name: str) -> B.HostColumn:
        """Column `name` of `table` encoded against the table-wide
        dictionary: a dictionary array through its dictionary (one lookup
        per distinct value), any other column through ingest."""
        import pyarrow as pa
        dtypes = {f.name: f.dtype for f in self.fields}
        self.ensure_meta([name])
        col = table.column(name)
        dictionary = self._meta[name][0]
        if not pa.types.is_dictionary(col.type):
            return B.ingest_arrow_column(col, dtypes[name],
                                         dictionary=dictionary)
        from ..exprs import dict_str
        table_wide = dict_str(dictionary)
        codes, valid = [], []
        for chunk in col.chunks:
            local = np.asarray(chunk.dictionary.to_pylist(), dtype=object)
            lut = np.searchsorted(table_wide, local.astype(str)).astype(
                np.int32) if len(local) else np.zeros(1, dtype=np.int32)
            idx = np.asarray(chunk.indices.fill_null(0))
            codes.append(lut[idx])
            valid.append(np.asarray(chunk.is_valid()) if chunk.null_count
                         else np.ones(len(chunk), dtype=bool))
        validity = (np.concatenate(valid) if valid
                    else np.zeros(0, dtype=bool))
        values = (np.concatenate(codes) if codes
                  else np.zeros(0, dtype=np.int32))
        return B.HostColumn(np.where(validity, values, 0).astype(np.int32),
                            validity, dictionary, None)

    def _host_column(self, name: str) -> B.HostColumn:
        """Column `name` across the part files, each file read and encoded
        alone into its rows of one preallocated array: the host holds the
        column once, plus a pool's worth of part files."""
        from ..exprs import dict_str
        dtype = {f.name: f.dtype for f in self.fields}[name]
        self.ensure_meta([name])
        dictionary, bounds = self._meta[name]
        if dictionary is not None:
            dict_str(dictionary)    # made once, before the pool uses it
        values = np.empty(self.num_rows, dtype=dtype.np_dtype)
        validity = np.empty(self.num_rows, dtype=bool)
        starts = np.concatenate([[0], np.cumsum(self._file_rows)])

        def one(i):
            h = self._encode(self._read(self.files[i], [name]), name)
            values[starts[i]:starts[i + 1]] = h.values
            validity[starts[i]:starts[i + 1]] = h.validity
        self._per_file(one)
        return B.HostColumn(values, validity, dictionary, bounds)

    def range_batch(self, names, lo: int, hi: int, capacity: int,
                    device) -> B.Batch:
        dtypes = {f.name: f.dtype for f in self.fields}
        t = self.range_table(lo, hi, names)
        return B.host_range_batch([self._encode(t, n) for n in names],
                                  [dtypes[n] for n in names], 0, hi - lo,
                                  capacity, device)


def _distinct_strings(col) -> np.ndarray:
    """The distinct non-NULL values of an arrow string column (dictionary
    chunks: the values their indices use) as a numpy str array."""
    import pyarrow as pa
    import pyarrow.compute as pc
    parts = []
    for chunk in col.chunks:
        if pa.types.is_dictionary(chunk.type):
            chunk = chunk.dictionary.take(pc.unique(pc.drop_null(
                chunk.indices)))
        parts.append(np.asarray(pc.unique(pc.drop_null(chunk)),
                                dtype=object).astype(str))
    return (np.unique(np.concatenate(parts)) if parts
            else np.zeros(0, dtype=str))


def _stat_value(v, dtype):
    """A parquet statistics value in the engine's representation (scaled
    integer for a decimal, days for a date), or None where its type is not
    the one expected."""
    import datetime
    import decimal as pydecimal
    if dtype.kind is TypeKind.DECIMAL:
        if isinstance(v, pydecimal.Decimal):
            return int(v.scaleb(dtype.scale))
        return None
    if dtype.kind is TypeKind.DATE32:
        if isinstance(v, datetime.date):
            return (v - datetime.date(1970, 1, 1)).days
        return None
    return int(v) if isinstance(v, (int, np.integer)) else None


def _is_masked_pair(value) -> bool:
    """A `(values, validity)` column of `register_numpy`: a 2-tuple whose
    second half is a bool array or list as long as the first. Any other
    tuple is a column's values, as a list would be."""
    if not (isinstance(value, tuple) and len(value) == 2
            and isinstance(value[1], (np.ndarray, list))):
        return False
    mask = np.asarray(value[1])
    return (mask.dtype == np.bool_ and mask.ndim == 1
            and np.ndim(value[0]) == 1 and len(value[0]) == len(mask))


class SessionContext:
    """One device, chosen explicitly. The default is "cuda", and that
    raises when no CUDA device is present: the port never carries on on
    the CPU unasked (the CPU tests pass device="cpu").

    Local mode by default; `distributed=True` routes every collect through
    the standalone cluster over `mesh` (`parallel.mesh.make_mesh`), by
    default one partition per visible device of the context's type (every
    CUDA device; the one CPU). A mesh whose devices are of another type
    than `device` raises."""

    def __init__(self, device="cuda",
                 options: Optional[PhysicalOptions] = None,
                 serial_partitions: Optional[int] = None,
                 distributed: bool = False, mesh=None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SessionContext(device='cuda'): CUDA is not "
                               "available; pass device='cpu' to run on the CPU")
        if mesh is not None:
            other = {torch.device(d).type for d in mesh} - {self.device.type}
            if other:
                raise ValueError(f"SessionContext(device={device!r}): mesh "
                                 f"devices of type {sorted(other)}")
        self.options = options or PhysicalOptions()
        # distributed mode: the standalone cluster (scheduler control
        # plane + partitioned runtime), made on first use by cluster()
        self.distributed = distributed
        self.mesh = mesh
        self._cluster = None
        # out-of-core: every query runs stage by stage, partition by
        # partition, on this context's device (scheduler/serial.py)
        self.serial_partitions = serial_partitions
        # the StageMetrics of the last serial run, by stage id
        self.serial_metrics: list = []
        self.tables: Dict[str, TableProvider] = {}
        # CREATE VIEW: name -> (SelectStmt, column aliases), expanded by
        # the SQL planner wherever the name is scanned
        self.views: Dict[str, tuple] = {}
        # planning warnings accumulated per session (WarningCollector,
        # core/src/warning_collector.rs)
        self.warnings: list = []
        self.config = None  # optional BallistaConfig (set_config)

    def set_config(self, config) -> None:
        """Keep a BallistaConfig on this session and load the UDF plugins
        of its plugin directory. (The reference also takes its capacity
        mode from it; the port has none: a table's capacity is its
        lane-rounded row count.)"""
        from ..config import BALLISTA_PLUGIN_DIR
        self.config = config
        plugin_dir = config.get(BALLISTA_PLUGIN_DIR)
        if plugin_dir:
            self.load_plugins(plugin_dir)

    def evict_device(self) -> None:
        """Free device memory: drop every table's device columns (the
        host columns stay; a column is uploaded again on next use)."""
        for tp in self.tables.values():
            tp.evict_device()
        if self._cluster is not None:
            self._cluster.runtime.drop_tables()
        B.drop_row_indices()
        drop_device_luts()

    def cluster(self):
        """The standalone cluster of distributed mode (made on first use)."""
        if self._cluster is None:
            from ..scheduler.standalone import StandaloneCluster
            self._cluster = StandaloneCluster(self, self.mesh)
        return self._cluster

    # -- registration (BallistaContext::register_* parity) --
    def register_host(self, name: str, fields: Sequence[Field],
                      columns: Dict[str, object],
                      primary_key=None) -> None:
        """Register `HostColumn`s, or `LazyColumn`s ingested on first
        use."""
        self.tables[name] = TableProvider(name, fields, columns, self.device,
                                          primary_key)

    def register_numpy(self, name: str, columns: dict, fields=None,
                       primary_key=None) -> None:
        """Register a table from host arrays: `columns` maps each column
        name to a numpy array or Python list (None = NULL), or to a
        `(values, validity)` pair whose second half is a bool array or
        list of the same length. `fields` (a sequence of `Field`)
        declares the types where they cannot be read off the arrays
        (decimals: `decimal(p, s)` over scaled integers) and the column
        order; without it every column has the type `batch.column_dtype`
        infers. Each column is ingested on the host
        (`batch.ingest_column`, with the RAW threshold in force now) when
        a query first needs it, and reaches the context's device on first
        use. Ready `HostColumn`s go to `register_host`."""
        declared = {f.name: f for f in fields or ()}
        order = [f.name for f in fields] if fields else list(columns)
        out_fields, host = [], {}
        raw_max = B.raw_dict_max()
        for cname in order:
            value, validity = columns[cname], None
            if _is_masked_pair(value):
                value, validity = value
            value = B.as_array(value)
            f = declared.get(cname) or Field(cname, B.column_dtype(value))
            out_fields.append(f)
            host[cname] = LazyColumn(len(value), partial(
                B.ingest_column, value, f.dtype, validity, raw_max=raw_max))
        self.register_host(name, out_fields, host, primary_key)

    def register_arrow(self, name: str, table, primary_key=None) -> None:
        """An arrow table, each column ingested on first use
        (`batch.ingest_arrow_column`; strings through the native
        encoder)."""
        fields = B.schema_from_arrow(table.schema).fields
        raw_max = B.raw_dict_max()
        self.register_host(
            name, fields,
            {f.name: LazyColumn(table.num_rows, partial(
                B.ingest_arrow_column, table.column(i), f.dtype,
                raw_max=raw_max))
             for i, f in enumerate(fields)}, primary_key)

    def register_pandas(self, name: str, df, primary_key=None) -> None:
        import pyarrow as pa
        self.register_arrow(name, pa.Table.from_pandas(df, preserve_index=False),
                            primary_key)

    def register_csv(self, name: str, path: str, schema=None,
                     primary_key=None, **kwargs) -> None:
        import pyarrow.csv as pacsv
        opts = {}
        if schema is not None:
            opts["convert_options"] = pacsv.ConvertOptions(column_types=schema)
        self.register_arrow(name, pacsv.read_csv(path, **opts), primary_key)

    def register_parquet(self, name: str, path: str, primary_key=None) -> None:
        import pyarrow.parquet as pq
        self.register_arrow(name, pq.read_table(path), primary_key)

    def register_parquet_dataset(self, name: str, directory: str,
                                 primary_key=None) -> None:
        """A directory of parquet part files, read range by range and
        never whole by the serial runtime (`ParquetDatasetProvider`)."""
        self.tables[name] = ParquetDatasetProvider(name, directory,
                                                   self.device, primary_key)

    def register_json(self, name: str, path: str, primary_key=None) -> None:
        """Newline-delimited JSON (BallistaContext::read_json parity)."""
        import pyarrow.json as pajson
        self.register_arrow(name, pajson.read_json(path), primary_key)

    def register_avro(self, name: str, path: str, primary_key=None) -> None:
        """An Avro container file (BallistaContext::read_avro parity), read
        by `avro.read_avro` with no pyarrow."""
        from ..avro import read_avro
        fields, cols = read_avro(path)
        self.register_host(name, fields, cols, primary_key)

    # read_* variants return a DataFrame over an anonymous registration
    # (BallistaContext::read_csv/parquet/json, context.rs:143+)
    def read_csv(self, path: str, schema=None, **kwargs) -> DataFrame:
        name = f"__read_{len(self.tables)}"
        self.register_csv(name, path, schema=schema, **kwargs)
        return self.table(name)

    def read_parquet(self, path: str) -> DataFrame:
        name = f"__read_{len(self.tables)}"
        self.register_parquet(name, path)
        return self.table(name)

    def read_json(self, path: str) -> DataFrame:
        name = f"__read_{len(self.tables)}"
        self.register_json(name, path)
        return self.table(name)

    def read_avro(self, path: str) -> DataFrame:
        name = f"__read_{len(self.tables)}"
        self.register_avro(name, path)
        return self.table(name)

    def register_udf(self, name: str, fn, out_dtype,
                     propagate_nulls: bool = True) -> None:
        """Register a scalar UDF for SQL and expressions: fn(*data
        tensors) -> data tensor (`exprs.register_udf`)."""
        from ..exprs import register_udf
        register_udf(name, fn, out_dtype, propagate_nulls)

    def load_plugins(self, plugin_dir: str):
        """Load UDF plugin modules from a directory (the dlopen plugin
        system, core/src/plugin; plugin.py for the module contract)."""
        from ..plugin import load_plugins
        return load_plugins(plugin_dir, self)

    def list_functions(self, kind=None):
        """All SQL functions, built-ins + registered UDFs
        (ballista-cli ListFunctions, command.rs:36)."""
        from ..functions import list_functions
        return list_functions(kind)

    def warn(self, message: str) -> None:
        self.warnings.append(message)

    def take_warnings(self):
        out, self.warnings = self.warnings, []
        return out

    def unique_keys(self, name: str):
        """Unique column sets for join build-side selection and
        functional-dependency reasoning: the declared primary key alone,
        else the single columns whose values are all distinct (tables of
        up to INFER_UNIQUE_ROWS rows, every column checked on the host
        when first asked; a NULL counts as one value). A larger table's
        join columns are checked by `join_unique_keys`."""
        tp = self.tables[name]
        if tp.primary_key:
            return [tp.primary_key]
        if tp._inferred_unique is None:
            tp._inferred_unique = []
            if tp.num_rows <= INFER_UNIQUE_ROWS:
                # a parquet dataset has no host columns to infer from
                for f in (f for f in tp.fields if f.name in tp.host):
                    h = tp.host[f.name]
                    # a RAW column's codes are row indices: count values
                    values = (h.dictionary[h.validity].astype(str) if h.raw
                              else h.values[h.validity])
                    n_distinct = (len(np.unique(values))
                                  + int(not h.validity.all()))
                    if n_distinct == tp.num_rows:
                        tp._inferred_unique.append((f.name,))
        return tp._inferred_unique

    def join_unique_keys(self, name: str, columns: Sequence[str]):
        """`unique_keys`, and for a table of more than INFER_UNIQUE_ROWS
        rows with no primary key, those of `columns` (the columns an
        equi-join compares) that hold each live value once and at most one
        NULL: each checked once on the device (`_distinct_on_device`) and
        the verdict kept for the table's registration. An integer, date,
        decimal or sorted-dictionary column is checked; a float or bool
        column, a RAW string column (its codes are row indices) and a
        column of a parquet dataset are not, and count as not unique."""
        tp = self.tables[name]
        keys = self.unique_keys(name)
        if tp.primary_key or tp.num_rows <= INFER_UNIQUE_ROWS:
            return keys
        with span("ballista.join.unique_keys"):
            found = [(c,) for c in dict.fromkeys(columns)
                     if self._distinct_on_device(tp, c)]
        return keys + found

    def _distinct_on_device(self, tp: "TableProvider", name: str) -> bool:
        """Whether column `name` of `tp` holds each live value once and at
        most one NULL: its valid values uploaded from the host (and not
        kept), sorted on the device and neighbours compared, with one host
        read. Cached per column."""
        if name in tp._distinct:
            return tp._distinct[name]
        kind = next(f.dtype.kind for f in tp.fields if f.name == name)
        verdict = False
        if name in tp.host and kind not in (TypeKind.FLOAT32,
                                            TypeKind.FLOAT64, TypeKind.BOOL):
            h = tp.host[name]
            nulls = tp.num_rows - int(h.validity.sum())
            if not h.raw and nulls <= 1:
                live = h.values if not nulls else h.values[h.validity]
                s = torch.sort(torch.from_numpy(np.ascontiguousarray(
                    live)).to(self.device)).values
                verdict = not bool((s[1:] == s[:-1]).any())
        tp._distinct[name] = verdict
        return verdict

    def table(self, name: str) -> DataFrame:
        tp = self.tables[name]
        return DataFrame(self, L.TableScan(
            name, tp.schema,
            unique_cols=tuple(tuple(k) for k in self.unique_keys(name))))

    def _ensure_referenced_meta(self, query: str) -> None:
        """The lexical pre-pass for tables whose schema ingests nothing
        (above `eager_meta_rows()`, and parquet datasets): a column whose
        name is a word of the query is ingested before planning, so that
        binding at logical planning finds its dictionary; unreferenced
        columns stay as they are."""
        words = set(re.findall(r"[a-zA-Z_][a-zA-Z0-9_]*", query.lower()))
        for name, tp in self.tables.items():
            if tp.eager_meta or name.lower() not in words:
                continue
            cols = [f.name for f in tp.fields if f.name.lower() in words]
            if cols:
                tp.ensure_meta(cols)

    def sql(self, query: str) -> DataFrame:
        """Run a SQL script: SELECTs, CREATE / DROP VIEW (the TPC-H Q15
        shape), CREATE TABLE AS, CREATE EXTERNAL TABLE, EXPLAIN, SHOW
        TABLES and SHOW COLUMNS (BallistaContext::sql intercepts DDL the
        same way, context.rs:362). Returns the last statement that yields
        rows as a DataFrame. Each SELECT is planned when it is read, so a
        view dropped after it has already been expanded into its plan."""
        from ..sql.parser import (CreateExternalTable, CreateTableAs,
                                  CreateView, DropView, ExplainStmt,
                                  ShowColumns, ShowTables, parse_statements)
        from ..sql.planner import SqlPlanner

        with span("ballista.sql"):
            self._ensure_referenced_meta(query)
            last = None
            with span("ballista.sql.parse"):
                stmts = parse_statements(query)
            for stmt in stmts:
                if isinstance(stmt, CreateView):
                    self.views[stmt.name] = (stmt.query, stmt.columns)
                elif isinstance(stmt, DropView):
                    self.views.pop(stmt.name, None)
                elif isinstance(stmt, CreateExternalTable):
                    self._create_external_table(stmt)
                elif isinstance(stmt, CreateTableAs):
                    with span("ballista.sql.plan"):
                        plan = SqlPlanner(self).plan_select(stmt.query)
                    self._create_table_as(stmt.name, DataFrame(self, plan))
                elif isinstance(stmt, ExplainStmt):
                    last = self._explain(stmt.query)
                elif isinstance(stmt, ShowTables):
                    last = self._show_tables()
                elif isinstance(stmt, ShowColumns):
                    last = self._show_columns(stmt.name)
                else:
                    with span("ballista.sql.plan"):
                        plan = SqlPlanner(self).plan_select(stmt)
                    last = DataFrame(self, plan)
            if last is None:
                raise ValueError("no SELECT statement in script")
            return last

    # -- DDL / catalog statements intercepted like BallistaContext::sql --
    def _create_external_table(self, stmt):
        if stmt.fmt == "csv":
            import pyarrow.csv as pacsv

            from ..schema import to_arrow_type
            kwargs = {}
            if stmt.columns:
                kwargs["convert_options"] = pacsv.ConvertOptions(
                    column_types={n: to_arrow_type(t)
                                  for n, t in stmt.columns})
                if not stmt.header:
                    kwargs["read_options"] = pacsv.ReadOptions(
                        column_names=[n for n, _ in stmt.columns])
            self.register_arrow(stmt.name,
                                pacsv.read_csv(stmt.location, **kwargs))
        elif stmt.fmt == "parquet":
            self.register_parquet(stmt.name, stmt.location)
        elif stmt.fmt in ("json", "ndjson"):
            self.register_json(stmt.name, stmt.location)
        else:
            raise NotImplementedError(f"STORED AS {stmt.fmt}")

    def _create_table_as(self, name: str, df: DataFrame) -> None:
        """Run the SELECT, bring its rows to the host and register them
        (ingested anew: fresh dictionaries and bounds)."""
        batch, schema = df.collect()
        self.register_numpy(name, B.to_numpy(batch, schema),
                            fields=schema.fields)

    def _catalog_df(self, name: str, columns: dict) -> DataFrame:
        """A catalog result (lists of str per column) as a table."""
        self.register_numpy(name, columns,
                            fields=[Field(c, STRING) for c in columns])
        return self.table(name)

    def _explain(self, query_stmt) -> DataFrame:
        """EXPLAIN <select>: one row per plan tier (DataFusion's
        (plan_type, plan) shape the reference inherits)."""
        from ..sql.planner import SqlPlanner
        plan = SqlPlanner(self).plan_select(query_stmt)
        rows = [("logical_plan", plan.display())]
        try:
            rows.append(("physical_plan", self.physical_plan(plan).display()))
        except Exception as e:  # noqa: BLE001 - logical tier still useful
            rows.append(("physical_plan", f"<not available: {e}>"))
        return self._catalog_df("__explain__", {
            "plan_type": [r[0] for r in rows], "plan": [r[1] for r in rows]})

    def _show_tables(self) -> DataFrame:
        """SHOW TABLES (information_schema.tables shape, config.rs
        with_information_schema parity)."""
        rows = [("ballista", "public", n, "BASE TABLE")
                for n in self.tables if not n.startswith("__")]
        rows += [("ballista", "public", n, "VIEW") for n in self.views]
        cols = [list(c) for c in zip(*rows)] or [[], [], [], []]
        return self._catalog_df("__show_tables__", {
            "table_catalog": cols[0], "table_schema": cols[1],
            "table_name": cols[2], "table_type": cols[3]})

    def _show_columns(self, name: str) -> DataFrame:
        tp = self.tables.get(name)
        if tp is None:
            raise KeyError(f"table {name!r} not found")
        return self._catalog_df("__show_columns__", {
            "table_name": [name] * len(tp.fields),
            "column_name": [f.name for f in tp.fields],
            "data_type": [str(f.dtype) for f in tp.fields],
            "is_nullable": ["YES" if f.nullable else "NO"
                            for f in tp.fields]})

    def _info_columns(self) -> DataFrame:
        """information_schema.columns: one row per column of every table."""
        rows = [("ballista", "public", tn, f.name, str(f.dtype),
                 "YES" if f.nullable else "NO")
                for tn, tp in self.tables.items() if not tn.startswith("__")
                for f in tp.fields]
        cols = [list(c) for c in zip(*rows)] or [[] for _ in range(6)]
        return self._catalog_df("__info_columns__", {
            "table_catalog": cols[0], "table_schema": cols[1],
            "table_name": cols[2], "column_name": cols[3],
            "data_type": cols[4], "is_nullable": cols[5]})

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
        """The physical plan of `plan`, its scans rebound first
        (`rebind_scans`): the columns it reads are ingested, so their
        bounds and dictionaries shape the plan."""
        capacities = {name: tp.capacity for name, tp in self.tables.items()}
        return create_physical_plan(rebind_scans(plan, self), capacities,
                                    options or self.options, self.device)

    def collect(self, plan: L.LogicalPlan, max_retries: int = 5):
        """Execute a logical plan: returns (Batch on the device, Schema).

        With `serial_partitions` set every plan runs on the serial runtime.
        Otherwise a plan goes there when the memory model says it will not
        fit (`serial_route`), and after its in-core run raised
        torch.cuda.OutOfMemoryError (`oom_partitions`). Any other error is
        raised as it is. In distributed mode the plan is a job of the
        standalone cluster (`cluster()`)."""
        from ..scheduler.serial import execute_serial
        with span("ballista.collect"):
            if self.distributed:
                cl = self.cluster()
                return cl.wait(cl.submit_plan(plan))
            if self.serial_partitions:
                return execute_serial(self, plan, self.serial_partitions,
                                      max_retries=max_retries)
            with span("ballista.route"):
                route_n = self.serial_route(plan)
            if route_n:
                return execute_serial(self, plan, route_n,
                                      max_retries=max_retries)
            try:
                exec_plan, _, out = self.converge(plan, max_retries)
                return out, exec_plan.schema
            except torch.cuda.OutOfMemoryError:
                pass
            # out of the except block: the traceback, whose frames hold the
            # failed run's tensors, is gone, so the memory can be given back
            return execute_serial(self, plan, self.oom_partitions(plan),
                                  max_retries=max_retries)

    def serial_route(self, plan: L.LogicalPlan) -> int:
        """The partition count of the serial runtime a plan is routed to
        before it runs, or 0 to run it in-core: routed when the memory
        model says it will not fit the device's budget
        (`exec.memory.route_serial`; a cheap gate first: when even 200
        bytes per registered row fit the budget, no plan is priced) or
        the out-of-memory memo names it. Routing leaves a warning."""
        from ..scheduler.serial import fit_partitions
        budget = memory.hbm_budget_bytes(self.device)
        total_rows = sum(tp.num_rows for tp in self.tables.values())
        if budget is None or total_rows * 200 < budget:
            return 0
        plan = rebind_scans(plan, self)
        exec_plan = self.physical_plan(plan)
        route_n = memory.route_serial(exec_plan, budget)
        if route_n and not memory.oom_memo_lookup(
                memory.plan_fingerprint(exec_plan)):
            # routed by the estimate: enough partitions for the stages
            # (a memo's count was fitted when it was learned)
            route_n = fit_partitions(self, plan, route_n, budget)
        if route_n:
            self.warn(f"plan routed out-of-core (serial@{route_n}): "
                      "predicted working set exceeds device memory")
        return route_n

    def oom_partitions(self, plan: L.LogicalPlan) -> int:
        """After a plan's in-core run ran out of device memory: free the
        device, record the plan in the OOM memo, and return the partition
        count of the serial runtime that answers it instead (twice the
        model's, fitted to the budget), with a warning."""
        from ..scheduler.serial import fit_partitions
        self.evict_device()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        self.warn("in-core execution exhausted device memory; falling back "
                  "to the out-of-core serial runtime")
        plan = rebind_scans(plan, self)
        exec_plan = self.physical_plan(plan)
        est = memory.estimate_plan_hbm(exec_plan)
        # the OOM just proved the estimate low: twice the model's count
        budget = memory.hbm_budget_bytes(self.device) or est
        n_parts = fit_partitions(self, plan, min(
            memory.plan_serial_partitions(est, budget) * 2, 64), budget)
        # later sessions send this plan shape out-of-core at once
        memory.oom_memo_record(memory.plan_fingerprint(exec_plan), n_parts)
        return n_parts

    def converge(self, plan: L.LogicalPlan, max_retries: int = 5):
        """Plan and run until the output fits: returns (exec_plan, inputs,
        out), the first physical plan whose run did not overflow, its bound
        inputs and that run's Batch. `run_plan(exec_plan, inputs)` runs it
        again without planning (timing loops, repeated queries).

        A plan whose group table or expanding-join output outgrows its
        static capacity raises the run's overflow flag; the flags are read
        once per run (`Run.verdict`). A run that overflowed also reads how
        far each kind of capacity fell short (`Run.growth`), and the plan
        is rebuilt with the capacities the serial and standalone runtimes'
        retries take (`grow_capacities`: each kind grown to a power of two
        at or above its need, and by at least 4x). After `max_retries` runs
        that overflowed this raises: a clipped batch would be a wrong
        answer. A run where a wide SUM read above passed int64 raises
        NotImplementedError at once."""
        # the scans' schemas taken anew: a parquet dataset reads its
        # columns' metadata on first use
        plan = rebind_scans(plan, self)
        opts = ran = self.options
        for attempt in range(max_retries):
            with span("ballista.attempt"):
                with span("ballista.plan.physical"):
                    exec_plan = self.physical_plan(plan, opts)
                with span("ballista.plan.bind"):
                    inputs = self.bind_inputs([leaf.input_id
                                               for leaf in exec_plan.leaves()])
                run = Run(inputs)
                out = eval_plan(run, exec_plan)
                verdict, growth = run.verdict(), None
                if verdict is not None:
                    with span("ballista.verdict"):
                        if run.overflowed(_read(verdict)):
                            # a second read, only where the run is dropped
                            growth = _read(run.growth())
                if growth is None:
                    return exec_plan, inputs, out
            # the dropped run's batches are freed before the next run
            del out, run
            ran, opts = opts, grow_capacities(opts, growth)
            self.warnings.append(
                f"output overflowed capacity on attempt {attempt + 1} "
                f"(max_group_table {ran.max_group_table}, join_out_factor "
                f"{ran.join_out_factor}); growth group "
                f"{opts.max_group_table // ran.max_group_table}x "
                f"(need {growth[0]}x), join "
                f"{int(opts.join_out_factor / ran.join_out_factor)}x "
                f"(need {growth[1]}x)")
        raise RuntimeError(
            f"join/group output overflowed capacity after {max_retries} "
            f"runs (last max_group_table {ran.max_group_table}, "
            f"join_out_factor {ran.join_out_factor}); raise "
            "max_retries, PhysicalOptions.max_group_table or "
            "PhysicalOptions.join_out_factor")


def _read(t: torch.Tensor):
    """A device tensor's value on the host (a Python int, or a list of
    them): converge's one way to read a run's flags."""
    return t.tolist()


def file_metadata(path: str) -> dict:
    """Schema and row count of a parquet, csv or json file (GetFileMetadata
    RPC parity, scheduler grpc.rs:293: the reference infers schemas
    server-side for clients). pyarrow is imported here; a parquet file's
    schema and counts come from its footer alone."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".parquet":
        import pyarrow.parquet as pq
        f = pq.ParquetFile(path)
        schema = f.schema_arrow
        meta = {"num_rows": f.metadata.num_rows,
                "num_row_groups": f.metadata.num_row_groups}
    elif ext == ".csv":
        import pyarrow.csv as pacsv
        t = pacsv.read_csv(path)  # no cheap schema-only CSV read in pyarrow
        schema, meta = t.schema, {"num_rows": t.num_rows}
    elif ext in (".json", ".ndjson"):
        import pyarrow.json as pajson
        t = pajson.read_json(path)
        schema, meta = t.schema, {"num_rows": t.num_rows}
    else:
        raise ValueError(f"unsupported file type: {path!r}")
    return {"path": path,
            "fields": [{"name": f.name, "type": str(f.type),
                        "nullable": f.nullable} for f in schema],
            **meta}


def rebind_scans(plan: L.LogicalPlan, ctx: SessionContext) -> L.LogicalPlan:
    """The plan with every scan's table schema taken anew from its table,
    after the table ingested the metadata (dictionaries, bounds) of the
    columns the pruned plan reads from it, and those only: a column no
    query reads is never ingested (a parquet dataset reads its metadata
    on demand the same way)."""
    from ..planner.optimizer import prune_columns
    needed: Dict[str, list] = {}
    _scan_columns(prune_columns(plan), ctx, needed)
    for name, cols in needed.items():
        ctx.tables[name].ensure_meta(cols)
    return _rebind(plan, ctx)


def _scan_columns(plan: L.LogicalPlan, ctx, needed: Dict[str, list]) -> None:
    if isinstance(plan, L.TableScan):
        tp = ctx.tables[plan.table_name]
        needed.setdefault(plan.table_name, []).extend(
            plan.projection or [f.name for f in tp.fields])
        return
    for child in plan.children():
        _scan_columns(child, ctx, needed)


def _rebind(plan: L.LogicalPlan, ctx: SessionContext) -> L.LogicalPlan:
    if isinstance(plan, L.TableScan):
        return dataclasses.replace(
            plan, table_schema=ctx.tables[plan.table_name].schema)
    if not plan.children():
        return plan
    new = {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)}
    for key, val in new.items():
        if isinstance(val, L.LogicalPlan):
            new[key] = _rebind(val, ctx)
        elif isinstance(val, (list, tuple)) and \
                any(isinstance(v, L.LogicalPlan) for v in val):
            # list-valued children (Union.inputs)
            new[key] = type(val)(_rebind(v, ctx)
                                 if isinstance(v, L.LogicalPlan) else v
                                 for v in val)
    return type(plan)(**new)
