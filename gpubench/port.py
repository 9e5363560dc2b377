"""Everything the benchmark takes from the system under test
(`ballista_tpu_torch`): the context, the generated tables as its host
columns, the answer of a query as host arrays, and the wrapper of the
entries that per-layer metrics name (`EntryWrap`). Besides this module only the `register` functions
of `gpubench/data/` import the program; `gpubench/reference/` never
does."""

from __future__ import annotations

import functools
import re
import sys
from typing import Callable, Iterator, List, Optional

import numpy as np

from .tables import Table

# warnings of `SessionContext.collect` that count a whole-plan re-run
# after an overflow (client/context.py converge)
OVERFLOW_WARNING = "output overflowed capacity"


def make_context(device: str):
    from ballista_tpu_torch.client import SessionContext
    return SessionContext(device=device)


def build_kernels(device: str) -> None:
    """Build (or load the built) CUDA kernel before the window: the first
    run in a checkout compiles it into build/kernels/."""
    if device.startswith("cuda"):
        from ballista_tpu_torch.ops import masked_sums
        masked_sums.build()


def _field_type(dtype: str):
    from ballista_tpu_torch import schema as S
    m = re.fullmatch(r"decimal\((\d+),(\d+)\)", dtype)
    if m:
        return S.decimal(int(m.group(1)), int(m.group(2)))
    return {"int32": S.INT32, "int64": S.INT64, "date32": S.DATE32,
            "float64": S.FLOAT64, "string": S.STRING, "text": S.STRING}[dtype]


def host_table(table: Table, raw_max: Optional[int] = None):
    """(fields, {column: HostColumn or LazyColumn}) of a generated table:
    the arrays as they are (no copy), bounds of every numeric column,
    every row valid. A text column is ingested at first use from its
    bytes and spans, as an arrow string column is
    (`batch.ingest_string_buffers`: RAW where its estimated distinct
    count passes `raw_max`, default BALLISTA_RAW_DICT_MAX, else a sorted
    dictionary)."""
    from ballista_tpu_torch.batch import HostColumn, ingest_string_buffers
    from ballista_tpu_torch.client.context import LazyColumn
    from ballista_tpu_torch.schema import Field
    fields, cols = [], {}
    for name, c in table.items():
        fields.append(Field(name, _field_type(c.dtype)))
        if c.dtype == "text":
            cols[name] = LazyColumn(len(c.values), functools.partial(
                ingest_string_buffers, c.dictionary, c.values, ends=c.ends,
                raw_max=raw_max))
            continue
        valid = np.ones(len(c.values), dtype=bool)
        bounds = None
        if c.dtype not in ("string", "float64") and len(c.values):
            bounds = (int(c.values.min()), int(c.values.max()))
        cols[name] = HostColumn(c.values, valid, c.dictionary, bounds)
    return tuple(fields), cols


def run_query(ctx, text: str, clock: Callable[[], float], spans):
    """`ctx.sql(text).collect()`: returns (batch, schema, sql seconds)."""
    t0 = clock()
    with spans("sql"):
        df = ctx.sql(text)
    t1 = clock()
    with spans("collect"):
        out, schema = df.collect()
    return out, schema, t1 - t0


def overflow_reruns(warnings: List[str]) -> int:
    return sum(1 for w in warnings if w.startswith(OVERFLOW_WARNING))


def answer_to_host(batch, schema) -> List[dict]:
    """The live rows of an answer on the host, undecoded: per column its
    kind, values (int64, float64, or int32 codes), validity (None where
    every row is valid), decimal scale, and a string column's dictionary
    as the schema holds it."""
    return list(host_columns(batch, schema))


def host_columns(batch, schema) -> Iterator[dict]:
    """The columns of `answer_to_host`, each copied as it is asked for."""
    from ballista_tpu_torch.schema import TypeKind
    import torch
    n = int(batch.num_rows)
    live = batch.live
    for f, col in zip(schema.fields, batch.columns):
        data, valid = col.data, col.validity
        if live is not None:
            data, valid = data[live], valid[live]
        else:
            data, valid = data[:n], valid[:n]
        kind = f.dtype.kind
        entry = {"name": f.name,
                 "valid": None if bool(valid.all()) else valid.cpu().numpy()}
        if f.dtype.is_wide:
            entry.update(kind="wide", scale=f.dtype.scale,
                         values=data.cpu().numpy())
        elif kind is TypeKind.STRING:
            d = schema.dictionary(f.name)
            entry.update(kind="string", values=data.cpu().numpy(),
                         dictionary=np.array([], dtype=object) if d is None
                         else np.asarray(d, dtype=object))
        elif kind is TypeKind.DECIMAL:
            entry.update(kind="decimal", scale=f.dtype.scale,
                         values=data.to(torch.int64).cpu().numpy())
        elif kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
            entry.update(kind="float",
                         values=data.to(torch.float64).cpu().numpy())
        else:
            entry.update(kind="int", values=data.to(torch.int64).cpu().numpy())
        yield entry


class EntryWrap:
    """In a traced run: every binding of an entry of the program (`module`,
    `name`) in the program's loaded modules is replaced by a wrapper that
    opens the `record_function` range `range_name` around the call, then
    adds the bytes the call must move (`call_bytes(*args, **kwargs)`, a
    device scalar) to a device counter outside that range. `restore()`
    puts the entry back."""

    def __init__(self, range_name: str, module: str, name: str, call_bytes):
        import importlib

        import torch
        mod = sys.modules.get(module) or importlib.import_module(module)
        self.name, self.range = name, range_name
        self.original = getattr(mod, name)
        self.calls = 0
        self.bytes = None
        self._patched = []
        original, rf = self.original, torch.autograd.profiler.record_function

        @functools.wraps(original)
        def wrapped(*args, **kwargs):
            with rf(range_name):
                out = original(*args, **kwargs)
            with rf("gpubench.entry_bytes"):
                b = call_bytes(*args, **kwargs)
                self.bytes = b if self.bytes is None else self.bytes + b
            self.calls += 1
            return out
        for mname, m in list(sys.modules.items()):
            if mname.split(".")[0] == "ballista_tpu_torch" and \
                    getattr(m, name, None) is original:
                setattr(m, name, wrapped)
                self._patched.append(m)

    def total_bytes(self) -> int:
        return 0 if self.bytes is None else int(self.bytes)

    def restore(self) -> None:
        for m in self._patched:
            setattr(m, self.name, self.original)
