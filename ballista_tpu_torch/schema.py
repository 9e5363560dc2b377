"""Type system and schema (port of ballista_tpu/schema.py).

Design notes (vs reference: Ballista/DataFusion use Arrow's type system,
`ballista/core/src/serde/scheduler/mod.rs` carries Arrow schemas on the wire):
here the type system is designed for fixed-shape device arrays:

- Integers / floats map directly to torch (and numpy) dtypes.
- DATE32 is int32 days-since-epoch (same as Arrow date32).
- DECIMAL(p, s) is stored as scaled int64 (value * 10^s), exact arithmetic
  in integer ops — matches Arrow decimal128 semantics for p <= 18, which
  covers every TPC-H column (decimal(15,2)).
- STRING is dictionary-encoded: device arrays hold int32 codes; the
  dictionary (sorted, so code order == lexicographic order) lives host-side
  in the Schema. Comparisons with literals / LIKE are evaluated on the
  dictionary at plan time and become code-set membership tests on device.
  Sorted dictionaries make ORDER BY and min/max on strings work on codes.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple

import numpy as np
import torch


class TypeKind(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DATE32 = "date32"
    DECIMAL = "decimal"
    STRING = "string"


@dataclasses.dataclass(frozen=True)
class DataType:
    kind: TypeKind
    precision: int = 0  # decimal only
    scale: int = 0      # decimal only

    def __repr__(self) -> str:
        if self.kind is TypeKind.DECIMAL:
            return f"decimal({self.precision},{self.scale})"
        return self.kind.value

    @property
    def torch_dtype(self) -> torch.dtype:
        return {
            TypeKind.BOOL: torch.bool,
            TypeKind.INT32: torch.int32,
            TypeKind.INT64: torch.int64,
            TypeKind.FLOAT32: torch.float32,
            TypeKind.FLOAT64: torch.float64,
            TypeKind.DATE32: torch.int32,
            TypeKind.DECIMAL: torch.int64,
            TypeKind.STRING: torch.int32,  # dictionary codes
        }[self.kind]

    @property
    def np_dtype(self) -> np.dtype:
        return np.dtype({
            TypeKind.BOOL: np.bool_,
            TypeKind.INT32: np.int32,
            TypeKind.INT64: np.int64,
            TypeKind.FLOAT32: np.float32,
            TypeKind.FLOAT64: np.float64,
            TypeKind.DATE32: np.int32,
            TypeKind.DECIMAL: np.int64,
            TypeKind.STRING: np.int32,
        }[self.kind])

    @property
    def is_numeric(self) -> bool:
        return self.kind in (
            TypeKind.INT32, TypeKind.INT64, TypeKind.FLOAT32,
            TypeKind.FLOAT64, TypeKind.DECIMAL,
        )

    @property
    def is_integer(self) -> bool:
        return self.kind in (TypeKind.INT32, TypeKind.INT64)


BOOL = DataType(TypeKind.BOOL)
INT32 = DataType(TypeKind.INT32)
INT64 = DataType(TypeKind.INT64)
FLOAT32 = DataType(TypeKind.FLOAT32)
FLOAT64 = DataType(TypeKind.FLOAT64)
DATE32 = DataType(TypeKind.DATE32)
STRING = DataType(TypeKind.STRING)


def to_arrow_type(dt: DataType):
    """DataType -> pyarrow type (external-table DDL and Arrow egress)."""
    import pyarrow as pa
    if dt.kind is TypeKind.DECIMAL:
        return pa.decimal128(dt.precision, dt.scale)
    return {
        TypeKind.BOOL: pa.bool_(), TypeKind.INT32: pa.int32(),
        TypeKind.INT64: pa.int64(), TypeKind.FLOAT32: pa.float32(),
        TypeKind.FLOAT64: pa.float64(), TypeKind.DATE32: pa.date32(),
        TypeKind.STRING: pa.string(),
    }[dt.kind]


def decimal(precision: int, scale: int) -> DataType:
    if precision > 18:
        raise ValueError(f"decimal precision {precision} > 18 not supported (int64 storage)")
    return DataType(TypeKind.DECIMAL, precision, scale)


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True


class Schema:
    """Ordered list of fields + host-side string dictionaries.

    Dictionaries are per-field numpy object arrays of Python str, sorted
    ascending, so that code order == lexicographic order, except for the
    RAW columns named in `unsorted` (see there). They are planning
    metadata; they never reach the device.
    """

    def __init__(self, fields: Tuple[Field, ...],
                 dictionaries: Optional[dict] = None,
                 int_bounds: Optional[dict] = None,
                 unsorted: Optional[set] = None):
        self.fields = tuple(fields)
        self.dictionaries = dict(dictionaries or {})  # name -> np.ndarray[str]
        # name -> (lo, hi): ingest-time value bounds for integer/date/
        # decimal columns (planning metadata)
        self.int_bounds = dict(int_bounds or {})
        # names of RAW string columns: the dictionary is the column's host
        # values verbatim (unsorted, duplicates allowed; code == row
        # index). Ingest takes this form when a column's estimated
        # distinct count exceeds BALLISTA_RAW_DICT_MAX (batch.py
        # `_estimate_high_cardinality`). LUT predicates (LIKE, =, IN) and
        # decoding work unchanged; code-order and code-equality uses
        # (group, sort and join keys, min/max, range compares) re-encode
        # through `exprs.sorted_recode` first.
        self.unsorted = set(unsorted or ())
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    def __repr__(self):
        return "Schema(" + ", ".join(f"{f.name}: {f.dtype!r}" for f in self.fields) + ")"

    def field(self, name: str) -> Field:
        return self.fields[self._index[name]]

    def index_of(self, name: str) -> int:
        if name not in self._index:
            raise KeyError(f"column {name!r} not in schema {self!r}")
        return self._index[name]

    def dictionary(self, name: str) -> Optional[np.ndarray]:
        return self.dictionaries.get(name)

    def int_bound(self, name: str):
        return self.int_bounds.get(name)

    def is_sorted_dict(self, name: str) -> bool:
        return name not in self.unsorted

    def select(self, names) -> "Schema":
        fields = tuple(self.field(n) for n in names)
        dicts = {n: self.dictionaries[n] for n in names if n in self.dictionaries}
        bounds = {n: self.int_bounds[n] for n in names if n in self.int_bounds}
        return Schema(fields, dicts, bounds, self.unsorted & set(names))
