"""Type system and schema (port of ballista_tpu/schema.py).

Design notes (vs reference: Ballista/DataFusion use Arrow's type system,
`ballista/core/src/serde/scheduler/mod.rs` carries Arrow schemas on the wire):
here the type system is designed for fixed-shape device arrays:

- Integers / floats map directly to torch (and numpy) dtypes.
- DATE32 is int32 days-since-epoch (same as Arrow date32).
- DECIMAL(p, s) is stored as scaled int64 (value * 10^s), exact arithmetic
  in integer ops — matches Arrow decimal128 semantics for p <= 18, which
  covers every TPC-H column (decimal(15,2)).
- A *wide* DECIMAL (precision 19-38, `wide_decimal`) is what a SUM whose
  exact total may pass int64 returns (`exec/aggregate.py`). It is stored
  as two int64 words per row, an int64[capacity, 2] tensor (a numpy
  (n, 2) array on the host): the value is hi * 2^32 + lo with 0 <= lo <
  2^32 (`split_wide` / `join_wide`), exact up to 2^95. It is carried (sort
  payload, limit, projection, exchange, egress); no operator reads it.
  Where an operator above reads such a SUM as a value, the lowering
  narrows it to decimal(18, s) at the aggregate's output (`narrow_wide`),
  as the JAX package types it, and a value past int64 fails the run
  (`wide_read_error`).
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
    def is_wide(self) -> bool:
        """A decimal of precision 19-38: two int64 words per value."""
        return self.kind is TypeKind.DECIMAL and self.precision > MAX_NARROW

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


# most digits a one-word (scaled int64) decimal holds
MAX_NARROW = 18
# most digits of a wide decimal (Arrow's decimal128)
MAX_WIDE = 38
# a wide value is hi * 2^32 + lo
WIDE_SHIFT = 32
_LO_MASK = (1 << WIDE_SHIFT) - 1


def decimal(precision: int, scale: int) -> DataType:
    if precision > MAX_NARROW:
        raise ValueError(f"decimal precision {precision} > {MAX_NARROW} not "
                         "supported (int64 storage)")
    return DataType(TypeKind.DECIMAL, precision, scale)


def wide_decimal(precision: int, scale: int) -> DataType:
    """A decimal of precision 19-38, stored as two int64 words."""
    if not MAX_NARROW < precision <= MAX_WIDE:
        raise ValueError(f"wide decimal precision {precision} not in "
                         f"{MAX_NARROW + 1}..{MAX_WIDE}")
    return DataType(TypeKind.DECIMAL, precision, scale)


def narrow_wide(words: torch.Tensor):
    """A wide column int64[n, 2] as int64 values, and where each value
    passes int64 (hi outside [-2^31, 2^31)): there the int64 is not the
    value."""
    hi, lo = words[:, 0], words[:, 1]
    passed = (hi < -(1 << 31)) | (hi >= (1 << 31))
    return (hi << WIDE_SHIFT) | lo, passed


def wide_read_error(column: str) -> NotImplementedError:
    """The error of a run where a narrowed SUM passed int64."""
    return NotImplementedError(
        f"{column}: its value passes int64, so it is a wide decimal; a "
        "wide decimal is exact where it is only carried, but cannot be "
        "read as a value (compared, sorted, grouped, computed with)")


def join_wide(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Per-row word sums (hi, lo) (any lo >= 0, each summed without
    passing int64) as a normalised wide column int64[n, 2]: the carry of lo
    past 32 bits moves into hi."""
    return torch.stack([hi + (lo >> WIDE_SHIFT), lo & _LO_MASK], dim=1)


def split_wide(v: torch.Tensor):
    """An int64 value's two halves: v >> 32 (signed) and v & (2^32 - 1),
    whose sums over fewer than 2^31 rows fit int64 each."""
    return v >> WIDE_SHIFT, v & _LO_MASK


def wide_to_ints(words: np.ndarray) -> np.ndarray:
    """A host wide column (n, 2) as an object array of Python ints."""
    words = np.asarray(words, dtype=np.int64).reshape(-1, 2)
    return (words[:, 0].astype(object) * (1 << WIDE_SHIFT)
            + words[:, 1].astype(object))


def wide_to_decimal128(words: np.ndarray) -> np.ndarray:
    """A host wide column (n, 2) as Arrow decimal128 words: (low 64
    bits, high 64 bits) of the two's complement value, int64 each."""
    words = np.asarray(words, dtype=np.int64).reshape(-1, 2)
    hi, lo = words[:, 0], words[:, 1]
    low = (hi.view(np.uint64) << np.uint64(WIDE_SHIFT)) | lo.view(np.uint64)
    return np.stack([low.view(np.int64), hi >> WIDE_SHIFT], axis=1)


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
                 unsorted: Optional[set] = None,
                 rows: Optional[int] = None, pending=()):
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
        # a table's row count (TableProvider.schema): what bounds the rows
        # an aggregate over a scan of it may add (logical.row_bound)
        self.rows = rows
        # a table's fields whose metadata (bounds, dictionaries) has not
        # been read yet: what a lazily ingested table knows before
        # `rebind_scans` (logical.Aggregate.sized_aggs waits for it)
        self.pending = frozenset(pending)
        self._index = {f.name: i for i, f in enumerate(self.fields)}

    def __repr__(self):
        return "Schema(" + ", ".join(f"{f.name}: {f.dtype!r}" for f in self.fields) + ")"

    def __contains__(self, name: str) -> bool:
        return name in self._index

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
        return Schema(fields, dicts, bounds, self.unsorted & set(names),
                      self.rows, self.pending & set(names))
