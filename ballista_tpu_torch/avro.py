"""Minimal Avro Object Container File reader and writer (port of
ballista_tpu/avro.py).

Reference parity: `BallistaContext::read_avro` / `register_avro`
(client/src/context.rs; DataFusion's avro feature). The container format
is implemented directly (spec
https://avro.apache.org/docs/current/specification/): null/deflate codecs,
records of primitive types, nullable unions, string/bytes/enum, and the
date and decimal logical types, the shapes SQL tables use. Tables come in
and go out as host columns ((fields, {column: HostColumn})), with no
pyarrow. Columns of types the port has no type for (bytes, timestamps)
raise.
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np

from . import batch as B
from .schema import (BOOL, DATE32, FLOAT32, FLOAT64, INT32, INT64, STRING,
                     Field, TypeKind, decimal)

MAGIC = b"Obj\x01"


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return b

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    # zig-zag varint (spec: binary encoding of int/long)
    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_value(self, schema) -> Any:
        if isinstance(schema, list):  # union
            idx = self.read_long()
            return self.read_value(schema[idx])
        if isinstance(schema, dict):
            t = schema["type"]
            if t == "record":
                return {f["name"]: self.read_value(f["type"])
                        for f in schema["fields"]}
            if t == "enum":
                return schema["symbols"][self.read_long()]
            if t == "array":
                out = []
                while True:
                    n = self.read_long()
                    if n == 0:
                        break
                    if n < 0:
                        self.read_long()  # block byte size, ignored
                        n = -n
                    out.extend(self.read_value(schema["items"])
                               for _ in range(n))
                return out
            if t == "map":
                out = {}
                while True:
                    n = self.read_long()
                    if n == 0:
                        break
                    if n < 0:
                        self.read_long()
                        n = -n
                    for _ in range(n):
                        out[self.read_bytes().decode()] = \
                            self.read_value(schema["values"])
                return out
            if t == "fixed":
                return self.read(schema["size"])
            return self.read_value(t)  # annotated primitive
        # primitive names
        if schema == "null":
            return None
        if schema == "boolean":
            return self.read(1) != b"\x00"
        if schema in ("int", "long"):
            return self.read_long()
        if schema == "float":
            return struct.unpack("<f", self.read(4))[0]
        if schema == "double":
            return struct.unpack("<d", self.read(8))[0]
        if schema == "bytes":
            return self.read_bytes()
        if schema == "string":
            return self.read_bytes().decode("utf-8")
        raise NotImplementedError(f"avro type {schema!r}")


def read_avro_rows(path: str) -> Tuple[dict, List[dict]]:
    """Returns (record schema, list of row dicts)."""
    with open(path, "rb") as fh:
        data = fh.read()
    r = _Reader(data)
    if r.read(4) != MAGIC:
        raise ValueError(f"not an avro object container file: {path!r}")
    meta: Dict[str, bytes] = {}
    while True:
        n = r.read_long()
        if n == 0:
            break
        if n < 0:
            r.read_long()
            n = -n
        for _ in range(n):
            key = r.read_bytes().decode()
            meta[key] = r.read_bytes()
    sync = r.read(16)
    schema = json.loads(meta["avro.schema"])
    codec = meta.get("avro.codec", b"null").decode()
    if codec not in ("null", "deflate"):
        raise NotImplementedError(f"avro codec {codec!r}")
    if schema.get("type") != "record":
        raise NotImplementedError("top-level avro schema must be a record")

    rows: List[dict] = []
    while not r.at_end():
        count = r.read_long()
        block = r.read_bytes()
        if codec == "deflate":
            block = zlib.decompress(block, -15)  # raw deflate per spec
        br = _Reader(block)
        for _ in range(count):
            rows.append(br.read_value(schema))
        if r.read(16) != sync:
            raise ValueError("avro sync marker mismatch (corrupt file)")
    return schema, rows


def _field_type(schema):
    """Avro field type -> (port DataType, nullable) (logical types
    honoured)."""
    nullable = False
    if isinstance(schema, list):
        non_null = [s for s in schema if s != "null"]
        if len(non_null) != 1:
            raise NotImplementedError(f"general avro union {schema!r}")
        nullable = len(non_null) != len(schema)
        schema = non_null[0]
    logical = schema.get("logicalType") if isinstance(schema, dict) else None
    t = schema["type"] if isinstance(schema, dict) else schema
    if logical == "date":
        return DATE32, nullable
    if logical == "decimal":
        return decimal(schema.get("precision", 38),
                       schema.get("scale", 0)), nullable
    if logical in ("timestamp-millis", "timestamp-micros"):
        raise NotImplementedError(f"avro {logical}: the port has no "
                                  "timestamp type")
    mapping = {"boolean": BOOL, "int": INT32, "long": INT64,
               "float": FLOAT32, "double": FLOAT64, "string": STRING,
               "enum": STRING}
    if t in mapping:
        return mapping[t], nullable
    raise NotImplementedError(f"avro type {t!r} as a table column")


def read_avro(path: str):
    """Avro container file -> (fields, {column: HostColumn}), typed as the
    JAX package's reader types its arrow table (int -> int32, long ->
    int64, date -> date32, decimal(p, s) over scaled integers)."""
    schema, rows = read_avro_rows(path)
    fields, cols = [], {}
    for f in schema["fields"]:
        dtype, nullable = _field_type(f["type"])
        name = f["name"]
        vals = [row[name] for row in rows]
        valid = np.array([v is not None for v in vals], dtype=bool)
        if dtype.kind is TypeKind.DECIMAL:
            # the two's complement big-endian bytes are the scaled integer
            vals = np.array([0 if v is None else
                             int.from_bytes(v, "big", signed=True)
                             for v in vals], dtype=np.int64)
        elif dtype.kind is TypeKind.DATE32:
            vals = np.array([0 if v is None else v for v in vals],
                            dtype=np.int32)
        fields.append(Field(name, dtype, nullable))
        cols[name] = B.ingest_column(B.as_array(vals), dtype, valid)
    return tuple(fields), cols


def _zz(n: int) -> bytes:
    """Zig-zag varint (the binary encoding of int and long)."""
    u = (n << 1) ^ (n >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _avro_type(f: Field):
    kind = f.dtype.kind
    base = {TypeKind.BOOL: "boolean", TypeKind.INT32: "int",
            TypeKind.INT64: "long", TypeKind.FLOAT32: "float",
            TypeKind.FLOAT64: "double", TypeKind.STRING: "string",
            TypeKind.DATE32: {"type": "int", "logicalType": "date"},
            TypeKind.DECIMAL: {"type": "bytes", "logicalType": "decimal",
                               "precision": f.dtype.precision,
                               "scale": f.dtype.scale}}[kind]
    return ["null", base] if f.nullable else base


def _encoded(f: Field, col: B.HostColumn) -> List[bytes]:
    """Each row's value of one column, encoded (with its union branch
    when the field is nullable)."""
    kind = f.dtype.kind
    if kind is TypeKind.STRING:
        enc = [_zz(len(b)) + b for b in
               (str(s).encode() for s in col.dictionary.tolist())]
        out = [enc[c] for c in col.values.tolist()]
    elif kind is TypeKind.BOOL:
        out = [b"\x01" if v else b"\x00" for v in col.values.tolist()]
    elif kind in (TypeKind.INT32, TypeKind.INT64, TypeKind.DATE32):
        out = [_zz(v) for v in col.values.tolist()]
    elif kind is TypeKind.FLOAT32:
        out = [struct.pack("<f", v) for v in col.values.tolist()]
    elif kind is TypeKind.FLOAT64:
        out = [struct.pack("<d", v) for v in col.values.tolist()]
    else:   # decimal: the scaled integer, two's complement big-endian
        out = []
        for v in col.values.tolist():
            b = v.to_bytes(max(1, (v.bit_length() + 8) // 8), "big",
                           signed=True)
            out.append(_zz(len(b)) + b)
    if not f.nullable:
        if not col.validity.all():
            raise ValueError(f"column {f.name}: NULLs in a field declared "
                             "not nullable")
        return out
    null, some = _zz(0), _zz(1)
    return [some + v if ok else null
            for v, ok in zip(out, col.validity.tolist())]


def write_avro(path: str, table, codec: str = "deflate") -> None:
    """A host table ((fields, {column: HostColumn})) -> Avro container
    file, in one block. Decimals are written as the decimal logical type
    over bytes."""
    fields, cols = table
    schema = {"type": "record", "name": "row",
              "fields": [{"name": f.name, "type": _avro_type(f)}
                         for f in fields]}
    per_col = [_encoded(f, cols[f.name]) for f in fields]
    n = len(per_col[0]) if per_col else 0
    block = b"".join(b"".join(row) for row in zip(*per_col))
    if codec == "deflate":
        co = zlib.compressobj(9, zlib.DEFLATED, -15)
        block = co.compress(block) + co.flush()
    elif codec != "null":
        raise NotImplementedError(f"avro codec {codec!r}")
    sync = b"\x00" * 16
    with open(path, "wb") as fh:
        fh.write(MAGIC)
        meta = {"avro.schema": json.dumps(schema).encode(),
                "avro.codec": codec.encode()}
        fh.write(_zz(len(meta)))
        for k, v in meta.items():
            kb = k.encode()
            fh.write(_zz(len(kb)) + kb + _zz(len(v)) + v)
        fh.write(_zz(0))
        fh.write(sync)
        fh.write(_zz(n))
        fh.write(_zz(len(block)) + block)
        fh.write(sync)
