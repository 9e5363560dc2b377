"""Arrow FlightSQL protocol envelope (hand-rolled protobuf wire format;
the port's copy of ballista_tpu/flightsql.py, which imports nothing, so it
runs where pyarrow is absent too).

Reference parity: `scheduler/src/flight_sql.rs` speaks the Arrow FlightSQL
protocol — FlightDescriptor commands are `google.protobuf.Any`-wrapped
messages from arrow/flight/protocol/sql (CommandStatementQuery,
CommandGetTables, ...), tickets are Any-wrapped TicketStatementQuery.
pyarrow ships no FlightSQL bindings, so the handful of messages needed are
encoded/decoded directly (protobuf wire format: varint keys, length-
delimited strings/bytes).

Message shapes (arrow FlightSql.proto):
  CommandStatementQuery   { 1: string query }
  TicketStatementQuery    { 1: bytes statement_handle }
  CommandGetCatalogs      { }
  CommandGetDbSchemas     { 1: optional string catalog, 2: filter }
  CommandGetTables        { 1..4: filters, 5: bool include_schema }
  ActionCreatePreparedStatementRequest  { 1: string query }
  ActionCreatePreparedStatementResult   { 1: bytes handle, ... }
  CommandPreparedStatementQuery { 1: bytes prepared_statement_handle }
google.protobuf.Any { 1: string type_url, 2: bytes value }
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

SQL_NS = "type.googleapis.com/arrow.flight.protocol.sql."


# -- protobuf wire helpers --

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _field_bytes(field: int, payload: bytes) -> bytes:
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def _field_varint(field: int, value: int) -> bytes:
    return _varint(field << 3) + _varint(value)


def parse_fields(buf: bytes) -> Dict[int, list]:
    """Decode a protobuf message into {field_number: [values]} (bytes for
    length-delimited, int for varint; other wire types skipped)."""
    out: Dict[int, list] = {}
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            out.setdefault(field, []).append(v)
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            out.setdefault(field, []).append(buf[i:i + ln])
            i += ln
        elif wt == 5:
            i += 4
        elif wt == 1:
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wt}")
    return out


# -- Any envelope --

def pack_any(type_name: str, payload: bytes) -> bytes:
    return (_field_bytes(1, (SQL_NS + type_name).encode())
            + _field_bytes(2, payload))


def unpack_any(buf: bytes) -> Optional[Tuple[str, bytes]]:
    """Returns (short type name, payload) or None if not an Any from the
    FlightSQL namespace."""
    try:
        f = parse_fields(buf)
    except (ValueError, IndexError):
        return None
    if 1 not in f:
        return None
    url = f[1][0].decode("utf-8", errors="replace")
    if not url.startswith(SQL_NS):
        return None
    payload = f[2][0] if 2 in f else b""
    return url[len(SQL_NS):], payload


# -- message constructors / parsers --

def command_statement_query(query: str) -> bytes:
    return pack_any("CommandStatementQuery",
                    _field_bytes(1, query.encode()))


def parse_statement_query(payload: bytes) -> str:
    return parse_fields(payload)[1][0].decode()


def ticket_statement_query(handle: bytes) -> bytes:
    return pack_any("TicketStatementQuery", _field_bytes(1, handle))


def parse_ticket_statement(payload: bytes) -> bytes:
    return parse_fields(payload)[1][0]


def prepared_statement_result(handle: bytes) -> bytes:
    """ActionCreatePreparedStatementResult body (returned inside a Flight
    Result, itself just bytes)."""
    return pack_any("ActionCreatePreparedStatementResult",
                    _field_bytes(1, handle))


def parse_prepared_query(payload: bytes) -> bytes:
    return parse_fields(payload)[1][0]


def command_get_tables(catalog: Optional[str] = None,
                       db_schema_filter: Optional[str] = None,
                       table_name_filter: Optional[str] = None,
                       table_types: Tuple[str, ...] = (),
                       include_schema: bool = False) -> bytes:
    body = b""
    if catalog is not None:
        body += _field_bytes(1, catalog.encode())
    if db_schema_filter is not None:
        body += _field_bytes(2, db_schema_filter.encode())
    if table_name_filter is not None:
        body += _field_bytes(3, table_name_filter.encode())
    for t in table_types:
        body += _field_bytes(4, t.encode())
    if include_schema:
        body += _field_varint(5, 1)
    return pack_any("CommandGetTables", body)


def parse_get_tables(payload: bytes) -> dict:
    """-> {catalog, db_schema_filter, table_name_filter, table_types,
    include_schema} (FlightSql.proto CommandGetTables fields 1-5)."""
    f = parse_fields(payload)
    return {
        "catalog": f[1][0].decode() if 1 in f else None,
        "db_schema_filter": f[2][0].decode() if 2 in f else None,
        "table_name_filter": f[3][0].decode() if 3 in f else None,
        "table_types": tuple(v.decode() for v in f.get(4, [])),
        "include_schema": bool(f[6][0]) if 6 in f else
                          bool(f[5][0]) if 5 in f else False,
    }


def command_get_db_schemas(catalog: Optional[str] = None,
                           db_schema_filter: Optional[str] = None) -> bytes:
    body = b""
    if catalog is not None:
        body += _field_bytes(1, catalog.encode())
    if db_schema_filter is not None:
        body += _field_bytes(2, db_schema_filter.encode())
    return pack_any("CommandGetDbSchemas", body)


def parse_get_db_schemas(payload: bytes) -> dict:
    f = parse_fields(payload)
    return {"catalog": f[1][0].decode() if 1 in f else None,
            "db_schema_filter": f[2][0].decode() if 2 in f else None}


def command_get_catalogs() -> bytes:
    return pack_any("CommandGetCatalogs", b"")


def command_get_table_types() -> bytes:
    return pack_any("CommandGetTableTypes", b"")


def command_get_sql_info(ids: Tuple[int, ...] = ()) -> bytes:
    body = b"".join(_field_varint(1, i) for i in ids)
    return pack_any("CommandGetSqlInfo", body)


def parse_get_sql_info(payload: bytes) -> Tuple[int, ...]:
    f = parse_fields(payload)
    vals = []
    for v in f.get(1, []):
        if isinstance(v, int):
            vals.append(v)
        else:  # packed repeated encoding
            i = 0
            while i < len(v):
                x, i = _read_varint(v, i)
                vals.append(x)
    return tuple(vals)


def command_get_primary_keys(table: str) -> bytes:
    return pack_any("CommandGetPrimaryKeys", _field_bytes(3, table.encode()))


def command_statement_update(query: str) -> bytes:
    return pack_any("CommandStatementUpdate", _field_bytes(1, query.encode()))


def parse_statement_update(payload: bytes) -> str:
    return parse_fields(payload)[1][0].decode()


def command_prepared_statement_update(handle: bytes) -> bytes:
    return pack_any("CommandPreparedStatementUpdate", _field_bytes(1, handle))


def command_prepared_statement_query(handle: bytes) -> bytes:
    return pack_any("CommandPreparedStatementQuery", _field_bytes(1, handle))


def do_put_update_result(record_count: int) -> bytes:
    """DoPutUpdateResult {1: int64 record_count} — the app_metadata of the
    PutResult a FlightSQL server returns for statement updates."""
    return _field_varint(1, record_count)


def parse_do_put_update_result(buf: bytes) -> int:
    f = parse_fields(buf)
    return f[1][0] if 1 in f else 0
