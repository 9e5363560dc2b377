"""FlightSQL conformance of the port (`ballista_tpu_torch/flightsql.py`,
`flight.py`): tests/test_flightsql_conformance.py against the port's
server and codec, plus the port's codec held byte for byte to the JAX
package's on every message.

The reference file's own account follows.

FlightSQL conformance against bytes the repo codec did NOT produce.

The round-2 verdict flagged that every FlightSQL test encoded AND decoded
with `ballista_tpu.flightsql` — a symmetric wire-format bug would pass.
Here the client half builds its messages from the protobuf wire spec and
the arrow FlightSql.proto field numbers directly (local helpers below,
byte-level), and drives the real gRPC server with a plain
`pyarrow.flight` client. `ballista_tpu.flightsql` is only ever imported
server-side (inside BallistaFlightServer).

Spec sources: protobuf encoding (varint keys, wire type 2 = length-
delimited) and arrow/flight/protocol/sql/FlightSql.proto:
  google.protobuf.Any          { 1: string type_url, 2: bytes value }
  CommandStatementQuery        { 1: string query }
  TicketStatementQuery         { 1: bytes statement_handle }
  CommandGetTables             { 5: bool include_schema }
  CommandGetCatalogs           { }
(flight_sql.rs:80 — the reference's surface is exercised by real JDBC
drivers; this is the installable-client-free equivalent.)
"""

import threading

import pandas as pd
import pyarrow as pa
import pyarrow.flight as fl
import pytest
import torch

torch.set_num_threads(2)

SQL_NS = b"type.googleapis.com/arrow.flight.protocol.sql."


# -- spec-derived wire helpers (deliberately NOT ballista_tpu.flightsql) --

def varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def ld(field: int, payload: bytes) -> bytes:     # length-delimited
    return varint(field << 3 | 2) + varint(len(payload)) + payload


def any_wrap(name: bytes, value: bytes) -> bytes:
    return ld(1, SQL_NS + name) + ld(2, value)


def any_unwrap(buf: bytes):
    """Minimal Any parser: returns (type_name, value)."""
    i, url, val = 0, b"", b""
    while i < len(buf):
        key = buf[i]
        i += 1
        n = 0
        shift = 0
        while True:
            b = buf[i]
            i += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        data, i = buf[i:i + n], i + n
        if key >> 3 == 1:
            url = data
        elif key >> 3 == 2:
            val = data
    assert url.startswith(SQL_NS), url
    return url[len(SQL_NS):].decode(), val


@pytest.fixture(scope="module")
def server():
    from ballista_tpu_torch.client import SessionContext
    from ballista_tpu_torch.flight import BallistaFlightServer

    ctx = SessionContext(device="cpu")
    ctx.register_pandas("nums", pd.DataFrame(
        {"x": [1, 2, 3, 4], "s": ["a", "b", "a", "c"]}))
    srv = BallistaFlightServer(ctx, location="grpc://127.0.0.1:0")
    t = threading.Thread(target=srv.serve, daemon=True)
    t.start()
    yield f"grpc://127.0.0.1:{srv.port}"
    srv.shutdown()


def test_statement_query_roundtrip(server):
    # CommandStatementQuery built byte-by-byte from the spec
    cmd = any_wrap(b"CommandStatementQuery",
                   ld(1, b"select s, sum(x) t from nums group by s order by s"))
    client = fl.connect(server)
    info = client.get_flight_info(fl.FlightDescriptor.for_command(cmd))
    assert info.total_records == 3
    # the ticket must be an Any-wrapped TicketStatementQuery per spec
    kind, payload = any_unwrap(info.endpoints[0].ticket.ticket)
    assert kind == "TicketStatementQuery"
    table = client.do_get(info.endpoints[0].ticket).read_all()
    assert table.column("s").to_pylist() == ["a", "b", "c"]
    assert table.column("t").to_pylist() == [4, 2, 4]


def test_get_tables_include_schema(server):
    # CommandGetTables { 5: include_schema=true } -> key 0x28, value 1
    cmd = any_wrap(b"CommandGetTables", bytes([0x28, 0x01]))
    client = fl.connect(server)
    info = client.get_flight_info(fl.FlightDescriptor.for_command(cmd))
    table = client.do_get(info.endpoints[0].ticket).read_all()
    names = table.column("table_name").to_pylist()
    assert "nums" in names
    # include_schema=true adds the serialized-schema column (spec col 5)
    assert "table_schema" in table.schema.names


def test_get_catalogs_empty_message(server):
    cmd = any_wrap(b"CommandGetCatalogs", b"")
    client = fl.connect(server)
    info = client.get_flight_info(fl.FlightDescriptor.for_command(cmd))
    table = client.do_get(info.endpoints[0].ticket).read_all()
    assert table.num_rows >= 1


def test_repo_encoder_is_spec_identical():
    """The repo's encoder must emit byte-identical messages to the
    spec-derived construction (canonical field order, minimal varints) —
    this is the direction a symmetric codec bug can't hide in."""
    from ballista_tpu_torch import flightsql as fsql

    q = "select 1"
    assert fsql.command_statement_query(q) == \
        any_wrap(b"CommandStatementQuery", ld(1, q.encode()))
    assert fsql.ticket_statement_query(b"h-1") == \
        any_wrap(b"TicketStatementQuery", ld(1, b"h-1"))
    assert fsql.command_get_catalogs() == any_wrap(b"CommandGetCatalogs", b"")
    assert fsql.command_get_tables(include_schema=True) == \
        any_wrap(b"CommandGetTables", bytes([0x28, 0x01]))


def test_repo_decoder_accepts_spec_bytes():
    from ballista_tpu_torch import flightsql as fsql

    # 200-char query exercises multi-byte varint lengths
    q = "select * from t where x < 10 " + "-- pad " * 25
    golden = any_wrap(b"CommandStatementQuery", ld(1, q.encode()))
    kind, payload = fsql.unpack_any(golden)
    assert kind == "CommandStatementQuery"
    assert fsql.parse_statement_query(payload) == q

    g2 = any_wrap(b"CommandGetTables", bytes([0x28, 0x01]))
    kind, payload = fsql.unpack_any(g2)
    assert fsql.parse_get_tables(payload)["include_schema"] is True


MESSAGES = [
    ("command_statement_query", ("select 1 -- é",)),
    ("ticket_statement_query", (b"\x00handle\xff",)),
    ("prepared_statement_result", (b"h" * 300,)),
    ("command_get_tables", ("ballista", "pub%", "t%", ("TABLE", "VIEW"),
                            True)),
    ("command_get_tables", ()),
    ("command_get_db_schemas", ("ballista", "p%")),
    ("command_get_catalogs", ()),
    ("command_get_table_types", ()),
    ("command_get_sql_info", ((0, 1, 2, 3, 500),)),
    ("command_get_primary_keys", ("lineitem",)),
    ("command_statement_update", ("create table x as select 1",)),
    ("command_prepared_statement_update", (b"h-2",)),
    ("command_prepared_statement_query", (b"h-3",)),
    ("do_put_update_result", (2 ** 40,)),
]


@pytest.mark.parametrize("name,args", MESSAGES,
                         ids=[f"{m}{i}" for i, (m, _) in enumerate(MESSAGES)])
def test_codec_equals_jax_package(name, args):
    """Every encoder of the port emits the JAX package's bytes, and each
    parser reads them back as the JAX package's does."""
    from ballista_tpu import flightsql as jax_fsql
    from ballista_tpu_torch import flightsql as fsql
    got = getattr(fsql, name)(*args)
    assert got == getattr(jax_fsql, name)(*args)
    if name == "do_put_update_result":
        assert fsql.parse_do_put_update_result(got) == args[0]
        return
    kind, payload = fsql.unpack_any(got)
    assert (kind, payload) == jax_fsql.unpack_any(got)
    parser = {"CommandGetTables": "parse_get_tables",
              "CommandGetDbSchemas": "parse_get_db_schemas",
              "CommandGetSqlInfo": "parse_get_sql_info",
              "CommandStatementQuery": "parse_statement_query",
              "CommandStatementUpdate": "parse_statement_update",
              "TicketStatementQuery": "parse_ticket_statement"}.get(kind)
    if parser:
        assert getattr(fsql, parser)(payload) == \
            getattr(jax_fsql, parser)(payload)


def test_parse_fields_skips_fixed_width_and_rejects_groups():
    from ballista_tpu_torch import flightsql as fsql
    buf = (bytes([0x0D]) + b"abcd" + bytes([0x11]) + b"12345678"
           + fsql._field_varint(3, 300))
    assert fsql.parse_fields(buf) == {3: [300]}
    with pytest.raises(ValueError):
        fsql.parse_fields(bytes([0x0B]))
    assert fsql.unpack_any(b"\x0a\x03abc") is None
