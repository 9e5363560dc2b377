"""The port's Arrow Flight endpoint (`ballista_tpu_torch/flight.py`):
tests/test_flight.py run against the port's server over a CPU context,
plus the parity of the JAX package's server and the port's (the same SQL
gives equal arrow tables through both, over a context and over the
standalone cluster) and `serve --flight-port`.

Reference parity: scheduler FlightSQL service (flight_sql.rs:80) +
executor Flight result fetch (flight_service.rs:74)."""

import decimal
import json

import pyarrow as pa
import pyarrow.flight as fl
import pytest

import torch

from ballista_tpu_torch.client import SessionContext as _Context
from ballista_tpu_torch.flight import BallistaFlightServer, flight_query

torch.set_num_threads(2)


def SessionContext():
    return _Context(device="cpu")


@pytest.fixture(scope="module")
def server():
    ctx = SessionContext()
    ctx.register_arrow("t", pa.table({
        "g": pa.array(["a", "a", "b"]),
        "v": pa.array([1, 2, 3], pa.int64()),
        "price": pa.array([decimal.Decimal("1.50"), decimal.Decimal("2.25"),
                           None], pa.decimal128(10, 2)),
    }))
    srv = BallistaFlightServer(ctx=ctx)
    yield srv, f"grpc://127.0.0.1:{srv.port}"
    srv.shutdown()


def test_get_flight_info_and_do_get(server):
    srv, endpoint = server
    client = fl.connect(endpoint)
    info = client.get_flight_info(fl.FlightDescriptor.for_command(
        b"select g, sum(v) as s from t group by g order by g"))
    assert info.total_records == 2
    table = client.do_get(info.endpoints[0].ticket).read_all()
    assert table.column("g").to_pylist() == ["a", "b"]
    assert table.column("s").to_pylist() == [3, 3]


def test_one_shot_ticket(server):
    srv, endpoint = server
    client = fl.connect(endpoint)
    table = client.do_get(fl.Ticket(b"select count(*) c from t")).read_all()
    assert table.column("c").to_pylist() == [3]


def test_decimal_exact_over_wire(server):
    srv, endpoint = server
    table = flight_query(endpoint, "select price from t order by v")
    vals = table.column("price").to_pylist()
    assert vals[0] == decimal.Decimal("1.50")
    assert vals[1] == decimal.Decimal("2.25")
    assert vals[2] is None
    assert pa.types.is_decimal(table.schema.field("price").type)


def test_list_flights(server):
    srv, endpoint = server
    client = fl.connect(endpoint)
    flights = list(client.list_flights())
    assert len(flights) == 1
    assert flights[0].total_records == 3


def test_explain_action(server):
    srv, endpoint = server
    client = fl.connect(endpoint)
    out = list(client.do_action(fl.Action(
        "explain", b"select v from t where v > 1")))
    text = out[0].body.to_pybytes().decode()
    assert "Filter" in text and "Projection" in text


def test_unknown_ticket_rejected(server):
    srv, endpoint = server
    client = fl.connect(endpoint)
    with pytest.raises(fl.FlightServerError):
        client.do_get(fl.Ticket(json.dumps({"ticket": "nope"}).encode())
                      ).read_all()


def test_flightsql_statement_query(server):
    """Real FlightSQL wire envelope: Any-wrapped CommandStatementQuery in
    the descriptor, Any-wrapped TicketStatementQuery back (what a JDBC
    FlightSQL driver sends; flight_sql.rs parity)."""
    from ballista_tpu_torch import flightsql as fsql
    srv, endpoint = server
    client = fl.connect(endpoint)
    cmd = fsql.command_statement_query(
        "select g, sum(v) as s from t group by g order by g")
    info = client.get_flight_info(fl.FlightDescriptor.for_command(cmd))
    # ticket must be an Any-wrapped TicketStatementQuery
    kind, payload = fsql.unpack_any(info.endpoints[0].ticket.ticket)
    assert kind == "TicketStatementQuery"
    table = client.do_get(info.endpoints[0].ticket).read_all()
    assert table.column("s").to_pylist() == [3, 3]


def test_flightsql_get_tables(server):
    from ballista_tpu_torch import flightsql as fsql
    srv, endpoint = server
    client = fl.connect(endpoint)
    cmd = fsql.command_get_tables()
    info = client.get_flight_info(fl.FlightDescriptor.for_command(cmd))
    table = client.do_get(info.endpoints[0].ticket).read_all()
    assert "t" in table.column("table_name").to_pylist()
    assert table.schema.field("table_type").type == pa.string()


def test_flightsql_roundtrip_encoding():
    from ballista_tpu_torch import flightsql as fsql
    cmd = fsql.command_statement_query("select 1")
    kind, payload = fsql.unpack_any(cmd)
    assert kind == "CommandStatementQuery"
    assert fsql.parse_statement_query(payload) == "select 1"
    t = fsql.ticket_statement_query(b"handle123")
    kind, payload = fsql.unpack_any(t)
    assert kind == "TicketStatementQuery"
    assert fsql.parse_ticket_statement(payload) == b"handle123"

def test_prepared_statement_lifecycle(server):
    """CreatePreparedStatement -> CommandPreparedStatementQuery ->
    ClosePreparedStatement (flight_sql.rs statement lifecycle)."""
    from ballista_tpu_torch import flightsql as fsql
    srv, endpoint = server
    client = fl.connect(endpoint)
    req = fsql.pack_any("ActionCreatePreparedStatementRequest",
                        fsql._field_bytes(
                            1, b"select sum(v) as s from t"))
    res = list(client.do_action(fl.Action("CreatePreparedStatement", req)))
    any_msg = fsql.unpack_any(res[0].body.to_pybytes())
    assert any_msg[0] == "ActionCreatePreparedStatementResult"
    handle = fsql.parse_prepared_query(any_msg[1])
    # execute by handle
    cmd = fsql.pack_any("CommandPreparedStatementQuery",
                        fsql._field_bytes(1, handle))
    info = client.get_flight_info(fl.FlightDescriptor.for_command(cmd))
    table = client.do_get(info.endpoints[0].ticket).read_all()
    assert table.column("s").to_pylist() == [6]
    # close, then the handle is gone
    close = fsql.pack_any("ActionClosePreparedStatementRequest",
                          fsql._field_bytes(1, handle))
    list(client.do_action(fl.Action("ClosePreparedStatement", close)))
    with pytest.raises(fl.FlightError):
        client.get_flight_info(fl.FlightDescriptor.for_command(cmd))


def test_handshake_bearer_auth():
    """Handshake issues a bearer token; wrong creds rejected
    (flight_sql.rs:80 handshake parity)."""
    ctx = SessionContext()
    ctx.register_arrow("t", pa.table({"v": pa.array([1, 2], pa.int64())}))
    srv = BallistaFlightServer(ctx=ctx, auth=("admin", "secret"))
    endpoint = f"grpc://127.0.0.1:{srv.port}"
    try:
        client = fl.connect(endpoint)
        with pytest.raises(fl.FlightError):
            client.do_get(fl.Ticket(b"select * from t")).read_all()
        client.authenticate_basic_token  # API presence
        class CliAuth(fl.ClientAuthHandler):
            def __init__(self):
                super().__init__()
                self.token = None
            def authenticate(self, outgoing, incoming):
                outgoing.write(fl.BasicAuth(b"admin", b"secret").serialize())
                self.token = incoming.read()
            def get_token(self):
                return self.token
        client.authenticate(CliAuth())
        t = client.do_get(fl.Ticket(b"select sum(v) as s from t")).read_all()
        assert t.column("s").to_pylist() == [3]
        # bad credentials fail the handshake
        bad = fl.connect(endpoint)
        class BadAuth(CliAuth):
            def authenticate(self, outgoing, incoming):
                outgoing.write(fl.BasicAuth(b"admin", b"wrong").serialize())
                self.token = incoming.read()
        with pytest.raises(fl.FlightError):
            bad.authenticate(BadAuth())
    finally:
        srv.shutdown()


class TestFlightSqlConformance:
    """Wire-exact FlightSQL catalog/metadata/do_put flows — the frames an
    ADBC/JDBC FlightSQL driver sends (flight_sql.rs:644-935 parity)."""

    def test_get_catalogs_and_db_schemas(self, server):
        from ballista_tpu_torch import flightsql as fsql
        srv, endpoint = server
        client = fl.connect(endpoint)
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_catalogs()))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.column("catalog_name").to_pylist() == ["ballista"]
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_db_schemas(db_schema_filter="pub%")))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.column("db_schema_name").to_pylist() == ["public"]
        # non-matching filter -> empty
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_db_schemas(db_schema_filter="nope%")))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.num_rows == 0

    def test_get_tables_filters_and_schema(self, server):
        from ballista_tpu_torch import flightsql as fsql
        srv, endpoint = server
        client = fl.connect(endpoint)
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_tables(table_name_filter="t",
                                    include_schema=True)))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.column("table_name").to_pylist() == ["t"]
        assert t.column("table_type").to_pylist() == ["TABLE"]
        # table_schema column holds an IPC-serialized Arrow schema
        schema_bytes = t.column("table_schema")[0].as_py()
        schema = pa.ipc.read_schema(pa.BufferReader(schema_bytes))
        assert "g" in schema.names and "v" in schema.names
        # type filter excluding TABLE -> empty
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_tables(table_types=("VIEW",))))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.num_rows == 0

    def test_get_table_types_and_sql_info(self, server):
        from ballista_tpu_torch import flightsql as fsql
        srv, endpoint = server
        client = fl.connect(endpoint)
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_table_types()))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.column("table_type").to_pylist() == ["TABLE"]
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_sql_info((0, 3))))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.column("info_name").to_pylist() == [0, 3]
        vals = t.column("value")
        assert vals[0].as_py() == "ballista-tpu-torch"   # server name
        assert vals[1].as_py() is True             # read-only

    def test_get_primary_keys_empty(self, server):
        from ballista_tpu_torch import flightsql as fsql
        srv, endpoint = server
        client = fl.connect(endpoint)
        info = client.get_flight_info(fl.FlightDescriptor.for_command(
            fsql.command_get_primary_keys("t")))
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.num_rows == 0
        assert "key_sequence" in t.schema.names

    def test_prepared_statement_param_binding(self, server):
        from ballista_tpu_torch import flightsql as fsql
        srv, endpoint = server
        client = fl.connect(endpoint)
        res = list(client.do_action(fl.Action(
            "CreatePreparedStatement",
            fsql.pack_any("ActionCreatePreparedStatementRequest",
                          fsql._field_bytes(
                              1, b"select g, v from t where v >= ? "
                                 b"and g = ? order by v")))))
        handle = fsql.parse_prepared_query(
            fsql.unpack_any(res[0].body.to_pybytes())[1])
        # bind (2, 'a') via do_put — the JDBC driver's setX path
        params = pa.table({"p1": pa.array([2], pa.int64()),
                           "p2": pa.array(["a"])})
        desc = fl.FlightDescriptor.for_command(
            fsql.command_prepared_statement_query(handle))
        writer, reader = client.do_put(desc, params.schema)
        writer.write_table(params)
        writer.done_writing()
        reader.read()  # server echoes the handle
        writer.close()
        info = client.get_flight_info(desc)
        t = client.do_get(info.endpoints[0].ticket).read_all()
        assert t.column("g").to_pylist() == ["a"]
        assert t.column("v").to_pylist() == [2]

    def test_statement_update_ctas(self, server):
        from ballista_tpu_torch import flightsql as fsql
        srv, endpoint = server
        client = fl.connect(endpoint)
        desc = fl.FlightDescriptor.for_command(fsql.command_statement_update(
            "create table t2 as select g, v from t where v > 1"))
        writer, reader = client.do_put(
            desc, pa.schema([]))
        writer.done_writing()
        buf = reader.read()  # PutResult app_metadata buffer
        assert fsql.parse_do_put_update_result(buf.to_pybytes()) == 2
        writer.close()
        t = flight_query(endpoint, "select count(*) as n from t2")
        assert t.column("n").to_pylist() == [2]


# -- the JAX package's server and the port's on the same tables --

PARITY_SQL = [
    "select g, sum(v) as s, count(*) as c from t group by g order by g",
    "select price, v from t order by v",
    "select * from t where v > 1 order by v",
]
SF = 0.01


@pytest.fixture(scope="module")
def both_servers():
    """(JAX endpoint, port endpoint), each over a context holding `t` and
    the TPC-H tables at SF 0.01 from the same arrow tables."""
    from ballista_tpu.client import SessionContext as JaxContext
    from ballista_tpu.datagen.tpch import TPCH_TABLES, generate_table
    from ballista_tpu.flight import BallistaFlightServer as JaxServer
    t = pa.table({
        "g": pa.array(["a", "a", "b", None]),
        "v": pa.array([1, 2, 3, 4], pa.int64()),
        "price": pa.array([decimal.Decimal("1.50"), decimal.Decimal("2.25"),
                           None, decimal.Decimal("-0.01")],
                          pa.decimal128(10, 2)),
    })
    tables = {n: generate_table(n, SF) for n in TPCH_TABLES}
    servers = []
    for ctx, server in ((JaxContext(capacity_mode="exact"), JaxServer),
                        (SessionContext(), BallistaFlightServer)):
        ctx.register_arrow("t", t)
        for n, table in tables.items():
            ctx.register_arrow(n, table, primary_key=TPCH_TABLES[n][1])
        servers.append(server(ctx=ctx))
    yield [f"grpc://127.0.0.1:{s.port}" for s in servers]
    for s in servers:
        s.shutdown()
        # a Flight server stays reachable from its C++ half after
        # shutdown: drop the context, whose device columns would outlive
        # the module (tests/test_evict.py counts the JAX arrays alive)
        s.ctx.evict_device()
        s.ctx = s.cluster = None


def _tpch(q):
    from ballista_tpu_torch.benchmarks import TPCH_QUERIES
    return TPCH_QUERIES[q]


@pytest.mark.parametrize("sql", PARITY_SQL + [1, 3, 6, 13])
def test_jax_and_port_servers_agree(both_servers, sql):
    sql = _tpch(sql) if isinstance(sql, int) else sql
    jax, port = (flight_query(e, sql) for e in both_servers)
    assert port.schema.names == jax.schema.names
    assert [f.type for f in port.schema] == [f.type for f in jax.schema]
    assert port.to_pylist() == jax.to_pylist()


def test_cluster_server_agrees_with_jax(both_servers):
    """Over the port's standalone cluster (P = 2 CPU partitions), as
    `serve --flight-port` runs it."""
    from ballista_tpu.datagen.tpch import TPCH_TABLES, generate_table
    from ballista_tpu_torch.parallel.mesh import make_mesh
    from ballista_tpu_torch.scheduler.standalone import StandaloneCluster
    ctx = SessionContext()
    for n in ("lineitem",):
        ctx.register_arrow(n, generate_table(n, SF),
                           primary_key=TPCH_TABLES[n][1])
    cluster = StandaloneCluster(ctx, make_mesh(
        2, devices=[torch.device("cpu")] * 2))
    srv = BallistaFlightServer(cluster=cluster)
    try:
        got = flight_query(f"grpc://127.0.0.1:{srv.port}", _tpch(1))
        want = flight_query(both_servers[0], _tpch(1))
        assert got.to_pylist() == want.to_pylist()
        client = fl.connect(f"grpc://127.0.0.1:{srv.port}")
        jobs = json.loads(list(client.do_action(fl.Action("jobs", b"")))[0]
                          .body.to_pybytes())
        assert len(jobs) == 1
    finally:
        srv.shutdown()


def test_serve_flight_port(tmp_path):
    """`python -m ballista_tpu_torch.serve --flight-port N --device cpu`
    answers Flight SQL over its cluster."""
    import os
    import socket
    import subprocess
    import sys
    import time

    def free_port():
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return port

    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ballista_tpu_torch.serve", "--device", "cpu",
         "--host", "127.0.0.1", "--port", str(free_port()),
         "--flight-port", str(port), "--sf-demo", "0.001"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.time() + 60
        while True:
            try:
                t = flight_query(f"grpc://127.0.0.1:{port}",
                                 "select count(*) as n from nation")
                break
            except fl.FlightUnavailableError:
                if time.time() > deadline or proc.poll() is not None:
                    raise
                time.sleep(0.5)
        assert t.column("n").to_pylist() == [25]
    finally:
        proc.kill()
        proc.communicate(timeout=30)
