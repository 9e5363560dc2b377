"""Arrow Flight endpoint: network SQL + result streaming (port of
ballista_tpu/flight.py over the port's SessionContext and standalone
cluster).

Reference parity (two services in one):
- the scheduler's FlightSQL endpoint (`scheduler/src/flight_sql.rs:80`) —
  clients submit SQL, receive a FlightInfo (schema + endpoints + ticket)
  and stream results with do_get; catalog metadata via list_flights and
  actions. JDBC/ODBC-style access without the Rust FlightSQL statement
  message envelope: commands are UTF-8 SQL or JSON {"query": ...}.
- the executor Flight shuffle/result service (`flight_service.rs:74`) —
  do_get with a job-result ticket streams a finished job's partitions.

The data plane speaks Arrow IPC on the wire (LZ4/ZSTD via pyarrow Flight's
gRPC transport), matching the reference's Flight data path; results come
off the devices exactly once per job (`batch.to_arrow`) and are cached for
ticket fetches. pyarrow is imported when the server's classes are first
used (`_classes`) or a client call is made, so the module imports without
it; `serve --flight-port` raises an ImportError where it is absent.
"""

from __future__ import annotations

import json
import threading
import uuid
from typing import Dict, Optional, Tuple

from . import batch as B


def _bind_params(sql: str, params) -> str:
    """Substitute `?` placeholders with row-0 literals from the bound
    parameter batch (the JDBC FlightSQL driver binds via do_put; the
    engine's parser has no placeholder production, so binding happens at
    the SQL layer — one statement per bound row set)."""
    if params is None or params.num_rows == 0 or "?" not in sql:
        return sql
    vals = [col[0].as_py() for col in params.columns]
    out, vi = [], 0
    in_str = False
    for ch in sql:
        if ch == "'":
            in_str = not in_str
        if ch == "?" and not in_str and vi < len(vals):
            v = vals[vi]
            vi += 1
            if v is None:
                out.append("NULL")
            elif isinstance(v, str):
                out.append("'" + v.replace("'", "''") + "'")
            elif isinstance(v, bool):
                out.append("TRUE" if v else "FALSE")
            else:
                out.append(repr(v))
        else:
            out.append(ch)
    return "".join(out)


def _sql_of(command: bytes) -> str:
    text = command.decode("utf-8", errors="replace")
    try:
        obj = json.loads(text)
        if isinstance(obj, dict) and "query" in obj:
            return obj["query"]
    except (json.JSONDecodeError, UnicodeDecodeError):
        pass
    return text


def _classes() -> dict:
    """The server's classes, made at first use: their bases come from
    pyarrow.flight, which is imported here and nowhere at module level,
    so the module imports where pyarrow is absent."""
    global _CLASSES
    if _CLASSES is None:
        import pyarrow as pa
        import pyarrow.flight as fl

        class _BearerAuthHandler(fl.ServerAuthHandler):
            """Handshake issues a bearer token for valid BasicAuth credentials
            (flight_sql.rs:80 handshake/bearer parity)."""

            def __init__(self, user: str, password: str):
                super().__init__()
                self._user = user
                self._password = password
                self._tokens: set = set()

            def authenticate(self, outgoing, incoming):
                auth = fl.BasicAuth.deserialize(incoming.read())
                if (auth.username.decode() != self._user
                        or auth.password.decode() != self._password):
                    raise fl.FlightUnauthenticatedError("bad credentials")
                token = uuid.uuid4().hex.encode()
                self._tokens.add(token)
                outgoing.write(token)

            def is_valid(self, token):
                if token in self._tokens:
                    return token
                raise fl.FlightUnauthenticatedError("invalid or missing token")


        class BallistaFlightServer(fl.FlightServerBase):
            """Flight front door over a SessionContext or StandaloneCluster.

            Flow (FlightSQL-style):
              info = client.get_flight_info(FlightDescriptor.for_command(sql))
              reader = client.do_get(info.endpoints[0].ticket)     # Arrow stream
            One-shot: client.do_get(Ticket(sql)) also works (DistributedQueryExec
            fetch-with-inline-plan analog).
            """

            def __init__(self, ctx=None, cluster=None,
                         location: str = "grpc://127.0.0.1:0",
                         auth: Optional[Tuple[str, str]] = None):
                """`auth=(user, password)`: enable the handshake/bearer-token flow
                (flight_sql.rs:80 issues bearer tokens the same way); None = open."""
                handler = _BearerAuthHandler(*auth) if auth is not None else None
                super().__init__(location, auth_handler=handler)
                if ctx is None and cluster is None:
                    raise ValueError("need a SessionContext or StandaloneCluster")
                self.cluster = cluster
                self.ctx = ctx if ctx is not None else cluster.ctx
                self._results: Dict[str, pa.Table] = {}
                # prepared-statement registry: handle -> SQL (flight_sql.rs
                # statement lifecycle; created/closed via do_action); bound
                # parameter batches arrive via do_put (JDBC setX + execute)
                self._prepared: Dict[bytes, str] = {}
                self._params: Dict[bytes, pa.Table] = {}
                self._lock = threading.Lock()

            # -- execution --

            def _run_sql(self, sql: str) -> pa.Table:
                if self.cluster is not None:
                    job_id = self.cluster.submit_sql(sql)
                    batch, schema = self.cluster.wait(job_id)
                else:
                    batch, schema = self.ctx.sql(sql).collect()
                return B.to_arrow(batch, schema)

            # -- FlightSQL protocol dispatch (flightsql.py wire helpers) --

            @staticmethod
            def _like(pattern: Optional[str], value: str) -> bool:
                """SQL LIKE filter-pattern match (FlightSQL catalog filters use
                `%`/`_` wildcards; flight_sql.rs:702-741 tables_impl parity)."""
                if pattern is None:
                    return True
                import fnmatch
                return fnmatch.fnmatchcase(
                    value, pattern.replace("%", "*").replace("_", "?"))

            def _catalog_tables(self, payload: bytes) -> pa.Table:
                """CommandGetTables result (FlightSQL GetTables schema incl. the
                optional `table_schema` column of IPC-serialized Arrow schemas —
                flight_sql.rs:702-770)."""
                from . import flightsql as fsql
                req = fsql.parse_get_tables(payload)
                names = [n for n in sorted(self.ctx.tables)
                         if self._like(req["table_name_filter"], n)
                         and self._like(req["db_schema_filter"], "public")
                         and (req["catalog"] in (None, "", "ballista"))
                         and (not req["table_types"] or "TABLE" in req["table_types"])]
                cols = {
                    "catalog_name": pa.array(["ballista"] * len(names)),
                    "db_schema_name": pa.array(["public"] * len(names)),
                    "table_name": pa.array(names),
                    "table_type": pa.array(["TABLE"] * len(names)),
                }
                if req["include_schema"]:
                    cols["table_schema"] = pa.array(
                        [B.schema_to_arrow(self.ctx.tables[n].schema)
                         .serialize().to_pybytes() for n in names], type=pa.binary())
                return pa.table(cols)

            def _sql_info(self, payload: bytes) -> pa.Table:
                """CommandGetSqlInfo result: uint32 info id -> dense-union value
                (FlightSql.proto GetSqlInfo schema; flight_sql.rs:644-664)."""
                from . import flightsql as fsql
                from . import __version__ as _ver
                infos = {  # FlightSql.proto SqlInfo enum ids
                    0: "ballista-tpu-torch",    # FLIGHT_SQL_SERVER_NAME
                    1: _ver,                    # FLIGHT_SQL_SERVER_VERSION
                    2: pa.__version__,          # FLIGHT_SQL_SERVER_ARROW_VERSION
                    3: True,                    # FLIGHT_SQL_SERVER_READ_ONLY
                }
                want = fsql.parse_get_sql_info(payload) or tuple(sorted(infos))
                ids, types, offsets, svals, bvals = [], [], [], [], []
                for i in want:
                    if i not in infos:
                        continue
                    v = infos[i]
                    ids.append(i)
                    if isinstance(v, bool):
                        types.append(1)
                        offsets.append(len(bvals))
                        bvals.append(v)
                    else:
                        types.append(0)
                        offsets.append(len(svals))
                        svals.append(str(v))
                value = pa.UnionArray.from_dense(
                    pa.array(types, pa.int8()), pa.array(offsets, pa.int32()),
                    [pa.array(svals, pa.string()), pa.array(bvals, pa.bool_())],
                    ["string_value", "bool_value"], [0, 1])
                return pa.table({"info_name": pa.array(ids, pa.uint32()),
                                 "value": value})

            _KEYS_SCHEMA = pa.schema([
                ("catalog_name", pa.string()), ("db_schema_name", pa.string()),
                ("table_name", pa.string()), ("column_name", pa.string()),
                ("key_name", pa.string()), ("key_sequence", pa.int32())])

            def _flightsql_table(self, kind: str, payload: bytes) -> Optional[pa.Table]:
                from . import flightsql as fsql
                if kind == "CommandStatementQuery":
                    return self._run_sql(fsql.parse_statement_query(payload))
                if kind == "CommandPreparedStatementQuery":
                    handle = fsql.parse_prepared_query(payload)
                    with self._lock:
                        sql = self._prepared.get(handle)
                        params = self._params.get(handle)
                    if sql is None:
                        raise fl.FlightServerError("unknown prepared statement")
                    return self._run_sql(_bind_params(sql, params))
                if kind == "CommandGetTables":
                    return self._catalog_tables(payload)
                if kind == "CommandGetCatalogs":
                    return pa.table({"catalog_name": pa.array(["ballista"])})
                if kind == "CommandGetDbSchemas":
                    req = fsql.parse_get_db_schemas(payload)
                    keep = (self._like(req["db_schema_filter"], "public")
                            and req["catalog"] in (None, "", "ballista"))
                    n = 1 if keep else 0
                    return pa.table({"catalog_name": pa.array(["ballista"] * n),
                                     "db_schema_name": pa.array(["public"] * n)})
                if kind == "CommandGetTableTypes":
                    return pa.table({"table_type": pa.array(["TABLE"])})
                if kind == "CommandGetSqlInfo":
                    return self._sql_info(payload)
                if kind in ("CommandGetPrimaryKeys", "CommandGetImportedKeys",
                            "CommandGetExportedKeys"):
                    # no constraint metadata in the engine: empty result with the
                    # spec schema (what flight_sql.rs returns for tables without
                    # key metadata)
                    return self._KEYS_SCHEMA.empty_table()
                return None

            # -- Flight verbs --

            def get_flight_info(self, context, descriptor):
                from . import flightsql as fsql
                table = None
                any_msg = fsql.unpack_any(descriptor.command)
                if any_msg is not None:
                    table = self._flightsql_table(*any_msg)
                if table is None:
                    table = self._run_sql(_sql_of(descriptor.command))
                ticket_id = uuid.uuid4().hex
                with self._lock:
                    self._results[ticket_id] = table
                if any_msg is not None:
                    ticket_bytes = fsql.ticket_statement_query(ticket_id.encode())
                else:
                    ticket_bytes = json.dumps({"ticket": ticket_id}).encode()
                endpoint = fl.FlightEndpoint(ticket_bytes, [])
                return fl.FlightInfo(table.schema, descriptor, [endpoint],
                                     table.num_rows, table.nbytes)

            def do_get(self, context, ticket):
                from . import flightsql as fsql
                raw = ticket.ticket
                any_msg = fsql.unpack_any(raw)
                if any_msg is not None:
                    kind, payload = any_msg
                    if kind == "TicketStatementQuery":
                        tid = fsql.parse_ticket_statement(payload).decode()
                        with self._lock:
                            table = self._results.pop(tid, None)
                        if table is None:
                            raise fl.FlightServerError(
                                "unknown or already-fetched ticket")
                        return fl.RecordBatchStream(table)
                    table = self._flightsql_table(kind, payload)
                    if table is not None:
                        return fl.RecordBatchStream(table)
                    raise fl.FlightServerError(f"unsupported FlightSQL ticket {kind}")
                try:
                    obj = json.loads(raw.decode("utf-8"))
                except (json.JSONDecodeError, UnicodeDecodeError):
                    obj = None
                if isinstance(obj, dict) and "ticket" in obj:
                    with self._lock:
                        table = self._results.pop(obj["ticket"], None)
                    if table is None:
                        raise fl.FlightServerError("unknown or already-fetched ticket")
                else:
                    table = self._run_sql(_sql_of(raw))
                return fl.RecordBatchStream(table)

            def do_put(self, context, descriptor, reader, writer):
                """FlightSQL do_put: prepared-statement parameter binding
                (CommandPreparedStatementQuery — JDBC setX), and statement
                updates (CommandStatementUpdate / CommandPreparedStatementUpdate
                run DDL/CTAS and return a DoPutUpdateResult; flight_sql.rs
                do_put_* handlers :820-935)."""
                from . import flightsql as fsql
                any_msg = fsql.unpack_any(descriptor.command)
                if any_msg is None:
                    raise fl.FlightServerError("do_put requires a FlightSQL command")
                kind, payload = any_msg
                if kind == "CommandPreparedStatementQuery":
                    handle = fsql.parse_prepared_query(payload)
                    table = reader.read_all()
                    with self._lock:
                        if handle not in self._prepared:
                            raise fl.FlightServerError("unknown prepared statement")
                        self._params[handle] = table
                    # echo the (possibly server-rewritten) handle back, per spec
                    writer.write(fsql.prepared_statement_result(handle))
                    return
                if kind in ("CommandStatementUpdate", "CommandPreparedStatementUpdate"):
                    if kind == "CommandStatementUpdate":
                        sql = fsql.parse_statement_update(payload)
                    else:
                        handle = fsql.parse_prepared_query(payload)
                        with self._lock:
                            sql = self._prepared.get(handle)
                        params = reader.read_all()
                        if params.num_rows:
                            sql = _bind_params(sql, params)
                        if sql is None:
                            raise fl.FlightServerError("unknown prepared statement")
                    before = {n: tp.num_rows for n, tp in self.ctx.tables.items()}
                    try:
                        self.ctx.sql(sql)
                    except ValueError as e:
                        # DDL-only scripts legitimately produce no SELECT result
                        if "no SELECT statement" not in str(e):
                            raise
                    # affected-row count: rows of tables created/changed by the DDL
                    changed = sum(tp.num_rows for n, tp in self.ctx.tables.items()
                                  if before.get(n) != tp.num_rows)
                    writer.write(fsql.do_put_update_result(changed))
                    return
                raise fl.FlightServerError(f"unsupported do_put command {kind}")

            def list_flights(self, context, criteria):
                for name, tp in self.ctx.tables.items():
                    desc = fl.FlightDescriptor.for_path(name)
                    schema = B.schema_to_arrow(tp.schema)
                    endpoint = fl.FlightEndpoint(
                        json.dumps({"query": f"select * from {name}"}).encode(), [])
                    yield fl.FlightInfo(schema, desc, [endpoint], tp.num_rows, -1)

            def list_actions(self, context):
                return [("explain", "logical plan for a SQL string"),
                        ("jobs", "job list (standalone cluster only)"),
                        ("CreatePreparedStatement", "FlightSQL prepared statement"),
                        ("ClosePreparedStatement", "FlightSQL prepared statement")]

            def do_action(self, context, action):
                from . import flightsql as fsql
                if action.type == "CreatePreparedStatement":
                    # body: Any-wrapped ActionCreatePreparedStatementRequest
                    # {1: query}; result: Any-wrapped ...Result {1: handle}
                    raw = action.body.to_pybytes()
                    any_msg = fsql.unpack_any(raw)
                    sql = (fsql.parse_statement_query(any_msg[1])
                           if any_msg is not None else _sql_of(raw))
                    handle = uuid.uuid4().hex.encode()
                    with self._lock:
                        self._prepared[handle] = sql
                    yield fsql.prepared_statement_result(handle)
                    return
                if action.type == "ClosePreparedStatement":
                    raw = action.body.to_pybytes()
                    any_msg = fsql.unpack_any(raw)
                    handle = (fsql.parse_prepared_query(any_msg[1])
                              if any_msg is not None else raw)
                    with self._lock:
                        self._prepared.pop(handle, None)
                    return
                if action.type == "explain":
                    sql = _sql_of(action.body.to_pybytes())
                    plan = self.ctx.sql(sql).plan
                    yield plan.display().encode()
                elif action.type == "jobs":
                    if self.cluster is None:
                        yield b"[]"
                    else:
                        sched = self.cluster.scheduler
                        jobs = [sched.job_status(jid)
                                for jid in sched.task_manager.jobs]
                        yield json.dumps(jobs).encode()
                else:
                    raise fl.FlightServerError(f"unknown action {action.type!r}")

        _CLASSES = {"_BearerAuthHandler": _BearerAuthHandler,
                    "BallistaFlightServer": BallistaFlightServer}
    return _CLASSES


_CLASSES = None


def __getattr__(name: str):
    # `from ballista_tpu_torch.flight import BallistaFlightServer` builds
    # the classes (and imports pyarrow) then
    if name in ("BallistaFlightServer", "_BearerAuthHandler"):
        return _classes()[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def flight_query(endpoint: str, sql: str):
    """Client helper: submit SQL over Flight, return the Arrow result
    (FlightSQL handshake + fetch in one call)."""
    import pyarrow.flight as fl
    client = fl.connect(endpoint)
    info = client.get_flight_info(
        fl.FlightDescriptor.for_command(sql.encode()))
    return client.do_get(info.endpoints[0].ticket).read_all()
