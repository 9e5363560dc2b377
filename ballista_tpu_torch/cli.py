"""Interactive SQL REPL (port of ballista_tpu/cli.py).

Reference parity: `ballista-cli` (a datafusion-cli-based REPL with meta
commands). Same command surface:

  \\q                quit            \\?                help
  \\d                list tables     \\d <table>        describe table
  \\timing on|off    toggle timing   \\pset format ...  output format
  \\set key value    session config  \\explain <sql>    show plans
  \\h                list functions  \\h <pattern>      search functions
  \\quiet on|off     quiet mode

Run:  python -m ballista_tpu_torch.cli [--sf F] [--parquet DIR] [--csv DIR]
      [--distributed] [-c SQL | -f script.sql] [--format table|csv|json]
      [--quiet]

It runs on the CUDA device (`--distributed`: one partition per visible
CUDA device). `--connect URL` sends each query to a scheduler's RPC wire
(`scheduler/rpc.py`; its executor processes run it) over the data
environment named by `--sf` or `--parquet`. Results print through the
port's own formatter, which needs no pandas. `--plugin-dir` loads the UDF
plugin modules of a directory (`plugin.py`) into the local session.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import batch as B
from .schema import TypeKind

HELP = __doc__.split("Run:")[0]


def _remote_tables_spec(args) -> dict:
    """The data-environment spec of the CLI's data flags (serde/tasks)."""
    if args.sf:
        return {"kind": "tpch", "sf": args.sf}
    if args.parquet:
        import glob
        import os
        tables = {}
        for path in sorted(glob.glob(os.path.join(args.parquet,
                                                  "*.parquet"))):
            name = os.path.splitext(os.path.basename(path))[0]
            tables[name] = {"format": "parquet", "path": os.path.abspath(path),
                            "primary_key": None}
        for d in sorted(glob.glob(os.path.join(args.parquet, "*/"))):
            name = os.path.basename(d.rstrip("/"))
            tables[name] = {"format": "parquet_dataset",
                            "path": os.path.abspath(d), "primary_key": None}
        return {"kind": "files", "tables": tables}
    raise SystemExit("--connect needs a data environment: --sf or --parquet")


class RemoteSession:
    """A SessionContext-shaped adapter over the scheduler's RPC wire
    (BallistaContext::remote, ballista-cli --host/--port parity): SQL is
    parsed and planned on the client against the named data environment
    (a context on `device`), ships as a serialized plan, and the result
    comes back as a stage blob."""

    def __init__(self, url: str, tables_spec: dict, device="cuda"):
        from .scheduler.rpc import SchedulerRpcClient
        from .serde.tasks import build_context
        self.client = SchedulerRpcClient(url, device=device)
        self.tables_spec = tables_spec
        self._local = build_context(tables_spec, device)  # for planning
        self.options = {}
        self.config = None

    @property
    def tables(self):
        return self._local.tables

    @property
    def views(self):
        return self._local.views

    def sql(self, query: str):
        session = self

        class _RemoteDF:
            def __init__(self):
                # plan at once, so \explain and errors surface locally
                self.plan = session._local.sql(query).plan

            def collect(self):
                job_id = session.client.submit_sql(
                    query, session.tables_spec, options=session.options,
                    ctx=session._local)
                return session.client.wait_batch(job_id)

        return _RemoteDF()

    def set_config(self, config) -> None:
        self._local.set_config(config)
        self.config = config

    def take_warnings(self):
        return self._local.take_warnings()


def _cell(value, valid: bool, dtype) -> str:
    """One value as text: decimals exact, dates ISO, NULL as NULL."""
    if not valid:
        return "NULL"
    if dtype.kind is TypeKind.DECIMAL:
        v = int(value)
        if dtype.scale == 0:
            return str(v)
        sign, v = ("-" if v < 0 else ""), abs(v)
        q, r = divmod(v, 10 ** dtype.scale)
        return f"{sign}{q}.{r:0{dtype.scale}d}"
    if dtype.kind is TypeKind.DATE32:
        return str(np.datetime64(int(value), "D"))
    if dtype.kind is TypeKind.BOOL:
        return "true" if value else "false"
    if dtype.kind in (TypeKind.FLOAT32, TypeKind.FLOAT64):
        return repr(float(value))
    return str(value)


def format_rows(batch, schema, fmt: str = "table") -> str:
    """A result's live rows as text: an aligned table, csv or json lines
    (one object per row)."""
    raw = B.to_numpy(batch, schema)
    names = [f.name for f in schema.fields]
    cols = [[_cell(v, ok, f.dtype) for v, ok in zip(*raw[f.name])]
            for f in schema.fields]
    rows = list(zip(*cols)) if cols else []
    if fmt == "csv":
        def quote(s):
            return f'"{s}"' if any(c in s for c in ',"\n') else s
        lines = [",".join(names)] + [
            ",".join(quote(c.replace('"', '""')) for c in r) for r in rows]
        return "\n".join(lines) + "\n"
    if fmt == "json":
        numeric = [f.dtype.kind not in (TypeKind.STRING, TypeKind.DATE32)
                   for f in schema.fields]
        lines = []
        for r in rows:
            items = [f"{json.dumps(n)}:"
                     + ("null" if c == "NULL" else c if num and c not in
                        ("nan", "inf", "-inf") else json.dumps(c))
                     for n, c, num in zip(names, r, numeric)]
            lines.append("{" + ",".join(items) + "}")
        return "\n".join(lines) + ("\n" if lines else "")
    widths = [max([len(n)] + [len(c) for c in col])
              for n, col in zip(names, cols)]
    lines = [" ".join(n.rjust(w) for n, w in zip(names, widths))]
    lines += [" ".join(c.rjust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join(lines) + "\n"


class Repl:
    def __init__(self, ctx, distributed: bool = False, mesh=None):
        self.ctx = ctx
        self.distributed = distributed
        self.mesh = mesh
        self.timing = True
        self.fmt = "table"
        self.quiet = False

    def execute_sql(self, sql: str):
        t0 = time.time()
        # distributed mode is handled inside the context (standalone cluster)
        try:
            batch, schema = self.ctx.sql(sql).collect()
        except ValueError as e:
            if "no SELECT statement" in str(e):
                return  # DDL-only statement (CREATE TABLE/VIEW, DROP, ...)
            raise
        elapsed = time.time() - t0
        if not self.quiet:
            print(format_rows(batch, schema, self.fmt), end="")
        for w in self.ctx.take_warnings():
            print(f"WARNING: {w}", file=sys.stderr)
        if self.timing and not self.quiet:
            print(f"{int(batch.num_rows)} row(s) in {elapsed:.3f}s")

    def handle_meta(self, line: str) -> bool:
        """Returns False to quit."""
        parts = line.split()
        cmd = parts[0]
        if cmd in ("\\q", "\\quit"):
            return False
        if cmd == "\\?":
            print(HELP)
        elif cmd == "\\d":
            if len(parts) == 1:
                for name in sorted(self.ctx.tables):
                    print(f"{name}  ({self.ctx.tables[name].num_rows} rows)")
                for name in sorted(self.ctx.views):
                    print(f"{name}  (view)")
            else:
                tp = self.ctx.tables.get(parts[1])
                if tp is None:
                    print(f"no such table: {parts[1]}")
                else:
                    for f in tp.schema.fields:
                        print(f"  {f.name}: {f.dtype!r}"
                              f"{'' if f.nullable else ' not null'}")
        elif cmd == "\\timing":
            self.timing = len(parts) < 2 or parts[1] == "on"
            print(f"timing {'on' if self.timing else 'off'}")
        elif cmd == "\\quiet":
            # QuietMode (ballista-cli command.rs:36)
            self.quiet = len(parts) < 2 or parts[1] == "on"
            print(f"quiet {'on' if self.quiet else 'off'}")
        elif cmd == "\\h":
            # ListFunctions / SearchFunctions (command.rs:36)
            from .functions import list_functions, search_functions
            fns = (search_functions(parts[1]) if len(parts) > 1
                   else list_functions())
            for f in fns:
                print(f"  {f.signature:55s} [{f.kind}] {f.description}")
        elif cmd == "\\pset":
            if len(parts) >= 3 and parts[1] == "format":
                self.fmt = parts[2]
        elif cmd == "\\set":
            # session config (BallistaConfig surface)
            from .config import BallistaConfig
            cfg = self.ctx.config or BallistaConfig()
            try:
                cfg.set(parts[1], parts[2])
                self.ctx.set_config(cfg)
                print(f"{parts[1]} = {parts[2]}")
            except (KeyError, NotImplementedError) as e:
                print(e)
        elif cmd == "\\explain":
            sql = line[len("\\explain"):].strip()
            df_api = self.ctx.sql(sql)
            print("Logical plan:")
            print(df_api.plan.display())
            if self.distributed:
                from .scheduler.distributed_planner import (DistOptions,
                                                            DistributedPlanner)
                n = len(self.mesh) if self.mesh else 8
                dp = DistributedPlanner(self.ctx, DistOptions(n_partitions=n))
                print("Distributed stages:")
                print(dp.plan(df_api.plan).display())
        else:
            print(f"unknown command {cmd}; try \\?")
        return True

    def run(self):
        buf = []
        while True:
            try:
                prompt = "ballista> " if not buf else "      -> "
                line = input(prompt)
            except (EOFError, KeyboardInterrupt):
                print()
                break
            if not line.strip():
                continue
            if line.strip().startswith("\\") and not buf:
                if not self.handle_meta(line.strip()):
                    break
                continue
            buf.append(line)
            if line.rstrip().endswith(";"):
                sql = "\n".join(buf)
                buf = []
                try:
                    self.execute_sql(sql)
                except Exception as e:  # noqa: BLE001 - REPL survives errors
                    print(f"Error: {type(e).__name__}: {e}")


def _parser(device="cuda"):
    ap = argparse.ArgumentParser(description="ballista_tpu_torch SQL REPL")
    ap.add_argument("--sf", type=float, default=None,
                    help="generate + register TPC-H data at this scale factor")
    ap.add_argument("--parquet", default=None,
                    help="register every parquet file in DIR as a table")
    ap.add_argument("--csv", default=None,
                    help="register every csv file in DIR as a table")
    ap.add_argument("--distributed", action="store_true",
                    help="execute over the mesh (one partition per device)")
    ap.add_argument("-c", "--command", default=None,
                    help="run one SQL command and exit")
    ap.add_argument("-f", "--file", default=None,
                    help="execute a SQL script file and exit "
                    "(';'-separated statements)")
    ap.add_argument("--plugin-dir", default=None,
                    help="load UDF plugin modules from this directory")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress result output (timing-only runs)")
    ap.add_argument("--format", default="table",
                    choices=["table", "csv", "json"])
    ap.add_argument("--connect", default=None, metavar="URL",
                    help="execute against a remote scheduler RPC service "
                    "(needs --sf or --parquet)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=device,
                    help="the device of the session (with --connect: of "
                    "the planning context)")
    return ap


def main(argv=None, device="cuda", mesh=None):
    """The command line. `device` is `--device`'s default (cuda) and
    `mesh` is for callers that run it in process (the CPU tests pass
    device="cpu" and a CPU mesh)."""
    args = _parser(device).parse_args(argv)
    device = args.device

    if args.connect:
        repl = Repl(RemoteSession(args.connect, _remote_tables_spec(args),
                                  device))
        repl.fmt = args.format
        repl.quiet = args.quiet
        if args.command:
            repl.execute_sql(args.command)
            return
        print(f"ballista_tpu_torch SQL REPL connected to {args.connect}")
        repl.run()
        return
    from .client import SessionContext
    if args.distributed and mesh is None:
        from .parallel.mesh import context_mesh
        mesh = context_mesh(device)
    ctx = SessionContext(device=device, distributed=args.distributed,
                         mesh=mesh)
    if args.sf:
        from .datagen import register_tpch
        print(f"generating TPC-H SF{args.sf} ...", file=sys.stderr)
        register_tpch(ctx, args.sf)
    for flag, ext, register in ((args.parquet, "parquet",
                                 ctx.register_parquet),
                                (args.csv, "csv", ctx.register_csv)):
        if flag:
            import glob
            import os
            for path in sorted(glob.glob(os.path.join(flag, f"*.{ext}"))):
                name = os.path.splitext(os.path.basename(path))[0]
                register(name, path)
                print(f"registered {name}", file=sys.stderr)
    if args.plugin_dir:
        loaded = ctx.load_plugins(args.plugin_dir)
        print(f"loaded plugins: {', '.join(loaded) or '(none)'}",
              file=sys.stderr)

    repl = Repl(ctx, args.distributed, mesh)
    repl.fmt = args.format
    repl.quiet = args.quiet
    if args.command:
        repl.execute_sql(args.command)
        return
    if args.file:
        # exec.rs file-execution parity: run each ';'-terminated statement
        with open(args.file) as fh:
            script = fh.read()
        for stmt in [s.strip() for s in script.split(";") if s.strip()]:
            repl.execute_sql(stmt)
        return
    print("ballista_tpu_torch SQL REPL — \\? for help, \\q to quit")
    repl.run()


if __name__ == "__main__":
    main()
