"""Server entry point: scheduler, partitioned executor and REST/UI in one
process, and optionally the scheduler's RPC wire for executor processes
(port of ballista_tpu/serve.py; the deployment unit — `scheduler_process.rs:49`
serves gRPC and REST on one port the same way; here the controller also owns
the data plane of its own executor, single controller).

  python -m ballista_tpu_torch.serve --port 8080 [--device cuda|cpu] \
      [--init init.sql] [--sf-demo 0.01] [--work-dir /data/spill] \
      [--policy push|pull] [--job-store /data/jobs.db] \
      [--scheduler-rpc-port 50050] [--flight-port 8815]

Executor processes (`python -m ballista_tpu_torch.scheduler.executor_process
--scheduler http://HOST:RPC_PORT --device cuda --partitions N`) register
with the RPC wire. `--flight-port N` serves Arrow Flight SQL (`flight.py`,
what JDBC / ODBC and BI clients speak) over the cluster. It needs pyarrow,
so the port defaults it to 0 where the reference serves 8815: a machine
without pyarrow runs the rest, and asking for Flight there raises an
ImportError before any socket opens.
"""

from __future__ import annotations

import argparse
import logging
import time


def _parser():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080, help="REST/UI port")
    ap.add_argument("--flight-port", type=int, default=0,
                    help="Arrow Flight SQL port (0 disables; needs pyarrow)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of the in-process executor's partitions "
                         "and of the planning contexts")
    ap.add_argument("--init", default=None,
                    help="SQL script run at startup (CREATE EXTERNAL TABLE …)")
    ap.add_argument("--sf-demo", type=float, default=None,
                    help="register generated TPC-H tables at this scale")
    ap.add_argument("--partitions", type=int, default=None,
                    help="shuffle partitions, all on --device (default: one "
                         "per visible device)")
    ap.add_argument("--policy", choices=("push", "pull"), default="push")
    ap.add_argument("--work-dir", default=None, help="stage-spill directory")
    ap.add_argument("--job-store", default=None,
                    help="sqlite path for HA job state (recovers on restart)")
    ap.add_argument("--task-slots", type=int, default=4)
    ap.add_argument("--scheduler-rpc-port", type=int, default=0,
                    help="serve the cross-process scheduler RPC wire on "
                         "this port (0 disables): executor_process workers "
                         "register here (ballista-scheduler binary parity); "
                         "requires --work-dir for the shuffle object store")
    ap.add_argument("--log-file", default=None,
                    help="rolling log file (executor_process.rs rolling "
                         "appender parity)")
    ap.add_argument("--log-rotation", default="daily",
                    choices=("minutely", "hourly", "daily", "never"),
                    help="log rotation policy (LogRotationPolicy parity)")
    ap.add_argument("--log-level", default="info",
                    help="level, optionally per module: "
                         "'info,ballista_tpu_torch.scheduler=debug'")
    return ap


def main(argv=None):
    args = _parser().parse_args(argv)
    if args.flight_port:
        try:
            import pyarrow.flight  # noqa: F401
        except ImportError as e:
            raise ImportError("serve --flight-port needs pyarrow (with "
                              "pyarrow.flight), which is not installed; "
                              "run without --flight-port") from e

    handlers = None
    if args.log_file:
        from logging.handlers import TimedRotatingFileHandler
        when = {"minutely": "M", "hourly": "H", "daily": "D",
                "never": "midnight"}[args.log_rotation]
        fh = TimedRotatingFileHandler(
            args.log_file, when=when,
            backupCount=0 if args.log_rotation == "never" else 7)
        handlers = [fh, logging.StreamHandler()]
    parts = [p.strip() for p in args.log_level.split(",") if p.strip()]
    root_level = (parts[0] if parts and "=" not in parts[0] else "info")
    logging.basicConfig(
        level=getattr(logging, root_level.upper(), logging.INFO),
        handlers=handlers,
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
    for p in parts:
        if "=" in p:  # per-module level, executor_config_spec.toml:123-132
            mod, lvl = p.split("=", 1)
            logging.getLogger(mod).setLevel(
                getattr(logging, lvl.upper(), logging.INFO))

    import torch

    from .api import ApiServer
    from .client import SessionContext
    from .parallel.mesh import make_mesh
    from .scheduler.distributed_planner import DistOptions
    from .scheduler.standalone import StandaloneCluster

    ctx = SessionContext(device=args.device)
    if args.sf_demo:
        from .datagen import register_tpch
        register_tpch(ctx, args.sf_demo)
    if args.init:
        with open(args.init) as f:
            for stmt in f.read().split(";"):
                if stmt.strip():
                    ctx.sql(stmt)

    mesh = options = None
    if args.partitions:
        mesh = make_mesh(args.partitions, devices=[torch.device(
            args.device)] * args.partitions)
        options = DistOptions(n_partitions=args.partitions)
    cluster = StandaloneCluster(ctx, mesh, options=options,
                                task_slots=args.task_slots,
                                work_dir=args.work_dir, policy=args.policy)
    if args.job_store:
        from .scheduler.kv import KeyValueJobStore, SqliteKeyValueStore
        if args.job_store.startswith(("http://", "https://")):
            # shared KV service (etcd-deployment analog, kv_remote.py):
            # N schedulers point at one store for HA takeover
            from .scheduler.kv_remote import RemoteKeyValueStore
            backend = RemoteKeyValueStore(args.job_store)
        else:
            backend = SqliteKeyValueStore(args.job_store)
        cluster.scheduler.job_store = KeyValueJobStore(backend)
        recovered = cluster.scheduler.recover_jobs()
        if recovered:
            logging.info("recovered jobs: %s", recovered)

    api = ApiServer(cluster, host=args.host, port=args.port).start()
    logging.info("REST/UI on http://%s:%d/", args.host, api.port)

    rpc_httpd = None
    if args.scheduler_rpc_port:
        import os
        import tempfile
        import threading

        from .scheduler.rpc import serve_scheduler
        _svc, rpc_httpd = serve_scheduler(
            args.work_dir or os.path.join(tempfile.gettempdir(),
                                          "ballista_shuffle"),
            host=args.host, port=args.scheduler_rpc_port,
            job_store=cluster.scheduler.job_store,
            policy=args.policy, device=args.device)
        threading.Thread(target=rpc_httpd.serve_forever,
                         daemon=True).start()
        logging.info("scheduler RPC wire on http://%s:%d/rpc/*", args.host,
                     rpc_httpd.server_address[1])

    flight = None
    if args.flight_port:
        from .flight import BallistaFlightServer
        flight = BallistaFlightServer(
            cluster=cluster,
            location=f"grpc://{args.host}:{args.flight_port}")
        logging.info("Flight SQL on grpc://%s:%d", args.host, flight.port)

    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        logging.info("shutting down")
        api.stop()
        if rpc_httpd is not None:
            rpc_httpd.shutdown()
        if flight is not None:
            flight.shutdown()


if __name__ == "__main__":
    main()
