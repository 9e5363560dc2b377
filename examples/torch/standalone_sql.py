"""Standalone-cluster example on the PyTorch/CUDA port (twin of
examples/standalone_sql.py; reference: examples/src/bin/standalone-sql.rs).

Runs SQL through the full control plane (scheduler, ExecutionGraph, mesh
task launcher) in one process over a mesh of partitions: on CUDA one per
visible card unless `partitions` says otherwise, on the CPU `partitions`
of them (default 1). `main` prints the result as a table and the job's
status, and returns (rows, status).
Run:  PYTHONPATH=. python examples/torch/standalone_sql.py \
          [--device cuda|cpu] [--partitions N]
"""

import argparse
import json

import torch

from ballista_tpu_torch.cli import format_rows
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import register_tpch
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
from ballista_tpu_torch.scheduler.standalone import StandaloneCluster


def main(device="cuda", partitions=None):
    ctx = SessionContext(device=device)
    register_tpch(ctx, 0.01)

    if partitions is None and torch.device(device).type == "cuda":
        mesh = make_mesh()
    else:
        mesh = make_mesh(devices=[torch.device(device)] * (partitions or 1))
    n = len(mesh)
    cluster = StandaloneCluster(ctx, mesh, DistOptions(n_partitions=n))

    batch, schema = cluster.collect_sql(
        "select l_returnflag, l_linestatus, sum(l_quantity) as sum_qty, "
        "count(*) as count_order from lineitem "
        "where l_shipdate <= date '1998-09-02' "
        "group by l_returnflag, l_linestatus "
        "order by l_returnflag, l_linestatus")
    status = cluster.job_status(list(cluster.launcher.jobs)[-1])
    print(format_rows(batch, schema), end="")
    print(status)
    return ([json.loads(line) for line in
             format_rows(batch, schema, "json").splitlines()], status)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--partitions", type=int, default=None)
    args = ap.parse_args()
    main(args.device, args.partitions)
