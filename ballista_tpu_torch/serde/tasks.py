"""Task and job wire format, JSON, for the control plane across processes
(port of ballista_tpu/serde/tasks.py, host only).

Reference parity: ballista.proto's TaskDefinition / TaskStatus /
ExecutorRegistration / JobSpec-shaped messages (`core/proto/ballista.proto`
TaskDefinition:603, TaskStatus:563, ExecutorRegistration:428): the
scheduler ships task assignments to executors and receives status updates
over a wire, not by sharing Python objects. Every envelope carries the
`@wire` version tag (serde/plans.py WIRE_VERSION), so peers of another
version fail with an actionable error instead of deep inside a decode.

A JobSpec is the context of a task: the reference ships a serialized
physical-plan fragment per task; here an executor derives a stage's plan
from the job's logical plan, its DistOptions and the first planning's
broadcast choices (`replay`), so the spec ships once per job and tasks
name it by job_id.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..scheduler.distributed_planner import DistOptions
from ..scheduler.execution_graph import TaskDescription, TaskStatus
from ..scheduler.server import ExecutorMetadata
from .plans import (WIRE_VERSION, check_wire_version, decode_plan,
                    encode_plan)


def _tag(d: dict) -> dict:
    d["@wire"] = WIRE_VERSION
    return d


def _untag(d: dict, what: str) -> dict:
    check_wire_version(d, what)
    return {k: v for k, v in d.items() if k != "@wire"}


def task_to_wire(t: TaskDescription) -> dict:
    return _tag({"job_id": t.job_id, "stage_id": t.stage_id,
                 "partitions": list(t.partitions), "task_id": t.task_id,
                 "executor_id": t.executor_id})


def task_from_wire(d: dict) -> TaskDescription:
    d = _untag(d, "task")
    return TaskDescription(d["job_id"], int(d["stage_id"]),
                           tuple(int(p) for p in d["partitions"]),
                           int(d["task_id"]), d["executor_id"])


def status_to_wire(s: TaskStatus) -> dict:
    return _tag({"task_id": s.task_id, "job_id": s.job_id,
                 "stage_id": s.stage_id, "partitions": list(s.partitions),
                 "executor_id": s.executor_id, "state": s.state,
                 "error": s.error,
                 "failed_input_stage": s.failed_input_stage,
                 "error_kind": s.error_kind, "stats": s.stats,
                 "metrics": s.metrics})


def status_from_wire(d: dict) -> TaskStatus:
    d = _untag(d, "task status")
    return TaskStatus(int(d["task_id"]), d["job_id"], int(d["stage_id"]),
                      tuple(int(p) for p in d["partitions"]),
                      d["executor_id"], d["state"], d.get("error"),
                      failed_input_stage=d.get("failed_input_stage"),
                      error_kind=d.get("error_kind"),
                      stats=d.get("stats"), metrics=d.get("metrics"))


def executor_meta_to_wire(m: ExecutorMetadata) -> dict:
    return _tag({"executor_id": m.executor_id, "host": m.host,
                 "port": m.port, "task_slots": m.task_slots,
                 "devices": m.devices, "data_port": m.data_port})


def executor_meta_from_wire(d: dict) -> ExecutorMetadata:
    d = _untag(d, "executor registration")
    return ExecutorMetadata(d["executor_id"], d.get("host", "localhost"),
                            int(d.get("port", 0)),
                            int(d.get("task_slots", 1)),
                            devices=int(d.get("devices", 0)),
                            data_port=int(d.get("data_port", 0)))


@dataclasses.dataclass
class JobSpec:
    """Everything an executor needs to run any task of a job:
    the logical plan, the data environment, the planner options, and the
    shared exchange location. `version` bumps when the scheduler escalates
    options after a shuffle overflow — executors re-derive their stage
    programs when they observe a newer version (the reference re-ships
    plan fragments per task; the version check is our cheaper analog)."""
    job_id: str
    plan: object                         # logical plan
    tables: dict                         # data environment spec (see below)
    options: DistOptions
    work_dir: str                        # shared object-store URL (exchange)
    version: int = 0
    final_stage: int = 0
    # the scheduler's first planning's choices, {"broadcasts": [bool],
    # "one_rows": [bool]}: an executor replays them, so a job re-planned
    # with escalated options keeps the stages of its ExecutionGraph
    replay: Optional[dict] = None


# Data-environment kinds an executor can materialize by itself. Paths point
# at shared storage all processes can read (the reference equivalently
# assumes a shared object store for scan inputs).
#   {"kind": "tpch", "sf": 0.01}                    deterministic datagen
#   {"kind": "tbl", "dir": "/path"}                 dbgen .tbl directory
#   {"kind": "files", "tables": {name: {"format": "parquet|csv|json|avro",
#                                       "path": "...",
#                                       "primary_key": [...]|null}}}


def jobspec_to_wire(js: JobSpec) -> dict:
    d = {"job_id": js.job_id, "plan": encode_plan(js.plan),
         "tables": js.tables, "options": dataclasses.asdict(js.options),
         "work_dir": js.work_dir, "version": js.version,
         "final_stage": js.final_stage}
    if js.replay is not None:
        d["replay"] = js.replay
    return _tag(d)


def jobspec_from_wire(d: dict) -> JobSpec:
    d = _untag(d, "job spec")
    return JobSpec(d["job_id"], decode_plan(d["plan"]), d["tables"],
                   DistOptions(**d["options"]), d["work_dir"],
                   int(d.get("version", 0)), int(d.get("final_stage", 0)),
                   d.get("replay"))


def build_context(tables: dict, device="cuda"):
    """A SessionContext on `device` from a data-environment spec: the
    executor's half of the scan plane (the reference's executors read scan
    inputs straight from shared storage, executor.rs:184). The device is
    the caller's to name; "cuda" raises without a card."""
    from ..client import SessionContext

    ctx = SessionContext(device=device)
    kind = tables.get("kind")
    if kind == "tpch":
        from ..datagen import register_tpch
        register_tpch(ctx, float(tables["sf"]))
    elif kind == "tbl":
        from ..datagen.tbl import register_tpch_tbl
        register_tpch_tbl(ctx, tables["dir"])
    elif kind == "files":
        for name, spec in tables["tables"].items():
            pk = tuple(spec["primary_key"]) if spec.get("primary_key") \
                else None
            fmt = spec.get("format", "parquet")
            reg = {"parquet": ctx.register_parquet, "csv": ctx.register_csv,
                   "json": ctx.register_json, "avro": ctx.register_avro,
                   "parquet_dataset": ctx.register_parquet_dataset}[fmt]
            reg(name, spec["path"], primary_key=pk)
    else:
        raise ValueError(f"unknown data environment kind {kind!r}")
    return ctx
