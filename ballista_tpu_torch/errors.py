"""Error taxonomy: classified, wire-encodable failure causes.

Reference parity: `BallistaError` (core/src/error.rs:44) and the proto
`ExecutionError` tree (ballista.proto:603) that travels inside failed
TaskStatus messages so the scheduler can distinguish retryable failures
(IoError-style launch/infra problems, FetchFailed) from permanent ones
(planning errors, NotImplemented, resource exhaustion after retries).
The engine raises ordinary Python exceptions inside operators;
`classify()` folds them into this taxonomy at the task boundary and
`to_dict`/`from_dict` round-trip it through job stores and status wires.
(The port's own copy of ballista_tpu/errors.py: host only.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class BallistaError(Exception):
    """One classified failure cause (error.rs:44 analog)."""

    kind: str              # one of KINDS
    message: str
    # FetchFailed payload (error.rs:58): which executor lost which map
    # partitions of which producer stage — drives stage rollback
    executor_id: Optional[str] = None
    map_stage_id: Optional[int] = None
    map_partitions: List[int] = field(default_factory=list)

    KINDS = ("not_implemented", "general", "internal", "planning",
             "sql", "io", "grpc", "fetch_failed", "cancelled",
             "resource_exhausted", "shuffle_overflow")
    # retryable per the reference's scheduler semantics: infra errors get
    # the task re-launched (state/mod.rs:255-320 synthesizes retryable
    # IoError statuses for failed launches); fetch failures roll back the
    # consumer stage; the rest fail the job after TASK_MAX_FAILURES
    RETRYABLE = {"io", "grpc", "fetch_failed", "shuffle_overflow"}
    # kinds where a retry is provably wasted work (same plan, same data,
    # deterministic failure); everything else keeps bounded retries —
    # "general"/"internal" stay retryable because engine RuntimeErrors
    # include transient infra causes the classifier can't see into
    PERMANENT = {"planning", "sql", "not_implemented"}

    def __post_init__(self):
        assert self.kind in self.KINDS, self.kind

    @property
    def retryable(self) -> bool:
        return self.kind in self.RETRYABLE

    def __str__(self):
        if self.kind == "fetch_failed":
            return (f"fetch_failed(executor={self.executor_id}, "
                    f"map_stage={self.map_stage_id}, "
                    f"partitions={self.map_partitions}): {self.message}")
        return f"{self.kind}: {self.message}"

    def to_dict(self) -> dict:
        d = {"kind": self.kind, "message": self.message}
        if self.kind == "fetch_failed":
            d.update(executor_id=self.executor_id,
                     map_stage_id=self.map_stage_id,
                     map_partitions=list(self.map_partitions))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BallistaError":
        return cls(d["kind"], d["message"],
                   executor_id=d.get("executor_id"),
                   map_stage_id=d.get("map_stage_id"),
                   map_partitions=list(d.get("map_partitions") or ()))


def fetch_failed(executor_id: str, map_stage_id: int,
                 map_partitions: List[int], message: str) -> BallistaError:
    return BallistaError("fetch_failed", message, executor_id=executor_id,
                         map_stage_id=map_stage_id,
                         map_partitions=map_partitions)


def classify(exc: BaseException) -> BallistaError:
    """Fold an arbitrary engine exception into the taxonomy (the From<>
    conversion ladder of error.rs:73-140). Already-classified errors pass
    through; everything else maps by type."""
    if isinstance(exc, BallistaError):
        return exc
    from .scheduler.runtime import ShuffleOverflowError
    name = type(exc).__name__
    msg = f"{name}: {exc}"
    if isinstance(exc, ShuffleOverflowError):
        return BallistaError("shuffle_overflow", msg)
    if isinstance(exc, NotImplementedError):
        return BallistaError("not_implemented", msg)
    if isinstance(exc, (OSError, IOError)):
        return BallistaError("io", msg)
    if isinstance(exc, MemoryError):
        return BallistaError("resource_exhausted", msg)
    if isinstance(exc, KeyboardInterrupt):
        return BallistaError("cancelled", msg)
    # torch's device errors: OutOfMemoryError is a RuntimeError whose
    # text says so; any other device-side failure is internal
    if name in ("OutOfMemoryError", "AcceleratorError") or (
            isinstance(exc, RuntimeError) and "CUDA" in str(exc)):
        if name == "OutOfMemoryError" or "out of memory" in str(exc).lower():
            return BallistaError("resource_exhausted", msg)
        return BallistaError("internal", msg)
    if name in ("ParserError", "PlanError") or "sql" in name.lower():
        return BallistaError("sql", msg)
    if isinstance(exc, (ValueError, TypeError, KeyError)):
        return BallistaError("planning", msg)
    return BallistaError("general", msg)
