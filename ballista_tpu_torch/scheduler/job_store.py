"""Persistent job state: the scheduler's HA store (the port's copy of
ballista_tpu/scheduler/job_store.py).

Reference parity: `JobState` over `KeyValueStore` backends
(`cluster/mod.rs:346`, `cluster/storage/{memory,sled,etcd}.rs`) — graphs
and statuses persisted on submit/save so another scheduler can take over a
job. The reference stubs the takeover (`try_acquire_job` is unimplemented
in both impls, kv.rs:697); here `SchedulerServer.recover_jobs` actually
performs it: reload non-terminal graphs, reset in-flight tasks, resume.

Backends: in-memory dict (memory.rs parity) and an embedded directory of
JSON files with atomic replace (sled parity — local-disk durability
without a database server). etcd parity is a deployment concern: point the
file store at replicated storage, or subclass KeyValueJobStore.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

from ..serde.plans import WIRE_VERSION, check_wire_version
from .execution_graph import ExecutionGraph, JobState


class InMemoryJobStore:
    """Keyspace {job_id -> encoded graph} (cluster/memory.rs:271 parity)."""

    def __init__(self):
        self._jobs: Dict[str, dict] = {}

    def save_job(self, graph: ExecutionGraph, plan_json: Optional[str] = None):
        doc = {"@wire": WIRE_VERSION, "graph": graph.to_dict()}
        if plan_json is not None:
            doc["plan"] = plan_json
        elif graph.job_id in self._jobs:
            doc["plan"] = self._jobs[graph.job_id].get("plan")
        self._jobs[graph.job_id] = doc

    def get_job(self, job_id: str) -> Optional[dict]:
        return self._jobs.get(job_id)

    def list_jobs(self) -> List[str]:
        return sorted(self._jobs)

    def remove_job(self, job_id: str):
        self._jobs.pop(job_id, None)


class FileJobStore(InMemoryJobStore):
    """One JSON file per job with atomic tmp+rename writes (the sled-
    embedded-store analog: survives scheduler restart on local disk)."""

    def __init__(self, directory: str):
        super().__init__()
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _path(self, job_id: str) -> str:
        return os.path.join(self.dir, f"{job_id}.json")

    def save_job(self, graph: ExecutionGraph, plan_json: Optional[str] = None):
        if plan_json is None:
            prev = self.get_job(graph.job_id)
            plan_json = prev.get("plan") if prev else None
        doc = {"@wire": WIRE_VERSION, "graph": graph.to_dict(),
               "plan": plan_json}
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self._path(graph.job_id))

    def get_job(self, job_id: str) -> Optional[dict]:
        try:
            with open(self._path(job_id)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def list_jobs(self) -> List[str]:
        return sorted(f[:-5] for f in os.listdir(self.dir)
                      if f.endswith(".json"))

    def remove_job(self, job_id: str):
        try:
            os.remove(self._path(job_id))
        except FileNotFoundError:
            pass


def recover_graphs(store) -> List[ExecutionGraph]:
    """Load every non-terminal job from the store, resetting in-flight
    tasks (the takeover the reference leaves unimplemented)."""
    out = []
    for job_id in store.list_jobs():
        doc = store.get_job(job_id)
        if doc is None:
            continue
        # cross-version takeover guard: a graph persisted by a different
        # build is rejected up front, not mid-decode
        check_wire_version(doc, f"persisted job {job_id}")
        g = ExecutionGraph.from_dict(doc["graph"])
        if g.state in (JobState.SUCCESSFUL, JobState.FAILED,
                       JobState.CANCELLED):
            continue
        g.reset_in_flight()
        out.append(g)
    return out
