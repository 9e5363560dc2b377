"""Key-value cluster storage: the HA state layer (port of
ballista_tpu/scheduler/kv.py, host only).

Reference parity: `KeyValueStore` (cluster/storage/mod.rs:53 — get, scan,
put, txn, mv, lock, watch, delete over `Keyspace` enums, storage/mod.rs:30)
with the etcd (storage/etcd.rs:37) and sled (storage/sled.rs:34) backends,
and `KeyValueState` (kv.rs:59) which implements the cluster's JobState over
it, writing graphs + statuses transactionally.

Stance: the scheduler is single-controller (SURVEY §2.5), so
watches are in-process subscriber queues (the reference's etcd watch
streams feed a local cache the same way, kv.rs heartbeat watch). Durability
comes from the sqlite backend (embedded, WAL — the sled analog); pointing
it at replicated storage is the etcd-deployment analog.
"""

from __future__ import annotations

import contextlib
import enum
import json
import queue
import threading
from typing import Dict, Iterable, List, Optional, Tuple

from .execution_graph import ExecutionGraph


class Keyspace(enum.Enum):
    """storage/mod.rs:30."""
    EXECUTORS = "executors"
    JOB_STATUS = "job_status"
    EXECUTION_GRAPH = "execution_graph"
    SLOTS = "slots"
    SESSIONS = "sessions"
    HEARTBEATS = "heartbeats"


class WatchEvent:
    PUT = "put"
    DELETE = "delete"

    def __init__(self, kind: str, keyspace: Keyspace, key: str,
                 value: Optional[str]):
        self.kind = kind
        self.keyspace = keyspace
        self.key = key
        self.value = value

    def __repr__(self):
        return f"WatchEvent({self.kind}, {self.keyspace.value}, {self.key})"


class Watch:
    """A subscription to one keyspace prefix; events arrive on an
    unbounded queue (etcd watch-stream analog)."""

    def __init__(self, store: "KeyValueStore", keyspace: Keyspace,
                 prefix: str):
        self._store = store
        self.keyspace = keyspace
        self.prefix = prefix
        self.events: "queue.Queue[WatchEvent]" = queue.Queue()

    def poll(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        try:
            return self.events.get(timeout=timeout) if timeout \
                else self.events.get_nowait()
        except queue.Empty:
            return None

    def drain(self) -> List[WatchEvent]:
        out = []
        while True:
            e = self.poll()
            if e is None:
                return out
            out.append(e)

    def cancel(self):
        self._store._watches.discard(self)


class KeyValueStore:
    """Interface + shared watch/lock machinery. Backends override the
    _raw_* primitives; values are strings (JSON documents)."""

    def __init__(self):
        self._watches: set = set()
        self._locks: Dict[Tuple[str, str], threading.RLock] = {}
        self._locks_guard = threading.Lock()

    # -- backend primitives --
    def _raw_get(self, ks: str, key: str) -> Optional[str]:
        raise NotImplementedError

    def _raw_scan(self, ks: str, prefix: str) -> List[Tuple[str, str]]:
        raise NotImplementedError

    def _raw_apply(self, ops: List[tuple]):
        """Atomically apply [(op, ks, key, value)] with op in put|delete."""
        raise NotImplementedError

    # -- public API (storage/mod.rs:53) --
    def get(self, keyspace: Keyspace, key: str) -> Optional[str]:
        return self._raw_get(keyspace.value, key)

    def scan(self, keyspace: Keyspace, prefix: str = ""
             ) -> List[Tuple[str, str]]:
        return self._raw_scan(keyspace.value, prefix)

    def put(self, keyspace: Keyspace, key: str, value: str):
        self.apply_txn([("put", keyspace, key, value)])

    def delete(self, keyspace: Keyspace, key: str):
        self.apply_txn([("delete", keyspace, key, None)])

    def apply_txn(self, ops: Iterable[Tuple[str, Keyspace, str,
                                            Optional[str]]]):
        ops = [(op, ks.value, key, value) for op, ks, key, value in ops]
        self._raw_apply(ops)
        for op, ks, key, value in ops:
            kind = WatchEvent.PUT if op == "put" else WatchEvent.DELETE
            ev = WatchEvent(kind, Keyspace(ks), key, value)
            for w in list(self._watches):
                if w.keyspace.value == ks and key.startswith(w.prefix):
                    w.events.put(ev)

    def mv(self, from_ks: Keyspace, to_ks: Keyspace, key: str):
        """Move a key between keyspaces in one transaction."""
        value = self.get(from_ks, key)
        if value is not None:
            self.apply_txn([("delete", from_ks, key, None),
                            ("put", to_ks, key, value)])

    @contextlib.contextmanager
    def lock(self, keyspace: Keyspace, key: str):
        """Advisory per-key lock (etcd lock / kv.rs:200 global-slots-lock
        analog; in-process because the scheduler is single-controller)."""
        lk = (keyspace.value, key)
        with self._locks_guard:
            lock = self._locks.setdefault(lk, threading.RLock())
        with lock:
            yield

    def watch(self, keyspace: Keyspace, prefix: str = "") -> Watch:
        w = Watch(self, keyspace, prefix)
        self._watches.add(w)
        return w


class MemoryKeyValueStore(KeyValueStore):
    """storage/memory.rs analog."""

    def __init__(self):
        super().__init__()
        self._data: Dict[str, Dict[str, str]] = {}
        self._guard = threading.Lock()

    def _raw_get(self, ks, key):
        with self._guard:
            return self._data.get(ks, {}).get(key)

    def _raw_scan(self, ks, prefix):
        with self._guard:
            return sorted((k, v) for k, v in self._data.get(ks, {}).items()
                          if k.startswith(prefix))

    def _raw_apply(self, ops):
        with self._guard:
            for op, ks, key, value in ops:
                space = self._data.setdefault(ks, {})
                if op == "put":
                    space[key] = value
                else:
                    space.pop(key, None)


class SqliteKeyValueStore(KeyValueStore):
    """Embedded durable backend (sled analog, storage/sled.rs:34): one WAL
    sqlite database; transactions are real BEGIN IMMEDIATE transactions."""

    def __init__(self, path: str):
        super().__init__()
        import sqlite3
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._guard = threading.Lock()
        with self._guard:
            self._conn.execute("PRAGMA journal_mode=WAL")
            self._conn.execute(
                "CREATE TABLE IF NOT EXISTS kv ("
                " ks TEXT NOT NULL, k TEXT NOT NULL, v TEXT NOT NULL,"
                " PRIMARY KEY (ks, k))")
            self._conn.commit()

    def _raw_get(self, ks, key):
        with self._guard:
            row = self._conn.execute(
                "SELECT v FROM kv WHERE ks=? AND k=?", (ks, key)).fetchone()
        return row[0] if row else None

    def _raw_scan(self, ks, prefix):
        with self._guard:
            rows = self._conn.execute(
                "SELECT k, v FROM kv WHERE ks=? AND k GLOB ? ORDER BY k",
                (ks, prefix + "*")).fetchall()
        return [(k, v) for k, v in rows]

    def _raw_apply(self, ops):
        with self._guard:
            try:
                for op, ks, key, value in ops:
                    if op == "put":
                        self._conn.execute(
                            "INSERT INTO kv (ks, k, v) VALUES (?,?,?) "
                            "ON CONFLICT (ks, k) DO UPDATE SET v=excluded.v",
                            (ks, key, value))
                    else:
                        self._conn.execute(
                            "DELETE FROM kv WHERE ks=? AND k=?", (ks, key))
                self._conn.commit()
            except Exception:
                self._conn.rollback()
                raise

    def close(self):
        with self._guard:
            self._conn.close()


class KeyValueJobStore:
    """JobState over a KeyValueStore (KeyValueState, kv.rs:59): graph and
    status written in ONE transaction (kv.rs persists both keyspaces
    transactionally); job-state watches feed the events stream the
    reference exposes as `job_state_events`."""

    def __init__(self, store: KeyValueStore):
        self.store = store

    def save_job(self, graph: ExecutionGraph, plan_json: Optional[str] = None):
        from ..serde.plans import WIRE_VERSION
        doc = {"@wire": WIRE_VERSION, "graph": graph.to_dict()}
        if plan_json is None:
            prev = self.get_job(graph.job_id)
            plan_json = prev.get("plan") if prev else None
        doc["plan"] = plan_json
        with self.store.lock(Keyspace.EXECUTION_GRAPH, graph.job_id):
            self.store.apply_txn([
                ("put", Keyspace.EXECUTION_GRAPH, graph.job_id,
                 json.dumps(doc)),
                ("put", Keyspace.JOB_STATUS, graph.job_id,
                 json.dumps({"state": graph.state.value,
                             "error": graph.error})),
            ])

    def get_job(self, job_id: str) -> Optional[dict]:
        raw = self.store.get(Keyspace.EXECUTION_GRAPH, job_id)
        return json.loads(raw) if raw is not None else None

    def get_job_status(self, job_id: str) -> Optional[dict]:
        raw = self.store.get(Keyspace.JOB_STATUS, job_id)
        return json.loads(raw) if raw is not None else None

    def list_jobs(self) -> List[str]:
        return [k for k, _ in self.store.scan(Keyspace.EXECUTION_GRAPH)]

    def remove_job(self, job_id: str):
        self.store.apply_txn([
            ("delete", Keyspace.EXECUTION_GRAPH, job_id, None),
            ("delete", Keyspace.JOB_STATUS, job_id, None),
        ])

    def job_state_events(self) -> Watch:
        """Stream of job-status changes (cluster/mod.rs job_state_events)."""
        return self.store.watch(Keyspace.JOB_STATUS)
