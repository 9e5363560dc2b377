"""Shared network KV backend: the etcd-deployment analog (port of
ballista_tpu/scheduler/kv_remote.py, host only).

Reference parity: `storage/etcd.rs:37` — multiple scheduler instances share
one consistent KV service (get/scan/txn/lock/watch) so any of them can
recover jobs and coordinate slots. Here the service is a small HTTP server
hosting any embedded KeyValueStore (memory or sqlite-WAL) plus the two
things a REMOTE store needs that an embedded one gets for free:

- server-side lease locks with TTLs (etcd lock leases): a crashed client
  can't wedge the keyspace — its lease expires and the next scheduler
  takes over;
- a revisioned event log with long-poll watch (etcd watch streams): a
  watcher in another process observes every put/delete transactionally
  applied by its peers, in order, from any starting revision.

`RemoteKeyValueStore` plugs into the same KeyValueJobStore / SchedulerServer
seams as the embedded backends — `serve.py --job-store kv://host:port`
style HA deployment uses one KV service under N schedulers.
"""

from __future__ import annotations

import contextlib
import json
import logging
import threading
import time
import urllib.request
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from .kv import Keyspace, KeyValueStore, Watch, WatchEvent

log = logging.getLogger("ballista_tpu_torch.kv_remote")


class LockLostError(RuntimeError):
    """A server lease lock expired or was taken over while held: the
    holder's critical section may have overlapped a peer's."""


class KvService:
    """Hosts an embedded store + revision log + lease locks."""

    def __init__(self, store: Optional[KeyValueStore] = None,
                 max_log: int = 10_000):
        from .kv import MemoryKeyValueStore
        self.store = store or MemoryKeyValueStore()
        self.rev = 0
        self.events: List[tuple] = []   # (rev, op, ks, key, value)
        self.max_log = max_log
        self.locks = {}                 # (ks, key) -> (lease, expiry)
        self.cond = threading.Condition()

    def get(self, req):
        return {"value": self.store._raw_get(req["ks"], req["key"])}

    def scan(self, req):
        return {"items": self.store._raw_scan(req["ks"],
                                              req.get("prefix", ""))}

    def apply(self, req):
        ops = [tuple(o) for o in req["ops"]]
        with self.cond:
            self.store._raw_apply(ops)
            for op, ks, key, value in ops:
                self.rev += 1
                self.events.append((self.rev, op, ks, key, value))
            del self.events[:-self.max_log]
            self.cond.notify_all()
        return {"ok": True, "rev": self.rev}

    def lock(self, req):
        lk = (req["ks"], req["key"])
        now = time.time()
        ttl = float(req.get("ttl_s", 30.0))
        with self.cond:
            held = self.locks.get(lk)
            if held is not None and held[1] > now:
                return {"acquired": False}
            lease = uuid.uuid4().hex
            self.locks[lk] = (lease, now + ttl)
            return {"acquired": True, "lease": lease}

    def renew(self, req):
        """Lease keep-alive (etcd LeaseKeepAlive): extend a held lease's
        expiry. ok:False means the lease already expired and a peer may
        hold the lock — the caller must treat its critical section as
        compromised (without keep-alive a slow holder silently lost mutual
        exclusion after lock_ttl_s)."""
        lk = (req["ks"], req["key"])
        with self.cond:
            held = self.locks.get(lk)
            if held is not None and held[0] == req.get("lease"):
                self.locks[lk] = (held[0],
                                  time.time() + float(req.get("ttl_s", 30.0)))
                return {"ok": True}
        return {"ok": False}

    def unlock(self, req):
        lk = (req["ks"], req["key"])
        with self.cond:
            held = self.locks.get(lk)
            if held is not None and held[0] == req.get("lease"):
                del self.locks[lk]
                return {"ok": True}
        return {"ok": False}

    def watch(self, req):
        """Long-poll: block until an event newer than since_rev matches
        (ks, prefix) or the timeout lapses; return all matching events.

        A since_rev older than the retained log window (the log is
        truncated to max_log entries) gets a `compacted` response with a
        consistent full scan + current rev instead of silently missing
        events (etcd returns ErrCompacted: a lagging watcher must resync,
        not skip)."""
        ks, prefix = req["ks"], req.get("prefix", "")
        since = int(req.get("since_rev", 0))
        deadline = time.time() + min(float(req.get("timeout_s", 10.0)), 55.0)

        def matching():
            return [(r, op, eks, k, v) for r, op, eks, k, v in self.events
                    if r > since and eks == ks and k.startswith(prefix)]

        with self.cond:
            while True:
                if since < self.rev - len(self.events):
                    # events in (since, rev] fell out of the log: resync
                    return {"compacted": True, "rev": self.rev,
                            "items": self.store._raw_scan(ks, prefix)}
                evs = matching()
                if evs:
                    return {"events": evs, "rev": self.rev}
                left = deadline - time.time()
                if left <= 0:
                    return {"events": [], "rev": self.rev}
                self.cond.wait(left)


class _KvHandler(BaseHTTPRequestHandler):
    service: KvService = None

    def log_message(self, fmt, *args):
        log.debug("kv http: " + fmt, *args)

    def do_POST(self):
        verb = self.path.rstrip("/").rsplit("/", 1)[-1]
        handler = getattr(self.service, verb, None)
        if handler is None or verb.startswith("_") or verb in ("store",):
            self.send_error(404, f"unknown verb {verb}")
            return
        n = int(self.headers.get("Content-Length", 0))
        try:
            resp = handler(json.loads(self.rfile.read(n) or b"{}"))
            body = json.dumps(resp).encode()
            self.send_response(200)
        except Exception as e:  # noqa: BLE001
            body = json.dumps({"error": str(e)}).encode()
            self.send_response(500)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


def serve_kv(store: Optional[KeyValueStore] = None, host: str = "127.0.0.1",
             port: int = 0):
    """Start the KV service; returns (service, http_server). Run
    http_server.serve_forever() on a thread; .shutdown() to stop."""
    service = KvService(store)
    handler = type("BoundKvHandler", (_KvHandler,), {"service": service})
    httpd = ThreadingHTTPServer((host, port), handler)
    return service, httpd


class _RemoteWatch(Watch):
    """Server-backed watch: poll() long-polls the service's revision log,
    so puts/deletes from OTHER processes are observed too."""

    def __init__(self, store: "RemoteKeyValueStore", keyspace: Keyspace,
                 prefix: str):
        self._remote = store
        self.keyspace = keyspace
        self.prefix = prefix
        self._since = store._call("watch", ks=keyspace.value, prefix=prefix,
                                  timeout_s=0)["rev"]
        self._buffer: List[WatchEvent] = []
        # keys this watcher has seen alive (PUT observed, no later DELETE):
        # the compacted-resync diff base, so deletions that happened inside
        # a compacted gap still surface as DELETE events (a PUT-only
        # resync would leave stale keys mirrored forever)
        self._known: set = set()

    def _pull(self, timeout: float):
        out = self._remote._call(
            "watch", ks=self.keyspace.value, prefix=self.prefix,
            since_rev=self._since, timeout_s=timeout)
        if out.get("compacted"):
            # our revision fell out of the server's retained log: resync
            # from the consistent scan the server returned — synthetic PUT
            # per current key, plus a synthetic DELETE for every key we had
            # observed alive that the scan no longer contains
            current = {key for key, _ in out["items"]}
            for key in sorted(self._known - current):
                self._buffer.append(WatchEvent(WatchEvent.DELETE,
                                               self.keyspace, key, None))
            for key, value in out["items"]:
                self._buffer.append(WatchEvent(WatchEvent.PUT,
                                               self.keyspace, key, value))
            self._known = current
            self._since = out["rev"]
            return
        for rev, op, ks, key, value in out["events"]:
            self._since = max(self._since, rev)
            kind = WatchEvent.PUT if op == "put" else WatchEvent.DELETE
            (self._known.add if kind == WatchEvent.PUT
             else self._known.discard)(key)
            self._buffer.append(WatchEvent(kind, Keyspace(ks), key, value))

    def poll(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        """timeout=None approximates the embedded watch's block-forever
        with repeated long-polls."""
        while not self._buffer:
            self._pull(10.0 if timeout is None else timeout)
            if timeout is not None:
                break
        return self._buffer.pop(0) if self._buffer else None

    def drain(self) -> List[WatchEvent]:
        self._pull(0)
        out, self._buffer = self._buffer, []
        return out

    def cancel(self):
        self._buffer = []


class RemoteKeyValueStore(KeyValueStore):
    """Client for a KvService (the etcd backend seat, storage/etcd.rs:37)."""

    def __init__(self, url: str, timeout: float = 60.0,
                 lock_ttl_s: float = 30.0):
        super().__init__()
        self.url = url.rstrip("/")
        self.timeout = timeout
        self.lock_ttl_s = lock_ttl_s

    def _call(self, verb: str, **req) -> dict:
        data = json.dumps(req).encode()
        r = urllib.request.Request(
            f"{self.url}/kv/{verb}", data=data,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=self.timeout) as resp:
            out = json.loads(resp.read())
        if "error" in out:
            raise RuntimeError(f"kv {verb}: {out['error']}")
        return out

    def _raw_get(self, ks, key):
        return self._call("get", ks=ks, key=key)["value"]

    def _raw_scan(self, ks, prefix):
        return [tuple(kv) for kv in
                self._call("scan", ks=ks, prefix=prefix)["items"]]

    def _raw_apply(self, ops):
        self._call("apply", ops=[list(o) for o in ops])

    @contextlib.contextmanager
    def lock(self, keyspace: Keyspace, key: str,
             acquire_timeout_s: float = 60.0):
        """Server lease lock: retries until acquired or timeout; the lease
        TTL bounds how long a crashed holder can block peers.

        A background thread renews the lease at ttl/3 (etcd lease
        keep-alive), so a holder inside the with-block longer than
        lock_ttl_s keeps exclusion. LockLostError is raised when the
        service reports the lease taken over (renewal or unlock answered
        ok:False), and when the final unlock cannot reach the service and
        no renewal has succeeded for longer than lock_ttl_s: the lease may
        have lapsed and a peer taken the lock. (The reference treated every
        transport failure on the unlock as clean.)"""
        deadline = time.time() + acquire_timeout_s
        while True:
            out = self._call("lock", ks=keyspace.value, key=key,
                             ttl_s=self.lock_ttl_s)
            if out.get("acquired"):
                lease = out["lease"]
                break
            if time.time() > deadline:
                raise TimeoutError(
                    f"kv lock {keyspace.value}/{key} not acquired in "
                    f"{acquire_timeout_s}s")
            time.sleep(0.05)

        stop = threading.Event()
        lost = threading.Event()
        # when the lease was last granted or extended (monotonic clock)
        renewed = [time.monotonic()]

        def _keepalive():
            while not stop.wait(self.lock_ttl_s / 3.0):
                try:
                    if not self._call("renew", ks=keyspace.value, key=key,
                                      ttl_s=self.lock_ttl_s,
                                      lease=lease).get("ok"):
                        lost.set()
                        return
                    renewed[0] = time.monotonic()
                except Exception:  # noqa: BLE001 - transient: retry; the
                    pass           # lease outlives 2 more attempts

        ka = threading.Thread(target=_keepalive, daemon=True)
        ka.start()
        body_raised = False
        try:
            yield
        except BaseException:
            body_raised = True
            raise
        finally:
            stop.set()
            ka.join(timeout=1.0)
            # a server-reported ok:False proves a peer holds a newer lease;
            # a transport failure on the final unlock is harmless while the
            # lease is younger than its TTL (it expires on its own), and
            # compromising once the renewals have failed for longer
            lease_taken = False
            try:
                lease_taken = not self._call(
                    "unlock", ks=keyspace.value, key=key,
                    lease=lease).get("ok")
            except Exception as e:  # noqa: BLE001 - service unreachable
                stale = time.monotonic() - renewed[0]
                if stale > self.lock_ttl_s:
                    lease_taken = True
                    log.warning("kv unlock %s/%s transport failure %.1f s "
                                "after the last renewal (ttl %.1f s): %s",
                                keyspace.value, key, stale,
                                self.lock_ttl_s, e)
                else:
                    log.warning("kv unlock %s/%s transport failure (lease "
                                "will expire on its own): %s",
                                keyspace.value, key, e)
            if (lost.is_set() or lease_taken):
                if body_raised:
                    log.warning("kv lock %s/%s lease lost during a failing "
                                "critical section", keyspace.value, key)
                else:
                    raise LockLostError(
                        f"kv lock {keyspace.value}/{key}: lease expired or "
                        "was taken over while held — mutual exclusion may "
                        "have been violated")

    def watch(self, keyspace: Keyspace, prefix: str = "") -> Watch:
        return _RemoteWatch(self, keyspace, prefix)
