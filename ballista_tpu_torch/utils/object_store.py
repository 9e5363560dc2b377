"""Object-store registry: byte stores dispatched by URL scheme (port of
ballista_tpu/utils/object_store.py, host only).

Reference parity: `BallistaObjectStoreRegistry` (core/src/utils.rs:91)
registers S3/GCS object stores into DataFusion's RuntimeEnv so shuffle
replication (replicator/mod.rs:226) and reader fallback
(shuffle_reader.rs:787-858) can address `s3://...` URLs. Here the store
carries spilled stage outputs (scheduler/spill.py); backends are pluggable
by scheme.

Built-ins: `file://` (local filesystem, the default) and `mem://`
(in-process, for tests and ephemeral clusters). Cloud schemes (`gs://`,
`s3://`) register the same way through `register`: a deployment supplies
a client (a FUSE mount exposed as file://, or a client library); none is
bundled.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, Optional, Tuple


class ObjectStore:
    """Minimal byte-blob interface (object_store crate's role)."""

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def list(self, prefix: str = "") -> Iterator[str]:
        raise NotImplementedError

    def mtime(self, key: str) -> Optional[float]:
        """Last-modified epoch seconds (drives the TTL cleaner)."""
        raise NotImplementedError


class LocalFileStore(ObjectStore):
    """file:// — keys are paths under a root; atomic tmp+rename puts."""

    def __init__(self, root: str):
        # absolutize eagerly: keys joined onto a relative root would never
        # compare equal to abspath(root)
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        p = os.path.normpath(os.path.join(self.root, key))
        # is_subdirectory path-safety check (executor_server.rs:1249):
        # reject keys escaping the root before touching the filesystem
        if not p.startswith(self.root + os.sep) and p != self.root:
            raise ValueError(f"object key escapes store root: {key!r}")
        return p

    def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)

    def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def delete(self, key: str) -> None:
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        # prune now-empty parents up to the root (job-dir cleanup)
        d = os.path.dirname(self._path(key))
        while d != os.path.abspath(self.root):
            try:
                os.rmdir(d)
            except OSError:
                break
            d = os.path.dirname(d)

    def list(self, prefix: str = "") -> Iterator[str]:
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                if f.endswith(".tmp"):
                    continue
                key = os.path.relpath(os.path.join(dirpath, f), self.root)
                if key.startswith(prefix):
                    yield key

    def mtime(self, key: str) -> Optional[float]:
        try:
            return os.path.getmtime(self._path(key))
        except FileNotFoundError:
            return None


class InMemoryStore(ObjectStore):
    """mem:// — per-process dict; the test/ephemeral backend."""

    def __init__(self):
        self._blobs: Dict[str, Tuple[bytes, float]] = {}

    def put(self, key: str, data: bytes) -> None:
        import time
        self._blobs[key] = (data, time.time())

    def get(self, key: str) -> Optional[bytes]:
        v = self._blobs.get(key)
        return v[0] if v else None

    def delete(self, key: str) -> None:
        self._blobs.pop(key, None)

    def list(self, prefix: str = "") -> Iterator[str]:
        return iter(sorted(k for k in self._blobs if k.startswith(prefix)))

    def mtime(self, key: str) -> Optional[float]:
        v = self._blobs.get(key)
        return v[1] if v else None


class ObjectStoreRegistry:
    """Scheme -> store factory map (utils.rs:91 parity). `resolve(url)`
    returns (store, key). Unregistered cloud schemes raise with the
    registration recipe instead of a bare KeyError."""

    def __init__(self):
        self._factories = {}
        self._mem = InMemoryStore()
        self.register("file", lambda root: LocalFileStore(root or "/"))
        self.register("mem", lambda _root: self._mem)

    def register(self, scheme: str, factory):
        self._factories[scheme] = factory

    def resolve(self, url: str) -> Tuple[ObjectStore, str]:
        if "://" not in url:
            return LocalFileStore(url), ""
        scheme, rest = url.split("://", 1)
        if scheme not in self._factories:
            raise ValueError(
                f"no object store registered for {scheme}://; call "
                "registry.register({scheme!r}, factory) with a client "
                "(or mount the bucket and use file://)")
        if scheme == "file":
            return self._factories[scheme](rest), ""
        # cloud-style: bucket/prefix becomes part of the key namespace
        return self._factories[scheme](None), rest


DEFAULT_REGISTRY = ObjectStoreRegistry()
