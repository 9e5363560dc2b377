"""Stage-output spill: shuffle data that survives the loss of an executor
(port of ballista_tpu/scheduler/spill.py).

Reference parity: the Replicator (`executor/src/replicator/mod.rs:76`)
uploads every shuffle file to object storage so ShuffleReaderExec can fall
back to it when the producing executor dies (`shuffle_reader.rs:395-537`).
A stage output is P device batches of one capacity, so a spill is one
device-to-host copy and one blob per stage under
`work_dir/<job_id>/[v<version>_]stage_<id>.stage` (the reference's
shuffle-file layout, `shuffle_writer.rs` path scheme); restoring it feeds
the partitions again without running the producers.

The blob is the spill file and the peer-to-peer fetch wire format. The
JAX package writes Arrow IPC; the port has no pyarrow on the card machine
and writes its own format from numpy and torch alone, never pickle or
`torch.save` (a peer's bytes are data, not code to run):

    b"BTSTAGE1"                 magic, 8 bytes
    header length               uint32, little-endian
    header                      JSON: {"P", "cap", "ncols", "num_rows": [P],
                                "planes": [{"dtype", "bytes"[, "width"]},
                                ...]}
    planes                      data and validity plane of each column in
                                turn, each (P, cap) little-endian ((P, cap,
                                width) for a wide decimal's words), each
                                starting on an 8-byte boundary of the
                                data section

`work_dir` is an object-store URL resolved through the ObjectStoreRegistry
(utils/object_store.py, the reference's BallistaObjectStoreRegistry,
core/src/utils.rs:91): a plain path or file:// URL spills to local disk,
mem:// to the in-process store.
"""

from __future__ import annotations

import json
import struct
import sys
import time
from typing import Optional

import numpy as np
import torch

from ..batch import Batch, Column
from ..parallel.partitioned import PartitionedBatch

MAGIC = b"BTSTAGE1"
SUFFIX = ".stage"
_ALIGN = 8
# plane dtypes a blob may name: what the engine's columns hold
_DTYPES = {"bool": torch.bool, "int32": torch.int32, "int64": torch.int64,
           "float32": torch.float32, "float64": torch.float64}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def encode_stage(pb: PartitionedBatch) -> bytes:
    """One self-describing blob of a stage output: per column its (P, cap)
    data and validity planes, and the rows of each partition. The planes
    are joined on the first partition's device and cross to the host in
    one copy."""
    if sys.byteorder != "little":
        raise RuntimeError("encode_stage: the stage blob is little-endian")
    P, cap = pb.n_partitions, pb.capacity
    dev = pb.batches[0].device
    ncols = len(pb.batches[0].columns)
    pieces, planes = [], []
    for i in range(ncols):
        for part in ("data", "validity"):
            plane = torch.stack([getattr(b.columns[i], part).to(dev)
                                 for b in pb.batches]).contiguous()
            raw = plane.view(-1).view(torch.uint8)
            nbytes = raw.numel()
            planes.append({"dtype": _NAMES[plane.dtype], "bytes": nbytes})
            if plane.dim() > 2:
                # a wide decimal: words per row
                planes[-1]["width"] = int(plane.shape[2])
            pieces.append(raw)
            pad = _padded(nbytes) - nbytes
            if pad:
                pieces.append(torch.zeros(pad, dtype=torch.uint8, device=dev))
    nrows = pb.num_rows.to(torch.int64)
    body = (torch.cat(pieces + [nrows.view(torch.uint8)]).cpu().numpy()
            if pieces else nrows.cpu().numpy().view(np.uint8))
    num_rows = body[len(body) - 8 * P:].view(np.int64).tolist()
    header = json.dumps({"P": P, "cap": cap, "ncols": ncols,
                         "num_rows": num_rows, "planes": planes}).encode()
    return b"".join((MAGIC, struct.pack("<I", len(header)), header,
                     body[:len(body) - 8 * P].tobytes()))


def read_header(blob: bytes) -> dict:
    """The header of a stage blob, checked against the blob's length."""
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError("not a stage blob (bad magic)")
    (hlen,) = struct.unpack_from("<I", blob, len(MAGIC))
    start = len(MAGIC) + 4 + hlen
    header = json.loads(blob[len(MAGIC) + 4:start])
    P, cap, ncols = int(header["P"]), int(header["cap"]), int(header["ncols"])
    planes = header["planes"]
    if len(planes) != 2 * ncols or len(header["num_rows"]) != P:
        raise ValueError("stage blob: header disagrees with its planes")
    total = 0
    for i, plane in enumerate(planes):
        dtype = _DTYPES.get(plane["dtype"])
        if dtype is None or (i % 2 == 1 and dtype is not torch.bool):
            raise ValueError(f"stage blob: plane dtype {plane['dtype']!r}")
        if plane["bytes"] != P * cap * plane.get("width", 1) * torch.empty(
                0, dtype=dtype).element_size():
            raise ValueError("stage blob: a plane's length is not P x cap")
        total += _padded(plane["bytes"])
    if len(blob) - start != total:
        raise ValueError(f"stage blob: {len(blob) - start} data bytes, the "
                         f"header describes {total}")
    header["_start"] = start
    return header


def decode_stage(blob: bytes, mesh=None) -> PartitionedBatch:
    """Inverse of encode_stage: partition p on `mesh[p]`, or every
    partition on the CPU when no mesh is given (the scheduler's egress).
    The data crosses to each distinct device in one copy; the columns are
    views of it."""
    h = read_header(blob)
    P, cap = int(h["P"]), int(h["cap"])
    if mesh is not None and len(mesh) != P:
        raise ValueError(f"stage blob of {P} partitions on a mesh of "
                         f"{len(mesh)}")
    devices = ([torch.device(d) for d in mesh] if mesh is not None
               else [torch.device("cpu")] * P)
    host = torch.frombuffer(bytearray(memoryview(blob)[h["_start"]:]),
                            dtype=torch.uint8) \
        if len(blob) > h["_start"] else torch.zeros(0, dtype=torch.uint8)
    on = {d: host.to(d) for d in dict.fromkeys(devices)}
    rows = {d: torch.tensor(h["num_rows"], dtype=torch.int32, device=d)
            for d in on}
    cols = [[] for _ in range(P)]
    offset = 0
    for i in range(0, len(h["planes"]), 2):
        views = []
        for plane in h["planes"][i:i + 2]:
            dtype, n = _DTYPES[plane["dtype"]], plane["bytes"]
            shape = (P, cap) + ((plane["width"],) if "width" in plane else ())
            views.append({d: raw[offset:offset + n].view(dtype).view(shape)
                          for d, raw in on.items()})
            offset += _padded(n)
        data, valid = views
        for p, d in enumerate(devices):
            cols[p].append(Column(data[d][p], valid[d][p]))
    return PartitionedBatch(tuple(
        Batch(tuple(cols[p]), rows[d][p]) for p, d in enumerate(devices)))


class StageSpiller:
    def __init__(self, work_dir: str, registry=None, version: int = 0):
        from ..utils.object_store import DEFAULT_REGISTRY
        self.work_dir = work_dir
        self.registry = registry
        # the job-spec version rides the spill key: after an overflow
        # escalation re-plans a job (rpc.py _escalate_on_overflow bumps
        # the spec version), a straggler finishing a task of the old spec
        # writes old-version keys and never shadows the re-run stage's
        # output. Version 0 keeps the flat layout.
        self.version = version
        self.store, self._prefix = \
            (registry or DEFAULT_REGISTRY).resolve(work_dir)

    def at_version(self, version: int) -> "StageSpiller":
        """The same store under another spec version's keys."""
        return StageSpiller(self.work_dir, self.registry, version)

    def _key(self, job_id: str, stage_id: int) -> str:
        v = f"v{self.version}_" if self.version else ""
        base = f"{job_id}/{v}stage_{stage_id}{SUFFIX}"
        return f"{self._prefix}/{base}" if self._prefix else base

    def spill(self, job_id: str, stage_id: int, pb: PartitionedBatch) -> int:
        """Persist a stage's output as one blob; returns its bytes."""
        blob = encode_stage(pb)
        self.store.put(self._key(job_id, stage_id), blob)
        return len(blob)

    def restore(self, job_id: str, stage_id: int,
                mesh=None) -> Optional[PartitionedBatch]:
        """Reload a spilled stage output onto the mesh (the object-store
        fallback read, shuffle_reader.rs:787-858)."""
        blob = self.read_blob(job_id, stage_id)
        return None if blob is None else decode_stage(blob, mesh)

    def read_blob(self, job_id: str, stage_id: int) -> Optional[bytes]:
        """Raw spill bytes of a stage: what the peer-to-peer data endpoint
        serves (flight_service.rs:74 do_get FetchPartition reads the
        producer's local shuffle file the same way)."""
        return self.store.get(self._key(job_id, stage_id))

    def clean_job(self, job_id: str):
        """RemoveJobData parity (executor_server.rs:1210): delete a job's
        spilled objects."""
        prefix = f"{self._prefix}/{job_id}/" if self._prefix \
            else f"{job_id}/"
        for key in list(self.store.list(prefix)):
            self.store.delete(key)

    def clean_expired(self, ttl_seconds: float = 7 * 24 * 3600) -> list:
        """The shuffle-data TTL cleaner (clean_shuffle_data_loop,
        executor_process.rs:503; default TTL 7 days): remove the spill
        directories of jobs whose newest file is older than the TTL.
        Returns the removed job ids."""
        now = time.time()
        newest: dict = {}
        for key in list(self.store.list(self._prefix)):
            rel = key[len(self._prefix):].lstrip("/") if self._prefix \
                else key
            job_id = rel.split("/", 1)[0]
            m = self.store.mtime(key) or 0
            newest[job_id] = max(newest.get(job_id, 0), m)
        removed = [j for j, m in newest.items() if now - m > ttl_seconds]
        for j in removed:
            self.clean_job(j)
        return removed

    def clean_all(self):
        """Full cleanup on shutdown (executor_process.rs:542)."""
        for key in list(self.store.list(self._prefix)):
            self.store.delete(key)
