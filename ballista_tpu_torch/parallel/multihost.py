"""Multi-process execution on torch.distributed (port of
ballista_tpu/parallel/multihost.py).

Reference parity: Ballista's fleet of executor processes. The JAX package
runs one program in every process (multi-controller SPMD): every process
registers the same tables, plans the same query and runs the same stages,
and a shuffle crosses the process boundary inside the collective. The port
does the same over `torch.distributed`: every process runs the same driver
(`runtime.execute_distributed` over a `GlobalMesh`), evaluates a stage for
the partitions it owns only, and the stage root's collective
(`parallel/shuffle.py`) moves the rows between processes by point-to-point
sends, which every gloo version has. The counts that decide an escalation
(overflow flags, growth needs, per-destination counts, rows sent) are
summed over the processes before anything reads them
(`runtime.StageRun.read`), so every process takes the same retry.

Backends. gloo moves host tensors and serves ranks that share a device or
run on the CPU; a CUDA partition's rows are copied to the host for it.
NCCL needs a GPU of its own per rank, so a machine with one card runs its
processes over gloo. A lost peer surfaces as an error of the next
collective (the connection closes) or, at the latest, when the group's
`timeout` passes: the process exits non-zero rather than hanging.

Host roles, as in the reference:
  executor registration  -> init_process_group's rendezvous
  task launch            -> every process runs the same driver
  shuffle write / fetch  -> point-to-point sends inside the exchange
  result fetch           -> all_gather_batch (partitioned.gather_partitions)
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from .mesh import Mesh

# seconds a collective may wait for a peer (BALLISTA_PEER_TIMEOUT)
DEFAULT_TIMEOUT_S = 120.0


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, backend: Optional[str] = None,
                   timeout_s: Optional[float] = None):
    """Join the process group (every process calls this with the same
    coordinator "host:port", which rank 0 listens on). `backend` is gloo
    unless asked for; NCCL raises without a CUDA device per rank.
    `timeout_s` (default BALLISTA_PEER_TIMEOUT, else 120 s) bounds every
    collective's wait for a peer. Returns (rank, world size). A failed
    rendezvous raises: there is no single-process fallback."""
    backend = backend or "gloo"
    if backend == "nccl" and torch.cuda.device_count() < 1:
        raise RuntimeError("init_multihost: NCCL needs a CUDA device per "
                           "rank; use gloo")
    if timeout_s is None:
        timeout_s = float(os.environ.get("BALLISTA_PEER_TIMEOUT",
                                         DEFAULT_TIMEOUT_S))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


class GlobalMesh(Mesh):
    """P partitions over every process of the group: partition p belongs
    to rank p // `per_process` (each rank a contiguous run) and lives on
    that rank's device. Entries of other ranks' partitions name
    this process's device too and are never used: a stage evaluates and
    holds its own partitions only (`is_local`)."""

    rank: int
    world: int
    per_process: int

    def is_local(self, p: int) -> bool:
        return p // self.per_process == self.rank

    @property
    def local_partitions(self) -> List[int]:
        lo = self.rank * self.per_process
        return list(range(lo, lo + self.per_process))

    def partitions_of(self, rank: int) -> List[int]:
        lo = rank * self.per_process
        return list(range(lo, lo + self.per_process))


def make_global_mesh(per_process: int = 1, device=None) -> GlobalMesh:
    """The mesh of world x `per_process` partitions, this process's on
    `device` (default: CUDA device rank mod the visible count; without
    CUDA this raises: pass device="cpu" to run the partitions on the
    CPU). Call after `init_multihost`."""
    if not dist.is_initialized():
        raise RuntimeError("make_global_mesh: call init_multihost first")
    rank, world = dist.get_rank(), dist.get_world_size()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_global_mesh: CUDA is not available; "
                               "pass device='cpu'")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    mesh = GlobalMesh([torch.device(device)] * (world * per_process))
    mesh.rank, mesh.world, mesh.per_process = rank, world, per_process
    return mesh


def spans_processes(mesh) -> bool:
    return isinstance(mesh, GlobalMesh) and mesh.world > 1


def _wire_device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The element-wise sum of `t` over every process, on `t`'s device."""
    w = t.to(_wire_device()).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM)
    return w.to(t.device)


def _as_bytes(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    flat = [p.contiguous().reshape(-1).view(torch.uint8)
            .to(_wire_device()) for p in parts]
    return (torch.cat(flat) if flat
            else torch.zeros(0, dtype=torch.uint8, device=_wire_device()))


def _from_bytes(buf: torch.Tensor, specs, device) -> List[torch.Tensor]:
    out, at = [], 0
    for dtype, n in specs:
        size = n * torch.empty((), dtype=dtype).element_size()
        # a copy: the slice may sit at an offset the dtype cannot view
        out.append(buf[at:at + size].clone().view(dtype).to(device))
        at += size
    return out


def swap(send: Dict[int, Sequence[torch.Tensor]],
         recv: Dict[int, Sequence[tuple]], device) -> Dict[int, list]:
    """Point-to-point exchange with every other rank: `send[r]` (tensors)
    goes to rank r, and from rank r come tensors of the (dtype, length)
    specs `recv[r]`, on `device`. Both sides know the sizes beforehand
    (from reduced counts), so one message of bytes each way suffices."""
    reqs, bufs = [], {}
    for r, specs in recv.items():
        size = sum(n * torch.empty((), dtype=d).element_size()
                   for d, n in specs)
        bufs[r] = torch.empty(size, dtype=torch.uint8, device=_wire_device())
        if size:
            reqs.append(dist.irecv(bufs[r], src=r))
    payloads = {r: _as_bytes(parts) for r, parts in send.items()}
    for r, buf in payloads.items():
        if buf.numel():
            reqs.append(dist.isend(buf, dst=r))
    for req in reqs:
        req.wait()
    return {r: _from_bytes(bufs[r], specs, device)
            for r, specs in recv.items()}
