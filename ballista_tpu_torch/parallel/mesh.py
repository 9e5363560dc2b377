"""The partition mesh (port of ballista_tpu/parallel/mesh.py `make_mesh`).

Reference parity: Ballista's executor fleet and `ballista.shuffle.partitions`
(`core/src/config.rs:31`). The JAX package's mesh is a `jax.sharding.Mesh`
over one axis, and one program drives every shard. The port is single
controller too: a `Mesh` is the sequence of P devices, partition p lives on
`devices[p]`, and the runtime runs each stage once per partition and moves
rows between the partitions' devices itself. Several partitions may share
one device (eight partitions on one card are asked for with
`make_mesh(8, devices=[torch.device("cuda:0")] * 8)`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

class Mesh(tuple):
    """P devices, one per partition (partition p on `self[p]`)."""

    @property
    def devices(self) -> tuple:
        return tuple(self)


def visible_devices(device_type: str = "cuda") -> list:
    """Every visible device of `device_type`: the CUDA devices, or the one
    CPU."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the first `n_devices` of `devices` (all of them when
    None). `devices` defaults to every visible CUDA device; with none and
    no explicit list this raises, and it never falls back to the CPU.
    Asking for more partitions than devices raises, as the JAX version
    does: P partitions on fewer devices are an explicit list that names a
    device several times."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "devices=[torch.device('cpu')] * n to run "
                               "the partitions on the CPU")
        devices = visible_devices("cuda")
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    return Mesh(devs[:n])


def context_mesh(device) -> Mesh:
    """The default mesh of a context on `device`: one partition per
    visible device of its type (every CUDA device; the one CPU)."""
    return make_mesh(devices=visible_devices(torch.device(device).type))
