"""The partitioned runtime's collectives against the JAX package's: the
same P partition batches, made from a numpy seed, go through the JAX
`hash_partition_exchange` / `all_gather_batch` under shard_map on the
virtual CPU mesh (tests/conftest.py) and through the port's over P CPU
partitions (`parallel/shuffle.py`). Compared exactly: every receiver's
row count, its live rows in order (data and validity), the validity of
every slot, each sender's overflow flag and its pre-clamp counts per
destination. Cases: NULL keys, empty partitions, a destination over
quota, spread and replicate salting, string keys (codes into one shared
dictionary), P in {4, 8}."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec

from ballista_tpu.batch import Batch as JBatch, Column as JColumn
from ballista_tpu.parallel import shuffle as jshuffle
from ballista_tpu_torch.batch import Batch, Column
from ballista_tpu_torch.parallel import shuffle
from ballista_tpu_torch.parallel.mesh import make_mesh
from ballista_tpu_torch.parallel.partitioned import (PartitionedBatch,
                                                     gather_partitions)

torch.set_num_threads(2)

CAP = 256
DICT = np.array(sorted(f"s{i:03d}" for i in range(40)), dtype=object)


def _partitions(P, seed, empty=(), nulls=0.1, hot=None):
    """P partitions of CAP slots: an int64 key with NULLs (or one hot key
    on most rows), a string key (int32 codes into DICT), a float payload
    with NULLs and a date. Partitions in `empty` hold no rows; dead slots
    are zero and invalid."""
    rng = np.random.default_rng(seed)
    out = []
    for p in range(P):
        n = 0 if p in empty else int(rng.integers(CAP // 2, CAP + 1))
        live = np.arange(CAP) < n
        k = rng.integers(-40, 40, CAP, dtype=np.int64)
        if hot is not None:
            k = np.where(rng.random(CAP) < hot, 7, k)
        s = rng.integers(0, len(DICT), CAP).astype(np.int32)
        x = rng.normal(size=CAP)
        d = rng.integers(8000, 11000, CAP).astype(np.int32)
        cols = [(k, rng.random(CAP) > nulls), (s, rng.random(CAP) > nulls),
                (x, rng.random(CAP) > 0.2), (d, np.ones(CAP, bool))]
        out.append(([(np.where(v & live, a, 0).astype(a.dtype), v & live)
                     for a, v in cols], n))
    return out


def _port_batches(parts):
    cpu = torch.device("cpu")
    return [Batch(tuple(Column(torch.from_numpy(a.copy()),
                               torch.from_numpy(v.copy())) for a, v in cols),
                  torch.tensor(n, dtype=torch.int32, device=cpu))
            for cols, n in parts]


def _jax_stack(parts):
    ncol = len(parts[0][0])
    datas = tuple(jnp.asarray(np.stack([c[i][0] for c, _ in parts]))
                  for i in range(ncol))
    valids = tuple(jnp.asarray(np.stack([c[i][1] for c, _ in parts]))
                   for i in range(ncol))
    return datas, valids, jnp.asarray(np.array([n for _, n in parts],
                                               np.int32))


def _jax_mesh(P):
    return Mesh(np.array(jax.devices()[:P]), ("p",))


def _jax_exchange(parts, keys, P, quota, salt, salt_mode):
    spec = PartitionSpec("p")

    def per_shard(datas, valids, nrows):
        b = JBatch(tuple(JColumn(d[0], v[0]) for d, v in zip(datas, valids)),
                   nrows[0])
        out, ov, counts = jshuffle.hash_partition_exchange(
            b, keys, P, quota, "p", salt=salt, salt_mode=salt_mode)
        return (tuple(c.data[None] for c in out.columns),
                tuple(c.validity[None] for c in out.columns),
                out.num_rows[None], ov[None], counts[None])

    fn = jax.jit(shard_map(per_shard, mesh=_jax_mesh(P),
                           in_specs=(spec, spec, spec),
                           out_specs=(spec,) * 5, check_vma=False))
    return [np.asarray(a) if not isinstance(a, tuple)
            else [np.asarray(x) for x in a] for a in fn(*_jax_stack(parts))]


def _jax_gather(parts, P):
    spec = PartitionSpec("p")

    def per_shard(datas, valids, nrows):
        b = JBatch(tuple(JColumn(d[0], v[0]) for d, v in zip(datas, valids)),
                   nrows[0])
        out = jshuffle.all_gather_batch(b, P, "p")
        return (tuple(c.data[None] for c in out.columns),
                tuple(c.validity[None] for c in out.columns),
                out.num_rows[None])

    fn = jax.jit(shard_map(per_shard, mesh=_jax_mesh(P),
                           in_specs=(spec, spec, spec),
                           out_specs=(spec,) * 3, check_vma=False))
    return [np.asarray(a) if not isinstance(a, tuple)
            else [np.asarray(x) for x in a] for a in fn(*_jax_stack(parts))]


def _assert_received(got, datas, valids, nrows):
    """Port receivers `got` equal the JAX shards: row counts, the live
    rows' data and validity in order, every slot's validity."""
    assert len(got) == len(nrows)
    for d, b in enumerate(got):
        n = int(nrows[d])
        assert int(b.num_rows) == n, d
        assert b.capacity == datas[0].shape[1]
        for i, c in enumerate(b.columns):
            np.testing.assert_array_equal(c.validity.numpy(), valids[i][d],
                                          err_msg=f"dest {d} col {i}")
            np.testing.assert_array_equal(c.data.numpy()[:n],
                                          datas[i][d][:n],
                                          err_msg=f"dest {d} col {i}")


EXCHANGES = {
    # name: (P, keys, quota, salt, salt_mode, partitions kwargs)
    "int key": (8, [0], 64, 1, None, {}),
    "null keys": (8, [0], 128, 1, None, {"nulls": 0.4}),
    "empty partitions": (8, [0, 3], 64, 1, None, {"empty": (1, 5, 6)}),
    "over quota": (8, [0], 16, 1, None, {}),
    "string key": (8, [1], 64, 1, None, {}),
    "string and int keys": (4, [1, 0], 128, 1, None, {}),
    "spread salt": (8, [0], 128, 4, "spread", {"hot": 0.8}),
    "replicate salt": (8, [0], 128, 2, "replicate", {}),
    "replicate over quota": (4, [1], 32, 4, "replicate", {"empty": (2,)}),
    "four partitions": (4, [0], 128, 1, None, {"empty": (0,)}),
}


@pytest.mark.parametrize("case", sorted(EXCHANGES))
def test_exchange_matches_jax(case):
    P, keys, quota, salt, mode, kw = EXCHANGES[case]
    parts = _partitions(P, seed=len(case), **kw)
    datas, valids, nrows, overflow, counts = _jax_exchange(
        parts, keys, P, quota, salt, mode)
    got, ovs, cnts = shuffle.hash_partition_exchange(
        _port_batches(parts), keys, P, quota,
        [torch.device("cpu")] * P, salt, mode)
    _assert_received(got, datas, valids, nrows)
    np.testing.assert_array_equal([bool(o) for o in ovs], overflow)
    np.testing.assert_array_equal(torch.stack(cnts).numpy(), counts)
    if case.endswith("over quota"):
        assert overflow.any()
    else:
        assert not overflow.any()


@pytest.mark.parametrize("P,empty", [(8, ()), (8, (0, 3, 7)), (4, (1,)),
                                     (4, (0, 1, 2, 3))])
def test_all_gather_matches_jax(P, empty):
    parts = _partitions(P, seed=P + len(empty), empty=empty)
    datas, valids, nrows = _jax_gather(parts, P)
    got = shuffle.all_gather_batch(_port_batches(parts), P)
    _assert_received(got, datas, valids, nrows)
    # one device: every partition shares one gathered batch
    assert all(b is got[0] for b in got)


def test_gather_partitions_in_partition_order():
    parts = _partitions(4, seed=3, empty=(2,))
    pb = PartitionedBatch(tuple(_port_batches(parts)))
    out = gather_partitions(pb, None)
    live = [np.concatenate([c[i][0][:n] for c, n in parts])
            for i in range(4)]
    assert int(out.num_rows) == sum(n for _, n in parts)
    for i, col in enumerate(out.columns):
        np.testing.assert_array_equal(col.data.numpy()[:len(live[i])],
                                      live[i])


def test_exchange_copies_between_devices(monkeypatch):
    """Partitions on devices of their own: each receiver's batch lies on
    its partition's device, and the rows are those of one device."""
    parts = _partitions(4, seed=11)
    same, _, _ = shuffle.hash_partition_exchange(_port_batches(parts), [0], 4,
                                                 128)
    moved = []
    orig = torch.Tensor.to

    def to(self, *args, **kwargs):
        moved.append(args[0] if args else kwargs.get("device"))
        return orig(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", to)
    devices = [torch.device("cpu", 0)] * 4
    got, _, _ = shuffle.hash_partition_exchange(_port_batches(parts), [0], 4,
                                                128, devices)
    monkeypatch.undo()
    assert any(str(m) == "cpu:0" for m in moved)
    for a, b in zip(same, got):
        assert int(a.num_rows) == int(b.num_rows)
        for ca, cb in zip(a.columns, b.columns):
            assert torch.equal(ca.data, cb.data)


def test_make_mesh_needs_cuda_or_an_explicit_list():
    cpu = torch.device("cpu")
    mesh = make_mesh(8, devices=[cpu] * 8)
    assert len(mesh) == 8 and mesh.devices == (cpu,) * 8
    with pytest.raises(ValueError):
        make_mesh(9, devices=[cpu] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
