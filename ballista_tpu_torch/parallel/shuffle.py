"""The device half of a hash-repartition shuffle (port of
ballista_tpu/parallel/shuffle.py `SHUFFLE_SEED`, `shuffle_dest` and
`exchange_send_layout`, which holds `_send_layout_packed`).

A shuffle write (Ballista's ShuffleWriterExec hash path) groups a batch's
live rows by destination partition into a send buffer of P x quota slots:
slots [d * quota, d * quota + send_counts[d]) hold the rows bound for
partition d, in batch order. The serial runtime takes the buffer's live
slots alone (`exchange_send_rows`: a host shuffle has no fixed buffer to
fill), copies them to the host and hands each partition its slices. The
reference sorts packed operand limbs with the destination, a TPU device;
here a stable sort of the destinations yields a permutation, a bincount
the per-destination counts, and every column is gathered once through the
slot -> row map.

The partitioned runtime's collectives (`hash_partition_exchange`, the
reference's in-program all_to_all, and `all_gather_batch`, its all_gather)
take the P partitions' batches as a list, each on its partition's device:
receiver d reads chunk d of every sender's fixed send buffer, copied to its
own device where the devices differ, and compacts the received slots to the
reference's row order (sender-major, slot order within a sender: the
stable sort on ~keep of `hash_partition_exchange`). In one process neither
reads a count on the host. Over a mesh that spans processes
(`multihost.GlobalMesh`) a process holds its own partitions only (the
others' entries of the list are None): the send counts or row counts are
summed over the processes on the host first, and then each process sends
every other the live rows its partitions bound for that process's ones
(`multihost.swap`), which land in the same segments and the same order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..batch import Batch, Column, row_mask
from ..ops.gather import gather_columns
from ..ops.hash import MASK32, hash_columns
from . import multihost

SHUFFLE_SEED = 0x7F4A7C15


def _key_hash(batch: Batch, key_indices: Sequence[int]) -> torch.Tensor:
    keys = [batch.columns[i] for i in key_indices]
    return hash_columns([k.data for k in keys], [k.validity for k in keys],
                        seed=SHUFFLE_SEED)


def shuffle_dest(batch: Batch, key_indices: Sequence[int], n_parts: int,
                 salt: int = 1, salt_mode: str | None = None):
    """(destination partition per row as int64, live mask); dead rows go
    to n_parts.

    With salt S > 1 a key's rows split over S destinations: 'spread' (the
    probe side of a join) gives each row the sub-bucket of its position;
    'replicate' (the build side) is `exchange_send_layout`'s, which copies
    each row S times first. Both compute (h * S + sub) mod P, so probe
    sub-bucket j meets build replica j exactly once."""
    live = row_mask(batch)
    h = _key_hash(batch, key_indices)
    if salt > 1:
        if salt_mode != "spread":
            raise ValueError(f"shuffle_dest: salt {salt} needs salt_mode "
                             f"'spread', got {salt_mode!r}")
        sub = torch.arange(batch.capacity, dtype=torch.int64,
                           device=h.device) % salt
        h = (h * salt + sub) & MASK32
    return torch.where(live, h % n_parts, n_parts), live


def _by_destination(batch: Batch, key_indices: Sequence[int], n_parts: int,
                    quota: int, salt: int, salt_mode: str | None):
    """The rows of a shuffle write grouped by destination: (row of the
    batch behind each position of the grouped order, per-destination
    first positions, send_counts, overflow, counts). With 'replicate'
    salting every row stands S times, replica j bound for (h * S + j) mod
    P. A stable sort of the destinations keeps each one's rows in batch
    order; dead rows go last (destination P)."""
    P = n_parts
    device = batch.device
    rows = None          # replicated position -> batch row
    if salt > 1 and salt_mode == "replicate":
        j = torch.arange(batch.capacity * salt, dtype=torch.int64,
                         device=device)
        rows = j // salt
        h = _key_hash(batch, key_indices).index_select(0, rows)
        live = row_mask(batch).index_select(0, rows)
        dest = torch.where(live, ((h * salt + j % salt) & MASK32) % P, P)
    else:
        dest, _ = shuffle_dest(batch, key_indices, P, salt, salt_mode)
    order = torch.sort(dest, stable=True).indices
    if rows is not None:
        order = rows.index_select(0, order)
    counts = torch.bincount(dest, minlength=P + 1)[:P]
    offsets = torch.cumsum(counts, 0) - counts
    overflow = (counts > quota).any()
    return order, offsets, counts.clamp(max=quota), overflow, counts


def exchange_send_layout(batch: Batch, key_indices: Sequence[int],
                         n_parts: int, quota: int, salt: int = 1,
                         salt_mode: str | None = None):
    """Group the live rows by destination into a (P * quota)-slot batch
    (the fixed send buffer of a mesh all_to_all).

    Returns (send Batch, send_counts, overflow, counts): send_counts[d]
    (int32, clamped to the quota) rows lie at slots [d * quota, ...);
    `counts` are the pre-clamp per-destination row counts (the
    shuffle-write stats an overflow retry sizes its quotas from) and
    `overflow` is a 0-d bool tensor, true where a destination got more
    rows than the quota (rows were dropped). The batch's num_rows is the
    number of rows sent."""
    P = n_parts
    order, offsets, send_counts, overflow, counts = _by_destination(
        batch, key_indices, P, quota, salt, salt_mode)
    slot = torch.arange(P * quota, dtype=torch.int64, device=batch.device)
    d_of, k_of = slot // quota, slot % quota
    slot_live = k_of < send_counts.index_select(0, d_of)
    src = order.index_select(0, (offsets.index_select(0, d_of) + k_of)
                             .clamp(0, order.shape[0] - 1))
    cols = gather_columns(batch.columns, src, valid_and=slot_live)
    total = send_counts.sum().to(torch.int32)
    return (Batch(tuple(cols), total), send_counts.to(torch.int32), overflow,
            counts.to(torch.int32))


def exchange_send_rows(batch: Batch, key_indices: Sequence[int],
                       n_parts: int, quota: int, salt: int = 1,
                       salt_mode: str | None = None):
    """`exchange_send_layout` without the fixed buffer (the serial
    runtime's send side, whose shuffle goes through the host): the same
    send_counts, overflow and counts, and the send buffer's live slots
    compacted to the front in slot order, so destination d's rows are
    [sum(send_counts[:d]), sum(send_counts[:d + 1])). The batch keeps the
    rows' count as its num_rows and at least the input's capacity (S
    times it under 'replicate' salting)."""
    order, offsets, send_counts, overflow, counts = _by_destination(
        batch, key_indices, n_parts, quota, salt, salt_mode)
    cap = order.shape[0]
    total = send_counts.sum()
    # position i of the output: the k-th row bound for destination d
    d_of = torch.repeat_interleave(
        torch.arange(n_parts, device=batch.device), send_counts)
    k_of = torch.arange(d_of.shape[0], device=batch.device) - (
        torch.cumsum(send_counts, 0) - send_counts).index_select(0, d_of)
    src = order.index_select(0, offsets.index_select(0, d_of) + k_of)
    pad = cap - src.shape[0]
    src = torch.cat([src, src.new_zeros(pad)])
    live = torch.arange(cap, device=batch.device) < total
    cols = gather_columns(batch.columns, src, valid_and=live)
    return (Batch(tuple(cols), total.to(torch.int32)),
            send_counts.to(torch.int32), overflow, counts.to(torch.int32))


def _compact_segments(columns, counts: torch.Tensor, seg: int) -> Batch:
    """Columns of P segments of `seg` slots each, whose first counts[k]
    slots of segment k are live, as a batch of P * seg rows with the live
    slots first, in segment order and slot order within a segment, and
    the dead slots after them in their order (the permutation the
    reference's stable sort on ~keep makes)."""
    device = counts.device
    n = counts.shape[0] * seg
    counts = counts.to(torch.int64)
    j = torch.arange(n, dtype=torch.int64, device=device)
    keep = (j % seg) < counts.index_select(0, j // seg)
    kept = torch.cumsum(keep, 0)
    total = counts.sum()
    pos = torch.where(keep, kept - 1, total + j - kept)
    perm = torch.empty_like(j).scatter_(0, pos, j)
    cols = gather_columns(columns, perm, valid_and=j < total)
    return Batch(tuple(cols), total.to(torch.int32))


def _devices_of(batches, devices):
    return (list(devices) if devices is not None
            else [b.device for b in batches])


def hash_partition_exchange(batches: Sequence[Batch],
                            key_indices: Sequence[int], n_parts: int,
                            quota: int, devices=None, salt: int = 1,
                            salt_mode: str | None = None):
    """Repartition the rows of P partition batches by key hash (the
    reference's all_to_all over the mesh, ShuffleWriterExec's hash path).

    Returns (received batches, overflow flags, counts): receiver d's batch
    (capacity P * quota, on devices[d]) holds the rows every sender bound
    for d, sender by sender, each sender's in its batch order; sender p's
    overflow is a 0-d bool tensor (some destination got more than `quota`
    rows, and rows were dropped) and counts[p] its pre-clamp (P,) int32
    row counts per destination, both on the sender's device."""
    P = n_parts
    if len(batches) != P:
        raise ValueError(f"hash_partition_exchange: {len(batches)} batches "
                         f"for {P} partitions")
    if multihost.spans_processes(devices):
        return _exchange_across(batches, key_indices, P, quota, devices,
                                salt, salt_mode)
    devices = _devices_of(batches, devices)
    sends, send_counts, overflows, counts = [], [], [], []
    for b in batches:
        send, sc, ov, cnt = exchange_send_layout(b, key_indices, P, quota,
                                                 salt, salt_mode)
        sends.append(send)
        send_counts.append(sc)
        overflows.append(ov)
        counts.append(cnt)
    matrices = {}     # device -> (senders, destinations) send counts
    out = []
    for d, dev in enumerate(devices):
        if str(dev) not in matrices:
            matrices[str(dev)] = torch.stack([sc.to(dev)
                                              for sc in send_counts])
        lo, hi = d * quota, (d + 1) * quota
        cols = [Column(torch.cat([s.columns[i].data[lo:hi].to(dev)
                                  for s in sends]),
                       torch.cat([s.columns[i].validity[lo:hi].to(dev)
                                  for s in sends]))
                for i in range(len(sends[0].columns))]
        out.append(_compact_segments(cols, matrices[str(dev)][:, d], quota))
    return out, overflows, counts


def all_gather_batch(batches: Sequence[Batch], n_parts: int,
                     devices=None) -> List[Batch]:
    """Every partition's live rows onto every partition, in partition
    order (the reference's all_gather; CoalescePartitionsExec and the
    broadcast side of a join): capacity P x the partitions' capacity.
    Partitions on one device share one batch."""
    if len(batches) != n_parts:
        raise ValueError(f"all_gather_batch: {len(batches)} batches for "
                         f"{n_parts} partitions")
    if multihost.spans_processes(devices):
        return _gather_across(batches, devices)
    devices = _devices_of(batches, devices)
    made = {}
    for dev in devices:
        if str(dev) in made:
            continue
        cols = [Column(torch.cat([b.columns[i].data.to(dev) for b in batches]),
                       torch.cat([b.columns[i].validity.to(dev)
                                  for b in batches]))
                for i in range(len(batches[0].columns))]
        nrows = torch.stack([b.num_rows.to(dev) for b in batches])
        made[str(dev)] = _compact_segments(cols, nrows, batches[0].capacity)
    return [made[str(dev)] for dev in devices]


def _padded(parts, seg: int, like: torch.Tensor) -> torch.Tensor:
    """Segments of `seg` slots, segment k holding parts[k] first and zeros
    (False for a validity) after it."""
    out = torch.zeros(len(parts) * seg, dtype=like.dtype, device=like.device)
    for k, t in enumerate(parts):
        out[k * seg:k * seg + t.shape[0]] = t
    return out


def _segment_batch(chunks, counts: torch.Tensor, seg: int, template: Batch,
                   device) -> Batch:
    """`_compact_segments` over the columns of P segments whose k-th holds
    the rows chunks[k] (a list of (data, validity) per column)."""
    cols = [Column(_padded([c[i][0] for c in chunks], seg,
                           template.columns[i].data.to(device)),
                   _padded([c[i][1] for c in chunks], seg,
                           template.columns[i].validity.to(device)))
            for i in range(len(template.columns))]
    return _compact_segments(cols, counts.to(device), seg)


def _specs(template: Batch, n: int):
    return [spec for c in template.columns
            for spec in ((c.data.dtype, n), (c.validity.dtype, n))]


def _chunks(parts, n_cols: int):
    """A flat [data, validity, data, ...] list as [(data, validity)]."""
    return [(parts[2 * i], parts[2 * i + 1]) for i in range(n_cols)]


def _exchange_across(batches, key_indices, P: int, quota: int, mesh,
                     salt: int, salt_mode):
    """`hash_partition_exchange` over a mesh that spans processes: this
    process's senders lay out their send buffers, the (senders,
    destinations) send counts are summed over the processes, and every
    process sends each other the rows its senders bound for that
    process's destinations, sender by sender, destination by
    destination. Receivers and flags of other processes' partitions are
    None."""
    local = mesh.local_partitions
    sends, ovs, counts = {}, [None] * P, [None] * P
    for p in local:
        send, sc, ov, cnt = exchange_send_layout(batches[p], key_indices, P,
                                                 quota, salt, salt_mode)
        sends[p] = (send, sc)
        ovs[p], counts[p] = ov, cnt
    sc_all = torch.zeros((P, P), dtype=torch.int64)
    for p, (_, sc) in sends.items():
        sc_all[p] = sc.cpu().to(torch.int64)
    sc_all = multihost.all_reduce_sum(sc_all)
    n = sc_all.tolist()
    template = sends[local[0]][0]
    device = template.device

    def rows(s, d):
        send = sends[s][0]
        lo = d * quota
        return [t[lo:lo + n[s][d]] for c in send.columns
                for t in (c.data, c.validity)]

    others = [r for r in range(mesh.world) if r != mesh.rank]
    got = multihost.swap(
        {r: [t for s in local for d in mesh.partitions_of(r)
             for t in rows(s, d)] for r in others},
        {r: [spec for s in mesh.partitions_of(r) for d in local
             for spec in _specs(template, n[s][d])] for r in others},
        device)
    # from each sender s, the (data, validity) per column bound for d
    n_cols = len(template.columns)
    per = {}
    for r in others:
        parts, at = got[r], 0
        for s in mesh.partitions_of(r):
            for d in local:
                per[s, d] = _chunks(parts[at:at + 2 * n_cols], n_cols)
                at += 2 * n_cols
    for s in local:
        for d in local:
            per[s, d] = _chunks([t.to(device) for t in rows(s, d)], n_cols)
    out = [None] * P
    for d in local:
        out[d] = _segment_batch([per[s, d] for s in range(P)],
                                sc_all[:, d], quota, template,
                                mesh[d])
    return out, ovs, counts


def _gather_across(batches, mesh) -> List[Batch]:
    """`all_gather_batch` over a mesh that spans processes: the row counts
    are summed over the processes, every process sends each other its
    partitions' live rows, and each process builds the gathered batch once
    for its partitions (None for other processes')."""
    P = len(batches)
    local = mesh.local_partitions
    template = batches[local[0]]
    seg = template.capacity
    nrows = torch.zeros(P, dtype=torch.int64)
    for p in local:
        nrows[p] = batches[p].num_rows.cpu().to(torch.int64)
    nrows = multihost.all_reduce_sum(nrows)
    n = nrows.tolist()

    def rows(p):
        return [t[:n[p]] for c in batches[p].columns
                for t in (c.data, c.validity)]

    others = [r for r in range(mesh.world) if r != mesh.rank]
    device = template.device
    got = multihost.swap(
        {r: [t for p in local for t in rows(p)] for r in others},
        {r: [spec for p in mesh.partitions_of(r)
             for spec in _specs(template, n[p])] for r in others},
        device)
    n_cols = len(template.columns)
    per = {p: _chunks([t.to(device) for t in rows(p)], n_cols) for p in local}
    for r in others:
        parts = got[r]
        for k, p in enumerate(mesh.partitions_of(r)):
            per[p] = _chunks(parts[2 * n_cols * k:2 * n_cols * (k + 1)],
                             n_cols)
    made = _segment_batch([per[p] for p in range(P)], nrows, seg, template,
                          device)
    return [made if mesh.is_local(p) else None for p in range(P)]
