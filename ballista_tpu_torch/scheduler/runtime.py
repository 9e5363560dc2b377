"""Stage metrics, the shuffle-overflow error and its retry escalation (port
of ballista_tpu/scheduler/runtime.py `StageMetrics`, `ShuffleOverflowError`
and `escalate_overflow_opts`). The multi-device `DistributedRuntime` is not
ported."""

from __future__ import annotations

import dataclasses

import numpy as np


class StageMetrics:
    """Per-stage execution metrics (the reference's OperatorMetricsSet,
    shipped to the scheduler in TaskStatus). The serial runtime adds the
    partitions it ran and the bytes it moved between host and device."""

    def __init__(self):
        self.run_s = 0.0
        self.output_rows = 0
        self.retries = 0
        self.operator_rows = {}   # per-operator output rows across shards
        self.partitions = 0
        self.bytes_to_device = 0
        self.bytes_to_host = 0

    def as_dict(self):
        return {"run_s": round(self.run_s, 4),
                "output_rows": int(self.output_rows),
                "retries": self.retries,
                "operator_rows": self.operator_rows,
                "partitions": self.partitions,
                "bytes_to_device": self.bytes_to_device,
                "bytes_to_host": self.bytes_to_host}


class ShuffleOverflowError(RuntimeError):
    """A shuffle exchange (or group table) outgrew its fixed quota. When the
    runtime saw the shuffle-write stats it attaches them as `stats`: a list
    of per-exchange dicts {"quota": int, "salt_kind": str or None,
    "counts": (shards, P) array} of pre-clamp destination row counts (the
    reference's PartitionStats, serde/scheduler/mod.rs:33-100)."""


class CapacityOverflowError(ShuffleOverflowError):
    """An operator outgrew its static capacity (a group table, an
    expanding join's output) while every exchange kept to its quota: the
    retry grows group tables and join outputs, as the in-core path does,
    and leaves the quotas (`grow_capacities`)."""


def grow_capacities(opts):
    """The DistOptions of the retry after a CapacityOverflowError."""
    return dataclasses.replace(opts, max_group_table=opts.max_group_table * 4,
                               join_out_factor=opts.join_out_factor * 4)


def escalate_overflow_opts(opts, err, attempt: int):
    """The DistOptions of the retry after a quota overflow.

    With shuffle-write stats: the worst observed per-(shard, destination)
    count against its quota sets the headroom, and a max / median ratio of
    4 or more on a saltable (join) exchange is hot-key skew, which gets the
    key split over `join_salt` destinations instead. Without stats (a
    group table or an expanding join that outgrew its capacity) the first
    retry bumps quotas and later retries add salt. Every retry also gives
    group tables and expanding joins 4x the room."""
    ratio = 0.0      # worst observed need/quota over exchanges
    skew = 1.0       # worst max/median on a saltable exchange
    flat = hot = 0.0  # flat vs hot-key components of the skewed need
    quota_of_skewed = 1.0
    salt = opts.join_salt
    for s in getattr(err, "stats", None) or ():
        c = np.asarray(s["counts"], np.float64).reshape(-1, opts.n_partitions)
        need = float(c.max())
        q = max(1.0, float(s["quota"]))
        if need <= q:
            continue
        ratio = max(ratio, need / q)
        if s["salt_kind"] is not None:
            pos = c[c > 0]
            med = float(np.median(pos)) if pos.size else 1.0
            sk = need / max(1.0, med)
            if sk > skew:
                skew, quota_of_skewed = sk, q
                # salting spreads only the hot key's rows over more
                # destinations; the flat component stays put
                flat, hot = med, need - med
    if ratio > 0.0:
        if skew >= 4.0:
            salt = int(min(opts.n_partitions,
                           max(2 * opts.join_salt,
                               1 << int(np.ceil(np.log2(
                                   min(skew, opts.n_partitions)))))))
            projected = flat + hot * opts.join_salt / salt
            headroom = opts.quota_headroom * max(
                1.2, 1.5 * projected / quota_of_skewed)
        else:
            # 2x the worst observed need: the stats come from the first
            # overflowing shard only, and its siblings are often worse
            headroom = opts.quota_headroom * 2.0 * ratio
        return dataclasses.replace(grow_capacities(opts),
                                   quota_headroom=headroom, join_salt=salt)
    salt = opts.join_salt if attempt == 0 else max(
        2, min(opts.join_salt * 4, opts.n_partitions))
    return dataclasses.replace(grow_capacities(opts),
                               quota_headroom=opts.quota_headroom * 4,
                               join_salt=salt)
