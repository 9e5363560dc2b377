"""Session configuration — string-typed, validated key/value settings.

Reference parity: `BallistaConfig` (`ballista/core/src/config.rs:30-213`):
a kv map validated against a registry of `ConfigEntry`s with defaults,
shipped with each job and applied to the engine. Same surface here; values
map onto PhysicalOptions and the serial runtime's DistOptions. (The
port's own copy of ballista_tpu/config.py. The capacity mode is kept as a
setting that the port does not act on: its capacities are always the
lane-rounded row count.)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

BALLISTA_JOB_NAME = "ballista.job.name"
BALLISTA_SHUFFLE_PARTITIONS = "ballista.shuffle.partitions"
BALLISTA_BATCH_SIZE = "ballista.batch.size"
BALLISTA_REPARTITION_JOINS = "ballista.repartition.joins"
BALLISTA_REPARTITION_AGGREGATIONS = "ballista.repartition.aggregations"
BALLISTA_WITH_INFORMATION_SCHEMA = "ballista.with_information_schema"
# additions of this engine
BALLISTA_CAPACITY_MODE = "ballista.capacity.mode"
BALLISTA_BROADCAST_THRESHOLD = "ballista.join.broadcast_threshold"
BALLISTA_MAX_GROUP_TABLE = "ballista.agg.max_group_table"
BALLISTA_QUOTA_HEADROOM = "ballista.shuffle.quota_headroom"
BALLISTA_PLUGIN_DIR = "ballista.plugin.dir"


def _parse_bool(s: str) -> bool:
    if s.lower() in ("true", "1", "yes"):
        return True
    if s.lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"not a boolean: {s!r}")


def _parse_capacity_mode(s: str) -> str:
    if s not in ("exact", "bucket"):
        raise ValueError(f"not a capacity mode: {s!r}")
    return s


@dataclasses.dataclass(frozen=True)
class ConfigEntry:
    key: str
    description: str
    parse: Callable[[str], Any]
    default: str


VALID_ENTRIES = {e.key: e for e in [
    ConfigEntry(BALLISTA_JOB_NAME, "Human-readable job name", str, ""),
    ConfigEntry(BALLISTA_SHUFFLE_PARTITIONS,
                "Default shuffle partition count", int, "16"),
    ConfigEntry(BALLISTA_BATCH_SIZE, "Rows per batch tile", int, "8192"),
    ConfigEntry(BALLISTA_REPARTITION_JOINS,
                "Repartition inputs to parallelize joins", _parse_bool, "true"),
    ConfigEntry(BALLISTA_REPARTITION_AGGREGATIONS,
                "Repartition inputs to parallelize aggregations", _parse_bool,
                "true"),
    ConfigEntry(BALLISTA_WITH_INFORMATION_SCHEMA,
                "Provide information_schema tables", _parse_bool, "false"),
    ConfigEntry(BALLISTA_CAPACITY_MODE,
                "Batch capacity sizing: 'exact' (lane-rounded row count) or "
                "'bucket' (geometric tiers, <19% padding, reuses compiled "
                "programs across data sizes)",
                _parse_capacity_mode, "bucket"),
    ConfigEntry(BALLISTA_BROADCAST_THRESHOLD,
                "Max build-side rows for broadcast join", int, str(1 << 17)),
    ConfigEntry(BALLISTA_MAX_GROUP_TABLE,
                "Max group hash-table slots", int, str(1 << 21)),
    ConfigEntry(BALLISTA_QUOTA_HEADROOM,
                "Shuffle per-destination quota headroom factor", float, "2.0"),
    ConfigEntry(BALLISTA_PLUGIN_DIR,
                "Directory of UDF plugin modules loaded at session start "
                "(core/src/plugin plugin_dir parity)", str, ""),
]}


class BallistaConfig:
    def __init__(self, settings: Optional[Dict[str, str]] = None):
        self.settings: Dict[str, str] = {}
        for k, v in (settings or {}).items():
            self.set(k, v)

    def set(self, key: str, value: str) -> "BallistaConfig":
        entry = VALID_ENTRIES.get(key)
        if entry is None:
            raise KeyError(f"unknown configuration key {key!r}")
        entry.parse(str(value))  # validate
        self.settings[key] = str(value)
        return self

    def get(self, key: str):
        entry = VALID_ENTRIES[key]
        return entry.parse(self.settings.get(key, entry.default))

    # typed accessors (config.rs helper parity)
    def shuffle_partitions(self) -> int:
        return self.get(BALLISTA_SHUFFLE_PARTITIONS)

    def batch_size(self) -> int:
        return self.get(BALLISTA_BATCH_SIZE)

    def job_name(self) -> str:
        return self.get(BALLISTA_JOB_NAME)

    def capacity_mode(self) -> str:
        return self.get(BALLISTA_CAPACITY_MODE)

    def to_dist_options(self, n_partitions: Optional[int] = None):
        from .scheduler.distributed_planner import DistOptions
        return DistOptions(
            n_partitions=n_partitions or self.shuffle_partitions(),
            broadcast_threshold=self.get(BALLISTA_BROADCAST_THRESHOLD),
            max_group_table=self.get(BALLISTA_MAX_GROUP_TABLE),
            quota_headroom=self.get(BALLISTA_QUOTA_HEADROOM),
        )

    def to_physical_options(self):
        from .planner.physical import PhysicalOptions
        return PhysicalOptions(max_group_table=self.get(BALLISTA_MAX_GROUP_TABLE))
