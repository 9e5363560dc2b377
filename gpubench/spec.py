"""What a cell is made of, found by name: `BENCHMARK.json` names the cell's
configuration and traffic mix; `configs/<config>.json` names its
dataset family, whose generator is `data/<family>.py`, whose plain
reference is `reference/<family>.py` and whose query texts are
`queries/<family>.json`; `traffic/<mix>.json` lists the queries of the
mix; `metrics/<metric>.py` reads one metric. A later change adds a
configuration, a mix or a metric by adding files."""

from __future__ import annotations

import importlib
import json
import os
from typing import NamedTuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Cell(NamedTuple):
    name: str
    config: dict
    traffic: dict
    queries: dict           # query id -> SQL text
    chips: int
    end_to_end: list        # metric entries of BENCHMARK.json for this cell
    per_layer: list


def _load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT, here: str = HERE) -> Cell:
    bench = _load(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    config = _load(os.path.join(here, "configs", f"{wl['config']}.json"))
    traffic = _load(os.path.join(here, "traffic", f"{wl['traffic']}.json"))
    queries = _load(os.path.join(here, "queries", f"{config['family']}.json"))
    if traffic["family"] != config["family"]:
        raise ValueError(f"mix {wl['traffic']} is of {traffic['family']}, "
                         f"configuration {wl['config']} of {config['family']}")
    missing = [q for q in traffic["order"] if q not in queries]
    if missing:
        raise KeyError(f"mix {wl['traffic']}: no query text for {missing}")
    return Cell(name, config, traffic, queries, int(wl["chips"]),
                [m for m in bench["end_to_end"] if applies(m, name)],
                [m for m in bench["per_layer"] if applies(m, name)])


def module(kind: str, name: str):
    """gpubench.<kind>.<name>: data/ and reference/ by family, metrics/ by
    metric name."""
    return importlib.import_module(f"gpubench.{kind}.{name}")
