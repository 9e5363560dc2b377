"""The h2oai db-benchmark groupby table G1_<N>_<K>_0_0 from a seed, as
plain numpy (`gpubench.tables`).

A frozen copy of the layout of `ballista_tpu_torch/benchmarks/h2o.py
groupby_table` (the db-benchmark's own generator): id1 and id2 strings
"id1".."id<K>", id3 strings "id1".."id<N/K>", id4 and id5 integers 1..K,
id6 integers 1..N/K, v1 in 1..5, v2 in 1..15, v3 uniform on [0, 100)
rounded to 6 places; no NULLs, rows unsorted. The rows are cut into
`CHUNKS` ranges, each drawn from its own stream `(seed, "h2o", chunk)`
on a pool of threads. The string ids come out as codes into the sorted
dictionary of their K (or N/K) values, the strings `id_strings` makes.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..tables import Col, Tables, rng, string_col

CHUNKS = 32
TABLE = "x"


def id_dictionary(hi: int):
    """(sorted "id<k>" strings for k in 1..hi, rank of each k - 1)."""
    names = np.char.add("id", np.arange(1, hi + 1).astype(str))
    order = np.argsort(names, kind="stable")
    rank = np.empty(hi, dtype=np.int32)
    rank[order] = np.arange(hi, dtype=np.int32)
    return names[order].astype(object), rank


def generate(config: dict, seed: int, threads: int = 0) -> Tables:
    n, k = int(float(config["rows"])), int(config["k"])
    nk = max(n // k, 1)
    bounds = [round(i * n / CHUNKS) for i in range(CHUNKS + 1)]
    cols = {"id1": np.empty(n, np.int64), "id2": np.empty(n, np.int64),
            "id3": np.empty(n, np.int64), "id4": np.empty(n, np.int64),
            "id5": np.empty(n, np.int64), "id6": np.empty(n, np.int64),
            "v1": np.empty(n, np.int64), "v2": np.empty(n, np.int64),
            "v3": np.empty(n, np.float64)}

    def chunk(c):
        lo, hi = bounds[c], bounds[c + 1]
        r, m = rng(seed, "h2o", c), bounds[c + 1] - bounds[c]
        for name, top in (("id1", k), ("id2", k), ("id3", nk), ("id4", k),
                          ("id5", k), ("id6", nk), ("v1", 5), ("v2", 15)):
            cols[name][lo:hi] = r.integers(1, top + 1, m)
        cols["v3"][lo:hi] = np.round(r.uniform(0, 100, m), 6)
    with ThreadPoolExecutor(threads or min(8, os.cpu_count() or 1)) as ex:
        list(ex.map(chunk, range(CHUNKS)))
    out = {}
    for name, hi in (("id1", k), ("id2", k), ("id3", nk)):
        dictionary, rank = id_dictionary(hi)
        out[name] = string_col(rank[cols.pop(name) - 1], dictionary)
    for name in ("id4", "id5", "id6", "v1", "v2"):
        out[name] = Col(cols[name], "int64")
    out["v3"] = Col(cols["v3"], "float64")
    order = ("id1", "id2", "id3", "id4", "id5", "id6", "v1", "v2", "v3")
    return {TABLE: {c: out[c] for c in order}}


def register(ctx, tables: Tables, config: dict) -> None:
    """The table as a user registers dictionary-encoded (categorical)
    string ids: codes into a sorted dictionary, ingested as they are."""
    from ..port import host_table
    fields, cols = host_table(tables[TABLE])
    ctx.register_host(TABLE, fields, cols)
