"""The h2oai db-benchmark join tables J1_<N>_NA_0_0 from a seed, as plain
numpy (`gpubench.tables`).

A copy of the layout of the db-benchmark's `_data/join-datagen.R`. For
each id, with n = N/1e6 (id1), N/1e3 (id2) and N (id3), 1.1 n distinct
keys are drawn from 1..2.5 n: the first 0.9 n are shared by x and the
right tables, the next 0.1 n are in x only, the last 0.1 n in the right
tables only (`split_keys`). Then:

- x (N rows): id1, id2, id3 drawn from x's n keys of each id, every key
  at least once (`sample_all`; x.id3 is a permutation of its N keys);
- small (N/1e6 rows, at least 10): id1 a permutation of its keys;
- medium (N/1e3 rows, at least 100): id1 drawn from the right keys of
  id1, id2 a permutation of its right keys;
- large ("big" in the generator's file names; N rows): id3 a permutation
  of its right keys, id1 and id2 drawn from theirs.

id4, id5 and id6 are the strings "id<k>" of id1, id2 and id3: id4 and id5
as codes into each table's own sorted dictionary of the strings it holds,
id6 as a text column, each row's span in one byte buffer of the 1.1 N key
strings of id3 (shared by x and large). v1 (x) and v2 (the right tables)
are uniform on [0, 100) rounded to 6 places. No NULLs, rows unsorted.
Every draw comes from its own stream `(seed, table, column[, chunk])`;
long columns are drawn in `CHUNKS` row ranges on a pool of threads.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..tables import Col, Tables, rng, string_col, text_col

CHUNKS = 32
# the right tables' floors at small N, as the port's launcher has them
SMALL_MIN, MEDIUM_MIN = 10, 100
TABLES = ("x", "small", "medium", "large")


def sizes(config: dict):
    """(N, rows of small, rows of medium)."""
    n = int(float(config["rows"]))
    return n, max(n // 10**6, SMALL_MIN), max(n // 10**3, MEDIUM_MIN)


def split_keys(seed: int, name: str, n: int):
    """(keys, x's key indices, the right tables' key indices): 1.1 n
    distinct keys from 1..2.5 n; indices [0, n) are x's (0.9 n shared,
    then 0.1 n of x alone), [0, 0.9 n) and [n, 1.1 n) the right tables'
    (n of each)."""
    shared = 9 * n // 10
    only = n - shared
    keys = rng(seed, "keys", name).choice(5 * n // 2, n + only,
                                          replace=False) + 1
    x_idx = np.arange(n, dtype=np.int64)
    r_idx = np.concatenate([np.arange(shared, dtype=np.int64),
                            np.arange(n, n + only, dtype=np.int64)])
    return keys.astype(np.int64), x_idx, r_idx


def _pool(threads: int) -> ThreadPoolExecutor:
    return ThreadPoolExecutor(threads or min(8, os.cpu_count() or 1))


def sample_all(seed: int, table: str, col: str, pool: np.ndarray, size: int,
               threads: int = 0) -> np.ndarray:
    """join-datagen.R's sample_all: `size` draws of `pool` in random order,
    each element at least once (a permutation where the sizes agree). The
    draws past the pool are made per row range; each element of the pool
    then takes a place of its own, drawn from the seed."""
    r = rng(seed, table, col)
    if len(pool) == size:
        return r.permutation(pool)
    out = np.empty(size, dtype=pool.dtype)
    bounds = [round(i * size / CHUNKS) for i in range(CHUNKS + 1)]

    def chunk(c):
        lo, hi = bounds[c], bounds[c + 1]
        out[lo:hi] = pool[rng(seed, table, col, c).integers(0, len(pool),
                                                             hi - lo)]
    with _pool(threads) as ex:
        list(ex.map(chunk, range(CHUNKS)))
    out[r.choice(size, len(pool), replace=False)] = r.permutation(pool)
    return out


def take(a: np.ndarray, idx: np.ndarray, threads: int = 0) -> np.ndarray:
    """a[idx], gathered per row range on a pool of threads."""
    out = np.empty(len(idx), dtype=a.dtype)
    bounds = [round(i * len(idx) / CHUNKS) for i in range(CHUNKS + 1)]

    def chunk(c):
        lo, hi = bounds[c], bounds[c + 1]
        np.take(a, idx[lo:hi], out=out[lo:hi])
    with _pool(threads) as ex:
        list(ex.map(chunk, range(CHUNKS)))
    return out


def uniform(seed: int, table: str, col: str, size: int,
            threads: int = 0) -> np.ndarray:
    out = np.empty(size, dtype=np.float64)
    bounds = [round(i * size / CHUNKS) for i in range(CHUNKS + 1)]

    def chunk(c):
        lo, hi = bounds[c], bounds[c + 1]
        draws = rng(seed, table, col, c).uniform(0, 100, hi - lo)
        out[lo:hi] = np.round(draws, 6)
    with _pool(threads) as ex:
        list(ex.map(chunk, range(CHUNKS)))
    return out


def id_names(keys: np.ndarray) -> np.ndarray:
    return np.char.add("id", keys.astype(str))


def string_codes(keys: np.ndarray, idx: np.ndarray, pool: np.ndarray,
                 threads: int = 0) -> Col:
    """A string column "id<keys[idx]>" as codes into the sorted dictionary
    of the strings of `pool`'s keys (every key the table holds)."""
    names = id_names(keys[pool])
    order = np.argsort(names, kind="stable")
    rank = np.full(len(keys), -1, dtype=np.int32)
    rank[pool[order]] = np.arange(len(pool), dtype=np.int32)
    return string_col(take(rank, idx, threads), names[order].astype(object))


def key_strings(keys: np.ndarray, threads: int = 0):
    """(bytes, starts, ends): the strings "id<k>" of `keys` one after
    another in one uint8 buffer, in the order of `keys`."""
    digits = np.ones(len(keys), dtype=np.int64)
    top = int(keys.max(initial=0))
    p = 10
    while p <= top:
        digits += keys >= p
        p *= 10
    ends = np.cumsum(digits + 2)
    starts = ends - digits - 2
    data = np.empty(int(ends[-1]) if len(ends) else 0, dtype=np.uint8)
    bounds = [round(i * len(keys) / CHUNKS) for i in range(CHUNKS + 1)]

    def chunk(c):
        lo, hi = bounds[c], bounds[c + 1]
        s, k, nd = starts[lo:hi], keys[lo:hi], digits[lo:hi]
        data[s] = ord("i")
        data[s + 1] = ord("d")
        for j in range(int(nd.max(initial=0))):
            at = nd > j
            place = 10 ** (nd[at] - 1 - j)
            data[s[at] + 2 + j] = ord("0") + (k[at] // place) % 10
    with _pool(threads) as ex:
        list(ex.map(chunk, range(CHUNKS)))
    return data, starts, ends


def generate(config: dict, seed: int, threads: int = 0) -> Tables:
    n, n_small, n_medium = sizes(config)
    k1, x1, r1 = split_keys(seed, "id1", n_small)
    k2, x2, r2 = split_keys(seed, "id2", n_medium)
    k3, x3, r3 = split_keys(seed, "id3", n)
    data, starts, ends = key_strings(k3, threads)

    def table(name, rows, draws):
        """draws: (column, keys, key pool, string column or None)."""
        out = {}
        strings = {}
        for col, keys, pool, string in draws:
            idx = sample_all(seed, name, col, pool, rows, threads)
            out[col] = Col(take(keys, idx, threads), "int64")
            if string == "id6":
                strings[string] = text_col(data, take(starts, idx, threads),
                                           take(ends, idx, threads))
            elif string is not None:
                strings[string] = string_codes(keys, idx, pool, threads)
            del idx
        out.update(strings)
        return out

    x = table("x", n, [("id1", k1, x1, "id4"), ("id2", k2, x2, "id5"),
                       ("id3", k3, x3, "id6")])
    x["v1"] = Col(uniform(seed, "x", "v1", n, threads), "float64")
    small = table("small", n_small, [("id1", k1, r1, "id4")])
    small["v2"] = Col(uniform(seed, "small", "v2", n_small, threads),
                      "float64")
    medium = table("medium", n_medium, [("id1", k1, r1, "id4"),
                                        ("id2", k2, r2, "id5")])
    medium["v2"] = Col(uniform(seed, "medium", "v2", n_medium, threads),
                       "float64")
    large = table("large", n, [("id1", k1, r1, "id4"), ("id2", k2, r2, "id5"),
                               ("id3", k3, r3, "id6")])
    large["v2"] = Col(uniform(seed, "large", "v2", n, threads), "float64")
    order = {"x": ("id1", "id2", "id3", "id4", "id5", "id6", "v1"),
             "small": ("id1", "id4", "v2"),
             "medium": ("id1", "id2", "id4", "id5", "v2"),
             "large": ("id1", "id2", "id3", "id4", "id5", "id6", "v2")}
    tables = {"x": x, "small": small, "medium": medium, "large": large}
    return {t: {c: tables[t][c] for c in order[t]} for t in TABLES}


def register(ctx, tables: Tables, config: dict) -> None:
    """The four tables with no primary key, as the db-benchmark loads
    them: id4 and id5 as codes into each table's sorted dictionary, id6
    ingested at first use from its bytes and spans (RAW where its
    estimated distinct count passes the program's threshold)."""
    from ..port import host_table
    for name in TABLES:
        fields, cols = host_table(tables[name])
        ctx.register_host(name, fields, cols)
