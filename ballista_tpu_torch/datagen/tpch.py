"""The eight TPC-H tables, generated straight into host columns (port of
the generators of ballista_tpu/datagen/tpch.py).

Same seed, same rng streams and the same draws in the same order as the
JAX package's `generate_table`, so the rows are identical; but instead of a
pyarrow table each column comes out as the `HostColumn` that the JAX
package's ingest (`ingest_column_host`) would make of it: decimals as
scaled int64, dates as int32 days, strings as int32 codes into a sorted
dictionary of the values present. No pyarrow. `register_tpch` then takes
ingest's RAW decision (`batch._estimate_high_cardinality`) on every
string column, as the reference's arrow ingest does.

The chunked datagen (`generate_tpch_parquet`, `datagen --chunks`) draws
each row range of a table from its own stream, as the JAX package's does,
and writes parquet part files; pyarrow is imported by the writer alone.

Every field is nullable, as the reference's arrow schemas declare it.
"""

from __future__ import annotations

import datetime
import logging
import os
import zlib
from functools import partial
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..batch import HostColumn, _estimate_high_cardinality, raw_dict_max
from ..schema import (DATE32, INT32, INT64, STRING, DataType, Field, Schema,
                      TypeKind, decimal)

log = logging.getLogger(__name__)

EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d):
    return (datetime.date(y, m, d) - EPOCH).days


STARTDATE = _days(1992, 1, 1)
CURRENTDATE = _days(1995, 6, 17)
ENDDATE = _days(1998, 12, 31)

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "MACHINERY", "HOUSEHOLD"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL", "FOB"]
INSTRUCTIONS = ["DELIVER IN PERSON", "COLLECT COD", "NONE", "TAKE BACK RETURN"]
TYPE_S1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
TYPE_S2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
TYPE_S3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
CONTAIN_S1 = ["SM", "LG", "MED", "JUMBO", "WRAP"]
CONTAIN_S2 = ["CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM"]
COLORS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque",
          "black", "blanched", "blue", "blush", "brown", "burlywood",
          "burnished", "chartreuse", "chiffon", "chocolate", "coral",
          "cornflower", "cornsilk", "cream", "cyan", "dark", "deep",
          "dim", "dodger", "drab", "firebrick", "floral", "forest",
          "frosted", "gainsboro", "ghost", "goldenrod", "green", "grey",
          "honeydew", "hot", "hotpink", "indian", "ivory", "khaki",
          "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
          "magenta", "maroon", "medium", "metallic", "midnight", "mint",
          "misty", "moccasin", "navajo", "navy", "olive", "orange",
          "orchid", "pale", "papaya", "peach", "peru", "pink", "plum",
          "powder", "puff", "purple", "red", "rose", "rosy", "royal",
          "saddle", "salmon", "sandy", "seashell", "sienna", "sky",
          "slate", "smoke", "snow", "spring", "steel", "tan", "thistle",
          "tomato", "turquoise", "violet", "wheat", "white", "yellow"]
NOUNS = ["packages", "requests", "accounts", "deposits", "foxes", "ideas",
         "theodolites", "pinto beans", "instructions", "dependencies",
         "excuses", "platelets", "asymptotes", "courts", "dolphins",
         "multipliers", "sauternes", "warthogs", "frets", "dinos"]
VERBS = ["sleep", "wake", "are", "cajole", "haggle", "nag", "use", "boost",
         "affix", "detect", "integrate", "maintain", "nod", "was", "lose",
         "sublate", "solve", "thrash", "promise", "engage"]
ADJS = ["furious", "sly", "careful", "blithe", "quick", "fluffy", "slow",
        "quiet", "ruthless", "thin", "close", "dogged", "daring", "brave",
        "stealthy", "permanent", "enticing", "idle", "busy", "regular",
        "final", "ironic", "even", "bold", "silent", "special", "pending",
        "express", "unusual"]

MONEY = decimal(15, 2)

# table -> (row_count_fn(sf), primary_key, fields), in generation order
TPCH_TABLES = {
    "region": (lambda sf: 5, ("r_regionkey",), (
        Field("r_regionkey", INT64), Field("r_name", STRING),
        Field("r_comment", STRING))),
    "nation": (lambda sf: 25, ("n_nationkey",), (
        Field("n_nationkey", INT64), Field("n_name", STRING),
        Field("n_regionkey", INT64), Field("n_comment", STRING))),
    "supplier": (lambda sf: int(10_000 * sf), ("s_suppkey",), (
        Field("s_suppkey", INT64), Field("s_name", STRING),
        Field("s_address", STRING), Field("s_nationkey", INT64),
        Field("s_phone", STRING), Field("s_acctbal", MONEY),
        Field("s_comment", STRING))),
    "customer": (lambda sf: int(150_000 * sf), ("c_custkey",), (
        Field("c_custkey", INT64), Field("c_name", STRING),
        Field("c_address", STRING), Field("c_nationkey", INT64),
        Field("c_phone", STRING), Field("c_acctbal", MONEY),
        Field("c_mktsegment", STRING), Field("c_comment", STRING))),
    "part": (lambda sf: int(200_000 * sf), ("p_partkey",), (
        Field("p_partkey", INT64), Field("p_name", STRING),
        Field("p_mfgr", STRING), Field("p_brand", STRING),
        Field("p_type", STRING), Field("p_size", INT32),
        Field("p_container", STRING), Field("p_retailprice", MONEY),
        Field("p_comment", STRING))),
    "partsupp": (lambda sf: int(800_000 * sf), ("ps_partkey", "ps_suppkey"), (
        Field("ps_partkey", INT64), Field("ps_suppkey", INT64),
        Field("ps_availqty", INT32), Field("ps_supplycost", MONEY),
        Field("ps_comment", STRING))),
    "orders": (lambda sf: int(1_500_000 * sf), ("o_orderkey",), (
        Field("o_orderkey", INT64), Field("o_custkey", INT64),
        Field("o_orderstatus", STRING), Field("o_totalprice", MONEY),
        Field("o_orderdate", DATE32), Field("o_orderpriority", STRING),
        Field("o_clerk", STRING), Field("o_shippriority", INT32),
        Field("o_comment", STRING))),
    "lineitem": (lambda sf: None, ("l_orderkey", "l_linenumber"), (
        Field("l_orderkey", INT64), Field("l_partkey", INT64),
        Field("l_suppkey", INT64), Field("l_linenumber", INT32),
        Field("l_quantity", MONEY), Field("l_extendedprice", MONEY),
        Field("l_discount", MONEY), Field("l_tax", MONEY),
        Field("l_returnflag", STRING), Field("l_linestatus", STRING),
        Field("l_shipdate", DATE32), Field("l_commitdate", DATE32),
        Field("l_receiptdate", DATE32), Field("l_shipinstruct", STRING),
        Field("l_shipmode", STRING), Field("l_comment", STRING))),
}
N_PART = TPCH_TABLES["part"][0]
N_SUPP = TPCH_TABLES["supplier"][0]
N_CUST = TPCH_TABLES["customer"][0]

Table = Tuple[Tuple[Field, ...], Dict[str, HostColumn]]


def from_ingested(values, validity, dictionary, bounds,
                  is_raw: bool = False) -> HostColumn:
    """The JAX package's host-ingest tuple (numpy arrays, from
    `ballista_tpu.batch.ingest_column_host`: values, validity, dictionary,
    is_raw, bounds) as a port host column.

    A RAW dictionary (`is_raw`: the column's values in row order, code ==
    row index) is kept as it is. Any other dictionary must be sorted and
    distinct, because code order stands for lexicographic order: an
    unsorted one not flagged raw raises ValueError instead of giving
    wrong answers."""
    if dictionary is not None and not is_raw:
        d = np.asarray(dictionary, dtype=object).astype(str)
        if len(d) > 1 and not bool((d[1:] > d[:-1]).all()):
            raise ValueError("unsorted string dictionary not flagged raw: "
                             "the port needs sorted, distinct values")
    return HostColumn(np.asarray(values), np.asarray(validity, dtype=bool),
                      None if dictionary is None
                      else np.asarray(dictionary, dtype=object),
                      None if bounds is None
                      else (int(bounds[0]), int(bounds[1])), bool(is_raw))


def as_ingested(col: HostColumn, raw_max: Optional[int] = None
                ) -> HostColumn:
    """A generated string column as ingest takes it: RAW (the values in
    row order, code == row index) where its estimated distinct count
    exceeds `raw_max` (default BALLISTA_RAW_DICT_MAX), else as it is."""
    if col.dictionary is None or col.raw:
        return col

    def values_at(idx):
        return np.where(col.validity[idx], col.dictionary[col.values[idx]],
                        "")

    n = len(col.values)
    if not _estimate_high_cardinality(n, values_at, raw_max):
        return col
    return HostColumn(np.arange(n, dtype=np.int32), col.validity,
                      values_at(np.arange(n)), None, raw=True)


def _numeric(values: np.ndarray, dtype: DataType) -> HostColumn:
    values = values.astype(dtype.np_dtype)
    bounds = (int(values.min()), int(values.max())) if len(values) else None
    return HostColumn(values, np.ones(len(values), dtype=bool), None, bounds)


def _strings(categories, idx: np.ndarray) -> HostColumn:
    """Column of categories[idx], dictionary-encoded against the sorted
    distinct values that occur."""
    categories = np.asarray(categories, dtype=object)
    present = np.flatnonzero(np.bincount(idx, minlength=len(categories)))
    vals = categories[present].astype(str)
    dictionary = np.unique(vals)
    lut = np.zeros(len(categories), dtype=np.int32)
    lut[present] = np.searchsorted(dictionary, vals)
    return HostColumn(lut[idx], np.ones(len(idx), dtype=bool),
                      dictionary.astype(object), None)


def _distinct_strings(values) -> HostColumn:
    """Column of arbitrary strings, dictionary-encoded against their
    sorted distinct values."""
    vals = np.asarray(values, dtype=object).astype(str)
    dictionary, codes = np.unique(vals, return_inverse=True)
    return HostColumn(codes.astype(np.int32), np.ones(len(vals), dtype=bool),
                      dictionary.astype(object), None)


def _comment_pool(rng: np.random.Generator, n_pool: int,
                  with_special: bool = False):
    """Bounded pool of dbgen-flavored comment sentences."""
    adj = rng.choice(ADJS, n_pool)
    noun = rng.choice(NOUNS, n_pool)
    verb = rng.choice(VERBS, n_pool)
    adj2 = rng.choice(ADJS, n_pool)
    noun2 = rng.choice(NOUNS, n_pool)
    out = np.array([f"{a} {n} {v} {a2} {n2}"
                    for a, n, v, a2, n2 in zip(adj, noun, verb, adj2, noun2)],
                   dtype=object)
    if with_special:
        # dbgen: some o_comments contain 'special ... requests' (Q13)
        k = max(n_pool // 100, 1)
        idx = rng.choice(n_pool, k, replace=False)
        for i in idx:
            out[i] = f"special packages {rng.choice(VERBS)} requests"
    return out


def _rng(name: str, seed: int) -> np.random.Generator:
    # stable per-table seed — Python's hash() is salted per process
    return np.random.default_rng(seed + zlib.crc32(name.encode()) % 100000)


def _phone(rng: np.random.Generator, nk: np.ndarray) -> HostColumn:
    c = 10 + nk
    a = rng.integers(100, 1000, len(nk))
    b = rng.integers(100, 1000, len(nk))
    d = rng.integers(1000, 10000, len(nk))
    return _distinct_strings([f"{ci}-{ai}-{bi}-{di}"
                              for ci, ai, bi, di in zip(c, a, b, d)])


def _region(sf: float, seed: int) -> Table:
    rng = _rng("region", seed)
    cols = {
        "r_regionkey": _numeric(np.arange(5), INT64),
        "r_name": _distinct_strings(REGIONS),
        "r_comment": _distinct_strings(_comment_pool(rng, 5)),
    }
    return TPCH_TABLES["region"][2], cols


def _nation(sf: float, seed: int) -> Table:
    rng = _rng("nation", seed)
    cols = {
        "n_nationkey": _numeric(np.arange(25), INT64),
        "n_name": _distinct_strings([n for n, _ in NATIONS]),
        "n_regionkey": _numeric(np.array([r for _, r in NATIONS]), INT64),
        "n_comment": _distinct_strings(_comment_pool(rng, 25)),
    }
    return TPCH_TABLES["nation"][2], cols


def _range(full_n: int, lo, hi):
    """(lo, hi) of a chunk, or of the whole table when lo is None."""
    return (0, full_n) if lo is None else (lo, hi)


def _supplier(sf: float, seed: int, lo=None, hi=None, rng=None) -> Table:
    rng = rng or _rng("supplier", seed)
    lo, hi = _range(N_SUPP(sf), lo, hi)
    n = hi - lo
    keys = np.arange(lo + 1, hi + 1)
    nk = rng.integers(0, 25, n)
    pool = _comment_pool(rng, 1000)
    # dbgen: some suppliers have 'Customer ... Complaints' comments (Q16)
    comments = pool[rng.integers(0, 1000, n)].copy()
    idx = rng.choice(n, max(n // 100, 1), replace=False)
    comments[idx] = "take Customer deposits Complaints"
    cols = {
        "s_suppkey": _numeric(keys, INT64),
        "s_name": _distinct_strings([f"Supplier#{k:09d}" for k in keys]),
        "s_address": _strings(pool, rng.integers(0, 1000, n)),
        "s_nationkey": _numeric(nk, INT64),
        "s_phone": _phone(rng, nk),
        "s_acctbal": _numeric(rng.integers(-99999, 999999, n), MONEY),
        "s_comment": _distinct_strings(comments),
    }
    return TPCH_TABLES["supplier"][2], cols


def _customer(sf: float, seed: int, lo=None, hi=None, rng=None) -> Table:
    rng = rng or _rng("customer", seed)
    lo, hi = _range(N_CUST(sf), lo, hi)
    n = hi - lo
    keys = np.arange(lo + 1, hi + 1)
    nk = rng.integers(0, 25, n)
    pool = _comment_pool(rng, 1000)
    cols = {
        "c_custkey": _numeric(keys, INT64),
        "c_name": _distinct_strings([f"Customer#{k:09d}" for k in keys]),
        "c_address": _strings(pool, rng.integers(0, 1000, n)),
        "c_nationkey": _numeric(nk, INT64),
        "c_phone": _phone(rng, nk),
        "c_acctbal": _numeric(rng.integers(-99999, 999999, n), MONEY),
        "c_mktsegment": _strings(SEGMENTS, rng.integers(0, 5, n)),
        "c_comment": _strings(pool, rng.integers(0, 1000, n)),
    }
    return TPCH_TABLES["customer"][2], cols


def _part(sf: float, seed: int, lo=None, hi=None, rng=None) -> Table:
    rng = rng or _rng("part", seed)
    lo, hi = _range(N_PART(sf), lo, hi)
    n = hi - lo
    keys = np.arange(lo + 1, hi + 1)
    # the reference's draw order: five colour words per name, the three
    # type words, the two container words, the comment pool, then (its
    # dict literal's key order) mfgr, brand's two digits, size, comment
    colors = np.array(COLORS, dtype=object)
    words = [colors[rng.integers(0, len(COLORS), n)] for _ in range(5)]
    t1, t2, t3 = (rng.integers(0, 6, n), rng.integers(0, 5, n),
                  rng.integers(0, 5, n))
    k1, k2 = rng.integers(0, 5, n), rng.integers(0, 8, n)
    pool = _comment_pool(rng, 1000)
    mfgr = rng.integers(1, 6, n)
    brand_m, brand_x = rng.integers(1, 6, n), rng.integers(1, 6, n)
    size = rng.integers(1, 51, n)
    comment = rng.integers(0, 1000, n)
    # retail price per dbgen's formula, through float64 as the reference
    price = (90000 + (keys % 20001) / 10 + 100 * (keys % 1000)).astype(np.int64)
    types = [f"{a} {b} {c}" for a in TYPE_S1 for b in TYPE_S2 for c in TYPE_S3]
    containers = [f"{a} {b}" for a in CONTAIN_S1 for b in CONTAIN_S2]
    cols = {
        "p_partkey": _numeric(keys, INT64),
        "p_name": _distinct_strings([" ".join(w) for w in zip(*words)]),
        "p_mfgr": _strings([f"Manufacturer#{m}" for m in range(1, 6)],
                           mfgr - 1),
        "p_brand": _strings([f"Brand#{m}{x}" for m in range(1, 6)
                             for x in range(1, 6)],
                            (brand_m - 1) * 5 + brand_x - 1),
        "p_type": _strings(types, t1 * 25 + t2 * 5 + t3),
        "p_size": _numeric(size, INT32),
        "p_container": _strings(containers, k1 * 8 + k2),
        "p_retailprice": _numeric(price, MONEY),
        "p_comment": _strings(pool, comment),
    }
    return TPCH_TABLES["part"][2], cols


def _partsupp(sf: float, seed: int, lo=None, hi=None, rng=None) -> Table:
    """A chunk's range indexes part rows (four partsupp rows each)."""
    rng = rng or _rng("partsupp", seed)
    n_supp = N_SUPP(sf)
    lo, hi = _range(N_PART(sf), lo, hi)
    # four suppliers per part, the ones lineitem draws from
    pk = np.repeat(np.arange(lo + 1, hi + 1), 4)
    sk = ((pk + np.tile(np.arange(4), hi - lo) * (n_supp // 4 + 1))
          % n_supp) + 1
    n = len(pk)
    pool = _comment_pool(rng, 1000)
    cols = {
        "ps_partkey": _numeric(pk, INT64),
        "ps_suppkey": _numeric(sk, INT64),
        "ps_availqty": _numeric(rng.integers(1, 10000, n), INT32),
        "ps_supplycost": _numeric(rng.integers(100, 100100, n), MONEY),
        "ps_comment": _strings(pool, rng.integers(0, 1000, n)),
    }
    return TPCH_TABLES["partsupp"][2], cols


def _orders(sf: float, seed: int, lo=None, hi=None, rng=None) -> Table:
    rng = rng or _rng("orders", seed)
    lo, hi = _range(TPCH_TABLES["orders"][0](sf), lo, hi)
    n = hi - lo
    # dbgen: order keys are sparse (8 of each 32)
    base = np.arange(lo, hi)
    keys = (base // 8) * 32 + (base % 8) + 1
    n_cust = N_CUST(sf)
    # only 2/3 of customers have orders (dbgen skips custkey % 3 == 0)
    ck = rng.integers(1, n_cust + 1, n)
    ck = np.where(ck % 3 == 0, (ck % (n_cust - 1)) + 1, ck)
    ck = np.where(ck % 3 == 0, ck + 1, ck)
    odate = rng.integers(STARTDATE, ENDDATE - 151, n)
    pool = _comment_pool(rng, 2000, with_special=True)
    total = rng.integers(100000, 50000000, n)
    status = np.where(odate + 151 < CURRENTDATE, 0,
                      np.where(odate > CURRENTDATE, 1, 2))
    priority = rng.integers(0, 5, n)
    clerk = rng.integers(1, max(int(sf * 1000), 2), n)
    comment = rng.integers(0, 2000, n)
    # zero-padded clerk names sort like their numbers
    clerks = np.unique(clerk)
    clerk_col = HostColumn(
        np.searchsorted(clerks, clerk).astype(np.int32),
        np.ones(n, dtype=bool),
        np.array([f"Clerk#{c:09d}" for c in clerks], dtype=object), None)
    cols = {
        "o_orderkey": _numeric(keys, INT64),
        "o_custkey": _numeric(ck, INT64),
        "o_orderstatus": _strings(["F", "O", "P"], status),
        "o_totalprice": _numeric(total, MONEY),
        "o_orderdate": _numeric(odate, DATE32),
        "o_orderpriority": _strings(PRIORITIES, priority),
        "o_clerk": clerk_col,
        "o_shippriority": _numeric(np.zeros(n, dtype=np.int32), INT32),
        "o_comment": _strings(pool, comment),
    }
    return TPCH_TABLES["orders"][2], cols


def _lineitem(sf: float, seed: int, orders: Table, rng=None) -> Table:
    rng = rng or _rng("lineitem", seed)
    okeys = orders[1]["o_orderkey"].values
    odates = orders[1]["o_orderdate"].values.astype(np.int64)
    per = rng.integers(1, 8, len(okeys))  # 1..7 lineitems per order
    l_ok = np.repeat(okeys, per)
    l_od = np.repeat(odates, per)
    n = len(l_ok)
    first = np.repeat(np.cumsum(per) - per, per)
    ln = np.arange(n) - first + 1
    n_part, n_supp = N_PART(sf), N_SUPP(sf)
    pk = rng.integers(1, n_part + 1, n)
    # supplier consistent with partsupp: one of the part's 4 suppliers
    j = rng.integers(0, 4, n)
    sk = ((pk + j * (n_supp // 4 + 1)) % n_supp) + 1
    qty = rng.integers(1, 51, n)
    # extendedprice = qty * p_retailprice(partkey)
    retail = (90000 + (pk % 20001) / 10 + 100 * (pk % 1000)).astype(np.int64)
    eprice = qty * retail
    disc = rng.integers(0, 11, n)      # 0.00 - 0.10
    tax = rng.integers(0, 9, n)        # 0.00 - 0.08
    shipdate = l_od + rng.integers(1, 122, n)
    commitdate = l_od + rng.integers(30, 91, n)
    receiptdate = shipdate + rng.integers(1, 31, n)
    # categories (A, N, R): returned lines draw R or A, the rest are N
    ra = np.array([2, 0])[rng.integers(0, 2, n)]
    returnflag = np.where(receiptdate <= CURRENTDATE, ra, 1)
    linestatus = (shipdate > CURRENTDATE).astype(np.int64)  # (F, O)
    pool = _comment_pool(rng, 2000)
    instruct = rng.integers(0, 4, n)
    mode = rng.integers(0, 7, n)
    comment = rng.integers(0, 2000, n)
    cols = {
        "l_orderkey": _numeric(l_ok, INT64),
        "l_partkey": _numeric(pk, INT64),
        "l_suppkey": _numeric(sk, INT64),
        "l_linenumber": _numeric(ln, INT32),
        "l_quantity": _numeric(qty * 100, MONEY),
        "l_extendedprice": _numeric(eprice, MONEY),
        "l_discount": _numeric(disc, MONEY),
        "l_tax": _numeric(tax, MONEY),
        "l_returnflag": _strings(["A", "N", "R"], returnflag),
        "l_linestatus": _strings(["F", "O"], linestatus),
        "l_shipdate": _numeric(shipdate, DATE32),
        "l_commitdate": _numeric(commitdate, DATE32),
        "l_receiptdate": _numeric(receiptdate, DATE32),
        "l_shipinstruct": _strings(INSTRUCTIONS, instruct),
        "l_shipmode": _strings(SHIPMODES, mode),
        "l_comment": _strings(pool, comment),
    }
    return TPCH_TABLES["lineitem"][2], cols


_GENERATORS = {"region": _region, "nation": _nation, "supplier": _supplier,
               "customer": _customer, "part": _part, "partsupp": _partsupp,
               "orders": _orders}


def generate_tpch(sf: float, seed: int = 19940101,
                  tables: Optional[Sequence[str]] = None) -> Dict[str, Table]:
    """{name: (fields, {column: HostColumn})} for the named tables (default:
    all eight). With BALLISTA_TPCH_CACHE set to a directory, each table is
    kept there as `{name}_sf{sf}_s{seed}.npz` (numpy alone) and read back
    by later calls with the same arguments."""
    names = list(tables or TPCH_TABLES)
    for name in names:
        if name not in TPCH_TABLES:
            raise KeyError(f"no TPC-H table {name!r}")
    cache = os.environ.get("BALLISTA_TPCH_CACHE")
    out = {}
    if cache:
        for name in names:
            path = _cache_path(cache, name, sf, seed)
            if os.path.exists(path):
                out[name] = _read_cached(name, path)
    made = {name: _GENERATORS[name](sf, seed) for name in names
            if name in _GENERATORS and name not in out}
    if "lineitem" in names and "lineitem" not in out:
        orders = made.get("orders") or out.get("orders") or _orders(sf, seed)
        made["lineitem"] = _lineitem(sf, seed, orders)
    if cache:
        for name, table in made.items():
            _write_cached(table, _cache_path(cache, name, sf, seed))
        log.info("generate_tpch SF %g: %d tables generated (%s), %d read "
                 "from %s", sf, len(made), ",".join(made), len(out), cache)
    out.update(made)
    return {name: out[name] for name in names}


def _cache_path(cache: str, name: str, sf: float, seed: int) -> str:
    return os.path.join(cache, f"{name}_sf{sf:g}_s{seed}.npz")


def _write_cached(table: Table, path: str) -> None:
    """One table as an .npz: per column its values, validity, dictionary
    (as a unicode array), bounds and RAW flag."""
    arrays = {}
    for name, col in table[1].items():
        arrays[f"{name}.values"] = col.values
        arrays[f"{name}.validity"] = col.validity
        if col.dictionary is not None:
            arrays[f"{name}.dictionary"] = col.dictionary.astype(str)
        if col.bounds is not None:
            arrays[f"{name}.bounds"] = np.asarray(col.bounds, dtype=np.int64)
        arrays[f"{name}.raw"] = np.asarray(col.raw)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def _read_cached(name: str, path: str) -> Table:
    fields = TPCH_TABLES[name][2]
    cols = {}
    with np.load(path, allow_pickle=False) as z:
        for f in fields:
            c = f.name
            d = z.get(f"{c}.dictionary")
            b = z.get(f"{c}.bounds")
            cols[c] = HostColumn(
                z[f"{c}.values"], z[f"{c}.validity"],
                None if d is None else d.astype(object),
                None if b is None else (int(b[0]), int(b[1])),
                bool(z[f"{c}.raw"]))
    return fields, cols


def _chunk_rng(name: str, seed: int, lo: int, hi: int) -> np.random.Generator:
    """The stream of one chunk of a table: any process builds any chunk
    on its own and gets the same rows."""
    return np.random.default_rng(
        [seed + zlib.crc32(name.encode()) % 100000, lo, hi])


def chunk_ranges(name: str, sf: float, n_chunks: int):
    """Row ranges of the table's driving index (orders rows for lineitem,
    part rows for partsupp: four partsupp rows per part, 1-7 lineitems
    per order)."""
    base = {"lineitem": "orders", "partsupp": "part"}.get(name, name)
    full = TPCH_TABLES[base][0](sf)
    bounds = [round(i * full / n_chunks) for i in range(n_chunks + 1)]
    return [(bounds[c], bounds[c + 1]) for c in range(n_chunks)
            if bounds[c + 1] > bounds[c]]


def generate_chunk(name: str, sf: float, lo: int, hi: int,
                   seed: int = 19940101) -> Table:
    """One row range of a table from its own stream (`_chunk_rng`; a
    lineitem chunk regenerates its orders chunk, so keys and dates agree).
    Chunked streams differ from the whole-table stream: check chunked data
    against an oracle on the same data, not against whole-table answer
    files."""
    if name == "lineitem":
        orders = _orders(sf, seed, lo, hi, _chunk_rng("orders", seed, lo, hi))
        return _lineitem(sf, seed, orders,
                         _chunk_rng("lineitem", seed, lo, hi))
    base = "part" if name == "partsupp" else name
    return _GENERATORS[name](sf, seed, lo, hi, _chunk_rng(base, seed, lo, hi))


def generate_table_chunks(name: str, sf: float, n_chunks: int,
                          seed: int = 19940101):
    """Yield (chunk index, (fields, {column: HostColumn})): bounded-RAM
    generation for scale factors whose tables do not fit in host memory
    (dbgen's -C/-S chunking). region and nation come whole, as chunk 0."""
    if name in ("region", "nation"):
        yield 0, _GENERATORS[name](sf, seed)
        return
    for c, (lo, hi) in enumerate(chunk_ranges(name, sf, n_chunks)):
        yield c, generate_chunk(name, sf, lo, hi, seed)


def _write_chunk(args) -> tuple:
    """One (table, chunk) part file, self-contained (a worker process's
    task): written under a temporary name and renamed into place."""
    sf, out_dir, name, c, lo, hi, seed, row_group_rows = args
    import pyarrow.parquet as pq

    fields, cols = (_GENERATORS[name](sf, seed) if lo is None
                    else generate_chunk(name, sf, lo, hi, seed))
    t = _chunk_table(fields, cols)
    path = os.path.join(out_dir, name, f"part_{c:04d}.parquet")
    tmp = f"{path}.tmp{os.getpid()}"
    # decimals of precision <= 18 as INT64, not 16-byte fixed-length
    # arrays (the same logical type); strings handed over as dictionary
    # arrays, so the writer hashes no row; no arrow schema stored, so they
    # read back as plain strings
    pq.write_table(t, tmp, row_group_size=row_group_rows,
                   store_decimal_as_integer=True, store_schema=False)
    os.replace(tmp, path)
    return name, t.num_rows


def _chunk_table(fields, cols):
    """A chunk's host columns as an arrow table: strings as dictionary
    arrays of their codes (no Python string per row), the other columns
    through `batch.columns_to_arrow`."""
    import pyarrow as pa

    from ..batch import columns_to_arrow, host_to_numpy
    plain = [f for f in fields if f.dtype.kind is not TypeKind.STRING]
    rest = columns_to_arrow(plain, host_to_numpy(plain, cols))
    arrays = []
    for f in fields:
        if f.dtype.kind is not TypeKind.STRING:
            arrays.append(rest.column(f.name))
            continue
        h = cols[f.name]
        codes = pa.array(h.values, mask=None if h.validity.all()
                         else ~h.validity)
        arrays.append(pa.DictionaryArray.from_arrays(
            codes, pa.array(list(h.dictionary), pa.string())))
    return pa.Table.from_arrays(arrays, names=[f.name for f in fields])


def generate_tpch_parquet(sf: float, out_dir: str, n_chunks: int = 1,
                          seed: int = 19940101, tables=None,
                          row_group_rows: int = 1 << 20,
                          workers: int = 1) -> dict:
    """Write every table as parquet part files with bounded RAM,
    out_dir/<table>/part_<c>.parquet (what `register_parquet_dataset`
    reads), and return each table's row count. The chunks are numpy;
    pyarrow writes the files. `workers` > 1 builds chunks in that many
    processes: the chunks draw from independent streams, so the files are
    the same bytes for any count."""
    try:
        import pyarrow.parquet  # noqa: F401
    except ImportError as e:
        raise ImportError("generate_tpch_parquet (datagen --chunks) writes "
                          "parquet through pyarrow, which is not "
                          "installed") from e
    names = list(tables or TPCH_TABLES)
    counts = {n: 0 for n in names}
    tasks = []
    for name in names:
        os.makedirs(os.path.join(out_dir, name), exist_ok=True)
        if name in ("region", "nation"):
            tasks.append((sf, out_dir, name, 0, None, None, seed,
                          row_group_rows))
            continue
        for c, (lo, hi) in enumerate(chunk_ranges(name, sf, n_chunks)):
            tasks.append((sf, out_dir, name, c, lo, hi, seed,
                          row_group_rows))
    if workers > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        # spawned, not forked: the parent may run torch's threads
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            done = list(ex.map(_write_chunk, tasks))
    else:
        done = [_write_chunk(t) for t in tasks]
    for name, rows in done:
        counts[name] += rows
    return counts


def register_tpch(ctx, sf: float, seed: int = 19940101,
                  tables: Optional[Sequence[str]] = None,
                  data: Optional[Dict[str, Table]] = None) -> None:
    """Register the tables (`data`, else generated) in `ctx`, each string
    column RAW where ingest would make it so (`as_ingested`, with the
    threshold in force now, applied when the column is first used)."""
    from ..client.context import LazyColumn
    data = data or generate_tpch(sf, seed, tables)
    raw_max = raw_dict_max()
    for name, (fields, cols) in data.items():
        ctx.register_host(name, fields,
                          {c: LazyColumn(len(h.values),
                                         partial(as_ingested, h, raw_max))
                           for c, h in cols.items()},
                          primary_key=TPCH_TABLES[name][1])
