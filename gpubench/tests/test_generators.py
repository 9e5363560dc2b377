"""The generators: a seed gives the same arrays, in any count of threads,
and another seed gives others."""

import numpy as np
import pytest

from gpubench import spec

CASES = [("tpch", {"scale_factor": 0.01}), ("h2o", {"rows": 2e4, "k": 100})]
BIG_SEED = 2**31 + 11


def _same(a, b) -> bool:
    if a.dtype != b.dtype or not np.array_equal(a.values, b.values):
        return False
    if a.dtype == "text":
        return (np.array_equal(a.ends, b.ends)
                and np.array_equal(a.dictionary, b.dictionary))
    return ((a.dictionary is None) == (b.dictionary is None)
            and (a.dictionary is None
                 or list(a.dictionary) == list(b.dictionary)))


@pytest.mark.parametrize("family,config", CASES)
def test_a_seed_gives_the_same_arrays(family, config):
    gen = spec.module("data", family).generate
    a, b = gen(config, BIG_SEED), gen(config, BIG_SEED, threads=1)
    assert a.keys() == b.keys()
    for t in a:
        assert a[t].keys() == b[t].keys()
        for c in a[t]:
            assert _same(a[t][c], b[t][c]), (t, c)


RANDOM = {"tpch": ("lineitem", ["l_partkey", "l_quantity", "l_shipdate",
                                "l_comment"]),
          "h2o": ("x", ["id1", "id3", "v3"])}


@pytest.mark.parametrize("family,config", CASES)
def test_another_seed_gives_other_arrays(family, config):
    gen = spec.module("data", family).generate
    a, b = gen(config, BIG_SEED), gen(config, BIG_SEED + 1)
    table, cols = RANDOM[family]
    for c in cols:
        assert not _same(a[table][c], b[table][c]), c


@pytest.mark.parametrize("family,config", CASES)
def test_dictionaries_sorted_and_codes_in_range(family, config):
    tables = spec.module("data", family).generate(config, 3)
    for t in tables.values():
        for name, c in t.items():
            if c.dictionary is None or c.dtype == "text":
                continue
            d = c.dictionary.astype(str)
            assert (d[1:] > d[:-1]).all(), name
            assert c.values.min() >= 0 and c.values.max() < len(d), name


def test_tpch_shapes():
    t = spec.module("data", "tpch").generate({"scale_factor": 0.01}, 9)
    rows = {name: len(next(iter(cols.values())).values)
            for name, cols in t.items()}
    assert rows["orders"] == 15000 and rows["partsupp"] == 8000
    per = np.bincount(np.searchsorted(t["orders"]["o_orderkey"].values,
                                      t["lineitem"]["l_orderkey"].values))
    assert per.min() >= 1 and per.max() <= 7 and len(per) == 15000
    # every lineitem (part, supplier) pair is a partsupp row
    span = 10**6
    ps = (t["partsupp"]["ps_partkey"].values * span
          + t["partsupp"]["ps_suppkey"].values)
    li = (t["lineitem"]["l_partkey"].values * span
          + t["lineitem"]["l_suppkey"].values)
    assert np.isin(li, ps).all()


def _holds(col, *pieces) -> np.ndarray:
    """Rows of a text column holding the pieces in order, by a regular
    expression over each row's string."""
    import re

    from gpubench.tables import text_bytes
    rx = re.compile(b".*".join(re.escape(p.encode()) for p in pieces))
    return np.array([rx.search(s) is not None
                     for s in text_bytes(col).tolist()])


def test_tpch_text_as_dbgen_makes_it():
    from gpubench.data import tpch
    from gpubench.tables import text_bytes
    t = tpch.generate({"scale_factor": 0.05}, 2**31 + 3)
    for table in t.values():
        for name, c in table.items():
            if c.dtype != "text":
                continue
            lens = c.ends - c.values
            lo, hi = ((10, 40) if "address" in name else
                      (int(tpch.COMMENT_MEAN[name] * 0.4),
                       int(tpch.COMMENT_MEAN[name] * 1.6)))
            assert lens.min() >= lo and lens.max() <= hi, name
            strs = text_bytes(c)
            if len(strs) >= 1000 and name not in ("l_comment", "p_comment"):
                # nearly distinct per row (the short comments of lineitem
                # and part repeat more, as dbgen's do)
                assert len(np.unique(strs)) > 0.95 * len(strs), name
    q13 = _holds(t["orders"]["o_comment"], "special", "requests")
    assert 0.005 < q13.mean() < 0.03        # the orders Q13 leaves out
    # the reference's LIKE over the spans finds the same rows
    from gpubench.reference.ops import spans_match
    assert (spans_match(t["orders"]["o_comment"], [b"special", b"requests"],
                        "cpu").numpy() == q13).all()


def test_tpch_supplier_comments_of_q16():
    # at SF10's 100,000 suppliers: about 100 with dbgen's Q16 text, half of
    # them complaints
    from concurrent.futures import ThreadPoolExecutor

    from gpubench.data import tpch
    from gpubench.tables import rng
    with ThreadPoolExecutor(4) as ex:
        pool = tpch.text_pool(5, ex)
    s = tpch._supplier_comments(pool, rng(5, "s"), 100_000)
    complaints = _holds(s, "Customer", "Complaints").sum()
    recommends = _holds(s, "Customer", "Recommends").sum()
    assert 25 <= complaints <= 75 and 25 <= recommends <= 75
