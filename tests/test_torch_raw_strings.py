"""RAW (unsorted, high-cardinality) string columns through the port, held
against the JAX package.

Above BALLISTA_RAW_DICT_MAX estimated distinct values a string column is
ingested RAW: its dictionary is the column in row order and a row's code
is its row index. The 15 cases of tests/test_raw_strings.py run here
through both packages on the same data, with the threshold patched in
both (`monkeypatch.setenv`): each answer is held equal to the JAX
package's (strings decoded, NULLs, and row order where ORDER BY fixes it;
a multiset otherwise) and to pandas as the reference's test checks it.
Then the two packages' RAW decisions, `sorted_recode`'s tables, the JAX
ingest tuple through `from_ingested`, a comparison of two RAW columns
(refused by both) and TPC-H with every string column RAW."""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu import batch as JB
from ballista_tpu import exprs as JE
from ballista_tpu.datagen.tpch import generate_tpch as jax_generate_tpch
from ballista_tpu.datagen.tpch import register_tpch as jax_register_tpch
from ballista_tpu.schema import STRING as JSTRING, Field as JField
from ballista_tpu_torch import batch as TB
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import from_ingested, register_tpch
from ballista_tpu_torch.exprs import recode_tables
from test_torch_fuzz import BothContexts

torch.set_num_threads(2)


def _frame(n, seed=11):
    """The reference test's table: k (97 groups), s (n distinct comments,
    one in seven with 'xyz'), v."""
    rng = np.random.default_rng(seed)
    strs = np.array([f"comment-{i:06d}-{'xyz' if i % 7 == 0 else 'abc'}"
                     for i in range(n)], dtype=object)
    rng.shuffle(strs)
    return pd.DataFrame({"k": np.arange(n, dtype=np.int64) % 97, "s": strs,
                         "v": rng.integers(0, 100, n).astype(np.int64)})


def _both(monkeypatch, n=5000, df=None):
    """Both packages with `t` registered under threshold 100 (far below n,
    with about n distinct values, so the estimate fires)."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "100")
    df = _frame(n) if df is None else df
    ctx = BothContexts()
    ctx.register_pandas("t", df)
    return ctx, df


def _same(ctx, sql, ordered=True):
    """The port's frame, held equal to the JAX package's: row for row
    where the query's ORDER BY fixes the order, as a multiset otherwise."""
    if ordered:
        return ctx.sql(sql).to_pandas()
    got = ctx.tctx.sql(sql).to_pandas()
    want = ctx.jctx.sql(sql).to_pandas()
    key = list(got.columns)
    pd.testing.assert_frame_equal(
        got.sort_values(key).reset_index(drop=True),
        want.sort_values(key).reset_index(drop=True), obj=sql)
    return got


def _unsorted(ctx, name):
    """(the port's RAW columns of `name`, the JAX package's)."""
    jt = ctx.jctx.tables[name]
    jt._ensure()
    return ctx.tctx.tables[name].schema.unsorted, jt.schema.unsorted


# -- the reference's 15 cases, through both packages --

def test_raw_mode_engaged(monkeypatch):
    ctx, _ = _both(monkeypatch)
    assert _unsorted(ctx, "t") == ({"s"}, {"s"})
    host = ctx.tctx.tables["t"].host["s"]
    assert host.raw and host.values.tolist() == list(range(5000))


def test_like_on_raw(monkeypatch):
    ctx, df = _both(monkeypatch)
    got = _same(ctx, "select k, v from t where s like '%xyz%' order by k, v")
    exp = (df[df["s"].str.contains("xyz")][["k", "v"]]
           .sort_values(["k", "v"]))
    assert got["k"].tolist() == exp["k"].tolist()
    assert got["v"].tolist() == exp["v"].tolist()


def test_equality_on_raw(monkeypatch):
    ctx, df = _both(monkeypatch)
    needle = str(df["s"].iloc[42])
    got = _same(ctx, f"select count(*) c from t where s = '{needle}'")
    assert got["c"].iloc[0] == int((df["s"] == needle).sum())
    got = _same(ctx, f"select count(*) c from t where s <> '{needle}'")
    assert got["c"].iloc[0] == int((df["s"] != needle).sum())


def test_in_list_on_raw(monkeypatch):
    ctx, df = _both(monkeypatch)
    a, b = str(df["s"].iloc[1]), str(df["s"].iloc[2])
    got = _same(ctx, f"select count(*) c from t where s in ('{a}', '{b}', "
                "'nope')")
    assert got["c"].iloc[0] == 2


def test_materialize_raw(monkeypatch):
    ctx, df = _both(monkeypatch)
    got = _same(ctx, "select s, v from t where k = 13 order by v",
                ordered=False)
    exp = df[df["k"] == 13]
    assert sorted(got["s"].tolist()) == sorted(exp["s"].tolist())
    assert got["v"].tolist() == sorted(exp["v"].tolist())


def test_join_on_raw_key(monkeypatch):
    ctx, df = _both(monkeypatch, n=3000)
    other = pd.DataFrame({"s2": df["s"].iloc[::3].astype(object),
                          "w": np.arange(1000, dtype=np.int64)})
    ctx.register_pandas("u", other)
    assert _unsorted(ctx, "u") == ({"s2"}, {"s2"})
    got = _same(ctx, "select sum(t.v) sv, sum(u.w) sw from t "
                "join u on t.s = u.s2")
    exp = df.merge(other, left_on="s", right_on="s2")
    assert got["sv"].iloc[0] == exp["v"].sum()
    assert got["sw"].iloc[0] == exp["w"].sum()


def test_order_by_raw(monkeypatch):
    ctx, df = _both(monkeypatch)
    got = _same(ctx, "select s from t order by s")
    assert got["s"].tolist() == sorted(df["s"].tolist())


def test_order_by_raw_desc_limit(monkeypatch):
    ctx, df = _both(monkeypatch)
    got = _same(ctx, "select s from t order by s desc limit 7")
    assert got["s"].tolist() == sorted(df["s"].tolist())[::-1][:7]


def test_group_by_raw(monkeypatch):
    # each string 1-3 times: the RAW dictionary repeats values
    df = _frame(4000)
    dup = pd.concat([df, df.iloc[::2], df.iloc[::5]], ignore_index=True)
    ctx, _ = _both(monkeypatch, df=dup)
    assert _unsorted(ctx, "t") == ({"s"}, {"s"})
    got = _same(ctx, "select s, count(*) c, sum(v) sv from t group by s "
                "order by s")
    exp = (dup.groupby("s", sort=True).agg(c=("v", "size"), sv=("v", "sum"))
           .reset_index())
    assert got["s"].tolist() == exp["s"].tolist()
    assert got["c"].tolist() == exp["c"].tolist()
    assert got["sv"].tolist() == exp["sv"].tolist()


def test_min_max_raw(monkeypatch):
    ctx, df = _both(monkeypatch)
    got = _same(ctx, "select min(s) m, max(s) x from t")
    assert got["m"].iloc[0] == min(df["s"])
    assert got["x"].iloc[0] == max(df["s"])


def test_min_max_raw_grouped(monkeypatch):
    ctx, df = _both(monkeypatch)
    got = _same(ctx, "select k, min(s) m, max(s) x from t group by k "
                "order by k")
    exp = df.groupby("k", sort=True)["s"].agg(["min", "max"]).reset_index()
    assert got["m"].tolist() == exp["min"].tolist()
    assert got["x"].tolist() == exp["max"].tolist()


def test_range_compare_raw(monkeypatch):
    ctx, df = _both(monkeypatch)
    got = _same(ctx, "select count(*) c from t where s < 'comment-002000'")
    assert got["c"].iloc[0] == int((df["s"] < "comment-002000").sum())


def test_window_over_raw(monkeypatch):
    ctx, _ = _both(monkeypatch, n=300)
    got = _same(ctx, "select s, row_number() over (order by s) rn from t "
                "order by s")
    assert got["rn"].tolist() == list(range(1, 301))


def test_default_threshold_keeps_sorted(monkeypatch):
    monkeypatch.delenv("BALLISTA_RAW_DICT_MAX", raising=False)
    ctx = BothContexts()
    ctx.register_pandas("t", pd.DataFrame({"s": ["b", "a", "c"] * 10}))
    assert _unsorted(ctx, "t") == (set(), set())
    got = _same(ctx, "select min(s) m, max(s) x from t")
    assert got["m"].iloc[0] == "a" and got["x"].iloc[0] == "c"


@pytest.fixture(scope="module")
def tpch_001():
    return jax_generate_tpch(0.01)


@pytest.mark.parametrize("q", [1, 2, 9, 13])
def test_tpch_all_raw(monkeypatch, tpch_001, q):
    """TPC-H at SF 0.01 with every string column RAW (threshold 0), the
    reference's four queries: grouping by strings (Q1), ordering by
    strings through a join (Q2), LIKE and grouping by n_name (Q9), a
    comment LIKE under an outer join (Q13)."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "0")
    ctx = BothContexts()
    jax_register_tpch(ctx.jctx, 0.01, data=tpch_001)
    register_tpch(ctx.tctx, 0.01)
    raw = {t: tp.schema.unsorted for t, tp in ctx.tctx.tables.items()}
    assert raw["lineitem"] >= {"l_returnflag", "l_linestatus", "l_comment"}
    assert raw["part"] >= {"p_name", "p_type"}
    _same(ctx, TPCH_QUERIES[q])


# -- beyond the reference's cases --

def test_comparison_of_two_raw_columns_raises_in_both(monkeypatch):
    ctx, df = _both(monkeypatch, n=1000)
    other = pd.DataFrame({"s2": df["s"].iloc[::-1].astype(object).values,
                          "w": np.arange(1000, dtype=np.int64)})
    ctx.register_pandas("u", other)
    sql = "select count(*) c from t join u on t.v = u.w where t.s < u.s2"
    with pytest.raises(NotImplementedError, match="raw string columns"):
        ctx.jctx.sql(sql).to_pandas()
    with pytest.raises(NotImplementedError, match="raw string columns"):
        ctx.tctx.sql(sql).to_pandas()


def _column(kind, n, rng):
    """(values with None for NULL, arrow array) of a string column."""
    if kind == "uniform":
        vals = [f"u{i:07d}" for i in rng.permutation(n)]
    elif kind == "skewed":
        # one hot value in most rows, the rest distinct
        vals = [("hot" if rng.random() < 0.9 else f"c{i}") for i in range(n)]
    elif kind == "few":
        vals = [f"f{i % 50}" for i in range(n)]
    else:   # nulls: a quarter NULL, NULL counted as ""
        vals = [None if rng.random() < 0.25 else f"n{i}" for i in range(n)]
    return vals, pa.array(vals, type=pa.string())


@pytest.mark.parametrize("kind", ["uniform", "skewed", "few", "nulls"])
@pytest.mark.parametrize("n, limit", [(20_000, 19_999), (20_000, 20_000),
                                      (150_000, 2_000), (150_000, 140_000),
                                      (3000, 0)])
def test_raw_verdict_matches_reference(monkeypatch, kind, n, limit):
    """The sampled RAW estimate gives the reference's verdict, bit for
    bit: n just above and at the limit, a sample that steps, threshold 0;
    and the port's RAW column equals the reference's."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", str(limit))
    vals, arr = _column(kind, n, np.random.default_rng(n + limit))
    filled = arr.fill_null("")
    want = JB._estimate_high_cardinality(filled, n)
    got = TB._estimate_high_cardinality(
        n, lambda idx: np.asarray(filled.take(pa.array(idx)), dtype=object))
    assert got == want
    values, validity, dictionary, is_raw, bounds = JB.ingest_column_host(
        arr, JField("c", JSTRING), n)
    col = TB.ingest_column(vals)
    assert col.raw == is_raw == want
    np.testing.assert_array_equal(col.validity, validity)
    if is_raw:
        np.testing.assert_array_equal(col.values, values)
        assert col.dictionary.dtype == object
        assert col.dictionary.tolist() == dictionary.tolist()


def _dictionaries():
    rng = np.random.default_rng(5)
    words = ["b", "a", "ä", "z", "Ω", "", "aa", "a b", "日本", "zz"]
    long = [f"a-long-string-of-more-than-eight-bytes-{i % 37:03d}"
            for i in range(300)]
    return {
        "duplicates": rng.choice(words, 500),
        "empty": np.array([], dtype=object),
        "one": np.array(["x"]),
        "non_ascii": np.array(["é", "e", "ê", "E", "日本", "日", "Ω", "ω",
                               "é"]),
        "long": rng.permutation(np.array(long)),
        "mixed": np.concatenate([rng.choice(words, 100),
                                 rng.choice(np.array(long), 100)]),
        # past 65,536 entries of 9 to 32 ASCII bytes: the word sort
        "many_words": np.array([f"id{k:0{w}d}" for k, w in zip(
            rng.integers(0, 40_000, 70_000), rng.integers(7, 31, 70_000))]),
    }


@pytest.mark.parametrize("name", sorted(_dictionaries()))
def test_sorted_recode_matches_reference(name):
    """The port's dense-rank tables equal the reference's pyarrow
    `rank(tiebreaker="dense") - 1` LUT and sorted unique values, in
    code-point order, on duplicates, the empty dictionary, non-ASCII and
    strings past the 8 bytes the packed sort path takes."""
    d = np.asarray(_dictionaries()[name], dtype=object)
    bound = JE.Bound(JSTRING, True, lambda b: None, dictionary=d,
                     dict_sorted=False)
    out = JE.sorted_recode(bound)
    _, want_uniq, want_lut = JE._RECODE_CACHE[id(d)]
    uniq, lut = recode_tables(d)
    assert uniq.dtype == object and lut.dtype == np.int32
    assert uniq.tolist() == want_uniq.tolist() == out.dictionary.tolist()
    np.testing.assert_array_equal(lut, np.asarray(want_lut))


def test_from_ingested_takes_a_jax_raw_tuple(monkeypatch):
    """The JAX ingest tuple of a RAW column becomes a RAW port column that
    answers as the JAX package does."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", "10")
    vals = [f"v{i % 40}" if i % 9 else None for i in range(200)]
    arr = pa.array(vals, type=pa.string())
    values, validity, dictionary, is_raw, bounds = JB.ingest_column_host(
        arr, JField("s", JSTRING), len(vals))
    assert is_raw
    col = from_ingested(values, validity, dictionary, bounds, is_raw)
    assert col.raw and col.dictionary.tolist() == dictionary.tolist()
    ctx = SessionContext(device="cpu")
    ctx.register_host("t", [TB.Field("s", TB.STRING)], {"s": col})
    assert ctx.tables["t"].schema.unsorted == {"s"}
    out = ctx.sql("select s, count(*) c from t group by s order by s"
                  ).to_pandas()
    want = pd.Series(vals).dropna().value_counts().sort_index()
    got = out.dropna()
    assert got["s"].tolist() == want.index.tolist()
    assert got["c"].tolist() == want.tolist()
    assert out["s"].isna().sum() == 1


def test_egress_of_a_raw_column_with_repeats():
    """The wire's result egress ships a RAW column's used values as one
    sorted, distinct dictionary: repeated values under different codes
    decode to the right strings."""
    from ballista_tpu_torch.batch import Batch, Column
    from ballista_tpu_torch.parallel.partitioned import PartitionedBatch
    from ballista_tpu_torch.scheduler.rpc import _result_blob
    from ballista_tpu_torch.scheduler.spill import decode_stage, encode_stage
    from ballista_tpu_torch.schema import Field, Schema, STRING
    raw = np.array(["b", "a", "b", "c", "a", "b", "zz"], dtype=object)
    codes = np.array([0, 2, 5, 1, 4, 3, 6, 6], dtype=np.int32)
    valid = np.array([1, 1, 1, 1, 1, 1, 0, 1], dtype=bool)
    batch = Batch((Column(torch.from_numpy(codes), torch.from_numpy(valid)),),
                  torch.tensor(8, dtype=torch.int32))
    schema = Schema((Field("s", STRING),), {"s": raw}, {}, {"s"})
    blob, dicts = _result_blob(encode_stage(PartitionedBatch((batch,))),
                               schema)
    assert dicts["s"] == ["a", "b", "c", "zz"]
    out = decode_stage(blob).batches[0]
    got = TB.to_numpy(out, Schema((Field("s", STRING),), {
        "s": np.array(dicts["s"], dtype=object)}))["s"][0]
    want = [raw[c] if v else None for c, v in zip(codes, valid)]
    assert got.tolist() == want


def test_large_luts_stay_on_the_device_between_runs(monkeypatch):
    """A LUT of a MiB or more is uploaded once per (LUT, device) and kept,
    least recently used first out past the byte bound, until
    `drop_device_luts` (what `evict_device` calls); the CPU and small
    LUTs are never held. The "meta" device stands in for the card."""
    from ballista_tpu_torch import exprs as E
    monkeypatch.setattr(E, "_LUT_CACHE", {})
    monkeypatch.setattr(E, "_LUT_CACHE_BYTES", 3 << 20)
    meta = torch.device("meta")
    luts = [np.zeros(1 << 18, dtype=np.int32) for _ in range(4)]  # 1 MiB
    first = E._device_lut(luts[0], meta)
    assert E._device_lut(luts[0], meta) is first
    assert E._device_lut(luts[0].copy(), meta) is not first
    for lut in luts[1:]:
        E._device_lut(lut, meta)
    assert len(E._LUT_CACHE) == 3 and (id(luts[0]), "meta") not in E._LUT_CACHE
    assert E._device_lut(np.zeros(8, np.int32), meta) is not None
    assert E._device_lut(luts[1], torch.device("cpu")) is not None
    assert len(E._LUT_CACHE) == 3
    E.drop_device_luts()
    assert not E._LUT_CACHE


def test_self_join_on_a_raw_key(monkeypatch):
    """Both sides of the join hold one RAW dictionary that repeats values:
    equal codes are not equal values there, so the key is remapped through
    its distinct values even though the dictionary object is shared."""
    df = _frame(600)
    dup = pd.concat([df, df.iloc[::2], df.iloc[::3]], ignore_index=True)
    ctx, _ = _both(monkeypatch, df=dup)
    got = _same(ctx, "select count(*) c, sum(a.v) sv from t a join t b "
                "on a.s = b.s")
    counts = dup["s"].value_counts()
    assert got["c"].iloc[0] == int((counts ** 2).sum())
    pairs = dup.merge(dup, on="s")
    assert got["sv"].iloc[0] == int(pairs["v_x"].sum())


@pytest.mark.parametrize("limit", ["100", "1000"])
def test_register_tpch_takes_the_references_raw_decisions(monkeypatch,
                                                          tpch_001, limit):
    """At a threshold between the columns' distinct counts, the port's
    `register_tpch` makes RAW exactly the columns the JAX package's arrow
    ingest makes RAW, with the same dictionaries."""
    monkeypatch.setenv("BALLISTA_RAW_DICT_MAX", limit)
    ctx = BothContexts()
    jax_register_tpch(ctx.jctx, 0.01, data=tpch_001)
    register_tpch(ctx.tctx, 0.01)
    some = False
    for name in ctx.tctx.tables:
        port, ref = _unsorted(ctx, name)
        assert port == ref, name
        some = some or bool(port)
        jschema = ctx.jctx.tables[name].schema
        for col in port:
            got = ctx.tctx.tables[name].host[col]
            assert got.dictionary.tolist() == jschema.dictionary(col).tolist()
    assert some
