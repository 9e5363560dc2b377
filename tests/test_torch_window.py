"""Window functions end to end: SQL through ballista_tpu_torch's
SessionContext on the CPU against ballista_tpu's on JAX-CPU over the same
tables: every case of tests/test_window.py (ranking, aggregates, navigation,
default, ROWS and RANGE UNBOUNDED/CURRENT frames), the random frames
against a pandas oracle, windows over TPC-H at SF 0.01, and the two extremum
helpers against the JAX functions.

Tolerances: ranks, counts, validity, int64 and decimal sums and extrema are
exact. Float window sums and averages are differences of f64 running sums,
held at rtol 1e-9; percent_rank and cume_dist are one f64 division of equal
integers and are held exactly."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu.exec import window as JW
from ballista_tpu_torch.exec import window as TW
from ballista_tpu_torch.exec.window import WindowExec, WindowFnSpec
from ballista_tpu_torch.exec.plan import InputLeaf
from ballista_tpu_torch.exprs import Col
from test_torch_stats_aggs import both, same_sql
from test_torch_tpch_six import _contexts

torch.set_num_threads(2)

FLOAT_RTOL = 1e-9

T = pa.table({
    "g": pa.array(["a", "a", "a", "b", "b", "c"]),
    "v": pa.array([10, 20, 20, 5, 7, None], pa.int64()),
    "f": pa.array([1.5, 2.25, None, -4.0, 0.125, 8.0], pa.float64()),
})


@pytest.fixture(scope="module")
def ctxs():
    return both({"t": T})


def _values(got, name):
    """A column as a list, None where NULL."""
    v, ok = got[name]
    return [x.item() if o else None for x, o in zip(v, ok)]


# name -> (sql, {column: expected list}) with the expectations of
# tests/test_window.py
CASES = {
    "ranking": ("""
        select g, v,
               row_number() over (partition by g order by v) as rn,
               rank() over (partition by g order by v) as rk,
               dense_rank() over (partition by g order by v) as dr
        from t order by g, v""",
        {"rn": [1, 2, 3, 1, 2, 1], "rk": [1, 2, 2, 1, 2, 1],
         "dr": [1, 2, 2, 1, 2, 1]}),
    "partition_aggregates": ("""
        select g, v,
               sum(v) over (partition by g) as total,
               count(v) over (partition by g) as cnt,
               min(v) over (partition by g) as mn,
               max(v) over (partition by g) as mx,
               avg(v) over (partition by g) as mean,
               count(*) over (partition by g) as n
        from t order by g, v""",
        # all-null partition c: sum/min/max are NULL, count 0
        {"total": [50, 50, 50, 12, 12, None], "cnt": [3, 3, 3, 2, 2, 0],
         "mn": [10, 10, 10, 5, 5, None], "mx": [20, 20, 20, 7, 7, None],
         "n": [3, 3, 3, 2, 2, 1]}),
    # SQL default frame is RANGE: peers (v=20,20) share the frame end
    "running_sum_with_peers": ("""
        select g, v, sum(v) over (partition by g order by v) as run
        from t where g = 'a' order by v""", {"run": [10, 50, 50]}),
    "lag_lead_first_last": ("""
        select g, v,
               lag(v) over (partition by g order by v) as prev,
               lead(v) over (partition by g order by v) as nxt,
               first_value(v) over (partition by g order by v) as fv,
               last_value(v) over (partition by g order by v) as lv
        from t where g = 'b' order by v""",
        {"prev": [None, 5], "nxt": [7, None], "fv": [5, 5], "lv": [5, 7]}),
    "lag_offset": ("""
        select v, lag(v, 2) over (order by v) as p2
        from t where v is not null order by v""",
        {"p2": [None, None, 5, 7, 10]}),
    # sums: a=50, b=12, c=NULL (desc -> nulls first)
    "window_over_aggregate": ("""
        select g, sum(v) as s, rank() over (order by sum(v) desc) as rk
        from t group by g order by g""", {"rk": [2, 3, 1]}),
    "no_partition_by": ("""
        select v, row_number() over (order by v desc) as rn
        from t where v is not null order by v desc""",
        {"rn": [1, 2, 3, 4, 5]}),
    "cumulative_min_max": ("""
        select g, v,
               min(v) over (partition by g order by v desc) as cmn,
               max(v) over (partition by g order by v) as cmx
        from t where v is not null order by g, v""",
        {"cmx": [10, 20, 20, 5, 7], "cmn": [10, 20, 20, 5, 7]}),
    "ntile_percent_rank_cume_dist": ("""
        select g, v,
               ntile(2) over (partition by g order by v) as nt,
               percent_rank() over (partition by g order by v) as pr,
               cume_dist() over (partition by g order by v) as cd
        from t order by g, v""",
        {"nt": [1, 1, 2, 1, 2, 1], "pr": [0.0, 0.5, 0.5, 0.0, 1.0, 0.0],
         "cd": [1 / 3, 1.0, 1.0, 0.5, 1.0, 1.0]}),
    # more buckets than rows: floor division of negative values before the
    # where picks a side
    "ntile_more_buckets_than_rows": ("""
        select v, ntile(5) over (order by v) as nt
        from t where g = 'a' order by v""", {"nt": [1, 2, 3]}),
    # default frame RANGE..CURRENT: NULL until the frame reaches row 2
    "nth_value": ("""
        select g, v, nth_value(v, 2) over (partition by g order by v) as n2
        from t order by g, v""", {"n2": [None, 20, 20, None, 7, None]}),
    "rows_frame_sliding_sum": ("""
        select g, v,
               sum(v) over (partition by g order by v
                            rows between 1 preceding and current row) as s,
               count(v) over (partition by g order by v
                              rows between 1 preceding and 1 following) as c
        from t order by g, v""",
        {"s": [10, 30, 40, 5, 12, None], "c": [2, 3, 2, 2, 2, 0]}),
    "rows_frame_sliding_min_max": ("""
        select g, v,
               min(v) over (partition by g order by v desc
                            rows between 1 preceding and current row) as mn,
               max(v) over (partition by g order by v
                            rows between current row and 1 following) as mx
        from t where g = 'a' order by v""", {"mx": [20, 20, 20]}),
    "rows_frame_unbounded_following": ("""
        select v,
               sum(v) over (order by v rows between current row
                            and unbounded following) as tail,
               last_value(v) over (order by v rows between current row
                                   and unbounded following) as lv
        from t where g = 'a' order by v""",
        {"tail": [50, 40, 20], "lv": [20, 20, 20]}),
    # ROWS 2 PRECEDING == BETWEEN 2 PRECEDING AND CURRENT ROW
    "rows_frame_shorthand": ("""
        select v, sum(v) over (order by v rows 2 preceding) as s
        from t where g = 'a' order by v""", {"s": [10, 30, 50]}),
    # frame entirely after the partition end: sum NULL, count 0
    "rows_frame_empty": ("""
        select v,
               sum(v) over (order by v rows between 2 following
                            and 3 following) as s,
               count(v) over (order by v rows between 2 following
                              and 3 following) as c
        from t where g = 'b' order by v""",
        {"s": [None, None], "c": [0, 0]}),
    # RANGE BETWEEN CURRENT ROW AND UNBOUNDED FOLLOWING starts at the
    # first peer
    "range_current_row_frame": ("""
        select v, sum(v) over (order by v range between current row
                               and unbounded following) as s
        from t where g = 'a' order by v""", {"s": [50, 40, 40]}),
    "range_unbounded_both": ("""
        select g, v, max(v) over (partition by g order by v range between
               unbounded preceding and unbounded following) as mx,
               first_value(v) over (partition by g order by v range between
               unbounded preceding and current row) as fv
        from t order by g, v""",
        {"mx": [20, 20, 20, 7, 7, None], "fv": [10, 10, 10, 5, 5, None]}),
    # float sums and averages: prefix-sum differences
    "float_sums": ("""
        select g, f, sum(f) over (partition by g order by f) as run,
               avg(f) over (partition by g) as mean,
               min(f) over (partition by g order by f
                            rows between 1 preceding and current row) as mn,
               lead(f) over (order by f) as nxt
        from t order by g, f""", {}),
    # two clauses in one SELECT: two sorts, one WindowExec
    "two_clauses": ("""
        select g, v, row_number() over (order by v, g) as a,
               row_number() over (partition by g order by v desc) as b
        from t where v is not null order by g, v""", {}),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_window_sql_matches_jax(ctxs, name):
    sql, expected = CASES[name]
    got = same_sql(ctxs, sql, FLOAT_RTOL)
    for col, want in expected.items():
        have = _values(got, col)
        if any(isinstance(x, float) for x in want):
            np.testing.assert_allclose(have, want, rtol=1e-12, err_msg=col)
        else:
            assert have == want, col


def test_sliding_min_order_desc(ctxs):
    # order desc: 20,20,10 -> sliding min over prev+current = 20, 20, 10
    got = same_sql(ctxs, CASES["rows_frame_sliding_min_max"][0], FLOAT_RTOL)
    assert sorted(_values(got, "mn")) == [10, 20, 20]


def test_partition_mean(ctxs):
    got = same_sql(ctxs, CASES["partition_aggregates"][0], FLOAT_RTOL)
    np.testing.assert_allclose(got["mean"][0][:3].astype(float), 50 / 3,
                               rtol=1e-6)
    assert not got["mean"][1][5]


def test_windowed_frames_vs_pandas_random():
    rng = np.random.default_rng(7)
    n = 500
    g = rng.integers(0, 8, n)
    v = rng.integers(-50, 50, n).astype("int64")
    mask = rng.random(n) < 0.1
    vals = pd.array(v, dtype="Int64")
    vals[mask] = pd.NA
    t = pa.table({"g": g, "v": pa.array(vals), "tie": np.arange(n)})
    got = same_sql(both({"r": t}), """
      select g, tie,
             sum(v) over (partition by g order by tie
                          rows between 3 preceding and 1 following) as s,
             min(v) over (partition by g order by tie
                          rows between 3 preceding and 1 following) as mn,
             max(v) over (partition by g order by tie
                          rows between 2 preceding and 2 following) as mx,
             avg(v) over (partition by g order by tie
                          rows between 3 preceding and current row) as a
      from r order by g, tie
    """, FLOAT_RTOL)
    pdf = t.to_pandas().sort_values(["g", "tie"]).reset_index(drop=True)
    # oracle: explicit python loop over each partition's frame
    exp = {"s": [], "mn": [], "mx": [], "a": []}
    for _, grp in pdf.groupby("g", sort=True):
        vv = grp["v"].tolist()
        for i in range(len(vv)):
            win = [x for x in vv[max(0, i - 3):i + 2] if not pd.isna(x)]
            exp["s"].append(sum(win) if win else None)
            exp["mn"].append(min(win) if win else None)
            w2 = [x for x in vv[max(0, i - 2):i + 3] if not pd.isna(x)]
            exp["mx"].append(max(w2) if w2 else None)
            w3 = [x for x in vv[max(0, i - 3):i + 1] if not pd.isna(x)]
            exp["a"].append(sum(w3) / len(w3) if w3 else None)
    for colname in ("s", "mn", "mx"):
        want = [None if x is None else int(x) for x in exp[colname]]
        assert _values(got, colname) == want, colname
    gota = _values(got, "a")
    assert [x is None for x in gota] == [x is None for x in exp["a"]]
    np.testing.assert_allclose(
        [x for x in gota if x is not None],
        [float(x) for x in exp["a"] if x is not None], rtol=1e-9)


@pytest.fixture(scope="module")
def tpch():
    return _contexts(0.01, ["lineitem", "orders"])


TPCH = {
    # decimal running sums, and the three extremum paths: sparse table,
    # prefix extremum, whole partition
    "lineitem_running": """
        select l_orderkey, l_linenumber,
               row_number() over (partition by l_orderkey
                                  order by l_linenumber) as rn,
               sum(l_quantity) over (partition by l_orderkey
                                     order by l_linenumber) as run,
               avg(l_extendedprice) over (partition by l_orderkey) as mean,
               min(l_extendedprice) over (partition by l_orderkey
                   order by l_linenumber
                   rows between 2 preceding and current row) as mn3,
               max(l_extendedprice) over (partition by l_orderkey
                                          order by l_linenumber) as cmx,
               min(l_shipdate) over (partition by l_orderkey) as first_ship,
               max(l_shipmode) over (partition by l_orderkey) as last_mode
        from lineitem order by l_orderkey, l_linenumber""",
    "orders_ranks": """
        select o_custkey, o_orderkey,
               rank() over (partition by o_custkey
                            order by o_totalprice desc) as rk,
               dense_rank() over (partition by o_custkey
                                  order by o_orderpriority) as dr,
               lag(o_totalprice) over (partition by o_custkey
                                       order by o_orderdate, o_orderkey) as prev,
               lead(o_orderdate, 2) over (partition by o_custkey
                   order by o_orderdate, o_orderkey) as nxt,
               first_value(o_orderstatus) over (partition by o_custkey
                   order by o_orderdate, o_orderkey) as fs,
               ntile(3) over (partition by o_custkey
                              order by o_orderkey) as nt
        from orders order by o_custkey, o_orderkey""",
    # a window over a filtered input, fed into an aggregate
    "top_per_customer": """
        select count(*) as n, sum(o_totalprice) as s from (
            select o_totalprice, row_number() over (partition by o_custkey
                       order by o_totalprice desc, o_orderkey) as rn
            from orders where o_orderstatus = 'F') x
        where rn <= 2""",
}


@pytest.mark.parametrize("name", sorted(TPCH))
def test_tpch_windows_match_jax(tpch, name):
    got = same_sql(tpch, TPCH[name], FLOAT_RTOL)
    assert len(next(iter(got.values()))[0]) > 0


def test_window_errors(ctxs):
    jctx, tctx = ctxs
    for ctx in (jctx, tctx):
        with pytest.raises(ValueError, match="requires OVER"):
            ctx.sql("select rank() over (partition by g) as r from t").collect()
        with pytest.raises(NotImplementedError, match="RANGE frames"):
            ctx.sql("select sum(v) over (order by v range between 1 preceding "
                    "and current row) as s from t").collect()


def test_duplicate_output_name_raises(ctxs):
    _, tctx = ctxs
    tp = tctx.tables["t"]
    leaf = InputLeaf("t", tp.schema, tp.capacity)
    spec = WindowFnSpec("row_number", None, (), ((Col("v"), True, None),),
                        alias="v")
    with pytest.raises(ValueError, match="duplicate column names"):
        WindowExec(leaf, [spec])


def _extremum_case(seed, n, dtype):
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-1000, 1000, n).astype(dtype) if dtype != np.float64
            else rng.normal(0, 10, n))
    valid = rng.random(n) > 0.3
    first = rng.random(n) < 0.15
    first[0] = True
    pos = np.arange(n)
    seg_start = np.maximum.accumulate(np.where(first, pos, 0))
    return vals, valid, seg_start


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("dtype", [np.int64, np.int32, np.float64])
def test_segmented_prefix_extremum_matches_jax(dtype, is_max):
    vals, valid, seg_start = _extremum_case(3, 333, dtype)
    jm, jv = JW._segmented_prefix_extremum(
        jnp.asarray(vals), jnp.asarray(valid),
        jnp.asarray(seg_start.astype(np.int32)), is_max)
    t = torch.from_numpy
    tm, tv = TW._segmented_prefix_extremum(t(vals), t(valid), t(seg_start),
                                           is_max)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy()[tv.numpy()],
                                  np.asarray(jm)[np.asarray(jv)])
    assert tv.any() and not tv.all()


@pytest.mark.parametrize("is_max", [True, False])
@pytest.mark.parametrize("n", [1, 2, 257, 1024])
def test_range_extremum_matches_jax_and_brute_force(n, is_max):
    vals, valid, _ = _extremum_case(n, n, np.int64)
    rng = np.random.default_rng(n + 1)
    fs = rng.integers(0, n, n)
    fe = np.minimum(fs + rng.integers(-2, 40, n), n - 1)   # some empty
    jm, jv = JW._range_extremum(jnp.asarray(vals), jnp.asarray(valid),
                                jnp.asarray(fs.astype(np.int32)),
                                jnp.asarray(fe.astype(np.int32)), is_max)
    t = torch.from_numpy
    tm, tv = TW._range_extremum(t(vals), t(valid), t(fs), t(fe), is_max)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy()[tv.numpy()],
                                  np.asarray(jm)[np.asarray(jv)])
    red = max if is_max else min
    for p in range(n):
        win = [v for v, ok in zip(vals[fs[p]:fe[p] + 1],
                                  valid[fs[p]:fe[p] + 1]) if ok]
        assert bool(tv[p]) == bool(win)
        if win:
            assert int(tm[p]) == red(win)


def test_floor_log2_is_exact_at_powers_of_two():
    x = torch.tensor([1, 2, 3, 4, 7, 8, 9, 2 ** 20 - 1, 2 ** 20, 2 ** 40 - 1,
                      2 ** 40, 2 ** 51 - 1, 2 ** 51])
    want = [int(v).bit_length() - 1 for v in x.tolist()]
    assert TW._floor_log2(x).tolist() == want
