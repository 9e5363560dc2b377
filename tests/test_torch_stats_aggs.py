"""The statistical aggregates end to end: var_samp, var_pop, stddev_samp,
stddev_pop, corr, median and percentile_cont through ballista_tpu_torch's
SessionContext on the CPU against ballista_tpu's on JAX-CPU and against
numpy/pandas, grouped (masked and sorted layouts) and ungrouped, with NULLs,
empty and one-row groups, constant columns, decimals, a NaN and a -0.0; and
the layouts' `percentile` against the JAX layouts'.

Tolerances: validity, integers, decimals and strings are exact. f64 moments
and corr are held at rtol 1e-9: both packages sum the same f64 values, in
another order, and s2/n - (s1/n)^2 cancels. Percentile reads interpolate
two stored values: rtol 1e-12."""

import decimal

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from ballista_tpu.batch import to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.ops import segagg as jax_segagg
from ballista_tpu_torch.batch import Column, to_numpy as port_to_numpy
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.exec.aggregate import (AggExpr, BoundAgg,
                                               _finalize_corr,
                                               _finalize_moment)
from ballista_tpu_torch.exprs import Col
from ballista_tpu_torch.ops import segagg
from test_torch_joins import _port_columns

torch.set_num_threads(2)

MOMENT_RTOL = 1e-9
PERCENTILE_RTOL = 1e-12


def assert_close(tbatch, tschema, jbatch, jschema, rtol):
    """Port batch against JAX batch: names, types, row count and validity
    equal; float columns within `rtol` (NaN equal to NaN), all others
    exactly."""
    assert [f.name for f in tschema.fields] == [f.name for f in jschema.fields]
    assert [repr(f.dtype) for f in tschema.fields] == \
        [repr(f.dtype) for f in jschema.fields]
    assert int(tbatch.num_rows) == int(jbatch.num_rows)
    got, want = port_to_numpy(tbatch, tschema), to_numpy(jbatch, jschema)
    for name in want:
        wv, wvalid = want[name]
        gv, gvalid = got[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
        if gv.dtype.kind == "f":
            np.testing.assert_allclose(gv[gvalid], wv[wvalid], rtol=rtol,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(gv[gvalid], wv[wvalid],
                                          err_msg=name)
    return got


def both(tables):
    """The same arrow tables registered in a JAX and a port context."""
    jctx = JaxContext(capacity_mode="exact")
    tctx = SessionContext(device="cpu")
    for name, table in tables.items():
        jctx.register_arrow(name, table)
        tctx.register_host(name, *_port_columns(table))
    return jctx, tctx


def same_sql(ctxs, sql, rtol):
    jctx, tctx = ctxs
    jbatch, jschema = jctx.sql(sql).collect()
    tbatch, tschema = tctx.sql(sql).collect()
    return assert_close(tbatch, tschema, jbatch, jschema, rtol)


def _data():
    rng = np.random.default_rng(5)
    n = 3000
    x = rng.normal(50, 12, n)
    y = rng.normal(0, 3, n) + np.repeat(np.arange(n // 100), 100) * 0.01
    xn = pd.array(x, dtype="Float64")
    yn = pd.array(y, dtype="Float64")
    xn[rng.random(n) < 0.1] = pd.NA
    yn[rng.random(n) < 0.1] = pd.NA
    return pa.table({
        "g": rng.integers(0, 12, n),                    # sorted layout
        "s": pa.array(rng.choice(["a", "b", "c", "d"], n)),   # masked layout
        "x": x, "y": y,
        "i": rng.integers(-100, 100, n),
        "xn": pa.array(xn), "yn": pa.array(yn),         # NULLs, not aligned
        "d": pa.array([decimal.Decimal(int(v)).scaleb(-2)
                       for v in rng.integers(0, 10 ** 6, n)],
                      pa.decimal128(15, 2)),
    })


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def ctxs(data):
    return both({"t": data})


MOMENTS = "stddev(x) as sd, var(x) as v, stddev_pop(x) as sdp, var_pop(x) as vp"


@pytest.mark.parametrize("key", ["g", "s"])
def test_stddev_var_grouped(ctxs, data, key):
    got = same_sql(ctxs, f"select {key}, {MOMENTS}, var_samp(i) as vi, "
                         f"stddev_pop(d) as sdd from t group by {key} "
                         f"order by {key}", MOMENT_RTOL)
    exp = data.to_pandas().groupby(key)["x"]
    np.testing.assert_allclose(got["sd"][0], exp.std(ddof=1), rtol=1e-9)
    np.testing.assert_allclose(got["v"][0], exp.var(ddof=1), rtol=1e-9)
    np.testing.assert_allclose(got["sdp"][0], exp.std(ddof=0), rtol=1e-9)
    np.testing.assert_allclose(got["vp"][0], exp.var(ddof=0), rtol=1e-9)
    # a decimal argument is divided by 10^scale before it is squared
    dd = data.to_pandas().assign(d=lambda p: p["d"].astype(float))
    np.testing.assert_allclose(got["sdd"][0],
                               dd.groupby(key)["d"].std(ddof=0), rtol=1e-9)


@pytest.mark.parametrize("key", ["g", "s"])
def test_corr_grouped(ctxs, data, key):
    got = same_sql(ctxs, f"select {key}, corr(x, y) as c, corr(xn, yn) as cn "
                         f"from t group by {key} order by {key}", MOMENT_RTOL)
    pdf = data.to_pandas()
    exp = pdf.groupby(key).apply(lambda d: d["x"].corr(d["y"]),
                                 include_groups=False)
    np.testing.assert_allclose(got["c"][0], exp.values, rtol=1e-8)
    # both arguments are masked by xn's and yn's validity together: pandas
    # drops a pair where either is missing
    expn = pdf.groupby(key).apply(lambda d: d["xn"].corr(d["yn"]),
                                  include_groups=False)
    np.testing.assert_allclose(got["cn"][0], expn.values.astype(float),
                               rtol=1e-8)


@pytest.mark.parametrize("key", ["g", "s"])
def test_median_and_percentile(ctxs, data, key):
    got = same_sql(ctxs, f"""
        select {key}, median(x) as m, approx_percentile_cont(x, 0.25) as q1,
               percentile_cont(i, 0.9) as p90, median(xn) as mn,
               median(d) as md
        from t group by {key} order by {key}""", PERCENTILE_RTOL)
    pdf = data.to_pandas().groupby(key)
    np.testing.assert_allclose(got["m"][0], pdf["x"].median(), rtol=1e-12)
    np.testing.assert_allclose(got["q1"][0], pdf["x"].quantile(0.25),
                               rtol=1e-12)
    np.testing.assert_allclose(got["p90"][0], pdf["i"].quantile(0.9),
                               rtol=1e-12)
    np.testing.assert_allclose(got["mn"][0],
                               pdf["xn"].median().astype(float), rtol=1e-12)
    # median of a decimal divides by 10^scale first: the answer is in units
    dd = data.to_pandas().assign(d=lambda p: p["d"].astype(float))
    np.testing.assert_allclose(got["md"][0], dd.groupby(key)["d"].median(),
                               rtol=1e-12)


def test_global_stats(ctxs, data):
    got = same_sql(ctxs, "select stddev(x) as sd, corr(x, y) as c, "
                         "var_pop(xn) as vn from t", MOMENT_RTOL)
    pdf = data.to_pandas()
    np.testing.assert_allclose(got["sd"][0][0], pdf["x"].std(ddof=1),
                               rtol=1e-9)
    np.testing.assert_allclose(got["c"][0][0], pdf["x"].corr(pdf["y"]),
                               rtol=1e-8)
    np.testing.assert_allclose(got["vn"][0][0], pdf["xn"].var(ddof=0),
                               rtol=1e-9)


def test_global_percentiles(ctxs, data):
    got = same_sql(ctxs, "select median(x) as m, percentile_cont(x, 0.9) "
                         "as p, median(xn) as mn from t", PERCENTILE_RTOL)
    pdf = data.to_pandas()
    np.testing.assert_allclose(got["m"][0][0], pdf["x"].median(), rtol=1e-12)
    np.testing.assert_allclose(got["p"][0][0], pdf["x"].quantile(0.9),
                               rtol=1e-12)
    np.testing.assert_allclose(got["mn"][0][0], float(pdf["xn"].median()),
                               rtol=1e-12)


# group 1: two values and a NULL; 2: one value; 3: all NULL; 4: a constant
EDGE = pa.table({
    "g": [1, 1, 1, 2, 2, 3, 4, 4, 4],
    "s": ["p", "p", "p", "q", "q", "r", "t", "t", "t"],
    "x": pa.array([1.0, None, 3.0, 5.0, None, None, 7.5, 7.5, 7.5]),
    "y": pa.array([2.0, 4.0, None, 1.0, 1.0, 1.0, 1.0, 2.0, 3.0]),
})


@pytest.fixture(scope="module")
def edge_ctxs():
    return both({"t": EDGE})


@pytest.mark.parametrize("key", ["g", "s"])
def test_stats_with_nulls(edge_ctxs, key):
    got = same_sql(edge_ctxs, f"""
        select {key}, stddev(x) as sd, median(x) as m, var_pop(x) as vp,
               var(x) as vs, stddev_pop(x) as sp, corr(x, y) as c
        from t group by {key} order by {key}""", MOMENT_RTOL)
    sd, m, vp, vs, sp, c = (got[k] for k in ("sd", "m", "vp", "vs", "sp", "c"))
    np.testing.assert_allclose(sd[0][0], np.std([1, 3], ddof=1))
    assert m[0][0] == 2.0
    # n = 1: the sample kinds are NULL, the population kinds 0
    assert not sd[1][1] and not vs[1][1]
    assert vp[1][1] and vp[0][1] == 0.0 and sp[1][1] and sp[0][1] == 0.0
    assert m[0][1] == 5.0
    # n = 0: every kind is NULL
    assert not (sd[1][2] or vs[1][2] or vp[1][2] or sp[1][2] or m[1][2])
    # a constant column: variance exactly 0 (clamped, never negative)
    assert vp[0][3] == 0.0 and vs[0][3] == 0.0 and sd[0][3] == 0.0
    # corr: NULL where one pair is left (group 1: x and y are both valid in
    # one row only), where n = 0 and where an argument is constant
    assert not c[1].any()


def test_corr_valid_where_both_vary(edge_ctxs):
    got = same_sql(edge_ctxs, "select corr(x, y) as c, corr(y, y) as one "
                              "from t", MOMENT_RTOL)
    pdf = EDGE.to_pandas()
    np.testing.assert_allclose(got["c"][0][0], pdf["x"].corr(pdf["y"]),
                               rtol=1e-9)
    np.testing.assert_allclose(got["one"][0][0], 1.0, rtol=1e-12)


def test_empty_input_is_null(edge_ctxs):
    got = same_sql(edge_ctxs, "select stddev(x) as sd, var_pop(x) as vp, "
                              "median(x) as m, corr(x, y) as c, count(x) as n "
                              "from t where g > 100", MOMENT_RTOL)
    assert got["n"][0][0] == 0
    assert not (got["sd"][1][0] or got["vp"][1][0] or got["m"][1][0]
                or got["c"][1][0])


# a NaN sorts behind every number and -0.0 beside 0.0, in both packages
ODD = pa.table({
    "s": ["a"] * 5 + ["b"] * 4 + ["c"] * 3,
    "g": [1] * 5 + [2] * 4 + [3] * 3,
    "x": [3.0, float("nan"), -1.0, 2.0, 0.5,
          -0.0, 0.0, -0.0, 1.0,
          float("nan"), float("nan"), 1.0],
})


@pytest.mark.parametrize("key", ["g", "s"])
def test_percentile_sorts_nan_last_and_signed_zero(key):
    got = same_sql(both({"t": ODD}), f"""
        select {key}, median(x) as m, percentile_cont(x, 0.25) as q,
               percentile_cont(x, 1.0) as top, min(x) as lo
        from t group by {key} order by {key}""", PERCENTILE_RTOL)
    # group a: -1, 0.5, 2, 3, NaN: the median is 2, the top NaN
    assert got["m"][0][0] == 2.0 and np.isnan(got["top"][0][0])
    assert got["q"][0][0] == 0.5
    # group b: three zeros of either sign, then 1
    assert got["m"][0][1] == 0.0 and got["q"][0][1] == 0.0
    assert got["top"][0][1] == 1.0
    # group c: 1, NaN, NaN
    assert np.isnan(got["m"][0][2]) and got["q"][0][2] != got["q"][0][2]


def _layout_case(seed, n=700, T=9):
    rng = np.random.default_rng(seed)
    slot = rng.integers(0, T, n).astype(np.int32)
    live = rng.random(n) > 0.1
    valid = rng.random(n) > 0.2
    vals = rng.normal(0, 5, n).round(1)
    vals[rng.random(n) < 0.05] = np.nan
    vals[rng.random(n) < 0.05] = -0.0
    valid[slot == 3] = False           # a group without a valid value
    return np.where(live, slot, T).astype(np.int32), live, valid, vals, T


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [0, 1])
def test_masked_layout_percentile_matches_jax(seed, frac):
    slot, live, valid, vals, T = _layout_case(seed)
    jp, jv = jax_segagg.MaskedLayout(
        jnp.asarray(slot), jnp.asarray(live), T).percentile(
            jnp.asarray(vals), jnp.asarray(valid), frac)
    t = torch.from_numpy
    tp, tv = segagg.MaskedLayout(t(slot), t(live), T).percentile(
        t(vals), t(valid), frac)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert not tv[3] and tv.any()
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                               rtol=PERCENTILE_RTOL, atol=0)


@pytest.mark.parametrize("frac", [0.25, 0.5])
@pytest.mark.parametrize("T", [16, 700])
def test_sorted_layout_percentile_matches_jax(T, frac):
    """Over keys already sorted, dead rows at the back, as the aggregate
    hands them over; with more and with fewer slots than rows."""
    slot, live, valid, vals, G = _layout_case(2)
    order = np.argsort(np.where(live, slot, 2 ** 40), kind="stable")
    keys = np.where(live, slot, 2 ** 40).astype(np.int64)[order]
    live, valid, vals = live[order], valid[order], vals[order]
    jl = jax_segagg.layout_from_sorted_keys((jnp.asarray(keys),),
                                            jnp.asarray(live), T)
    jp, jv = jl.percentile(jnp.asarray(vals), jnp.asarray(valid), frac)
    t = torch.from_numpy
    tl = segagg.layout_from_sorted_keys([t(keys)], t(live), T)
    tp, tv = tl.percentile(t(vals), t(valid), frac)
    assert int(tl.n_groups) == G
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                               rtol=PERCENTILE_RTOL, atol=0)


def test_variance_is_clamped_at_zero():
    """Sums whose s2/n - (s1/n)^2 cancels below zero give 0, not NaN."""
    s1 = torch.tensor([3.0 * 0.1, 0.0], dtype=torch.float64)
    s2 = torch.tensor([3.0 * 0.1 * 0.1 - 1e-17, 0.0], dtype=torch.float64)
    n = torch.tensor([3, 0])
    for kind in ("var_pop", "stddev_pop", "var_samp", "stddev_samp"):
        col = _finalize_moment(kind, s1, s2, n)
        assert col.validity.tolist() == [True, False]
        assert col.data.tolist() == [0.0, 0.0]


def test_corr_null_on_zero_denominator():
    one = torch.ones(3, dtype=torch.float64)
    # n = 1; a constant x at n = 2; a proper pair
    n = torch.tensor([1, 2, 2])
    sx, sxx = one * torch.tensor([1.0, 2.0, 3.0]), torch.tensor([1.0, 2.0, 5.0],
                                                              dtype=torch.float64)
    sy, syy = torch.tensor([1.0, 3.0, 3.0], dtype=torch.float64), \
        torch.tensor([1.0, 5.0, 5.0], dtype=torch.float64)
    sxy = torch.tensor([1.0, 3.0, 5.0], dtype=torch.float64)
    col = _finalize_corr(sx, sy, sxx, syy, sxy, n)
    assert col.validity.tolist() == [False, False, True]
    assert col.data.tolist() == [0.0, 0.0, 1.0]


@pytest.mark.parametrize("kind", ["median", "percentile"])
def test_non_decomposable_merge_raises(ctxs, kind):
    _, tctx = ctxs
    ba = BoundAgg(AggExpr(kind, Col("x"), alias="m", frac=0.5),
                  tctx.tables["t"].schema)
    assert [f.name for f in ba.state_fields()] == ["m#s0"]
    state = Column(torch.zeros(4, dtype=torch.float64),
                   torch.ones(4, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="cannot be merged"):
        ba.merge([state], None)
