"""The h2o db-benchmark questions and the taxi query at N = 5000: the
port's generators give the JAX package's rows, and every question gives
the same answer through ballista_tpu_torch (tables registered from numpy
arrays, on the CPU), through ballista_tpu and through pandas. Against pandas keys, counts
and integer sums are exact; f64 sums, averages, stddev and corr rtol 1e-9;
the median rtol 1e-12.

Against the JAX package the f64 columns get an absolute allowance as well:
its sorted layout takes a group's float sum as a difference of running sums
over all N rows, which carries the rounding of the whole prefix (about
eps x N x max|v|: 1e-10 for a sum of values up to 100 at N = 5000, 1e-8 for
the sum of their squares under a stddev). The port sums each run by itself
and is held to pandas without that allowance."""

import numpy as np
import pandas as pd
import pytest
import torch

from ballista_tpu.benchmarks import h2o as ref_h2o
from ballista_tpu.benchmarks import nyctaxi as ref_taxi
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu_torch.benchmarks import h2o, nyctaxi
from ballista_tpu_torch.client import SessionContext

torch.set_num_threads(2)

N = 5000
RTOL = 1e-9
MEDIAN_RTOL = 1e-12
# the JAX package's prefix-sum rounding (see above), by output column
JAX_ATOL = {"stddev_v3": 1e-7, "corr": 1e-7}
JAX_SUM_ATOL = 1e-9


def _register(ref_tables, port_tables):
    jctx, tctx = JaxContext(capacity_mode="exact"), SessionContext(device="cpu")
    for name, table in ref_tables.items():
        jctx.register_arrow(name, table)
        tctx.register_numpy(name, port_tables[name])
    return jctx, tctx


@pytest.fixture(scope="module")
def groupby():
    table = ref_h2o.groupby_table(N)
    return _register({"x": table}, {"x": h2o.groupby_table(N)}) \
        + (table.to_pandas(),)


@pytest.fixture(scope="module")
def join():
    tables = ref_h2o.join_tables(N)
    return _register(tables, h2o.join_tables(N)) \
        + ({k: v.to_pandas() for k, v in tables.items()},)


def test_generators_give_the_reference_rows():
    def same(ref_table, port_table):
        assert list(port_table) == ref_table.column_names
        for name in ref_table.column_names:
            want = ref_table[name].to_numpy(zero_copy_only=False)
            np.testing.assert_array_equal(port_table[name], want, err_msg=name)
            assert port_table[name].dtype.kind == \
                ("U" if want.dtype == object else want.dtype.kind), name
    same(ref_h2o.groupby_table(N, 50, 7), h2o.groupby_table(N, 50, 7))
    ref_j, port_j = ref_h2o.join_tables(N, 9), h2o.join_tables(N, 9)
    assert list(port_j) == list(ref_j)
    for name in ref_j:
        same(ref_j[name], port_j[name])
    same(ref_taxi.synthetic_tripdata(N, 3), nyctaxi.synthetic_tripdata(N, 3))
    assert h2o.GROUPBY_QUERIES == ref_h2o.GROUPBY_QUERIES
    assert h2o.JOIN_QUERIES == ref_h2o.JOIN_QUERIES
    assert nyctaxi.QUERIES == ref_taxi.QUERIES


def _both(jctx, tctx, sql, keys):
    """The query through both packages, rows ordered by `keys` (and then
    by every other column), the frames held equal."""
    want, got = jctx.sql(sql).to_pandas(), tctx.sql(sql).to_pandas()
    assert list(got.columns) == list(want.columns)
    order = keys + [c for c in got.columns if c not in keys]
    want = want.sort_values(order, kind="stable").reset_index(drop=True)
    got = got.sort_values(order, kind="stable").reset_index(drop=True)
    for name in got.columns:
        if got[name].dtype.kind == "f":
            g, w = got[name].to_numpy(), want[name].to_numpy()
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), name)
            np.testing.assert_allclose(
                g, w, rtol=RTOL, atol=JAX_ATOL.get(name, JAX_SUM_ATOL),
                err_msg=name)
        else:
            pd.testing.assert_series_equal(got[name], want[name])
    return got


def _expect_groupby(pdf, q):
    """(key columns, pandas frame with the question's column names)."""
    if q == 1:
        return ["id1"], pdf.groupby("id1").agg(v1=("v1", "sum"))
    if q == 2:
        return ["id1", "id2"], pdf.groupby(["id1", "id2"]).agg(v1=("v1", "sum"))
    if q == 3:
        return ["id3"], pdf.groupby("id3").agg(v1=("v1", "sum"),
                                               v3=("v3", "mean"))
    if q == 4:
        return ["id4"], pdf.groupby("id4").agg(
            v1=("v1", "mean"), v2=("v2", "mean"), v3=("v3", "mean"))
    if q == 5:
        return ["id6"], pdf.groupby("id6").agg(
            v1=("v1", "sum"), v2=("v2", "sum"), v3=("v3", "sum"))
    if q == 6:
        return ["id4", "id5"], pdf.groupby(["id4", "id5"]).agg(
            median_v3=("v3", "median"), stddev_v3=("v3", "std"))
    if q == 7:
        g = pdf.groupby("id3")
        return ["id3"], (g["v1"].max() - g["v2"].min()).to_frame("range_v1_v2")
    if q == 9:
        return ["id2", "id4"], pdf.groupby(["id2", "id4"]).apply(
            lambda d: d["v1"].corr(d["v2"]),
            include_groups=False).to_frame("corr")
    if q == 10:
        keys = ["id1", "id2", "id3", "id4", "id5", "id6"]
        return keys, pdf.groupby(keys).agg(v3=("v3", "sum"),
                                           cnt=("v3", "size"))
    raise KeyError(q)


@pytest.mark.parametrize("q", [q for q in sorted(h2o.GROUPBY_QUERIES)
                               if q != 8])
def test_groupby_question(groupby, q):
    jctx, tctx, pdf = groupby
    keys, exp = _expect_groupby(pdf, q)
    got = _both(jctx, tctx, h2o.GROUPBY_QUERIES[q], keys)
    exp = exp.reset_index().sort_values(keys, kind="stable") \
        .reset_index(drop=True)
    assert len(got) == len(exp)
    for name in exp.columns:
        g, e = got[name].to_numpy(), exp[name].to_numpy()
        if e.dtype.kind == "f":
            # one-row groups: stddev and corr are NULL
            np.testing.assert_array_equal(np.isnan(g.astype(float)),
                                          np.isnan(e), err_msg=name)
            rtol = MEDIAN_RTOL if name == "median_v3" else RTOL
            ok = ~np.isnan(e)
            np.testing.assert_allclose(g[ok].astype(float), e[ok], rtol=rtol,
                                       atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(g, e, err_msg=name)


def test_groupby_q8_top_two_per_group(groupby):
    jctx, tctx, pdf = groupby
    got = _both(jctx, tctx, h2o.GROUPBY_QUERIES[8], ["id6", "v3"])
    exp = (pdf.sort_values("v3", ascending=False).groupby("id6").head(2)
           [["id6", "v3"]].sort_values(["id6", "v3"]).reset_index(drop=True))
    assert got["id6"].tolist() == exp["id6"].tolist()
    assert got["v3"].tolist() == exp["v3"].tolist()      # exact multiset


@pytest.mark.parametrize("q", sorted(h2o.JOIN_QUERIES))
def test_join_question(join, q):
    jctx, tctx, pdfs = join
    got = _both(jctx, tctx, h2o.JOIN_QUERIES[q],
                ["id3" if "id3" in h2o.JOIN_QUERIES[q].split("FROM")[0]
                 .replace("x.id3,", "id3 ").split() else "v1", "v1"])
    x = pdfs["x"]
    if q == 1:
        exp = x.merge(pdfs["small"], on="id1")
    elif q in (2, 3):
        exp = x.merge(pdfs["medium"], on="id2",
                      how="inner" if q == 2 else "left")
    elif q == 4:
        exp = x.merge(pdfs["medium"], on="id5", how="left")
    else:
        exp = x.merge(pdfs["large"], on="id3", how="left")
    assert len(got) == len(exp), (len(got), len(exp))
    assert int(got["v2"].notna().sum()) == int(exp["v2"].notna().sum())
    np.testing.assert_allclose(got["v1"].sum(), exp["v1"].sum(), rtol=RTOL)
    np.testing.assert_allclose(got["v2"].fillna(0).sum(),
                               exp["v2"].fillna(0).sum(), rtol=RTOL)
    # row by row: (v1, v2) pairs as a multiset
    pairs = sorted(zip(got["v1"], got["v2"].fillna(-1.0)))
    assert pairs == sorted(zip(exp["v1"], exp["v2"].fillna(-1.0)))


def test_nyctaxi_query():
    n = 4000
    table = ref_taxi.synthetic_tripdata(n)
    jctx, tctx = _register({"tripdata": table},
                           {"tripdata": nyctaxi.synthetic_tripdata(n)})
    got = _both(jctx, tctx, nyctaxi.QUERIES["fare_amt_by_passenger"],
                ["passenger_count"])
    pdf = table.to_pandas().groupby("passenger_count")["fare_amount"]
    assert got["passenger_count"].tolist() == sorted(pdf.groups)
    np.testing.assert_array_equal(got.iloc[:, 1], pdf.min())     # exact
    np.testing.assert_array_equal(got.iloc[:, 2], pdf.max())
    np.testing.assert_allclose(got.iloc[:, 3], pdf.sum(), rtol=RTOL, atol=0)
    # an integer key has no code bound, so the seven passenger counts
    # take the sorted layout (as in the reference), its table cut to 16
    # slots by the key's value bounds
    node = tctx.physical_plan(tctx.sql(
        nyctaxi.QUERIES["fare_amt_by_passenger"]).plan)
    while not hasattr(node, "_masked"):
        node = node.children[0]
    assert not node._masked and node.table_size == 16


def test_groupby_q10_through_overflow_retries(groupby):
    """q10 has one group per row. With a group table of 2^10 slots the
    first plan overflows and is thrown away; the retry, sized from the
    groups the first run counted, gives the same exact sums and counts."""
    from ballista_tpu_torch.planner.physical import PhysicalOptions
    _, _, pdf = groupby
    tctx = SessionContext(device="cpu",
                          options=PhysicalOptions(max_group_table=1 << 10))
    tctx.register_numpy("x", h2o.groupby_table(N))
    got = tctx.sql(h2o.GROUPBY_QUERIES[10]).to_pandas()
    warnings = tctx.take_warnings()
    assert len(warnings) == 1                      # 2^10 -> 2^13, the need
    assert "growth group 8x" in warnings[0]
    keys, exp = _expect_groupby(pdf, 10)
    got = got.sort_values(keys, kind="stable").reset_index(drop=True)
    exp = exp.reset_index().sort_values(keys, kind="stable") \
        .reset_index(drop=True)
    assert len(got) == len(exp) > 1 << 12
    np.testing.assert_array_equal(got["cnt"], exp["cnt"])
    np.testing.assert_allclose(got["v3"], exp["v3"], rtol=RTOL, atol=0)


@pytest.fixture
def card_free(monkeypatch):
    """The timing entry points open a SessionContext() on the card and
    drain it around each run: here the context is given the CPU and the
    two CUDA calls do nothing."""
    import functools

    import ballista_tpu_torch.client as client
    monkeypatch.setattr(client, "SessionContext",
                        functools.partial(SessionContext, device="cpu"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "cpu")


@pytest.mark.parametrize("task", ["groupby", "join"])
def test_h2o_run_times_every_question(card_free, capsys, task):
    import json
    queries = h2o.GROUPBY_QUERIES if task == "groupby" else h2o.JOIN_QUERIES
    h2o.main(["--task", task, "--n", "2000", "--iterations", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["task"] == task and last["n"] == 2000
    assert sorted(int(q) for q in last["queries"]) == sorted(queries)
    assert all(r["ms"] > 0 for r in last["queries"].values())
    if task == "groupby":
        assert last["queries"]["10"]["rows"] == 2000     # one group per row
    else:
        # every key of x has its one row in the other table
        assert all(r["rows"] == 2000 for r in last["queries"].values())
    only = h2o.run(task, 1000, iterations=1, queries=[1])
    assert list(only) == [1]


def test_nyctaxi_run_times_the_query(card_free, capsys):
    import json
    nyctaxi.main(["--n", "3000", "--iterations", "1"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["n"] == 3000
    assert last["queries"]["fare_amt_by_passenger"]["rows"] == 7


def test_run_needs_the_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        h2o.run("groupby", 100)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nyctaxi.run(None, 100)
