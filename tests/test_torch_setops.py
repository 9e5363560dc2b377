"""Cross, theta and full outer joins and UNION end to end: SQL through
ballista_tpu_torch's SessionContext on the CPU against ballista_tpu's on
JAX-CPU over the same small tables. CrossJoinExec on both of its paths
(broadcast of a one-row side, and the cell product, padded past its
cells), NestedLoopJoinExec in several chunks (MAX_CELLS patched down in
both packages) with an output overflow that retries, full outer joins on
the unique and the expanding path with NULL keys and unmatched rows on
both sides, UNION [ALL] over differing dictionaries and a typed-NULL
string branch; and the operators `merge_full_unique` and `concat_batches`
against the JAX functions. Every comparison is exact: int64 values,
validity and decoded strings, row by row where ORDER BY fixes the order."""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from ballista_tpu import batch as JB
from ballista_tpu import exprs as JE
from ballista_tpu import schema as JS
from ballista_tpu.batch import to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.exec import plan as JP
from ballista_tpu.ops.merge_join import merge_full_unique as jax_full_unique
from ballista_tpu.planner import logical as JL
from ballista_tpu_torch import batch as TB
from ballista_tpu_torch import exprs as TE
from ballista_tpu_torch import schema as TS
from ballista_tpu_torch.batch import (ingest_arrow_column, schema_from_arrow,
                                      to_numpy as port_to_numpy)
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.exec import plan as TP
from ballista_tpu_torch.ops.merge_join import merge_full_unique
from ballista_tpu_torch.planner import logical as TL

torch.set_num_threads(2)

_RNG = np.random.default_rng(1)
TABLES = {
    "t1": (pa.table({"x": pa.array([1, 2, 3], pa.int64()),
                     "y": pa.array(["a", "b", "c"])}), None),
    "t2": (pa.table({"x2": pa.array([3, 4], pa.int64()),
                     "y2": pa.array(["c", "d"])}), None),
    "ords": (pa.table({"k": pa.array([1, 1, 9], pa.int64()),
                       "amt": pa.array([10, 20, 30], pa.int64())}), None),
    "cust": (pa.table({"ck": pa.array([1, 2], pa.int64()),
                       "nm": pa.array(["ann", "bob"])}), ("ck",)),
    # NULL keys on both sides; keys_b repeats 'banana'
    "keys_a": (pa.table({"a_k": ["apple", "banana", "cherry", None, "fig",
                                 "kiwi"],
                         "a_v": pa.array([1, 2, 3, 4, 5, 6], pa.int64())}),
               ("a_k",)),
    "keys_b": (pa.table({"b_k": ["kiwi", "banana", None, "banana", "grape",
                                 "apple", "zucchini", "fig"],
                         "b_w": pa.array([10, 20, 30, 40, 50, 60, 70, 80],
                                         pa.int64())}), None),
    # the nested-loop join tables of tests/test_nested_loop_join.py
    "t": (pa.table({"x": pa.array(_RNG.integers(0, 1000, 300), pa.int64()),
                    "i": pa.array(np.arange(300), pa.int64())}), None),
    "s": (pa.table({"z": pa.array(_RNG.integers(0, 1000, 200), pa.int64()),
                    "kk": pa.array(np.arange(200), pa.int64())}), None),
}


def _port_columns(arrow):
    """Port fields and host columns of an arrow table, by the port's own
    arrow ingest (what `register_arrow` registers)."""
    fields = schema_from_arrow(arrow.schema).fields
    return fields, {f.name: ingest_arrow_column(arrow[f.name], f.dtype)
                    for f in fields}


@pytest.fixture(scope="module")
def contexts():
    jctx = JaxContext(capacity_mode="exact")
    tctx = SessionContext(device="cpu")
    for name, (table, pk) in TABLES.items():
        jctx.register_arrow(name, table, primary_key=pk)
        tctx.register_host(name, *_port_columns(table), primary_key=pk)
    return jctx, tctx


@pytest.fixture()
def small_cells(monkeypatch):
    """Force the chunked theta join at test sizes, in both packages."""
    monkeypatch.setattr(JP.CrossJoinExec, "MAX_CELLS", 1 << 12)
    monkeypatch.setattr(TP.CrossJoinExec, "MAX_CELLS", 1 << 12)


def _assert_same(tbatch, tschema, jbatch, jschema):
    assert [f.name for f in tschema.fields] == [f.name for f in jschema.fields]
    assert [repr(f.dtype) for f in tschema.fields] == \
        [repr(f.dtype) for f in jschema.fields]
    assert [f.nullable for f in tschema.fields] == \
        [f.nullable for f in jschema.fields]
    assert int(tbatch.num_rows) == int(jbatch.num_rows)
    got, want = port_to_numpy(tbatch, tschema), to_numpy(jbatch, jschema)
    for name in want:
        wv, wvalid = want[name]
        gv, gvalid = got[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
        np.testing.assert_array_equal(gv[gvalid], wv[wvalid], err_msg=name)


def _same_sql(jctx, tctx, sql):
    jbatch, jschema = jctx.sql(sql).collect()
    tbatch, tschema = tctx.sql(sql).collect()
    _assert_same(tbatch, tschema, jbatch, jschema)
    return int(tbatch.num_rows)


def _labels(tctx, sql):
    plan = tctx.physical_plan(tctx.sql(sql).plan).display()
    return [line.strip() for line in plan.splitlines()]


# (sql, an operator its port plan must hold)
QUERIES = {
    "cross": ("select x, x2 from t1 cross join t2 order by x, x2",
              "CrossJoinExec"),
    "theta_comma": ("select x, x2 from t1, t2 where x + 1 = x2 order by x",
                    "FilterExec"),
    "theta_on_inequality": ("select count(*) c from t1 join t2 on x < x2",
                            "CrossJoinExec"),
    # LIMIT capacities: the product (2 x 1 cells) is padded to 128 rows
    "cross_padded": ("""select a.x, b.x2 from
                        (select x from t1 order by x limit 2) a,
                        (select x2 from t2 order by x2 limit 1) b
                        order by a.x""", "CrossJoinExec"),
    # a no-key aggregate broadcasts (Q16's NOT IN shape)
    "cross_broadcast": ("""select x, n from t1,
                           (select count(*) as n from t2) c order by x""",
                        "CrossJoinExec[broadcast"),
    "not_in_three_valued": ("""select a_k, a_v from keys_a
                               where a_v not in (select b_w / 10 + 2 from keys_b)
                               order by a_v""", "CrossJoinExec[broadcast"),
    # ords' k repeats: ords is the (expanding) build side
    "full_expanding": ("""select nm, ck, k, amt from cust full outer join ords
                          on ck = k order by amt, ck""",
                       "HashJoinExec[full_outer,expanding]"),
    # t1's x is unique: t1 is the build side
    "full_unique": ("""select k, amt, x, y from ords full join t1
                       on k = x order by amt, x""",
                    "HashJoinExec[full_outer,unique]"),
    "full_unique_merge": ("""select k, amt, nm from ords full join cust
                             on k = ck order by amt, nm""",
                          "HashJoinExec[full_outer,unique]"),
    "full_null_keys_unique": ("""select a_k, a_v, b_k, b_w from keys_b
                                 full join keys_a on a_k = b_k
                                 order by b_w, a_v""",
                              "HashJoinExec[full_outer,unique]"),
    "full_null_keys_expanding": ("""select a_k, a_v, b_k, b_w from keys_a
                                    full join keys_b on a_k = b_k
                                    order by a_v, b_w""",
                                 "HashJoinExec[full_outer,expanding]"),
    # a filter on each side, under the join (kept as FilterExecs)
    "full_filtered_sides": ("""select nm, ck, k, amt from
                               (select ck, nm from cust where nm <> 'bob') c
                               full join
                               (select k, amt from ords where amt > 10) o
                               on ck = k order by amt, ck""",
                            "FilterExec"),
    "union_all": ("select x, y from t1 union all select x2, y2 from t2 "
                  "order by x, y", "DictRemapExec"),
    "union_distinct": ("select x, y from t1 union select x2, y2 from t2 "
                       "order by x, y", "CoalesceExec"),
    "union_three": ("""select y from t1 union all select y2 from t2
                       union all select nm from cust order by y""",
                    "CoalesceExec(n=2)"),
}


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_query_matches_jax(contexts, name):
    jctx, tctx = contexts
    sql, node = QUERIES[name]
    assert any(x.startswith(node) for x in _labels(tctx, sql))
    assert _same_sql(jctx, tctx, sql) > 0


def test_full_outer_rows(contexts):
    """The full outer answer of tests/test_setops.py, row for row."""
    _, tctx = contexts
    got = tctx.sql(QUERIES["full_expanding"][0]).to_numpy()
    rows = set()
    for i in range(len(got["nm"][0])):
        rows.add(tuple(got[c][0][i] if got[c][1][i] else None
                       for c in ("nm", "ck", "k", "amt")))
    assert rows == {("ann", 1, 1, 10), ("ann", 1, 1, 20),
                    (None, None, 9, 30), ("bob", 2, None, None)}


# the bags of tests/test_setops.py: INTERSECT / EXCEPT with NULLs that
# compare equal, and their ALL forms (row_number against the right side's
# per-key count)
BAGS = {
    "sa": pa.table({"x": pa.array([1, 2, 2, 3, None], pa.int64()),
                    "s": ["p", "q", "q", "r", None]}),
    "sb": pa.table({"x": pa.array([2, 3, 4, None], pa.int64()),
                    "s": ["q", "zz", "t", None]}),
    "ba": pa.table({"x": pa.array([1, 1, 1, 2, 2, 3, None, None],
                                  pa.int64())}),
    "bb": pa.table({"x": pa.array([1, 1, 2, 4, None], pa.int64())}),
    "ma": pa.table({"x": pa.array([1, 1, 2], pa.int64()),
                    "y": ["a", "a", "b"]}),
    "mb": pa.table({"x": pa.array([1, 2], pa.int64()), "y": ["a", "b"]}),
    "oa": pa.table({"x": pa.array([3, 1, 2], pa.int64()),
                    "y": pa.array([1, 1, 1], pa.int64())}),
    "ob": pa.table({"x": pa.array([9], pa.int64()),
                    "y": pa.array([0], pa.int64())}),
}
# name -> (sql, x column of the answer, None for NULL)
SETOPS = {
    "intersect": ("select x, s from sa intersect select x, s from sb "
                  "order by x", [2, None]),
    "except": ("select x, s from sa except select x, s from sb order by x",
               [1, 3]),
    "except_self": ("select x from sa except select x from sa where x = 2 "
                    "order by x", [1, 3, None]),
    # each row min(l, r) times; NULLs compare equal
    "intersect_all": ("select x from ba intersect all select x from bb "
                      "order by x", [1, 1, 2, None]),
    # each row max(l - r, 0) times
    "except_all": ("select x from ba except all select x from bb order by x",
                   [1, 2, 3, None]),
    "except_all_multicol": ("select x, y from ma except all "
                            "select x, y from mb order by x", [1]),
    "intersect_all_multicol": ("select x, y from ma intersect all "
                               "select x, y from mb order by x", [1, 2]),
    "except_order_by_expression": ("select x, y from oa except "
                                   "select x, y from ob order by x + y desc",
                                   [3, 2, 1]),
    # INTERSECT binds tighter than EXCEPT
    "precedence": ("select x from ba except select x from bb intersect "
                   "select x from sa order by x", [3]),
}


@pytest.fixture(scope="module")
def bag_contexts():
    jctx = JaxContext(capacity_mode="exact")
    tctx = SessionContext(device="cpu")
    for name, table in BAGS.items():
        jctx.register_arrow(name, table)
        tctx.register_host(name, *_port_columns(table))
    return jctx, tctx


@pytest.mark.parametrize("name", sorted(SETOPS))
def test_intersect_except_match_jax(bag_contexts, name):
    jctx, tctx = bag_contexts
    sql, want = SETOPS[name]
    assert _same_sql(jctx, tctx, sql) == len(want)
    x, valid = tctx.sql(sql).to_numpy()["x"]
    assert [int(v) if ok else None for v, ok in zip(x, valid)] == want
    if "_all" in name:
        assert any(l.startswith("WindowExec") for l in _labels(tctx, sql))


THETA = {
    "chunked": "select i, kk from t, s where z > x and z - x < 5 "
               "order by i, kk",
    "exists_non_equi": "select i from t where exists "
                       "(select 1 from s where z > x + 900) order by i",
}


@pytest.mark.parametrize("name", sorted(THETA))
def test_theta_join_chunked(small_cells, contexts, name):
    jctx, tctx = contexts
    labels = _labels(tctx, THETA[name])
    nlj = next(x for x in labels if x.startswith("NestedLoopJoinExec"))
    assert int(nlj.split("chunks=")[1].rstrip(")")) > 1
    assert _same_sql(jctx, tctx, THETA[name]) > 0


def test_theta_join_overflow_retries(small_cells, contexts):
    """A predicate that keeps most pairs outgrows the chunked join's
    output capacity: the run's overflow flag makes the client retry with
    join_out_factor grown to the pairs the run counted, and the count is
    exact."""
    jctx, _ = contexts
    tctx = SessionContext(device="cpu")
    for name in ("t", "s"):
        tctx.register_host(name, *_port_columns(TABLES[name][0]))
    sql = "select count(*) as n from t, s where z > x"
    jbatch, jschema = jctx.sql(sql).collect()
    tbatch, tschema = tctx.sql(sql).collect()
    _assert_same(tbatch, tschema, jbatch, jschema)
    x = TABLES["t"][0]["x"].to_numpy()
    z = TABLES["s"][0]["z"].to_numpy()
    assert int(tbatch.columns[0].data[0]) == int((z[None, :] > x[:, None]).sum())
    assert len(tctx.warnings) == 1
    assert all("overflowed" in w for w in tctx.warnings)


def test_bare_cross_over_the_bound_raises(small_cells, contexts):
    jctx, tctx = contexts
    for ctx in (jctx, tctx):
        with pytest.raises(NotImplementedError,
                           match="256x384 rows exceeds the 4096 cell bound"):
            ctx.sql("select count(*) from t, s").collect()


def test_union_typed_null_string_branch(contexts):
    """A branch that projects a typed NULL string has no dictionary: the
    union's schema still carries the other branch's dictionary, and only
    that branch is remapped."""
    jctx, tctx = contexts
    out = []
    for ctx, E, L, S in ((jctx, JE, JL, JS), (tctx, TE, TL, TS)):
        nulls = L.Projection(ctx.sql("select x from t1").plan,
                             (E.Col("x"), E.Lit(None, S.STRING)), ("x", "y"))
        other = ctx.sql("select x2, y2 from t2").plan
        out.append(ctx.collect(L.Union((nulls, other))))
    (jbatch, jschema), (tbatch, tschema) = out
    _assert_same(tbatch, tschema, jbatch, jschema)
    got = port_to_numpy(tbatch, tschema)
    assert list(got["y"][0]) == [None, None, None, "c", "d"]
    assert list(tschema.dictionary("y")) == ["c", "d"]


def _key_case(seed, nb, np_, dup=False):
    rng = np.random.default_rng(seed)
    keys = []
    for side, n in (("b", nb), ("p", np_)):
        k1 = (rng.permutation(3 * n)[:n] if side == "b" and not dup
              else rng.integers(0, 3 * nb, n))
        k2 = k1 % 7
        keys.append(([k1, k2], [rng.random(n) > 0.1, rng.random(n) > 0.05],
                     np.arange(n) < n - 5))
    return keys


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_full_unique_matches_jax(seed):
    """Per-probe match and per-build matched flag, field by field: NULL
    key parts on both sides, dead rows at the tail of each side."""
    (bk, bv, bl), (pk, pv, pl) = _key_case(seed, 300, 500)
    jm, jflag = jax_full_unique(
        tuple(jnp.asarray(k) for k in bk), tuple(jnp.asarray(v) for v in bv),
        jnp.asarray(bl), tuple(jnp.asarray(k) for k in pk),
        tuple(jnp.asarray(v) for v in pv), jnp.asarray(pl))
    t = torch.from_numpy
    tm, tflag = merge_full_unique([t(k) for k in bk], [t(v) for v in bv],
                                  t(bl), [t(k) for k in pk],
                                  [t(v) for v in pv], t(pl))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tflag.numpy(), np.asarray(jflag))
    assert (tm >= 0).any() and (tm < 0).any()
    assert tflag.any() and (~tflag).any()


def _batch_pair(seed, n_live, cap):
    """The same batch (an int64 and a nullable int32 column) in both
    packages."""
    rng = np.random.default_rng(seed)
    a = rng.integers(-100, 100, n_live)
    b = rng.integers(0, 9, n_live).astype(np.int32)
    valid = rng.random(n_live) > 0.2
    jb = JB.Batch((JB.make_column(a, np.ones(n_live, bool), JS.INT64, cap),
                   JB.make_column(b, valid, JS.INT32, cap)),
                  jnp.int32(n_live))
    tb = TB.Batch((TB.make_column(a, np.ones(n_live, bool), TS.INT64, cap,
                                  "cpu"),
                   TB.make_column(b, valid, TS.INT32, cap, "cpu")),
                  torch.tensor(n_live, dtype=torch.int32))
    return jb, tb


@pytest.mark.parametrize("capacity", [384, 640, 200])
def test_concat_batches_matches_jax(capacity):
    """Live rows in input order at a fixed capacity, cut where they do not
    fit. The reference tiles the padding (jnp.resize), the port pads with
    zeros: validity is equal over the whole capacity, data where valid."""
    pairs = [_batch_pair(s, n, 128) for s, n in ((0, 100), (1, 0), (2, 128),
                                                 (3, 37))]
    jout = JP.concat_batches([j for j, _ in pairs], capacity)
    tout = TP.concat_batches([t for _, t in pairs], capacity)
    assert tout.capacity == jout.capacity == capacity
    assert int(tout.num_rows) == int(jout.num_rows) == min(265, capacity)
    for jc, tc in zip(jout.columns, tout.columns):
        jv = np.asarray(jc.validity)
        np.testing.assert_array_equal(tc.validity.numpy(), jv)
        np.testing.assert_array_equal(tc.data.numpy()[jv],
                                      np.asarray(jc.data)[jv])
