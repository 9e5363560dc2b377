"""Live-mask (sparse) flow: `plan_sparse_flow` marks the filters and the
unique-build inner / semi / anti joins whose parent reads liveness through
`row_mask`, and they hand their keep mask on as `Batch.live` instead of
compacting. tests/test_sparse_flow.py's cases against the port and the JAX
package (answers exact), the marks of TPC-H Q3, Q5 and Q18 node by node
against the reference's plan, a subtree with one sparse-accepting and one
dense parent, and a run-time check over all 22 TPC-H queries that only the
consumers and the row-by-row nodes ever receive a sparse batch."""

import numpy as np
import pyarrow as pa
import pytest
import torch

from ballista_tpu.client.context import _rebind_scans
from ballista_tpu.exec import plan as JP
from ballista_tpu.planner.physical import create_physical_plan as jax_physical
from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.datagen import TPCH_TABLES
from ballista_tpu_torch.exec import plan as TP
from ballista_tpu_torch.exec.cse import cse_tree
from ballista_tpu_torch.exprs import BinOp, Col, Lit
from ballista_tpu_torch.ops.sort import SortKeySpec, sort_batch
from test_torch_stats_aggs import both, same_sql
from test_torch_tpch_six import _contexts

torch.set_num_threads(2)

_RNG = np.random.default_rng(7)
N, M = 500, 80
F = pa.table({"k": _RNG.integers(0, M, N), "v": _RNG.integers(0, 1000, N),
              "flag": _RNG.integers(0, 2, N).astype(bool)})
D = pa.table({"k": np.arange(M), "grp": _RNG.integers(0, 5, M)})

CONSUMERS = (TP.HashAggregateExec, TP.SortExec, TP.FilterExec, TP.HashJoinExec)
TRANSPARENT = (TP.ProjectExec, TP.DictRemapExec)


@pytest.fixture(scope="module")
def ctxs():
    return both({"f": F, "d": D})


def _marks(root, mod):
    """Pre-order (node type, emit_sparse) of the filters and joins."""
    out = []

    def walk(n):
        if isinstance(n, (mod.FilterExec, mod.HashJoinExec)):
            out.append((type(n).__name__, getattr(n, "join_type", ""),
                        bool(n.emit_sparse)))
        for c in n.children:
            walk(c)
    walk(root)
    return out


def _plans(ctxs, sql):
    jctx, tctx = ctxs
    jplan = _rebind_scans(jctx.sql(sql).plan, jctx)
    caps = {t: tp.capacity for t, tp in jctx.tables.items()}
    return (jax_physical(jplan, caps, jctx.options),
            tctx.physical_plan(tctx.sql(sql).plan))


SPARSE_SQL = {
    "join_under_agg": "select d.grp, sum(f.v) s from f join d on f.k = d.k "
                      "where f.v > 100 group by d.grp order by d.grp",
    "filtered_join_counts": "select d.grp, count(*) n, sum(f.v) s from f "
                            "join d on f.k = d.k where f.v > 100 and f.flag "
                            "group by d.grp order by d.grp",
    "filter_feeds_sort": "select v from f where v > 900 order by v desc",
    "semi_join_under_agg": "select count(*) n from f where f.k in "
                           "(select k from d where grp = 2)",
    "anti_join_under_sort": "select k, v from f where f.k not in "
                            "(select k from d where grp < 3) order by v, k",
    "filter_under_filter": "select k, v from (select k, v from f where v > 50)"
                           " t where k < 40 order by k, v",
    "sparse_probe_left_outer": "select d.k, t.v from d left join "
                               "(select k, v from f where v > 990) t "
                               "on d.k = t.k order by d.k, t.v",
    "filtered_probe_unique_left_outer": "select t.k, t.v, d.grp from "
                                        "(select k, v from f where v > 900) t "
                                        "left join d on t.k = d.k "
                                        "order by t.v, t.k",
}


@pytest.mark.parametrize("case", sorted(SPARSE_SQL))
def test_sparse_results_match_jax(ctxs, case):
    got = same_sql(ctxs, SPARSE_SQL[case], 0)
    assert len(next(iter(got.values()))[0]) > 0


@pytest.mark.parametrize("case", ["join_under_agg", "filter_feeds_sort",
                                  "semi_join_under_agg",
                                  "anti_join_under_sort"])
def test_sparse_marks_set(ctxs, case):
    jroot, troot = _plans(ctxs, SPARSE_SQL[case])
    marks = _marks(troot, TP)
    assert any(sparse for _, _, sparse in marks), \
        "no operator left out its compaction under a mask-aware parent"
    assert marks == _marks(jroot, JP)
    assert " sparse" in troot.display()


def test_outer_join_probe_stays_dense(ctxs):
    """Where the port's marks differ from the reference's: the reference
    lets the probe of a unique-build LEFT OUTER join arrive under a mask
    and hands that mask on; the port keeps that probe dense, so its
    filter packs the probe's columns alone and the join's output, the
    probe's rows in place, is dense as well."""
    jroot, troot = _plans(ctxs, SPARSE_SQL["filtered_probe_unique_left_outer"])
    assert _marks(jroot, JP) == [("HashJoinExec", "left_outer", False),
                                 ("FilterExec", "", True)]
    assert _marks(troot, TP) == [("HashJoinExec", "left_outer", False),
                                 ("FilterExec", "", False)]
    join = troot
    while not isinstance(join, TP.HashJoinExec):
        join = join.children[0]
    assert join.unique_build
    _, tctx = ctxs
    out, _ = TP.run_plan(join, tctx.bind_inputs(
        [leaf.input_id for leaf in join.leaves()]))
    assert out.live is None
    assert int(out.num_rows) == int((np.asarray(F["v"]) > 900).sum())
    # the same probe under an inner join arrives as a mask, as in the reference
    inner = SPARSE_SQL["filtered_probe_unique_left_outer"].replace(
        "left join", "join")
    jroot, troot = _plans(ctxs, inner)
    assert _marks(troot, TP) == _marks(jroot, JP)
    assert ("FilterExec", "", True) in _marks(troot, TP)


def test_cse_dedups_identical_subtrees(ctxs):
    _, tctx = ctxs
    sql = ("select k, sum(v) s from f group by k "
           "union all select k, sum(v) s from f group by k")
    root = tctx.physical_plan(tctx.sql(sql).plan)
    aggs = []

    def find(n):
        if isinstance(n, TP.HashAggregateExec):
            aggs.append(n)
        for c in n.children:
            find(c)
    find(root)
    assert len(aggs) == 2 and aggs[0] is aggs[1]
    got = same_sql(ctxs, sql, 0)
    assert len(got["k"][0]) == 2 * len(np.unique(F["k"]))


def test_subtree_with_a_sparse_and_a_dense_parent(ctxs):
    """The same filter under a sort (which takes a mask) and under a
    UNION ALL (which needs packed rows): the marks differ, so cse_tree
    keeps two nodes, and each parent gets what it can read."""
    _, tctx = ctxs
    sql = ("select v from (select v from f where v > 900 order by v) a "
           "union all select v from f where v > 900")
    root = tctx.physical_plan(tctx.sql(sql).plan)
    filters = []

    def find(n):
        if isinstance(n, TP.FilterExec) and n not in filters:
            filters.append(n)
        for c in n.children:
            find(c)
    find(root)
    assert sorted(f.emit_sparse for f in filters) == [False, True]
    assert all(f.n_parents == 1 for f in filters)
    got = same_sql(ctxs, sql, 0)
    v = np.asarray(F["v"])
    np.testing.assert_array_equal(
        got["v"][0], np.concatenate([np.sort(v[v > 900]), v[v > 900]]))

    # the same subtree built by hand, unmarked: one shared node
    def branch():
        leaf = TP.InputLeaf("f", tctx.tables["f"].schema,
                            tctx.tables["f"].capacity)
        return TP.FilterExec(leaf, BinOp(">", Col("v"), Lit(900)))
    shared = cse_tree(TP.CoalesceExec([TP.SortExec(branch(),
                                                   [(Col("v"), True, None)]),
                                       branch()]))
    a, b = shared.children[0].children[0], shared.children[1]
    assert a is b and a.n_parents == 2
    marked = cse_tree(TP.plan_sparse_flow(TP.CoalesceExec(
        [TP.SortExec(branch(), [(Col("v"), True, None)]), branch()])))
    a, b = marked.children[0].children[0], marked.children[1]
    assert a is not b and a.emit_sparse and not b.emit_sparse


def test_sparse_batch_contract(ctxs):
    """A sparse batch: rows in place, num_rows = live.sum() on the
    device, row_mask = live; sorting it packs the live rows."""
    _, tctx = ctxs
    leaf = TP.InputLeaf("f", tctx.tables["f"].schema, tctx.tables["f"].capacity)
    node = TP.FilterExec(leaf, BinOp(">", Col("v"), Lit(900)))
    inputs = tctx.bind_inputs(["f"])
    dense, _ = TP.run_plan(node, inputs)
    node.emit_sparse = True
    sparse, _ = TP.run_plan(node, inputs)
    assert dense.live is None and sparse.live is not None
    assert sparse.num_rows.dtype == torch.int32
    assert int(sparse.num_rows) == int(dense.num_rows) == \
        int(sparse.live.sum()) == int((np.asarray(F["v"]) > 900).sum())
    assert TP.row_mask(sparse) is sparse.live
    for s, i in zip(sparse.columns, inputs["f"].columns):
        assert s.data is i.data      # nothing moved
    packed = sort_batch(sparse, [SortKeySpec(0)])
    want = sort_batch(dense, [SortKeySpec(0)])
    assert packed.live is None
    n = int(want.num_rows)
    for p, w in zip(packed.columns, want.columns):
        torch.testing.assert_close(p.data[:n], w.data[:n], rtol=0, atol=0)
    kept = sparse.replace_columns(sparse.columns[:1])
    assert kept.live is sparse.live and len(kept.columns) == 1


# -- TPC-H ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def tpch():
    return _contexts(0.01, list(TPCH_TABLES))


@pytest.mark.parametrize("q", [3, 5, 18])
def test_tpch_marks_equal_reference(tpch, q):
    jroot, troot = _plans(tpch, TPCH_QUERIES[q])
    marks = _marks(troot, TP)
    assert marks == _marks(jroot, JP)
    assert sum(sparse for _, _, sparse in marks) >= 2


def _edges(root):
    seen, out = set(), []

    def walk(n):
        for c in n.children:
            out.append((n, c))
            if id(c) not in seen:
                seen.add(id(c))
                walk(c)
    walk(root)
    return out


@pytest.mark.parametrize("q", sorted(TPCH_QUERIES))
def test_only_consumers_receive_sparse_batches(tpch, q, monkeypatch):
    """Run the query with every node's output recorded: a node whose
    output carried `live` may only be read by a consumer or a row-by-row
    node, and the root's output is dense."""
    _, tctx = tpch
    sparse_out = {}
    real_eval = TP.Run.eval

    def recording_eval(self, node):
        out = real_eval(self, node)
        sparse_out[id(node)] = out.live is not None
        if out.live is not None:
            assert int(out.num_rows) == int(out.live.sum())
        return out
    monkeypatch.setattr(TP.Run, "eval", recording_eval)
    df = tctx.sql(TPCH_QUERIES[q])
    root, inputs, out = df.converge()
    assert out.live is None and not sparse_out[id(root)]
    n_sparse = 0
    for parent, child in _edges(root):
        if sparse_out.get(id(child)):
            n_sparse += 1
            assert isinstance(parent, CONSUMERS + TRANSPARENT), \
                (type(parent).__name__, type(child).__name__)
            assert isinstance(child, (TP.FilterExec, TP.HashJoinExec)
                              + TRANSPARENT)
            assert not (isinstance(parent, TP.HashJoinExec)
                        and parent.unique_build
                        and parent.join_type in ("left_outer", "full_outer")
                        and child is parent.children[1])
    marked = sum(getattr(n, "emit_sparse", False)
                 for n in {id(c): c for _, c in _edges(root)}.values())
    assert (n_sparse > 0) == (marked > 0)


# -- the two host-side caches that came with the pass ---------------------------

def test_row_index_is_made_once_per_capacity_and_device(monkeypatch):
    from ballista_tpu_torch import batch as TB
    TB.drop_row_indices()
    a = TB.row_index(256, torch.device("cpu"))
    assert TB.row_index(256, "cpu") is a and a.dtype == torch.int32
    assert torch.equal(a, torch.arange(256, dtype=torch.int32))
    # bounded by bytes: the oldest go first, too large a one is not kept
    monkeypatch.setattr(TB, "_ARANGES_MAX_BYTES", 4 * 1024)
    for cap in (256, 512, 384, 128):
        TB.row_index(cap, "cpu")
        assert sum(4 * c for c, _ in TB._ARANGES) <= 4 * 1024
    assert [c for c, _ in TB._ARANGES] == [512, 384, 128]
    big = TB.row_index(2048, "cpu")
    assert big.shape == (2048,) and TB.row_index(2048, "cpu") is not big
    assert [c for c, _ in TB._ARANGES] == [512, 384, 128]
    dense = TB.Batch((TB.Column(torch.zeros(256), torch.ones(256, dtype=bool)),),
                     torch.tensor(3, dtype=torch.int32))
    assert TB.row_mask(dense).sum() == 3


def test_negated_string_predicates_reuse_their_lut(monkeypatch):
    """NOT LIKE and NOT IN are bound on every collect: each bind gathers
    through the same negated LUT object, so the device copy of a large
    one is made once and not once per collect."""
    from ballista_tpu_torch import batch as TB
    from ballista_tpu_torch import exprs as E
    from ballista_tpu_torch.schema import STRING, Field, Schema
    monkeypatch.setattr(E, "_DICT_CACHE", {})
    raw = np.array(["apple", "banana", "cherry"], dtype=object)
    schema = Schema((Field("s", STRING),), dictionaries={"s": raw},
                    unsorted=frozenset({"s"}))
    seen = []
    gather = E.gather_lut
    monkeypatch.setattr(E, "gather_lut",
                        lambda lut, col: (seen.append(lut), gather(lut, col))[1])
    codes = TB.Column(torch.tensor([0, 1, 2]), torch.ones(3, dtype=bool))
    batch = TB.Batch((codes,), torch.tensor(3))
    for pred, want in (
            (E.Like(E.Col("s"), "%an%", negated=True), [True, False, True]),
            (E.InList(E.Col("s"), (E.Lit("cherry"),), negated=True),
             [True, True, False])):
        seen.clear()
        for _ in range(2):
            assert E.bind_expr(pred, schema).fn(batch).data.tolist() == want
        assert seen[0] is seen[1]


def test_dictionary_tables_are_built_once_per_dictionary_object(monkeypatch):
    """LIKE, substring and the string functions loop over the dictionary
    in Python: a second bind over the same dictionary object reuses the
    table; an equal dictionary in another object does not, and the entry
    keeps its dictionary alive so that the id cannot be taken over."""
    from ballista_tpu_torch import exprs as E
    monkeypatch.setattr(E, "_DICT_CACHE", {})
    d1 = np.array(["apple", "banana", "cherry"], dtype=object)
    d2 = d1.copy()
    lut = E.like_lut(d1, "%an%")
    assert lut.tolist() == [False, True, False]
    assert E.like_lut(d1, "%an%") is lut
    assert E.like_lut(d2, "%an%") is not lut
    assert E.like_lut(d1, "a%") is not lut
    assert all(entry[0] is d for (i, _), entry in E._DICT_CACHE.items()
               for d in (d1, d2) if i == id(d))
    calls = []
    made = E.dict_cached(d1, ("f",), lambda: calls.append(1) or "table")
    assert E.dict_cached(d1, ("f",), lambda: calls.append(1)) == made
    assert calls == [1]
    for k in range(2 * E._DICT_CACHE_MAX):
        E.dict_cached(d1, ("g", k), lambda: k)
    assert len(E._DICT_CACHE) <= E._DICT_CACHE_MAX     # bounded, oldest out
    # through SQL: the same answer on the second bind, from the cache
    _, tctx = both({"w": pa.table({"s": ["apple", "banana", None, "cherry"]})})
    sql = ("select s, substring(s, 1, 2) as p, upper(s) as u, length(s) as n "
           "from w where s like '%an%' or s like 'ch%' order by s")
    first = tctx.sql(sql).to_numpy()
    n_entries = len(E._DICT_CACHE)
    second = tctx.sql(sql).to_numpy()
    assert len(E._DICT_CACHE) == n_entries
    assert first["p"][0].tolist() == second["p"][0].tolist() == ["ba", "ch"]
    assert first["u"][0].tolist() == ["BANANA", "CHERRY"]
    assert first["n"][0].tolist() == [6, 6]
