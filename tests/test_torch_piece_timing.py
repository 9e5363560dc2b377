"""The per-piece profiler of ballista_tpu_torch (`exec.plan.plan_pieces`,
`piece_bytes` and the timed run behind BALLISTA_PIECE_TIMING=1) and its
reader `benchmarks/roofline.py`, on the CPU. The pieces equal the cut the
JAX package's `_split_compile` makes of its own physical plan (the rule is
applied here, to the JAX plan of the same SQL); a timed run gives the
untimed run's answer, verdict, growth, retries and evaluate calls and the
JAX package's answer; the byte floor matches a numpy count; a printed
line parses with the port's regex and with the one in scripts/roofline.py."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from ballista_tpu.client.context import _rebind_scans as jax_rebind
from ballista_tpu.planner.optimizer import prune_columns as jax_prune
from ballista_tpu.planner.physical import create_physical_plan as jax_physical
from ballista_tpu_torch.batch import Batch, Column
from ballista_tpu_torch.benchmarks import TPCH_QUERIES, roofline
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, register_tpch
from ballista_tpu_torch.exec import plan as TP
from ballista_tpu_torch.planner.physical import PhysicalOptions
from test_torch_tpch_six import _assert_same, _contexts

torch.set_num_threads(2)

SF = 0.02            # Q21 is empty at SF 0.01 and below
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXTRA = {
    # a WindowExec cut below the root's sort
    "window": "select o_custkey, o_orderkey, rank() over (partition by "
              "o_custkey order by o_totalprice desc) as rk from orders "
              "where o_totalprice > 100000 order by o_custkey, o_orderkey",
    # a CrossJoinExec cut below an aggregate
    "cross": "select r_name, count(*) as n from nation, region "
             "where n_regionkey <> r_regionkey group by r_name "
             "order by r_name",
}
QUERIES = {**{f"q{q}": TPCH_QUERIES[q] for q in sorted(TPCH_QUERIES)},
           **EXTRA}
TIMED = (1, 3, 9, 13, 18, 21)
# group tables and expanding join outputs small enough that Q13, Q18 and
# Q21 overflow before they converge
SMALL = PhysicalOptions(join_out_factor=1 / 64, max_group_table=1 << 10)


@pytest.fixture(scope="module")
def contexts():
    jctx, tctx = _contexts(SF, list(TPCH_TABLES))
    yield jctx, tctx
    # tests/test_evict.py counts every live JAX array of its process
    jctx.evict_device()


def reference_pieces(root):
    """(key, label) of each program `ballista_tpu.exec.plan._split_compile`
    makes of `root`, by its rule: post order by identity; cut at every
    join, aggregate and window below the root; one `__whole` program where
    fewer than two heavy operators or nothing to cut."""
    cut_names = {"HashJoinExec", "CrossJoinExec", "HashAggregateExec",
                 "WindowExec"}
    order, seen = [], set()

    def post(n):
        if id(n) in seen:
            return
        seen.add(id(n))
        for c in n.children:
            post(c)
        order.append(n)

    post(root)
    heavy = [n for n in order
             if type(n).__name__ in cut_names | {"SortExec"}]
    cuts = [n for n in order if type(n).__name__ in cut_names
            and n is not root]
    if len(heavy) < 2 or not cuts:
        return [("__whole", type(root).__name__)]
    return [(f"__piece{k}", type(n).__name__) for k, n in enumerate(cuts)] \
        + [("__root", "root")]


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_pieces_equal_the_reference_cut(contexts, name):
    jctx, tctx = contexts
    sql = QUERIES[name]
    jplan = jax_rebind(jax_prune(jctx.sql(sql).plan), jctx)
    caps = {t: tp.capacity for t, tp in jctx.tables.items()}
    jroot = jax_physical(jplan, caps, jctx.options)
    troot = tctx.physical_plan(tctx.sql(sql).plan)
    got = [(key, label) for key, label, _ in TP.plan_pieces(troot)]
    assert got == reference_pieces(jroot)
    if name in EXTRA:
        assert {"window": "WindowExec",
                "cross": "CrossJoinExec"}[name] in dict(got).values()
    # the nodes are the plan's own, each once
    nodes = [n for _, _, n in TP.plan_pieces(troot)]
    assert nodes[-1] is troot and len({id(n) for n in nodes}) == len(nodes)


def _nodes(root):
    seen, stack = {}, [root]
    while stack:
        n = stack.pop()
        seen[id(n)] = n
        stack.extend(n.children)
    return list(seen.values())


def _run(plan, inputs, timed, monkeypatch):
    """(Batch, Run) of one evaluation of `plan`, timed or not."""
    if timed:
        monkeypatch.setenv("BALLISTA_PIECE_TIMING", "1")
    else:
        monkeypatch.delenv("BALLISTA_PIECE_TIMING", raising=False)
    run = TP.Run(inputs)
    out = TP.eval_plan(run, plan)
    return out, run


def _needs(run):
    return [(int(need), have, kind) for need, have, kind in run.needs]


@pytest.mark.parametrize("q", TIMED)
def test_timed_run_changes_nothing(contexts, q, monkeypatch, capsys):
    jctx, _ = contexts
    tctx = SessionContext(device="cpu", options=SMALL)
    register_tpch(tctx, SF)
    sql = TPCH_QUERIES[q]
    jbatch, jschema = jctx.sql(sql).collect()

    monkeypatch.delenv("BALLISTA_PIECE_TIMING", raising=False)
    plan, inputs, untimed = tctx.sql(sql).converge()
    retries = tctx.take_warnings()
    capsys.readouterr()
    monkeypatch.setenv("BALLISTA_PIECE_TIMING", "1")
    plan2, inputs2, timed = tctx.sql(sql).converge()
    lines = roofline.LINE.findall(capsys.readouterr().err)
    assert tctx.take_warnings() == retries
    if q in (13, 18, 21):
        assert retries              # the timed runs overflowed too
    pieces = TP.plan_pieces(plan2)
    assert len(lines) == (len(retries) + 1) * len(pieces)
    assert [(k, l) for k, l, *_ in lines[-len(pieces):]] == \
        [(k, l) for k, l, _ in pieces]
    _assert_same(untimed, plan.schema, jbatch, jschema)
    _assert_same(timed, plan2.schema, jbatch, jschema)

    # one run each way on the converged plan: the same Batch, verdict,
    # needs, growth and evaluate calls; nothing left kept or shared, and
    # no node's children swapped
    children = {id(n): n.children for n in _nodes(plan)}
    out0, run0 = _run(plan, inputs, False, monkeypatch)
    out1, run1 = _run(plan, inputs, True, monkeypatch)
    assert len(roofline.LINE.findall(capsys.readouterr().err)) == len(pieces)
    _assert_same(out1, plan.schema, jbatch, jschema)
    _assert_same(out0, plan.schema, jbatch, jschema)
    assert run1.evaluated == run0.evaluated == len(children)
    assert _needs(run1) == _needs(run0)
    v0, v1 = run0.verdict(), run1.verdict()
    assert (v0 is None) == (v1 is None)
    if v0 is not None:
        assert int(v0) == int(v1) == 0
        assert torch.equal(run0.growth(), run1.growth())
    assert run1.kept == {} and run1._shared == {} and run0._shared == {}
    assert all(n.children is children[id(n)] for n in _nodes(plan))
    # the first plan, whose run overflows in Q13, Q18 and Q21: the same
    # verdict, needs and growth (what the retry grows by)
    first = tctx.physical_plan(tctx.sql(sql).plan)
    first_inputs = tctx.bind_inputs([leaf.input_id
                                     for leaf in first.leaves()])
    out0, run0 = _run(first, first_inputs, False, monkeypatch)
    out1, run1 = _run(first, first_inputs, True, monkeypatch)
    v0, v1 = run0.verdict(), run1.verdict()
    assert (v0 is None) == (v1 is None)
    if v0 is not None:
        assert int(v0) == int(v1) == (-1 if q in (13, 18, 21) else 0)
        assert torch.equal(run0.growth(), run1.growth())
    assert _needs(run1) == _needs(run0) and run1.evaluated == run0.evaluated
    assert int(out0.num_rows) == int(out1.num_rows)
    capsys.readouterr()
    # run_plan takes the same path
    monkeypatch.setenv("BALLISTA_PIECE_TIMING", "1")
    again, verdict = TP.run_plan(plan, inputs)
    _assert_same(again, plan.schema, jbatch, jschema)
    assert len(roofline.LINE.findall(capsys.readouterr().err)) == len(pieces)


def test_shared_subtree_is_one_piece(contexts, monkeypatch, capsys):
    """Q21's lineitem scan is shared by two parents (exec/cse.py); a
    timed run evaluates every distinct node once, as the untimed run."""
    _, tctx = contexts
    plan, inputs, _ = tctx.sql(TPCH_QUERIES[21]).converge()
    shared = [n for n in _nodes(plan) if n.n_parents > 1]
    assert shared
    out, run = _run(plan, inputs, True, monkeypatch)
    assert run.evaluated == len(_nodes(plan))
    keys = [k for k, *_ in roofline.LINE.findall(capsys.readouterr().err)]
    assert keys == [k for k, _, _ in TP.plan_pieces(plan)]


# -- piece_bytes ---------------------------------------------------------------

def _col(values, valid=None):
    values = torch.as_tensor(values)
    if valid is None:
        valid = torch.ones(values.shape[0], dtype=torch.bool)
    return Column(values, torch.as_tensor(valid))


def _batch(cols, rows, live=None):
    return Batch(tuple(cols), torch.tensor(rows, dtype=torch.int32),
                 None if live is None else torch.as_tensor(live))


def _numpy_count(parts):
    """Sum of (rows, itemsize * width) over distinct tensors (given as
    (name, rows, bytes per row))."""
    seen = {}
    for name, rows, per_row in parts:
        seen[name] = max(seen.get(name, 0), rows * per_row)
    return sum(seen.values())


def test_piece_bytes_dense_sparse_nullable_shared():
    rng = np.random.default_rng(5)
    cap = 16
    a = rng.integers(0, 100, cap)                       # int64
    b = rng.random(cap)                                 # float64
    nulls = rng.random(cap) < 0.3
    dense = _batch([_col(a), _col(b, ~nulls)], 11)
    live = rng.random(cap) < 0.4
    shared = torch.as_tensor(rng.integers(0, 9, cap).astype(np.int32))
    sparse = _batch([_col(shared), _col(shared)], int(live.sum()), live)
    wide = torch.as_tensor(rng.integers(0, 9, (cap, 2)))
    out = _batch([_col(wide), dense.columns[0]], 7)
    floor, whole = TP.piece_bytes([dense, sparse], out)
    n_live = int(live.sum())
    want = _numpy_count([
        ("dense.rows", 1, 4), ("a", 11, 8), ("a.valid", 11, 1),
        ("b", 11, 8), ("b.valid", 11, 1),
        ("sparse.rows", 1, 4), ("live", cap, 1), ("shared", n_live, 4),
        ("shared.valid0", n_live, 1), ("shared.valid1", n_live, 1),
        ("out.rows", 1, 4), ("wide", 7, 16), ("wide.valid", 7, 1),
        # dense's first column again: counted once, at its larger rows
        ("a", 7, 8), ("a.valid", 7, 1)])
    assert floor == want
    assert whole == 3 * 4 + cap * (8 + 1 + 8 + 1) + cap + cap * (4 + 2) \
        + cap * (16 + 1)
    # a broadcast view holds one row
    one = torch.tensor([3], dtype=torch.int64).expand(cap)
    view = _batch([Column(one, torch.ones(1, dtype=torch.bool).expand(cap))],
                  cap)
    assert TP.piece_bytes([], view) == (4 + 8 + 1, 4 + 8 + 1)


# -- the printed line ---------------------------------------------------------

def _script_regex():
    """LINE of scripts/roofline.py, read from the file (not imported)."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "roofline.py")).read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "LINE":
            return re.compile(ast.literal_eval(node.value.args[0]))
    raise AssertionError("no LINE in scripts/roofline.py")


class _Clock:
    """perf_counter that advances 0.5 s per call."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.5
        return self.t


def test_line_parses_and_states_rates(monkeypatch, capsys):
    """A plan with one aggregate is one `__whole` piece. With each repeat's
    clock fixed (the 5 repeats take 0.5 s: 100 ms each) and the roof at
    1 GB/s, the line's GiB/s and share follow from its byte floor."""
    ctx = SessionContext(device="cpu")
    ctx.register_numpy("t", {"k": np.arange(1000) % 7,
                             "v": np.arange(1000)})
    plan, inputs, _ = ctx.sql(
        "select k, sum(v) as s from t group by k").converge()
    (key, label, node), = TP.plan_pieces(plan)
    assert (key, label, node) == ("__whole", type(plan).__name__, plan)
    monkeypatch.setattr(TP, "time", _Clock())
    monkeypatch.setenv("BALLISTA_HBM_GBPS", "1")
    _, run = _run(plan, inputs, True, monkeypatch)
    err = capsys.readouterr().err
    out = TP.run_plan(plan, inputs)[0]    # untimed: the env is gone
    nbytes, cap = TP.piece_bytes(list(inputs.values()), out)
    (m,) = roofline.LINE.findall(err)
    (s,) = _script_regex().findall(err)
    assert m[:7] == s
    assert m[:4] == ("__whole", type(plan).__name__, "100.00", "7")
    rate = nbytes / 0.1
    assert m[4] == f"{nbytes / 2 ** 20:.1f}"
    assert m[5] == f"{rate / 2 ** 30:.1f}"
    assert m[6] == f"{100 * rate / 1e9:.1f}"
    assert m[7] == f"{cap / 2 ** 20:.1f}"
    row, = roofline.parse(err, 5)
    assert row["bound_ms"] == pytest.approx(float(m[4]) * 2 ** 20 / 1e9 * 1e3)
    assert TP.hbm_bytes_per_s() == 1e9
    monkeypatch.delenv("BALLISTA_HBM_GBPS")
    assert TP.hbm_bytes_per_s() == 3350e9


# -- benchmarks/roofline.py ----------------------------------------------------

def _roofline(tmp_path, queries, **env):
    out = tmp_path / "roofline.json"
    p = subprocess.run(
        [sys.executable, "-m", "ballista_tpu_torch.benchmarks.roofline",
         "--device", "cpu", "--sf", "0.01", "--queries", queries,
         "--iterations", "1", "--out", str(out)],
        capture_output=True, text=True, cwd=REPO, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="2", **env))
    return p, out


def test_roofline_script_writes_rows(tmp_path):
    p, out = _roofline(tmp_path, "1,3")
    assert p.returncode == 0, p.stderr[-2000:]
    rows = json.load(open(out))
    assert {r["query"] for r in rows} == {1, 3}
    assert [r["ms"] for r in rows] == sorted((r["ms"] for r in rows),
                                             reverse=True)
    q3 = [r for r in rows if r["query"] == 3]
    assert len(q3) == 4 and {r["op"] for r in q3} == {
        "HashJoinExec", "HashAggregateExec", "root"}
    for r in rows:
        assert r["cap_mib"] >= r["mib"] >= 0 and r["rows"] >= 0
        assert r["bound_ms"] == pytest.approx(
            r["mib"] * 2 ** 20 / 3350e9 * 1e3)
    assert "# wrote" in p.stdout and "q 3" in p.stdout


def test_roofline_script_fails_without_pieces(tmp_path):
    """A query routed to the serial runtime (a tiny device budget) prints
    no piece line: the script writes what it has and exits 1."""
    p, out = _roofline(tmp_path, "6", BALLISTA_HBM_BYTES=str(64 << 10))
    assert p.returncode == 1
    assert "no pieces or a failed run for queries [6]" in p.stderr
    assert json.load(open(out)) == []
