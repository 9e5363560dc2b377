"""The h2o db-benchmark join task J1 (`gpubench/data/h2o_join.py`,
`gpubench/reference/h2o_join.py`) through the port on the CPU, and the
join build sides it forces the planner to find unique at any size.

At N = 2 x 10^4 (the right tables at their floors of 10 and 100 rows) the
generator's layout holds, each of the five questions gives the plain
reference's answer (judged by `gpubench.answer.compare`, with x.id6 and
large.id6 RAW as they are at 10^8) and the reference's float32 control
does not. On tables of 1,100,000 rows (above the planner's host
inference) q5 plans a unique build found on the device, a duplicated key
on both sides makes it expanding, both answer as the reference does, and
a declared primary key stays the only unique set. Under a profiler the
join spans are recorded, and `exec.plan.JOIN_COUNTS` counts both modes."""

import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from ballista_tpu_torch.client import SessionContext  # noqa: E402
from ballista_tpu_torch.client import context as C  # noqa: E402
from ballista_tpu_torch.exec.plan import JOIN_COUNTS  # noqa: E402
from gpubench import port, spec  # noqa: E402
from gpubench.answer import DictMaps, as_program_cols, compare  # noqa: E402
from gpubench.data import h2o_join  # noqa: E402
from gpubench.reference.h2o_join import Reference  # noqa: E402
from gpubench.tables import Col, text_bytes  # noqa: E402

torch.set_num_threads(2)

N = 2 * 10**4
BIG = 1_100_000
SEED = 2**33 + 17
QUERIES = spec.cell("h2o_j1_1e8.join").queries
LIMITS = spec.cell("h2o_j1_1e8.join").config["limits"]
QS = sorted(QUERIES)


def _context(tables, device="cpu"):
    ctx = SessionContext(device=device)
    h2o_join.register(ctx, tables, {})
    return ctx


def _join_labels(ctx, q):
    plan = ctx.physical_plan(ctx.sql(QUERIES[q]).plan).display()
    return [line.strip() for line in plan.splitlines()
            if "HashJoinExec" in line]


def _judge(ctx, tables, q, maps=None):
    out, schema = ctx.sql(QUERIES[q]).collect()
    return compare(port.answer_to_host(out, schema),
                   Reference(tables, "cpu").answer(q), "cpu", maps)


@pytest.fixture(scope="module")
def tables():
    return h2o_join.generate({"rows": N}, SEED)


@pytest.fixture(scope="module")
def raw_ctx(tables):
    """The tables registered with a RAW threshold below id6's distinct
    count, every column ingested under it."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("BALLISTA_RAW_DICT_MAX", "1000")
        ctx = _context(tables)
        for tp in ctx.tables.values():
            tp.ensure_meta([f.name for f in tp.fields])
    return ctx


@pytest.fixture(scope="module")
def big():
    return h2o_join.generate({"rows": BIG}, SEED + 1)


def _share(a, b):
    return float(np.isin(a, b).mean())


@pytest.mark.parametrize("check", ["sizes", "right_keys_unique",
                                   "x_id3_permutation", "match_share",
                                   "strings"])
def test_generator_layout(tables, check):
    x, small, medium, large = (tables[t] for t in h2o_join.TABLES)
    if check == "sizes":
        assert [len(t["id1"].values) for t in (x, small, medium, large)] \
            == [N, 10, 100, N]
        assert list(large) == ["id1", "id2", "id3", "id4", "id5", "id6", "v2"]
    elif check == "right_keys_unique":
        for t, k in ((small, "id1"), (medium, "id2"), (large, "id3")):
            assert len(np.unique(t[k].values)) == len(t[k].values)
        # the other right ids repeat
        assert len(np.unique(large["id1"].values)) == 10
    elif check == "x_id3_permutation":
        v = x["id3"].values
        assert len(np.unique(v)) == N
        assert v.min() >= 1 and v.max() <= 5 * N // 2
        # in random order, not sorted
        assert not (np.diff(v) > 0).all()
    elif check == "match_share":
        for share in (_share(x["id1"].values, small["id1"].values),
                      _share(x["id2"].values, medium["id2"].values),
                      _share(x["id3"].values, large["id3"].values)):
            assert 0.85 <= share <= 0.95, share
        assert _share(x["id3"].values, large["id3"].values) == 0.9
    else:
        assert x["id6"].dtype == large["id6"].dtype == "text"
        assert x["id6"].dictionary is large["id6"].dictionary
        want = np.char.add(b"id", x["id3"].values.astype("S"))
        assert (text_bytes(x["id6"]) == want).all()
        for t, k, s in ((x, "id1", "id4"), (medium, "id2", "id5")):
            d = t[s].dictionary
            assert (d[:-1] < d[1:]).all()
            assert (d[t[s].values] == np.char.add(
                "id", t[k].values.astype(str))).all()


def test_id6_is_raw(raw_ctx):
    for name in ("x", "large"):
        assert raw_ctx.tables[name].host["id6"].raw
        assert not raw_ctx.tables[name].host["id4"].raw


@pytest.mark.parametrize("q", QS)
def test_question_matches_reference(raw_ctx, tables, q):
    v = _judge(raw_ctx, tables, q)
    assert v.wrong_cells <= LIMITS["wrong_cells"], v
    assert v.float_err <= LIMITS["float_err"], v
    kind = "left_outer" if q == "q3" else "inner"
    assert all(lab.startswith(f"HashJoinExec[{kind},unique]")
               for lab in _join_labels(raw_ctx, q))


@pytest.mark.parametrize("q", QS)
def test_control_is_not_correct(tables, q):
    ref, lower = Reference(tables, "cpu"), Reference(tables, "cpu",
                                                     control=True)
    v = compare(as_program_cols(lower.answer(q)), ref.answer(q), "cpu")
    assert v.wrong_cells <= LIMITS["wrong_cells"]
    assert v.float_err > LIMITS["float_err"]


def test_left_join_nulls_hold_zero(raw_ctx):
    out, schema = raw_ctx.sql(QUERIES["q3"]).collect()
    n = int(out.num_rows)
    names = [f.name for f in schema.fields]
    missed = None
    for name in ("mediumid1", "mediumid4", "mediumid5", "v2"):
        c = out.columns[names.index(name)]
        valid = c.validity[:n]
        missed = ~valid if missed is None else missed
        assert torch.equal(~valid, missed)
        assert not c.data[:n][~valid].any()
    assert 0 < int(missed.sum()) < n


def _big_ctx(tables, primary_keys=None):
    ctx = SessionContext(device="cpu")
    for name in h2o_join.TABLES:
        fields, cols = port.host_table(tables[name])
        ctx.register_host(name, fields, cols,
                          (primary_keys or {}).get(name))
    return ctx


def test_large_build_found_unique_on_the_device(big):
    ctx = _big_ctx(big)
    before = JOIN_COUNTS["unique"]
    assert _join_labels(ctx, "q5")[0].startswith("HashJoinExec[inner,unique]")
    v = _judge(ctx, big, "q5")
    assert (v.wrong_cells, v.float_err) == (0, 0.0), v
    assert JOIN_COUNTS["unique"] > before
    # the later relation was found unique: the earlier never checked
    assert ctx.tables["large"]._distinct == {"id3": True}
    assert ctx.tables["x"]._distinct == {}


def test_a_duplicated_key_makes_the_join_expanding(big):
    dup = {t: dict(cols) for t, cols in big.items()}
    for t in ("x", "large"):
        v = dup[t]["id3"].values.copy()
        v[1] = v[0]
        dup[t]["id3"] = Col(v, "int64")
    ctx = _big_ctx(dup)
    before = JOIN_COUNTS["expanding"]
    assert _join_labels(ctx, "q5")[0].startswith(
        "HashJoinExec[inner,expanding]")
    v = _judge(ctx, dup, "q5")
    assert (v.wrong_cells, v.float_err) == (0, 0.0), v
    assert JOIN_COUNTS["expanding"] > before
    assert ctx.tables["large"]._distinct == {"id3": False}
    assert ctx.tables["x"]._distinct == {"id3": False}


def test_a_declared_primary_key_stays_the_only_unique_set(big):
    ctx = _big_ctx(big, {"x": ("id1", "id2"), "large": ("id1", "id2")})
    assert _join_labels(ctx, "q5")[0].startswith(
        "HashJoinExec[inner,expanding]")
    assert ctx.join_unique_keys("large", ["id3"]) == [("id1", "id2")]
    assert ctx.tables["large"]._distinct == ctx.tables["x"]._distinct == {}


def _numpy_ctx(n, columns):
    ctx = SessionContext(device="cpu")
    ctx.register_numpy("t", columns)
    return ctx


@pytest.mark.parametrize("rows", [1000, BIG])
def test_verdicts_by_column(rows):
    """The same verdicts on the host (at most INFER_UNIQUE_ROWS rows, every
    column) and on the device (above, join columns): a NULL counts as one
    value; a float column is checked on the host alone."""
    ids = np.random.default_rng(rows).permutation(rows).astype(np.int64)
    dup = ids.copy()
    dup[1] = dup[0]
    one_null = np.ones(rows, dtype=bool)
    one_null[5] = False
    two_null = one_null.copy()
    two_null[6] = False
    cols = {"ids": ids, "dup": dup, "codes": ids.astype(str),
            "one_null": (ids, one_null), "two_null": (ids, two_null),
            "dup_null": (dup, one_null), "f": ids.astype(np.float64)}
    ctx = _numpy_ctx(rows, cols)
    found = {k for (k,) in ctx.join_unique_keys("t", list(cols))}
    want = {"ids", "codes", "one_null"}
    if rows <= C.INFER_UNIQUE_ROWS:
        want.add("f")
        assert found == want
        assert ctx.tables["t"]._distinct == {}
    else:
        assert found == want
        assert {k for k, v in ctx.tables["t"]._distinct.items() if v} == want
        # uploaded for the check, not kept on the device
        assert not ctx.tables["t"]._cols


def test_spans_and_counts(monkeypatch):
    """Under a profiler: the device check (above a threshold lowered to
    the test's size), q4's union-dictionary lookup tables and each probe;
    JOIN_COUNTS counts the unique probes, and the lookup tables built once
    for the pair of dictionaries, not on the next collect."""
    monkeypatch.setattr(C, "INFER_UNIQUE_ROWS", 1000)
    # fresh dictionaries: no other test has built their lookup tables
    ctx = _context(h2o_join.generate({"rows": N}, SEED + 2))
    before = dict(JOIN_COUNTS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for q in ("q4", "q5", "q4"):
            ctx.sql(QUERIES[q]).collect()
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("ballista.join.unique_keys") == 1
    assert names.count("ballista.join.key_remap") == 2
    assert names.count("ballista.join.probe") == 3
    assert JOIN_COUNTS["unique"] - before.get("unique", 0) == 3
    assert JOIN_COUNTS["key_remap"] - before.get("key_remap", 0) == 1
    assert ctx.tables["large"]._distinct == {"id3": True}


def test_one_judging_maps_each_dictionary_once(raw_ctx, tables):
    maps = DictMaps()
    for q in QS:
        v = _judge(raw_ctx, tables, q, maps)
        assert v.wrong_cells == 0
