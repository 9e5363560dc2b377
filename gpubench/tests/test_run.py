"""Runs of whole cells on the CPU, in a copy of the benchmark with toy
cells added as files (`toy.make`): what the result line holds, that a
configuration, a mix and a metric added as files are found and run, and
that a run whose program is broken underneath comes out not correct."""

import hashlib
import os

import pytest

from gpubench.tests import toy

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return toy.make(tmp_path_factory.mktemp("gpubench"))


def _digest(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in d:
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


def test_toy_files_are_found_with_no_file_edited(base):
    mine = _digest(os.path.join(toy.ROOT, "gpubench"))
    theirs = _digest(os.path.join(base, "gpubench"))
    added = set(theirs) - set(mine)
    assert added == {"configs/toy_tpch.json", "configs/toy_h2o.json",
                     "traffic/toy_tpch_mix.json", "traffic/toy_h2o_mix.json",
                     "metrics/toy_queries.py", "metrics/toy_plan_evals.py"}
    assert all(theirs[f] == mine[f] for f in theirs if f in mine)
    for cell in ("toy.tpch", "toy.h2o"):
        rc, last, err = toy.run(base, cell)
        assert rc == 0, err[-2000:]
        assert last["correct"] is True, err[-2000:]
        assert last["metrics"]["toy_queries"]["value"] == (
            last["attempted"] - last["failed"])


@pytest.mark.parametrize("trace", [0, 1])
def test_result_line(base, trace):
    rc, last, err = toy.run(base, "toy.tpch", trace=trace)
    assert rc == 0, err[-2000:]
    keys = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(last) == keys
    assert last["correct"] is True and last["failed"] == 0
    assert last["attempted"] > 0
    want = ({"sql_plan_ms", "overflow_reruns_per_query", "toy_plan_evals"}
            if trace else
            {"queries_per_s", "query_geomean_ms", "query_p95_ms", "setup_s",
             "toy_queries"})
    assert want <= set(last["metrics"])
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        last["device"])
    checks = last["checks"]
    assert checks["wrong_cells"] == {"value": 0, "limit": 0}
    # the numbers compared are the last lines of standard error too
    tail = err.strip().splitlines()[-len(checks):]
    assert [line.split()[0] for line in tail] == list(checks)
    if trace:
        # the wrapped entry ran at least once per query answered
        assert last["metrics"]["toy_plan_evals"]["value"] >= last["attempted"]
        assert {"busy_s", "window_s"} <= set(last["device"])
        for part in ("device_ops", "idle_gaps"):
            assert len(last["breakdown"][part]) <= 10


ALTER = """
import ballista_tpu_torch.client.context as C
_collect = C.SessionContext.collect
def collect(self, plan, *a, **k):
    out, schema = _collect(self, plan, *a, **k)
    cols = list(out.columns)
    c = cols[-1]
    d = c.data.clone()
    d[0] += 1
    cols[-1] = c._replace(data=d)
    return out._replace(columns=type(out.columns)(cols)), schema
C.SessionContext.collect = collect
"""

HALF = """
import ballista_tpu_torch.client.context as C
from ballista_tpu_torch.batch import HostColumn
def cut(h, n):
    return HostColumn(h.values[:n], h.validity[:n],
                      h.dictionary[:n] if h.raw else h.dictionary,
                      h.bounds, h.raw)
def halve(h):
    if isinstance(h, C.LazyColumn):
        n = h.n // 2 or h.n
        return C.LazyColumn(n, lambda: cut(h.make(), n))
    return cut(h, len(h.values) // 2 or len(h.values))
_register = C.SessionContext.register_host
def register_host(self, name, fields, columns, primary_key=None):
    return _register(self, name, fields,
                     {c: halve(h) for c, h in columns.items()}, primary_key)
C.SessionContext.register_host = register_host
"""


@pytest.mark.parametrize("fault", ["answer_altered", "half_left_out"])
@pytest.mark.parametrize("cell", ["toy.tpch", "toy.h2o"])
def test_a_broken_program_is_not_correct(base, cell, fault):
    prelude = ALTER if fault == "answer_altered" else HALF
    rc, last, err = toy.run(base, cell, prelude=prelude)
    assert rc == 0, err[-2000:]
    assert last["correct"] is False
    assert last["checks"]["wrong_cells"]["value"] > 0 or \
        last["checks"].get("float_err", {}).get("value", 0) > \
        last["checks"].get("float_err", {}).get("limit", 1)


# every query's answers of the window's passes 0 and 1 kept
PASS_1 = """
import gpubench.run as R
R.sample_passes = lambda seed, order, passes: {q: [0, 1] for q in order}
"""

# ... and the program's answer altered in pass 1 alone: each text runs
# twice in set-up, so its fourth answer is the window's pass 1
PASS_1_ALTERED = PASS_1 + """
import collections
import gpubench.port as P
_run_query, _calls = P.run_query, collections.Counter()
def run_query(ctx, text, clock, spans):
    out, schema, sql_s = _run_query(ctx, text, clock, spans)
    _calls[text] += 1
    if _calls[text] == 4:
        cols = list(out.columns)
        d = cols[-1].data.clone()
        d[0] += 1
        cols[-1] = cols[-1]._replace(data=d)
        out = out._replace(columns=type(out.columns)(cols))
    return out, schema, sql_s
P.run_query = run_query
"""


def test_a_sampled_pass_equal_to_pass_0_is_held_once(base):
    rc, last, err = toy.run(base, "toy.tpch", prelude=PASS_1)
    assert rc == 0, err[-2000:]
    assert last["correct"] is True
    notes = [line for line in err.splitlines() if line.startswith("# check:")]
    once = [n for n in notes if "pass 1 equal to pass 0, held once" in n]
    assert once and all("passes [0, 1] compared" in n for n in once), notes
    assert "# host: kept answers " in err


@pytest.mark.parametrize("cell", ["toy.tpch", "toy.h2o"])
def test_a_change_in_the_sampled_pass_alone_is_not_correct(base, cell):
    rc, last, err = toy.run(base, cell, prelude=PASS_1_ALTERED)
    assert rc == 0, err[-2000:]
    notes = [line.split(" ", 2)[2] for line in err.splitlines()
             if line.startswith("# check: ")]
    # an answer the change reached is judged as its own (an empty one is
    # the same either way)
    changed = {n.split()[0] for n in notes if " pass 1: " in n}
    assert changed, notes
    for n in notes:
        if n.split()[0].rstrip(":") in changed:
            assert "held once" not in n, notes
    assert last["correct"] is False
    assert last["checks"]["wrong_cells"]["value"] > 0 or \
        last["checks"].get("float_err", {}).get("value", 0) > \
        last["checks"].get("float_err", {}).get("limit", 1)


@pytest.mark.cuda
def test_toy_cell_on_the_card(base, card):
    rc, last, err = toy.run(base, "toy.tpch", trace=1, device="cuda")
    assert rc == 0, err[-2000:]
    assert last["correct"] is True
    assert last["device"]["busy_s"] > 0
    share = last["metrics"].get("masked_sums_roofline_pct")
    assert share is None or 0 < share["value"] <= 105
