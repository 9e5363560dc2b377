"""The join family (`configs/h2o_j1_1e8.json`, `data/h2o_join.py`,
`reference/h2o_join.py`, `queries/h2o_join.json`, `traffic/h2o_join.json`)
at a toy size through `run.main` on the CPU, in a copy of the benchmark
with a toy configuration added as a file (`toy.make`): the run is correct,
traced or not, and an answer altered underneath is not."""

import json
import os

import pytest

from gpubench import spec
from gpubench.tests import toy

CELL = "toy.j1"

ALTER = """
import ballista_tpu_torch.client.context as C
_collect = C.SessionContext.collect
def collect(self, plan, *a, **k):
    out, schema = _collect(self, plan, *a, **k)
    cols = list(out.columns)
    c = cols[{col}]
    d = c.data.clone()
    d[0] += 1
    cols[{col}] = c._replace(data=d)
    return out._replace(columns=type(out.columns)(cols)), schema
C.SessionContext.collect = collect
"""


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    base = toy.make(tmp_path_factory.mktemp("gpubench"))
    config = dict(spec.cell("h2o_j1_1e8.join").config, name="toy_j1",
                  rows=2e4, reduced=["rows"])
    with open(os.path.join(base, "gpubench", "configs", "toy_j1.json"),
              "w") as f:
        json.dump(config, f)
    path = os.path.join(base, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy_j1", "source": "toy",
                             "reduced": ["rows"],
                             "file": "gpubench/configs/toy_j1.json",
                             "why": "toy"})
    bench["workloads"].append({"name": CELL, "config": "toy_j1",
                               "traffic": "h2o_join", "chips": 1,
                               "why": "toy"})
    for m in bench["per_layer"]:
        if m["name"] == "join_probe_roofline_pct":
            m["workloads"].append(CELL)
    with open(path, "w") as f:
        json.dump(bench, f)
    return base


@pytest.mark.parametrize("trace", [0, 1])
def test_the_join_family_runs_correct(base, trace):
    rc, last, err = toy.run(base, CELL, seed=2**32 + 5, trace=trace)
    assert rc == 0, err[-2000:]
    assert last["correct"] is True, err[-2000:]
    assert last["failed"] == 0 and last["attempted"] >= 5
    assert last["checks"]["float_err"] == {"value": 0.0, "limit": 0}
    want = ({"sql_plan_ms", "overflow_reruns_per_query"} if trace else
            {"queries_per_s", "query_geomean_ms", "query_p95_ms",
             "setup_s"})
    assert want <= set(last["metrics"])
    notes = [line for line in err.splitlines() if line.startswith("# check:")]
    assert any(n.startswith("# check: q5: passes") for n in notes), notes


# the first column (an int id in every question) and the last (v2, a float)
@pytest.mark.parametrize("col", [0, -1])
def test_an_altered_answer_is_not_correct(base, col):
    rc, last, err = toy.run(base, CELL, prelude=ALTER.format(col=col))
    assert rc == 0, err[-2000:]
    assert last["correct"] is False
    checks = last["checks"]
    assert checks["wrong_cells"]["value"] > 0 or \
        checks["float_err"]["value"] > checks["float_err"]["limit"]
