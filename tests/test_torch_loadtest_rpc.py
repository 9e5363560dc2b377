"""The port's multi-executor load test (`benchmarks/loadtest_rpc.py`) on the
CPU: a scheduler and three executor processes at SF 0.005, two clients of
three requests, one executor SIGKILLed once it has finished a task under
load and holds a task of a job in flight beside another. Every answer
equals the numpy answers the run reports, and those equal the JAX
package's answers to the same SQL texts (counts exact, decimals as scaled
integers). A run held to a wrong answer exits 1."""

import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from ballista_tpu.batch import to_numpy as jax_to_numpy
from ballista_tpu.client import SessionContext as JaxContext
from ballista_tpu.datagen import register_tpch as jax_register_tpch
from ballista_tpu_torch.benchmarks import loadtest_rpc

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SF = 0.005
ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
ENV.pop("BALLISTA_TPCH_CACHE", None)


def _run(args, code=None, timeout=240):
    cmd = [sys.executable] + (
        ["-c", code] if code else
        ["-m", "ballista_tpu_torch.benchmarks.loadtest_rpc"])
    res = subprocess.run(cmd + args, cwd=REPO, env=ENV, capture_output=True,
                         text=True, timeout=timeout)
    return res, json.loads(res.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def killed_run():
    return _run(["--device", "cpu", "--sf", str(SF), "--workers", "3",
                 "--clients", "2", "--requests", "3"])


def test_victim_killed_after_a_task_and_every_answer_exact(killed_run):
    res, report = killed_run
    assert res.returncode == 0, (report, res.stderr[-3000:])
    assert report["ok"] and not report["failures"]
    assert report["killed_one"]
    assert report["victim"] in ("lt-0", "lt-1", "lt-2")
    assert report["killed_at_s"] is not None and report["killed_at_s"] >= 0
    assert report["total_queries"] == report["correct"] == 6
    assert report["victim_jobs"]
    assert any(v["state"] == "successful" and v["final_executors"]
               and report["victim"] not in v["final_executors"]
               for v in report["victim_jobs"])
    # the scheduler drops the victim 5 s after its last heartbeat, which
    # came at most a heartbeat (1 s) before the kill
    assert loadtest_rpc.EXPIRY_S - 2 < report["expiry_s"] < 30
    for key in ("clients", "requests_per_client", "workers", "wall_s",
                "jobs_per_s", "p50_s", "p95_s", "max_s"):
        assert key in report


def test_executors_read_the_npz_cache(killed_run):
    _, report = killed_run
    tables = report["executor_tables"]
    assert sorted(tables) == ["lt-0", "lt-1", "lt-2"]
    assert sum(t["generated"] for t in tables.values()) == 0
    # every executor that ran a task read the eight tables from the cache
    assert any(t["read"] == 8 for t in tables.values())
    assert all(t["read"] in (0, 8) for t in tables.values())


@pytest.mark.parametrize("name", sorted(loadtest_rpc.QUERIES))
def test_answers_equal_the_jax_package(killed_run, name):
    _, report = killed_run
    ctx = JaxContext()
    jax_register_tpch(ctx, SF)
    batch, schema = ctx.sql(loadtest_rpc.QUERIES[name]).collect()
    rows = loadtest_rpc.answer_rows(jax_to_numpy(batch, schema),
                                    schema.fields)
    assert loadtest_rpc.report_rows(rows) == report["expected"][name]


def test_a_wrong_expected_answer_exits_nonzero():
    code = textwrap.dedent("""
        import sys
        from ballista_tpu_torch.benchmarks import loadtest_rpc as lt
        right = lt.expected_answers

        def wrong(data):
            out = right(data)
            name, n = out["join_agg"][0]
            out["join_agg"][0] = (name, n + 1)
            return out

        lt.expected_answers = wrong
        sys.exit(0 if lt.main(sys.argv[1:])["ok"] else 1)
    """)
    res, report = _run(["--device", "cpu", "--sf", "0.002", "--workers", "1",
                        "--clients", "1", "--requests", "1", "--no-kill"],
                       code)
    assert res.returncode == 1
    assert not report["ok"]
    assert any("join_agg" in f for f in report["failures"])


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        loadtest_rpc.main(["--device", "cuda"])


def test_load_test_and_example_twins_import_without_jax_pyarrow_pandas():
    code = textwrap.dedent("""
        import importlib.util, os, sys
        for m in ("jax", "jaxlib", "ballista_tpu", "pyarrow", "pandas"):
            sys.modules[m] = None
        import ballista_tpu_torch.benchmarks.loadtest_rpc
        for name in ("sql", "dataframe", "standalone_sql"):
            spec = importlib.util.spec_from_file_location(
                name, os.path.join("examples", "torch", name + ".py"))
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
