"""The port's TPC-H runner (`ballista_tpu_torch/benchmarks/runner.py`) on
the CPU at SF 0.01 against the JAX package's runner: every path (generated
tables, `--tbl-dir`, `--serial 2`, `--distributed` on a CPU mesh of 2,
routed by the memory model, the out-of-memory fallback, `--verify`,
`--isolate`, `--query-timeout`) matches the JAX package's answer files
exactly, and its `rows` equal the JAX runner's on the same queries;
`loadtest` returns the reference's keys; `main` prints the table and the
JSON line; `device="cuda"` without a card raises."""

import contextlib
import io
import json
import os
import time

import pytest
import torch

from ballista_tpu_torch.benchmarks import runner
from ballista_tpu_torch.exec import memory
from ballista_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(2)

SF = 0.01
QUERIES = (1, 3, 6, 12, 14, 19)
LOAD_KEYS = {"clients", "requests_per_client", "total_queries", "wall_s",
             "qps", "p50_ms", "p95_ms", "max_ms"}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """(port `.tbl` dir, JAX answer files, the JAX runner's results over
    QUERIES on those answers)."""
    from ballista_tpu.benchmarks import runner as jax_runner
    from ballista_tpu.benchmarks.oracle import to_pd
    from ballista_tpu.datagen import generate_tpch as jax_generate
    from ballista_tpu.datagen.tbl import write_answers
    from ballista_tpu_torch.datagen.__main__ import main as datagen

    tbl = str(tmp_path_factory.mktemp("tbl"))
    with contextlib.redirect_stdout(io.StringIO()):
        datagen(["--sf", str(SF), "--format", "tbl", "--out", tbl])
    answers = str(tmp_path_factory.mktemp("answers"))
    write_answers(to_pd(jax_generate(SF)), answers, QUERIES)
    # the JAX runner points the compile cache where the conftest does
    os.environ.setdefault("JAX_COMPILATION_CACHE_DIR", "/tmp/jax_cache_cpu")
    with contextlib.redirect_stdout(io.StringIO()):
        jax = jax_runner.run(SF, QUERIES, 1, False, expected=answers)
    assert all(r["match"] for r in jax.values())
    return tbl, answers, jax


def _check(results, jax, queries=QUERIES):
    assert list(results) == list(queries)
    for q, r in results.items():
        assert "error" not in r, (q, r)
        assert r["match"] is True, (q, r)
        assert r["rows"] == jax[q]["rows"], q
        assert r["ms"] > 0 and r["compile_s"] > 0


@pytest.mark.parametrize("path", ["generated", "tbl", "serial",
                                  "distributed", "timeout"])
def test_run_paths_match(data, path):
    tbl, answers, jax = data
    kw = {"generated": {}, "tbl": {"tbl_dir": tbl},
          "serial": {"tbl_dir": tbl, "serial": 2},
          "distributed": {"distributed": True,
                          "mesh": make_mesh(2, devices=[torch.device("cpu")]
                                            * 2)},
          "timeout": {"tbl_dir": tbl, "query_timeout": 120}}[path]
    with contextlib.redirect_stdout(io.StringIO()):
        results = runner.run(SF, QUERIES, 2, expected=answers, device="cpu",
                             **kw)
    _check(results, jax)


def test_verify_against_the_oracle(data):
    _, _, jax = data
    with contextlib.redirect_stdout(io.StringIO()):
        results = runner.run(SF, (1, 6), 1, verify=True, device="cpu")
    for q, r in results.items():
        assert r["match"] is True and r["oracle_ms"] > 0, r
        assert r["rows"] == jax[q]["rows"]


def test_routed_and_oom_fallback(data, monkeypatch, tmp_path):
    """Under a tiny budget the router sends every query to the serial
    runtime; an in-core run that raises OutOfMemoryError falls back to it
    and leaves the plan in the memo. Both still match."""
    tbl, answers, jax = data
    monkeypatch.setattr(memory, "_oom_memo_path",
                        lambda: str(tmp_path / "memo.json"))
    monkeypatch.setenv("BALLISTA_HBM_BYTES", str(64 << 10))
    ctx, _ = runner._context(SF, "cpu", tbl)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = runner.run(SF, (1, 3), 1, expected=answers, ctx=ctx)
    _check(results, jax, (1, 3))
    assert sum("routed out-of-core" in w for w in ctx.take_warnings()) == 2
    monkeypatch.delenv("BALLISTA_HBM_BYTES")

    def oom(*args, **kwargs):
        raise torch.cuda.OutOfMemoryError("planted")

    monkeypatch.setattr(ctx, "converge", oom)
    with contextlib.redirect_stdout(io.StringIO()):
        results = runner.run(SF, (6,), 1, expected=answers, ctx=ctx)
    _check(results, jax, (6,))
    assert any("exhausted device memory" in w for w in ctx.take_warnings())
    with open(tmp_path / "memo.json") as f:
        assert len(json.load(f)) == 1


def test_isolate(data):
    tbl, answers, jax = data
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        results = runner.run_isolated(SF, (1, 6), 1, False, 300,
                                      device="cpu", tbl_dir=tbl,
                                      expected=answers)
    _check(results, jax, (1, 6))
    assert json.loads(out.getvalue().splitlines()[-1])["queries"]["6"] == \
        json.loads(json.dumps(results[6]))


def test_query_timeout_records_the_error(data, monkeypatch):
    tbl, answers, _ = data
    real = runner._run_query

    def slow(ctx, q, *args):
        if q == 3:
            time.sleep(5)
        return real(ctx, q, *args)

    monkeypatch.setattr(runner, "_run_query", slow)
    with contextlib.redirect_stdout(io.StringIO()):
        results = runner.run(SF, (3, 6), 1, tbl_dir=tbl, expected=answers,
                             query_timeout=1, device="cpu")
    assert results[3] == {"error": "QueryTimeout: query exceeded 1s"}
    assert results[6]["match"] is True


def test_loadtest_keys(data):
    tbl, _, _ = data
    with contextlib.redirect_stdout(io.StringIO()):
        out = runner.loadtest(SF, 2, 2, [1, 6], device="cpu", tbl_dir=tbl)
    assert set(out) == LOAD_KEYS
    assert out["total_queries"] == 4 and out["qps"] > 0


def test_main_prints_table_and_json(data):
    tbl, answers, jax = data
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runner.main(["--device", "cpu", "--tbl-dir", tbl, "--expected",
                     answers, "--queries", "1,6", "--iterations", "1"])
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("q 1") and "[== expected]" in lines[0]
    assert lines[1].startswith("q 6")
    summary = json.loads(lines[-1])
    assert summary["queries"]["1"]["rows"] == jax[1]["rows"]
    assert summary["total_ms"] > 0


def test_unported_flags_and_cuda_raise():
    """--capacity-mode raises; --lazy-ingest is ported (it runs in
    tests/test_torch_lazy_ingest.py) and, like every run, raises on a
    device="cuda" without a card."""
    with pytest.raises(NotImplementedError, match="no effect"):
        runner.main(["--device", "cpu", "--capacity-mode", "exact"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.run(SF, (1,), 1)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            runner.run(SF, (1,), 1, lazy_ingest=True)
