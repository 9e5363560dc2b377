"""`benchmarks/oracle_pregen.py` over a chunked parquet dataset the port's
`datagen --chunks` writes at SF 0.01: it fills BALLISTA_ORACLE_CACHE with
the names the runner reads, a second run finds them all, `runner --verify`
over the dataset then computes no oracle frame and matches, and `runner
--isolate --oracle-cache DIR` hands DIR (and the dataset) to every
process it starts."""

import json
import os
import subprocess

import pytest
import torch

from ballista_tpu_torch.benchmarks import oracle, oracle_pregen
from ballista_tpu_torch.benchmarks import runner as runner_mod
from ballista_tpu_torch.datagen import __main__ as datagen_cli

torch.set_num_threads(2)

SF = 0.01


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("tpch_chunks"))
    datagen_cli.main(["--sf", str(SF), "--chunks", "2", "--out", out])
    return out


@pytest.fixture
def cache(tmp_path, monkeypatch):
    path = str(tmp_path / "oracle")
    monkeypatch.setenv("BALLISTA_ORACLE_CACHE", path)
    return path


def test_fills_the_cache_then_finds_it_whole(dataset, cache, capsys):
    assert oracle_pregen.main(["--dataset-dir", dataset, "--sf", str(SF),
                               "--queries", "1,6"]) == [1, 6]
    assert sorted(os.listdir(cache)) == [
        "oracle_sf0.01_q1.pkl", "oracle_sf0.01_q1.pkl.json",
        "oracle_sf0.01_q6.pkl", "oracle_sf0.01_q6.pkl.json"]
    for q in (1, 6):
        path, meta = runner_mod.oracle_paths(cache, SF, q)
        with open(meta) as f:
            assert json.load(f)["oracle_ms"] >= 0
    capsys.readouterr()
    assert oracle_pregen.main(["--dataset-dir", dataset, "--sf", str(SF),
                               "--queries", "1,6"]) == []
    assert capsys.readouterr().out.strip() == "all cached"
    # a query not cached yet is computed alone
    assert oracle_pregen.main(["--dataset-dir", dataset, "--sf", str(SF),
                               "--queries", "1,3,6"]) == [3]


def test_runner_verify_reads_the_cache(dataset, cache, monkeypatch):
    oracle_pregen.main(["--dataset-dir", dataset, "--sf", str(SF),
                        "--queries", "1,6"])

    def computed(tables):
        raise AssertionError("an oracle frame was computed")

    for q in (1, 6):
        monkeypatch.setitem(oracle.ORACLES, q, computed)
    res = runner_mod.run(SF, [1, 6], iterations=1, verify=True,
                         dataset_dir=dataset, device="cpu")
    assert all(res[q]["match"] for q in (1, 6)), res


def test_runner_verify_over_a_dataset_fills_an_empty_cache(dataset, tmp_path):
    path = str(tmp_path / "fresh")
    res = runner_mod.run(SF, [6], iterations=1, verify=True,
                         dataset_dir=dataset, device="cpu",
                         oracle_cache=path)
    assert res[6]["match"], res
    assert all(os.path.exists(p) for p in runner_mod.oracle_paths(
        path, SF, 6))


def test_isolate_passes_the_oracle_cache_on(dataset, tmp_path, monkeypatch):
    monkeypatch.delenv("BALLISTA_ORACLE_CACHE", raising=False)
    calls = []

    def fake_run(cmd, **kwargs):
        calls.append((cmd, kwargs["env"]))
        q = cmd[cmd.index("--queries") + 1]
        line = json.dumps({"queries": {q: {"ms": 1.0, "match": True}}})
        return subprocess.CompletedProcess(cmd, 0, f"q{q} ok\n{line}\n", "")

    monkeypatch.setattr(runner_mod.subprocess, "run", fake_run)
    path = str(tmp_path / "oracle")
    runner_mod.main(["--isolate", "60", "--sf", str(SF), "--queries", "1,6",
                     "--verify", "--dataset-dir", dataset, "--oracle-cache",
                     path, "--device", "cpu"])
    assert len(calls) == 2
    for cmd, env in calls:
        assert env["BALLISTA_ORACLE_CACHE"] == path
        assert cmd[cmd.index("--dataset-dir") + 1] == dataset
        assert "--verify" in cmd
    assert "BALLISTA_ORACLE_CACHE" not in os.environ


def test_without_the_cache_variable_it_refuses(dataset, monkeypatch):
    monkeypatch.delenv("BALLISTA_ORACLE_CACHE", raising=False)
    with pytest.raises(AssertionError, match="BALLISTA_ORACLE_CACHE"):
        oracle_pregen.main(["--dataset-dir", dataset, "--sf", str(SF)])
