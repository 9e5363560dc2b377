"""Multi-process execution on torch.distributed
(`ballista_tpu_torch/parallel/multihost.py`): two gloo processes of four
CPU partitions each, one global mesh of eight, the reference's three
scenarios (tests/test_multihost.py, tests/multihost_worker.py):

- basic: the reference's orders x customer query and five TPC-H queries at
  SF 0.01, every process's answer equal to the JAX package's;
- skew: a hot-key join under a tight quota overflows and escalates to a
  salted shuffle across the processes; both processes take the sequence
  of options one process takes, and the answer equals numpy's;
- crash: worker 1 exits hard after joining; worker 0 exits non-zero
  within its timeout instead of hanging, and a fresh pair answers.

The worker is this file, run as
`python tests/test_torch_multihost.py <pid> <nproc> <port> <scenario>`;
it imports no JAX. Every `communicate` has a timeout."""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np

SF = 0.01
BASIC_SQL = """
    select o_orderpriority, count(*) as n
    from orders join customer on o_custkey = c_custkey
    where o_totalprice > 1000
    group by o_orderpriority order by o_orderpriority
"""
QUERIES = (1, 3, 5, 13, 18)
SKEW_SQL = ("select k, sum(v + w) as s, count(*) c from fact join dim "
            "on k = dk group by k order by k")
SKEW_OPTS = dict(n_partitions=8, broadcast_threshold=0, min_quota=16,
                 quota_headroom=1.05)


def skew_tables():
    """The reference's skew tables, from its seed, as numpy columns."""
    rng = np.random.default_rng(0)
    n = 4000
    keys = np.where(rng.random(n) < 0.85, 7, rng.integers(0, 100, n))
    fact = {"k": keys.astype(np.int64),
            "v": rng.integers(0, 1000, n).astype(np.int64)}
    dim = {"dk": np.arange(100, dtype=np.int64),
           "w": np.arange(100, dtype=np.int64) * 10}
    return fact, dim


def skew_expected(fact, dim):
    """(k, s, c) of SKEW_SQL by numpy."""
    w = dim["w"][fact["k"]]
    ks = np.unique(fact["k"])
    return (ks, np.array([(fact["v"] + w)[fact["k"] == k].sum() for k in ks]),
            np.array([(fact["k"] == k).sum() for k in ks]))


def attempts_of(ctx):
    return [(o.quota_headroom, o.join_salt, o.max_group_table)
            for o in ctx.dist_attempts]


def _worker(pid: int, nproc: int, port: str, scenario: str) -> None:
    import torch

    from ballista_tpu_torch import batch as B
    from ballista_tpu_torch.client import SessionContext
    from ballista_tpu_torch.parallel.multihost import (init_multihost,
                                                       make_global_mesh)
    from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
    from ballista_tpu_torch.scheduler.runtime import execute_distributed

    torch.set_num_threads(2)
    init_multihost(f"127.0.0.1:{port}", nproc, pid)
    mesh = make_global_mesh(4, device="cpu")
    assert len(mesh) == 4 * nproc and mesh.local_partitions == \
        list(range(4 * pid, 4 * pid + 4))
    if os.environ.get("BALLISTA_CRASH_WORKER") == str(pid):
        os._exit(17)     # dies without a word: the peer must notice
    ctx = SessionContext(device="cpu")
    out = {}
    if scenario == "skew":
        fact, dim = skew_tables()
        ctx.register_numpy("fact", fact)
        ctx.register_numpy("dim", dim, primary_key=("dk",))
        batch, schema = execute_distributed(ctx, ctx.sql(SKEW_SQL).plan,
                                            mesh, DistOptions(**SKEW_OPTS))
        got = B.to_numpy(batch, schema)
        for name, want in zip(("k", "s", "c"), skew_expected(fact, dim)):
            np.testing.assert_array_equal(got[name][0], want)
        out = {"attempts": attempts_of(ctx)}
    else:
        from ballista_tpu_torch.benchmarks import TPCH_QUERIES
        from ballista_tpu_torch.datagen import register_tpch
        register_tpch(ctx, SF)
        for q, sql in [(0, BASIC_SQL)] + [(q, TPCH_QUERIES[q])
                                          for q in QUERIES]:
            batch, schema = execute_distributed(
                ctx, ctx.sql(sql).plan, mesh, DistOptions(n_partitions=8))
            out[q] = B.to_numpy(batch, schema)
    with open(os.path.join(os.environ["BALLISTA_RESULT_DIR"],
                           f"p{pid}.pkl"), "wb") as f:
        pickle.dump(out, f)
    print(f"RESULT_OK p{pid}", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
            sys.argv[4] if len(sys.argv) > 4 else "basic")
    sys.exit(0)


import pytest  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_pair(scenario, result_dir, extra_env=None, timeout=240):
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]), OMP_NUM_THREADS="2",
        BALLISTA_RESULT_DIR=str(result_dir))
    env.update(extra_env or {})
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), "2", str(port),
         scenario], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return procs, outs


def _results(result_dir):
    out = []
    for pid in range(2):
        with open(os.path.join(result_dir, f"p{pid}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _assert_ok(procs, outs):
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"RESULT_OK p{pid}" in out, out[-3000:]


def _assert_same(got, want):
    assert list(got) == list(want)
    for name, (wv, wvalid) in want.items():
        gv, gvalid = got[name]
        np.testing.assert_array_equal(gvalid, wvalid, err_msg=name)
        np.testing.assert_array_equal(gv[gvalid], wv[wvalid], err_msg=name)


@pytest.fixture(scope="module")
def jax_answers():
    from ballista_tpu.batch import to_numpy
    from ballista_tpu.client import SessionContext as JaxContext
    from ballista_tpu.datagen.tpch import TPCH_TABLES, generate_table
    from ballista_tpu_torch.benchmarks import TPCH_QUERIES
    jctx = JaxContext(capacity_mode="exact")
    for name in TPCH_TABLES:
        jctx.register_arrow(name, generate_table(name, SF),
                            primary_key=TPCH_TABLES[name][1])
    return {q: to_numpy(*jctx.sql(sql).collect())
            for q, sql in [(0, BASIC_SQL)] + [(q, TPCH_QUERIES[q])
                                              for q in QUERIES]}


def test_two_process_global_mesh(tmp_path, jax_answers):
    procs, outs = _spawn_pair("basic", tmp_path)
    _assert_ok(procs, outs)
    for res in _results(tmp_path):
        assert list(res) == list(jax_answers)
        for q, want in jax_answers.items():
            _assert_same(res[q], want)


def test_salted_shuffle_across_processes(tmp_path):
    """Both processes overflow alike and take the one-process sequence of
    options (a salted retry): their counts are summed before any
    decision."""
    from ballista_tpu_torch.client import SessionContext
    from ballista_tpu_torch.parallel.mesh import make_mesh
    from ballista_tpu_torch.scheduler.distributed_planner import DistOptions
    from ballista_tpu_torch.scheduler.runtime import execute_distributed
    fact, dim = skew_tables()
    ctx = SessionContext(device="cpu")
    ctx.register_numpy("fact", fact)
    ctx.register_numpy("dim", dim, primary_key=("dk",))
    execute_distributed(ctx, ctx.sql(SKEW_SQL).plan,
                        make_mesh(8, devices=[torch.device("cpu")] * 8),
                        DistOptions(**SKEW_OPTS))
    one = attempts_of(ctx)
    assert len(one) > 1 and one[-1][1] > 1      # escalated to a salt
    procs, outs = _spawn_pair("skew", tmp_path)
    _assert_ok(procs, outs)
    for res in _results(tmp_path):
        assert res["attempts"] == one


def test_killed_worker_detected_and_job_rerun_succeeds(tmp_path,
                                                       jax_answers):
    """Worker 1 dies after joining; worker 0's next collective fails (the
    connection closes) or times out (BALLISTA_PEER_TIMEOUT): it exits
    non-zero without an answer, within the test's timeout. A fresh pair
    then answers."""
    procs, outs = _spawn_pair("basic", tmp_path, {
        "BALLISTA_CRASH_WORKER": "1", "BALLISTA_PEER_TIMEOUT": "30"},
        timeout=120)
    assert procs[1].returncode == 17, outs[1][-2000:]
    assert procs[0].returncode != 0, outs[0][-2000:]
    assert "RESULT_OK p0" not in outs[0]
    procs, outs = _spawn_pair("basic", tmp_path)
    _assert_ok(procs, outs)
    _assert_same(_results(tmp_path)[0][1], jax_answers[1])
