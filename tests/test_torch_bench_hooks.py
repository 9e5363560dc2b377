"""The environment hooks of the port's benchmark tools, on the CPU:
BALLISTA_SERIAL_PASSES (the serial run's first pass is the measurement),
BALLISTA_FAULTDUMP (periodic stack dumps while `runner.main` runs),
BALLISTA_ORACLE_CACHE (the oracle's frame and its first ms kept on disk),
BALLISTA_TPCH_CACHE (generated tables kept as .npz and read back equal),
and `benchmarks.op_profile`'s per-operator bytes, bound and share."""

import contextlib
import io
import time

import numpy as np
import pytest
import torch

from ballista_tpu_torch.batch import to_numpy
from ballista_tpu_torch.benchmarks import TPCH_QUERIES, op_profile, runner
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import generate_tpch, register_tpch
from ballista_tpu_torch.datagen import tpch as tpch_mod
from ballista_tpu_torch.exec import plan as TP
from ballista_tpu_torch.scheduler import serial

torch.set_num_threads(2)

SF = 0.01


@pytest.fixture(scope="module")
def ctx():
    c = SessionContext(device="cpu")
    register_tpch(c, SF)
    return c


@pytest.mark.parametrize("passes", [None, "1", "2"])
def test_serial_passes(ctx, passes, monkeypatch):
    calls = []
    real = serial.execute_serial

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(serial, "execute_serial", counted)
    if passes is None:
        monkeypatch.delenv("BALLISTA_SERIAL_PASSES", raising=False)
    else:
        monkeypatch.setenv("BALLISTA_SERIAL_PASSES", passes)
    plan = ctx.sql(TPCH_QUERIES[6]).plan
    first_s, run_s, out, schema = runner._run_serial(
        ctx, plan, 2, time.perf_counter())
    want, _ = ctx.sql(TPCH_QUERIES[6]).collect()
    _same_batches(out, want, schema)
    assert len(calls) == (1 if passes == "1" else 2)
    assert (first_s == run_s) == (passes == "1")


def test_faultdump_dumps_while_main_runs(monkeypatch, capfd):
    """Every second while `main` runs, every thread's stack goes to
    stderr; none after it returns."""
    monkeypatch.setenv("BALLISTA_FAULTDUMP", "1")
    monkeypatch.setattr(runner, "_main", lambda args, queries: time.sleep(2.6)
                        or {"ran": queries})
    assert runner.main(["--queries", "6", "--device", "cpu"]) == \
        {"ran": [6]}
    during = capfd.readouterr().err
    assert during.count("Timeout (0:00:01)!") >= 1
    assert "test_faultdump_dumps_while_main_runs" in during
    time.sleep(1.5)
    assert "Timeout" not in capfd.readouterr().err
    monkeypatch.delenv("BALLISTA_FAULTDUMP")
    monkeypatch.setattr(runner, "_main", lambda args, queries: queries)
    assert runner.main(["--queries", "6"]) == [6]


def test_oracle_cache(monkeypatch, tmp_path):
    pd = pytest.importorskip("pandas")
    from ballista_tpu_torch.benchmarks.oracle import to_pd
    data = generate_tpch(SF)
    made = []

    def tables():
        made.append(1)
        return to_pd(data)

    monkeypatch.delenv("BALLISTA_ORACLE_CACHE", raising=False)
    plain, _ = runner._oracle(3, SF, tables)
    monkeypatch.setenv("BALLISTA_ORACLE_CACHE", str(tmp_path / "oracle"))
    first, ms = runner._oracle(3, SF, tables)
    assert len(made) == 2 and ms > 0
    assert sorted(p.name for p in (tmp_path / "oracle").iterdir()) == \
        ["oracle_sf0.01_q3.pkl", "oracle_sf0.01_q3.pkl.json"]

    def no_tables():
        raise AssertionError("a cached frame needs no tables")

    again, ms_again = runner._oracle(3, SF, no_tables)
    assert ms_again == ms
    pd.testing.assert_frame_equal(again, plain)
    pd.testing.assert_frame_equal(first, plain)
    # another scale is another entry
    other, _ = runner._oracle(3, 0.02, tables)
    assert len(made) == 3


def _same_batches(got, want, schema):
    g, w = to_numpy(got, schema), to_numpy(want, schema)
    assert list(g) == list(w)
    for name in w:
        for a, b in zip(g[name], w[name]):
            np.testing.assert_array_equal(a, b, err_msg=name)


def _same_tables(got, want):
    assert list(got) == list(want)
    for name, (fields, cols) in want.items():
        gfields, gcols = got[name]
        assert gfields == fields and list(gcols) == list(cols), name
        for c, h in cols.items():
            g = gcols[c]
            assert g.values.dtype == h.values.dtype, c
            np.testing.assert_array_equal(g.values, h.values, err_msg=c)
            np.testing.assert_array_equal(g.validity, h.validity, err_msg=c)
            assert g.bounds == h.bounds and g.raw == h.raw, c
            if h.dictionary is None:
                assert g.dictionary is None, c
            else:
                assert g.dictionary.dtype == h.dictionary.dtype, c
                assert list(g.dictionary) == list(h.dictionary), c


def test_tpch_cache(ctx, monkeypatch, tmp_path):
    monkeypatch.delenv("BALLISTA_TPCH_CACHE", raising=False)
    fresh = generate_tpch(SF)
    monkeypatch.setenv("BALLISTA_TPCH_CACHE", str(tmp_path))
    # a first call with some tables cached: lineitem from orders
    generate_tpch(SF, tables=["orders", "nation"])
    _same_tables(generate_tpch(SF), fresh)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{n}_sf0.01_s19940101.npz" for n in fresh)

    def no_generator(*args):
        raise AssertionError("cached tables are not generated")

    monkeypatch.setattr(tpch_mod, "_GENERATORS", {
        n: no_generator for n in tpch_mod._GENERATORS})
    monkeypatch.setattr(tpch_mod, "_orders", no_generator)
    monkeypatch.setattr(tpch_mod, "_lineitem", no_generator)
    _same_tables(generate_tpch(SF), fresh)
    _same_tables(generate_tpch(SF, tables=["lineitem", "part"]),
                 {n: fresh[n] for n in ("lineitem", "part")})
    # a context on the cached tables answers as one on generated tables
    c = SessionContext(device="cpu")
    register_tpch(c, SF)
    got, schema = c.sql(TPCH_QUERIES[3]).collect()
    want, _ = ctx.sql(TPCH_QUERIES[3]).collect()
    assert int(got.num_rows) > 0
    _same_batches(got, want, schema)


def test_op_profile_bytes_bound_share(ctx, monkeypatch):
    """Each operator's floor bytes are `piece_bytes` of its children's
    outputs and its own, its bound those bytes at the HBM rate, and its
    share the bound over its device ms (timing patched: no card here)."""
    monkeypatch.setattr(op_profile.torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(op_profile, "_device_ms",
                        lambda fn, reps, ops=None: (fn(), (2.0, {}))[1])
    with contextlib.redirect_stdout(io.StringIO()):
        r = op_profile.profile_query(ctx, TPCH_QUERIES[3], 1)
    plan = ctx.physical_plan(ctx.sql(TPCH_QUERIES[3]).plan)
    nodes, seen = [], set()
    for n in op_profile._post_order(plan):
        if id(n) not in seen:
            seen.add(id(n))
            nodes.append(n)
    assert [op["op"] for op in r["operators"]] == \
        [n._label()[:110] for n in nodes]
    inputs = ctx.bind_inputs([leaf.input_id for leaf in plan.leaves()])
    run = TP.Run(inputs)
    outs = run.kept
    for n, op in zip(nodes, r["operators"]):
        got = n.evaluate(run)
        if isinstance(n, TP.InputLeaf):
            assert op["bytes"] == op["cap_bytes"] == 0
        else:
            want = TP.piece_bytes([outs[id(c)] for c in n.children], got)
            assert (op["bytes"], op["cap_bytes"]) == want, op["op"]
            assert op["bound_ms"] == pytest.approx(want[0] / 3350e9 * 1e3)
            assert op["roofline_share"] == pytest.approx(
                op["bound_ms"] / 2.0)
        outs[id(n)] = got
    assert sum(op["bytes"] for op in r["operators"]) > 0
    # no node was left with stand-in children
    assert all(type(c).__name__ != "_Cached"
               for n in nodes for c in n.children)
