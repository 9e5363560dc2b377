"""`benchmarks/hbm_estimate.py` at SF 0.01 on the CPU with BALLISTA_HBM_BYTES
set so that some queries route serial: the route it prints for each query
is `exec.memory.route_serial`'s verdict and the serial partition count that
`collect()` takes on the same tables (both seen through spies)."""

import re

import pytest
import torch

from ballista_tpu_torch.benchmarks import TPCH_QUERIES, hbm_estimate
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.client.context import rebind_scans
from ballista_tpu_torch.datagen import register_tpch
from ballista_tpu_torch.exec import memory
from ballista_tpu_torch.scheduler import serial as serial_mod

torch.set_num_threads(2)

SF = 0.01
BUDGET = "2e6"
LINE = re.compile(r"^q\s*(\d+)\s+(\S+) GB\s+(in-core|serial@(\d+))")


class _Taken(Exception):
    """Raised by the spies once collect() has chosen its route."""


@pytest.fixture
def routed_env(monkeypatch, tmp_path):
    monkeypatch.setenv("BALLISTA_HBM_BYTES", BUDGET)
    monkeypatch.delenv("BALLISTA_ROUTE_FACTOR", raising=False)
    monkeypatch.setattr(memory, "_oom_memo_path",
                        lambda: str(tmp_path / "oom_memo.json"))
    verdicts = {}
    route_serial = memory.route_serial

    def spy(exec_plan, budget):
        # by plan: a scalar subquery's collect() is routed too
        verdicts[exec_plan.display()] = route_serial(exec_plan, budget)
        return verdicts[exec_plan.display()]

    monkeypatch.setattr(memory, "route_serial", spy)
    return verdicts


def _collect_route(monkeypatch, ctx, q):
    """The serial partition count collect() takes for query q (0: in-core),
    stopped before anything runs."""
    taken = []

    def serial(ctx_, plan, n_parts, **kwargs):
        taken.append(n_parts)
        raise _Taken

    def in_core(plan, max_retries=5):
        taken.append(0)
        raise _Taken

    df = ctx.sql(TPCH_QUERIES[q])      # scalar subqueries run here
    with monkeypatch.context() as m:
        m.setattr(serial_mod, "execute_serial", serial)
        m.setattr(ctx, "converge", in_core)
        with pytest.raises(_Taken):
            df.collect()
    return taken[0]


def test_printed_route_is_route_serial_and_collects(routed_env, monkeypatch,
                                                    capsys):
    out = hbm_estimate.main(["--device", "cpu", "--sf", str(SF)])
    printed = {int(m.group(1)): (float(m.group(2)), int(m.group(4) or 0))
               for m in map(LINE.match, capsys.readouterr().out.splitlines())
               if m}
    assert sorted(printed) == sorted(out) == list(range(1, 23))
    routes = {q: r["route"] for q, r in out.items()}
    assert {q: p[1] for q, p in printed.items()} == routes
    assert 0 < sum(1 for n in routes.values() if n) < 22
    for q, (gb, _) in printed.items():
        assert gb == pytest.approx(out[q]["bytes"] / 1e9, abs=6e-4)

    ctx = SessionContext(device="cpu")
    register_tpch(ctx, SF)
    for q in sorted(routes):
        exec_plan = ctx.physical_plan(rebind_scans(
            ctx.sql(TPCH_QUERIES[q]).plan, ctx))
        assert memory.estimate_plan_hbm(exec_plan) == out[q]["bytes"], q
        # route_serial's own count, or the one fit_partitions raised it to
        verdict = routed_env[exec_plan.display()]
        assert bool(verdict) == bool(routes[q]) and verdict <= routes[q], q
        assert _collect_route(monkeypatch, ctx, q) == routes[q], q


def test_no_budget_on_the_cpu_routes_nothing(monkeypatch, tmp_path, capsys):
    monkeypatch.delenv("BALLISTA_HBM_BYTES", raising=False)
    monkeypatch.setattr(memory, "_oom_memo_path",
                        lambda: str(tmp_path / "oom_memo.json"))
    out = hbm_estimate.main(["--device", "cpu", "--sf", str(SF),
                             "--queries", "1,6"])
    assert {q: r["route"] for q, r in out.items()} == {1: 0, 6: 0}
    assert all(r["bytes"] > 0 for r in out.values())
    assert "nothing is routed" in capsys.readouterr().out
