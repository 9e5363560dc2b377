"""The reduction of the program's spans (`spans.py`): self time, device
work by the span that launched it and by attempt, the window's idle time
by innermost span and query, sync calls inside collect; `trace.summarize`
unchanged by the program's ranges; a traced toy cell on the CPU."""

import json

import pytest

from gpubench import spans, trace
from gpubench.tests import toy


class Ev:
    def __init__(self, name, start, end, device=False, corr=0, thread=1):
        self._n, self._s, self._d = name, start, end - start
        self._dev, self._c, self._t = device, corr, thread

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t


def P(name, start, end, thread=1):
    return Ev("ballista." + name, start, end, thread=thread)


BENCH = [
    Ev(trace.WINDOW, 0, 10000), Ev(trace.PAUSE, 9000, 9500),
    Ev(trace.SPAN + "sql q1", 0, 500),
    Ev(trace.SPAN + "collect q1", 500, 5000),
    Ev(trace.SPAN + "sql q2", 5000, 5400),
    Ev(trace.SPAN + "collect q2", 5400, 8800),
    # launches and the device work they queue; a sync outside collect (the
    # benchmark's), and a copy inside the pause
    Ev("cudaLaunchKernel", 1010, 1015, corr=1), Ev("k1", 1100, 2000, True, 1),
    Ev("cudaStreamSynchronize", 2310, 2490, corr=2),
    Ev("cudaLaunchKernel", 3100, 3105, corr=3), Ev("k2", 3200, 4600, True, 3),
    Ev("cudaStreamSynchronize", 4710, 4890, corr=4),
    Ev("cudaLaunchKernel", 5800, 5805, corr=5), Ev("k3", 5900, 6000, True, 5),
    Ev("cudaMemcpy", 6100, 6210, corr=6),
    Ev("Memcpy DtoH", 6100, 6200, True, 6),
    Ev("cudaStreamSynchronize", 8510, 8690, corr=7),
    Ev("cudaDeviceSynchronize", 8850, 8860, corr=8),
    Ev("cudaMemcpyAsync", 9050, 9055, corr=9),
    Ev("Memcpy DtoH", 9100, 9200, True, 9),
]

PROGRAM = [
    P("sql", 0, 500), P("sql.parse", 50, 150), P("sql.plan", 150, 450),
    P("collect", 500, 5000), P("route", 510, 550),
    P("attempt", 600, 2500), P("plan.physical", 600, 800),
    P("plan.bind", 800, 900), P("exec.HashAggregateExec", 900, 2300),
    P("exec.InputLeaf", 950, 1000), P("verdict", 2300, 2500),
    P("attempt", 2600, 4900), P("plan.physical", 2600, 2900),
    P("plan.bind", 2900, 3000), P("exec.HashAggregateExec", 3000, 4700),
    P("verdict", 4700, 4900),
    P("sql", 5000, 5400), P("sql.parse", 5000, 5100),
    P("sql.plan", 5100, 5400),
    P("collect", 5400, 8800), P("route", 5400, 5500),
    P("attempt", 5500, 8700), P("plan.physical", 5500, 5600),
    P("plan.bind", 5600, 5700), P("exec.SortExec", 5700, 8500),
    P("verdict", 8500, 8700),
    # another thread's range is not the window's
    P("exec.SortExec", 100, 9000, thread=2),
]


@pytest.fixture(scope="module")
def program():
    return spans.reduce(BENCH + PROGRAM)


def test_readings(program):
    r = program.readings()
    assert program.queries == 2
    # plan: 200 + 100, 300 + 100, 100 + 100 ns over two queries
    assert r["plan_ms_per_query"] == pytest.approx(900e-9 / 2 * 1e3)
    # q1's first attempt overflowed: k1 of k1 + k2 + k3 + the copy
    assert (program.attempts, program.overflowed) == (3, 1)
    assert r["rerun_device_pct"] == pytest.approx(100 * 900 / 2500)
    assert program.reruns_by_query == {"q1": (1, pytest.approx(900e-9))}
    # idle inside the operators: 200 + 300, 200 + 100, 200 + 100 + 2300
    assert r["exec_idle_pct"] == pytest.approx(100 * 3400 / 9500)
    # three verdict reads and a hidden copy in the sort over two queries;
    # the benchmark's own sync lies outside collect
    assert r["host_syncs_per_query"] == 2.0
    assert program.syncs_by_span == {"ballista.verdict": 3,
                                     "ballista.exec.SortExec": 1}
    assert program.runtime_calls["cudaLaunchKernel"] == 3


def test_span_stats(program):
    agg = program.spans["ballista.exec.HashAggregateExec"]
    assert agg.calls == 2
    assert agg.host_s == pytest.approx((1400 - 50 + 1700) * 1e-9)
    assert agg.device_s == pytest.approx(2300e-9)
    assert agg.idle_s == pytest.approx((50 + 100 + 300 + 200 + 100) * 1e-9)
    sort = program.spans["ballista.exec.SortExec"]
    assert (sort.calls, sort.device_s) == (1, pytest.approx(200e-9))
    assert program.spans["ballista.collect"].calls == 2
    # the other thread's range adds nothing
    assert sort.host_s == pytest.approx(2800e-9)
    assert program.device_by_span_op[0] == (
        "ballista.exec.HashAggregateExec", "k2", pytest.approx(1400e-9))


def test_idle_is_attributed_once(program):
    s = trace.summarize(BENCH + PROGRAM)
    assert program.window_s == pytest.approx(s.window_s)
    assert program.idle_s == pytest.approx(s.window_s - s.busy_s)
    assert sum(program.idle_by_label.values()) == pytest.approx(
        program.idle_s)
    labels = program.idle_by_label
    assert labels["ballista.exec.SortExec q2"] == pytest.approx(2600e-9)
    assert labels["ballista.collect q2"] == pytest.approx(100e-9)
    assert labels["ballista.route q2"] == pytest.approx(100e-9)
    assert labels["harness"] == pytest.approx(700e-9)
    assert program.idle_gaps(1) == [("ballista.exec.SortExec q2",
                                     pytest.approx(2600e-9))]


def test_summarize_passes_over_the_program_ranges():
    """The program's spans are CPU ranges: every field of trace.summarize
    is what it is without them. Their device-side copies, had the
    program made any, would not count as device work in spans.reduce."""
    entry = "gpubench.entry.f"
    without = trace.summarize(BENCH, [entry])
    assert trace.summarize(BENCH + PROGRAM, [entry]) == without
    copies = [Ev(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                 True) for e in PROGRAM]
    plain = spans.reduce(BENCH + PROGRAM)
    assert spans.reduce(BENCH + PROGRAM + copies) == plain


def test_innermost_pieces():
    spans_ = [(0, 100, "a"), (10, 20, "b"), (20, 50, "c"), (30, 40, "d"),
              (60, 100, "e")]
    assert spans._innermost(spans_) == [
        (0, 10, 0), (10, 20, 1), (20, 30, 2), (30, 40, 3), (40, 50, 2),
        (50, 60, 0), (60, 100, 4)]


def test_no_program_spans_read_nothing():
    """A program without the spans (the parent) reads nothing and does not
    raise."""
    p = spans.reduce(BENCH)
    assert p.spans == {} and p.queries == 2
    assert p.readings() == dict.fromkeys(spans.READINGS)


def test_no_window_is_an_error():
    with pytest.raises(RuntimeError):
        spans.reduce(PROGRAM)


def test_traced_toy_cell_reads_the_spans(tmp_path_factory):
    base = toy.make(tmp_path_factory.mktemp("gpubench"))
    out = tmp_path_factory.mktemp("spans") / "spans.json"
    rc, last, err = toy.run(
        base, "toy.tpch", trace=1,
        prelude=f"from gpubench import spans; spans.capture({str(out)!r})")
    assert rc == 0, err[-2000:]
    assert last["correct"] is True
    got = json.loads(out.read_text())
    assert got["queries"] == last["attempted"] - last["failed"]
    assert got["attempts"] >= got["queries"]
    r = got["readings"]
    assert r["plan_ms_per_query"] > 0
    assert 0 < r["exec_idle_pct"] <= 100
    assert {"ballista.sql", "ballista.collect", "ballista.attempt",
            "ballista.plan.physical"} <= set(got["spans"])
    assert "# spans: " in err


@pytest.mark.cuda
def test_spans_on_the_card(tmp_path_factory, card):
    """On the card the program's spans put nothing on the device's
    timeline, and every collect reads its verdict through a sync."""
    base = toy.make(tmp_path_factory.mktemp("gpubench"))
    out = tmp_path_factory.mktemp("spans") / "spans.json"
    rc, last, err = toy.run(
        base, "toy.tpch", trace=1, device="cuda",
        prelude=f"from gpubench import spans; spans.capture({str(out)!r})")
    assert rc == 0, err[-2000:]
    assert last["correct"] is True
    assert not any(n.startswith("ballista.")
                   for n, _ in last["breakdown"]["device_ops"])
    got = json.loads(out.read_text())
    assert got["readings"]["host_syncs_per_query"] >= 1
    assert 0 <= got["readings"]["exec_idle_pct"] <= (
        last["metrics"]["device_idle_pct"]["value"] + 1e-9)
    assert got["attempt_device_s"] > 0
