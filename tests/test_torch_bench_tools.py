"""The port's scaling harness (`benchmarks/scaling.py`) and scheduler
event bench (`benchmarks/scheduler_events.py`) on the CPU: scaling at
P = 1 and 2 gives equal answers, each exact against the JAX package's
answer file, P = 2 on one device says so and makes no efficiency claim; the event bench completes every job in process and over
the HTTP wire (tests/test_scheduler.py TestSchedulerEventBench), with the
JAX package's output keys."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from ballista_tpu.benchmarks import scheduler_events as jax_events
from ballista_tpu_torch.benchmarks import TPCH_QUERIES, scaling, \
    scheduler_events
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import register_tpch
from ballista_tpu_torch.datagen.tbl import diff_expected

torch.set_num_threads(2)

SF = 0.01
SCALING_QUERIES = (1, 3)


@pytest.fixture(scope="module")
def answers_dir(tmp_path_factory):
    """The JAX package's answer files (its pandas oracle) at SF."""
    from ballista_tpu.benchmarks.oracle import to_pd
    from ballista_tpu.datagen import generate_tpch as jax_generate
    from ballista_tpu.datagen.tbl import write_answers
    out = str(tmp_path_factory.mktemp("answers"))
    write_answers(to_pd(jax_generate(SF)), out, SCALING_QUERIES)
    return out


@pytest.mark.parametrize("q", SCALING_QUERIES)
def test_scaling_points_and_equal_answers(q, answers_dir):
    ctx = SessionContext(device="cpu")
    register_tpch(ctx, SF)
    answers = {}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        points = scaling.run(SF, q, [1, 2], 1, ctx=ctx, answers=answers)
    assert json.loads(out.getvalue().splitlines()[-1])["points"] == points
    one, two = points
    assert (one["devices"], one["partitions"],
            one["efficiency_vs_linear"]) == (1, 1, 1.0)
    assert (two["devices"], two["partitions"],
            two["efficiency_vs_linear"]) == (1, 2, None)
    assert one["out_rows"] == two["out_rows"] > 0
    schema = ctx.sql(TPCH_QUERIES[q]).schema()
    for p in (1, 2):
        assert diff_expected((answers[p], schema), answers_dir, q) is None, p
    for name, (values, valid) in answers[1].items():
        np.testing.assert_array_equal(answers[2][name][1], valid)
        np.testing.assert_array_equal(answers[2][name][0][valid],
                                      values[valid])


def test_scaling_main_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        scaling.main(["--sf", "0.001", "--devices", "1"])


def test_event_bench_completes_all_jobs():
    out = scheduler_events.bench_inproc(20, 4, 8, 2)
    assert out["jobs_per_s"] > 0 and out["events_per_s"] > 0
    assert set(out) == set(jax_events.bench_inproc(20, 4, 8, 2))


def test_event_bench_over_the_wire():
    out = scheduler_events.bench_wire(20, 4, 8, device="cpu")
    assert out["jobs"] == 20 and out["jobs_per_s"] > 0 and out["polls"] > 0
    assert set(out) == {"mode", "jobs", "stages", "polls", "wall_s",
                        "jobs_per_s", "tasks_per_s"}


def test_event_bench_main():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        scheduler_events.main(["--jobs", "10", "--stages", "3", "--wire",
                               "--device", "cpu"])
    modes = [r["mode"] for r in json.loads(out.getvalue().splitlines()[-1])]
    assert modes == ["inproc", "wire"]
