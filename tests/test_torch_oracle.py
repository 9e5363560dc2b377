"""The port's pandas oracle (`ballista_tpu_torch/benchmarks/oracle.py`)
against the JAX package's at SF 0.01: `to_pd` of the port's host tables
equals `to_pd` of the JAX package's arrow tables (values and dtypes), all
22 oracle frames are equal, and the `write_answers` files of both
packages are byte for byte the same."""

import os

import pandas as pd
import pytest
import torch

from ballista_tpu.benchmarks import oracle as JO
from ballista_tpu.datagen import generate_tpch as jax_generate
from ballista_tpu.datagen.tbl import write_answers as jax_write_answers
from ballista_tpu_torch.benchmarks import oracle as O
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES, generate_tpch, register_tpch
from ballista_tpu_torch.datagen.tbl import write_answers

torch.set_num_threads(2)

SF = 0.01


@pytest.fixture(scope="module")
def frames():
    return JO.to_pd(jax_generate(SF)), O.to_pd(generate_tpch(SF))


@pytest.mark.parametrize("name", list(TPCH_TABLES))
def test_to_pd_equals_reference(frames, name):
    want, got = frames
    pd.testing.assert_frame_equal(got[name], want[name], check_exact=True)


def test_to_pd_of_context_tables(frames):
    """A context's providers convert as the generated tables do."""
    ctx = SessionContext(device="cpu")
    register_tpch(ctx, SF, tables=["nation", "orders"])
    got = O.to_pd(ctx.tables)
    for name in ("nation", "orders"):
        pd.testing.assert_frame_equal(got[name], frames[0][name],
                                      check_exact=True)


@pytest.mark.parametrize("q", range(1, 23))
def test_oracle_frames_equal(frames, q):
    want, got = frames
    pd.testing.assert_frame_equal(O.ORACLES[q](got), JO.ORACLES[q](want),
                                  check_exact=True)


def test_write_answers_byte_identical(frames, tmp_path):
    mine = write_answers(frames[1], str(tmp_path / "port"))
    theirs = jax_write_answers(frames[0], str(tmp_path / "jax"))
    names = sorted(os.listdir(theirs))
    assert sorted(os.listdir(mine)) == names and len(names) == 22
    for name in names:
        with open(os.path.join(mine, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name


def test_diff_frames_equals_reference(frames):
    want, got = frames
    exp = JO.ORACLES[1](want)
    bad = exp.copy()
    bad.loc[0, "sum_qty"] += 1.0
    for g in (exp, bad, exp.iloc[:-1], exp[exp.columns[:-1]]):
        assert O.diff_frames(g, exp) == JO.diff_frames(g, exp)
    assert O.diff_frames(bad, exp) is not None
