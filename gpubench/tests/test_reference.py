"""The plain references: the TPC-H one reproduces the answer files of
`answers/sf1` from the tables they were made from (the program's
`generate_tpch(1, 19940101)`, fed to the reference by this test alone);
both equal the program's CPU answers on the benchmark's own generators."""

import json
import os

import pytest

from gpubench import port, spec
from gpubench.answer import compare
from gpubench.tests.tpch_answers import from_program, rows_match

ROOT = spec.ROOT
TPCH = json.load(open(os.path.join(ROOT, "gpubench", "queries", "tpch.json")))
H2O = json.load(open(os.path.join(ROOT, "gpubench", "queries", "h2o.json")))


@pytest.fixture(scope="module")
def sf1_reference():
    from ballista_tpu_torch.datagen.tpch import generate_tpch
    ref = spec.module("reference", "tpch")
    return ref.Reference(from_program(generate_tpch(1, 19940101)), "cpu")


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_reference_equals_the_sf1_answer_files(sf1_reference, q):
    with open(os.path.join(ROOT, "answers", "sf1", "answers", f"q{q}.out")) as f:
        lines = f.read().splitlines()
    assert rows_match(sf1_reference.answer(f"q{q}"), lines) == ""


def _program_and_reference(family, config, seed):
    data = spec.module("data", family)
    tables = data.generate(config, seed)
    ctx = port.make_context("cpu")
    data.register(ctx, tables, config)
    return ctx, spec.module("reference", family).Reference(tables, "cpu")


@pytest.fixture(scope="module")
def tpch_pair():
    return _program_and_reference("tpch", {"scale_factor": 0.01}, 2**31 + 5)


@pytest.fixture(scope="module")
def tpch_raw_pair():
    # the text columns of more than 1000 rows RAW, as o_comment, l_comment
    # and ps_comment are at SF10 (their distinct counts pass the
    # threshold there)
    old = os.environ.get("BALLISTA_RAW_DICT_MAX")
    os.environ["BALLISTA_RAW_DICT_MAX"] = "1000"
    try:
        ctx, ref = _program_and_reference("tpch", {"scale_factor": 0.01},
                                          2**31 + 8)
        for table, col in (("orders", "o_comment"), ("customer", "c_comment"),
                           ("customer", "c_address")):
            assert ctx.tables[table].host[col].raw, col
        yield ctx, ref
    finally:
        if old is None:
            del os.environ["BALLISTA_RAW_DICT_MAX"]
        else:
            os.environ["BALLISTA_RAW_DICT_MAX"] = old


@pytest.fixture(scope="module")
def h2o_pair():
    return _program_and_reference("h2o", {"rows": 1e5, "k": 100}, 2**31 + 6)


@pytest.mark.parametrize("q", range(1, 23))
def test_tpch_reference_equals_the_program(tpch_pair, q):
    ctx, ref = tpch_pair
    out, schema = ctx.sql(TPCH[f"q{q}"]).collect()
    v = compare(port.answer_to_host(out, schema), ref.answer(f"q{q}"))
    assert v.wrong_cells == 0, v.note
    assert v.float_err == 0.0


# the queries that read a comment or an address
@pytest.mark.parametrize("q", [2, 10, 13, 15, 16, 20])
def test_tpch_reference_equals_the_program_with_raw_text(tpch_raw_pair, q):
    ctx, ref = tpch_raw_pair
    out, schema = ctx.sql(TPCH[f"q{q}"]).collect()
    v = compare(port.answer_to_host(out, schema), ref.answer(f"q{q}"))
    assert v.wrong_cells == 0, v.note


@pytest.mark.parametrize("q", range(1, 11))
def test_h2o_reference_equals_the_program(h2o_pair, q):
    ctx, ref = h2o_pair
    out, schema = ctx.sql(H2O[f"q{q}"]).collect()
    v = compare(port.answer_to_host(out, schema), ref.answer(f"q{q}"))
    limit = spec.cell("h2o_g1_1e8.high_card").config["limits"]["float_err"]
    assert v.wrong_cells == 0, v.note
    assert v.float_err <= limit
