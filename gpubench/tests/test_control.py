"""The control: the plain reference one precision step lower, put in the
program's place, comes out not correct (at a size a test run holds)."""

from gpubench import spec
from gpubench.answer import as_program_cols, compare


def _readings(family, config, queries, seed=17):
    tables = spec.module("data", family).generate(config, seed)
    ref = spec.module("reference", family)
    sound, lower = ref.Reference(tables, "cpu"), ref.Reference(
        tables, "cpu", control=True)
    out = [compare(as_program_cols(lower.answer(q)), sound.answer(q))
           for q in queries]
    return sum(v.wrong_cells for v in out), max(v.float_err for v in out)


def test_tpch_control_is_not_correct():
    # at SF1 Q1's sum_charge (about 5e16 units at scale 6) is past float64's
    # 2^53: decimal sums accumulated in float64 come out wrong
    limits = spec.cell("tpch_sf10.power").config["limits"]
    wrong, _ = _readings("tpch", {"scale_factor": 1}, ["q1"])
    assert wrong > limits["wrong_cells"]


def test_h2o_control_is_not_correct_in_either_mix():
    for name in ("h2o_g1_1e8.high_card", "h2o_g1_1e8.low_card"):
        cell = spec.cell(name)
        wrong, err = _readings("h2o", {"rows": 1e5, "k": 100},
                               cell.traffic["order"])
        limits = cell.config["limits"]
        assert wrong > limits["wrong_cells"] or err > limits["float_err"], name
