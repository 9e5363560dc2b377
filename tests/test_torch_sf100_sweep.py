"""The SF100 sweep's invariant checker (`benchmarks/sf100.py`, the port of
`scripts/sf100_sweep.py`) on synthetic saved results, its streaming numpy
reference against the port's Q1 and Q6 over a chunked dataset at SF 0.01,
and the sweep itself end to end on the CPU (SF 0.01 as the reference, SF
0.1 in place of SF100)."""

import decimal

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from ballista_tpu.datagen.tpch import generate_tpch_parquet
from ballista_tpu_torch import batch as B
from ballista_tpu_torch.benchmarks import TPCH_QUERIES, sf100
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import TPCH_TABLES

torch.set_num_threads(2)

D = decimal.Decimal


def _q1(scale: int, wrap: bool = False):
    """A Q1 answer whose sums and counts are `scale` times one SF's; with
    `wrap`, N|O's sum_charge is what an int64 sum past 2^63 returns."""
    base = {("A", "F"): 1, ("N", "F"): 0.026, ("N", "O"): 2, ("R", "F"): 1}
    rows = sorted(base)
    charge = [D(int(1.0356e11 * base[k] * scale * 10 ** 6)).scaleb(-6)
              for k in rows]
    if wrap:
        i = rows.index(("N", "O"))
        charge[i] = (charge[i].scaleb(6) - 2 ** 64).scaleb(-6)

    def dec(values, p, s):
        return pa.array([D(v).quantize(D(1).scaleb(-s)) for v in values],
                        pa.decimal128(p, s))
    n = [int(1.5e6 * base[k] * scale) for k in rows]
    return pa.table({
        "l_returnflag": [k[0] for k in rows],
        "l_linestatus": [k[1] for k in rows],
        "sum_qty": dec([x * 25 for x in n], 18, 2),
        "sum_base_price": dec([x * 38000 for x in n], 18, 2),
        "sum_disc_price": dec([x * 36000 for x in n], 18, 4),
        "sum_charge": pa.array(charge, pa.decimal128(28, 6)),
        "avg_qty": dec([25.5] * 4, 18, 6),
        "avg_price": dec([38000.1] * 4, 18, 6),
        "avg_disc": dec([0.05] * 4, 18, 6),
        "count_order": pa.array(n, pa.int64())})


def _reference_first_column(got, ref):
    """The reference sweep's additive check (scripts/sf100_sweep.py
    `_verify`): the ratio of the first integer or float column only
    (pandas reads decimals as objects, which it skips)."""
    num = [f.name for f in got.schema
           if pa.types.is_integer(f.type) or pa.types.is_floating(f.type)]
    ratio = (sum(got.column(num[0]).to_pylist())
             / sum(ref.column(num[0]).to_pylist()))
    return 8.0 <= ratio <= 12.0


def test_right_answer_passes():
    res = sf100.check(1, _q1(100), _q1(10))
    assert res["verified"] is True
    assert all(ok for ok, _ in res["checks"].values())


def test_wrapped_sum_charge_fails_where_the_reference_passes():
    wrapped = _q1(100, wrap=True)
    assert _reference_first_column(wrapped, _q1(10))
    res = sf100.check(1, wrapped, _q1(10))
    assert res["verified"] is False
    assert res["checks"]["sum_charge x10"][0] is False
    assert res["checks"]["sum_qty x10"][0] is True


@pytest.mark.parametrize("q,got,ref,failed", [
    (1, _q1(100).slice(0, 3), None, "rows"),
    (14, pa.table({"promo_revenue": pa.array([D("16.5")])}),
     pa.table({"promo_revenue": pa.array([D("12.1")])}), "promo_revenue x1"),
    (16, pa.table({"supplier_cnt": pa.array([1, 2, 3])}),
     pa.table({"supplier_cnt": pa.array([1, 2])}), "saturated rows"),
    (13, pa.table({"c_count": pa.array([0, 1]),
                   "custdist": pa.array([10, 20])}),
     pa.table({"c_count": pa.array([0, 1]), "custdist": pa.array([1, 2])}),
     None),
])
def test_each_invariant(q, got, ref, failed):
    res = sf100.check(q, got, ref)
    bad = [name for name, (ok, _) in res["checks"].items() if not ok]
    assert bad == ([failed] if failed else [])
    assert res["verified"] is (failed is None)


def test_exact_check_needs_equal_answers():
    want = pa.table({"revenue": pa.array([D("1234.5678")],
                                         pa.decimal128(38, 4))})
    got = pa.table({"revenue": pa.array([D("1234.5678")],
                                        pa.decimal128(18, 4))})
    assert sf100.check(6, got, exact=want)["verified"] is True
    off = pa.table({"revenue": pa.array([D("1234.5679")],
                                        pa.decimal128(18, 4))})
    assert sf100.check(6, off, exact=want)["verified"] is False


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("sweep")
    for sf, name in ((0.01, "small"), (0.1, "big")):
        generate_tpch_parquet(sf, str(root / name), n_chunks=3,
                              tables=["lineitem"], workers=2)
    return root


@pytest.mark.parametrize("q", [1, 6])
def test_numpy_reference_equals_the_port(datasets, q):
    ctx = SessionContext(device="cpu")
    ctx.register_parquet_dataset("lineitem", str(datasets / "small" /
                                                 "lineitem"),
                                 TPCH_TABLES["lineitem"][1])
    batch, schema = ctx.sql(TPCH_QUERIES[q]).collect()
    got = B.to_arrow(batch, schema)
    want = sf100.NUMPY[q](str(datasets / "small"), workers=2)
    assert sf100.check(q, got, exact=want)["checks"]["exact vs numpy"][0]


def test_sweep_end_to_end(datasets, tmp_path):
    """Each query in its own process: the reference pass holds in-core
    against serial exactly; the larger pass meets every invariant."""
    ten = sf100.sf10_pass(str(datasets / "small"), str(tmp_path), [1, 6],
                          device="cpu", serial_partitions=3, timeout=300,
                          log=lambda *_: None)
    assert all(r["verified"] and r["serial_equal"] for r in ten.values())
    big = sf100.sf100_pass(str(datasets / "big"), str(tmp_path), [1, 6],
                           device="cpu", timeout=300, log=lambda *_: None)
    for q, r in big.items():
        assert r["verified"] is True, (q, r)
        assert r["route"] == "in-core" and r["rows"] == sf100.FIXED_ROWS[q]
        assert "exact vs numpy" in r["checks"]
    assert pq.read_table(tmp_path / "sf100" / "q1.parquet").num_rows == 4


def test_capacity_past_int32_raises():
    """Row indices and counts are int32: a capacity (a table's, or an
    expanding join's output grown by the overflow retry) past them raises
    rather than wraps."""
    assert B.round_capacity(B.MAX_CAPACITY) == B.MAX_CAPACITY
    assert B.round_capacity(600_037_902) == 600_038_016    # SF100 lineitem
    with pytest.raises(ValueError, match="int32"):
        B.round_capacity(B.MAX_CAPACITY + 1)
