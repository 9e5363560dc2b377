"""Card-only tests of ballista_tpu_torch: the CUDA kernel against its plain
PyTorch version, and the port's queries on the card against the same
queries on the CPU. They skip where CUDA is absent (a CUDA kernel has no
CPU mode). This file imports neither jax nor ballista_tpu, so on a machine
with a card and no JAX it runs on its own:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest
import torch

from ballista_tpu_torch.benchmarks import TPCH_QUERIES
from ballista_tpu_torch.client import SessionContext
from ballista_tpu_torch.datagen import generate_tpch, register_tpch
from ballista_tpu_torch.ops.masked_sums import (
    a_chunk, masked_slot_sums, masked_slot_sums_reference,
    masked_slot_sums_rows, masked_slot_sums_rows_reference)

torch.set_num_threads(2)

BIG = 2 ** 62


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,T,A", [(0, 6, 3), (1, 6, 3), (257, 12, 11),
                                   (1_000_003, 12, 11), (100_000, 64, 3)])
def test_kernel_matches_reference(cuda_device, n, T, A):
    g = torch.Generator().manual_seed(n + T)
    slot = torch.randint(-1, T + 2, (n,), generator=g, dtype=torch.int32)
    contribs = torch.randint(-BIG, BIG, (A, n), generator=g,
                             dtype=torch.int64)
    launches = masked_slot_sums.launches
    got = masked_slot_sums(slot.to(cuda_device), contribs.to(cuda_device), T)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), masked_slot_sums_reference(slot, contribs, T))
    assert masked_slot_sums.launches == launches + (1 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n,T,A", [(100_003, 64, 100), (50_000, 60, 105)])
def test_wide_kernel_call_is_split(cuda_device, n, T, A):
    """T x A beyond shared memory: chunks of A, one launch each."""
    g = torch.Generator().manual_seed(n + A)
    slot = torch.randint(-1, T + 2, (n,), generator=g, dtype=torch.int32)
    contribs = torch.randint(-BIG, BIG, (A, n), generator=g,
                             dtype=torch.int64)
    launches = masked_slot_sums.launches
    got = masked_slot_sums(slot.to(cuda_device), contribs.to(cuda_device), T)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), masked_slot_sums_reference(slot, contribs, T))
    assert masked_slot_sums.launches == launches + -(
        -A // a_chunk(T, cuda_device))


# every T where the kernel changes its code path (registers up to 4,
# lane columns in shared memory above, warp-matched cells where those do
# not fit), at sizes below one vector, odd sizes and a tile multiple
EDGE_T = (1, 2, 3, 4, 5, 8, 9, 16, 17, 26, 64)
EDGE_N = (1, 2, 3, 2048, 4099, 1_000_003)


@pytest.mark.cuda
@pytest.mark.parametrize("T", EDGE_T)
@pytest.mark.parametrize("n", EDGE_N)
def test_kernel_edges_match_reference(cuda_device, n, T):
    """The matrix entry, whole and as the view contribs[1:], whose rows sit
    off the 16-byte grid when n is odd; slots from -1 to T + 1."""
    g = torch.Generator().manual_seed(n * 67 + T)
    slot = torch.randint(-1, T + 2, (n,), generator=g, dtype=torch.int32)
    contribs = torch.randint(-BIG, BIG, (4, n), generator=g, dtype=torch.int64)
    want = masked_slot_sums_reference(slot, contribs, T)
    slot, contribs = slot.to(cuda_device), contribs.to(cuda_device)
    got = masked_slot_sums(slot, contribs, T)
    tail = masked_slot_sums(slot, contribs[1:], T)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(tail.cpu(), want[:, 1:])


def _card_rows(n, g, device, offset=0):
    """count(*), a count, int64 sums with and without NULLs (one sharing
    the count's validity column), an int32 sum; every column a view that
    starts `offset` elements into its storage."""
    def col(dtype, lo, hi, to=None):
        t = torch.randint(lo, hi, (n + offset,), generator=g, dtype=dtype)
        return (t if to is None else t.to(to)).to(device)[offset:]

    v1, v2 = (col(torch.int8, 0, 2, torch.bool) for _ in range(2))
    return [(None, None), (None, v1), (col(torch.int64, -BIG, BIG), v1),
            (col(torch.int64, -BIG, BIG), None),
            (col(torch.int32, -2 ** 31, 2 ** 31 - 1), v2)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", EDGE_T)
@pytest.mark.parametrize("n,offset", [(1, 0), (2, 1), (3, 3), (4099, 0),
                                      (300_001, 1), (300_002, 2),
                                      (1_000_003, 3)])
def test_rows_kernel_edges_match_reference(cuda_device, n, offset, T):
    """The rows entry over int32 and int64 data with and without validity,
    on columns and slots that start 0 to 3 elements off the 16-byte grid."""
    g = torch.Generator().manual_seed(n * 31 + T)
    slot = torch.randint(-1, T + 2, (n + offset,), generator=g,
                         dtype=torch.int32).to(cuda_device)[offset:]
    rows = _card_rows(n, g, cuda_device, offset)
    launches = masked_slot_sums_rows.launches
    got = masked_slot_sums_rows(slot, rows, T)
    torch.cuda.synchronize()
    assert torch.equal(got, masked_slot_sums_rows_reference(slot, rows, T))
    assert masked_slot_sums_rows.launches == launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_slot", "one_percent_live", "none_live",
                                  "wraps_up", "wraps_down"])
def test_kernel_skew_sparsity_and_wraparound(cuda_device, case):
    n, T, A = 500_001, 12, 11
    g = torch.Generator().manual_seed(len(case))
    lo, hi = {"wraps_up": (BIG - 2 ** 20, BIG),
              "wraps_down": (-BIG, -BIG + 2 ** 20)}.get(
                  case, (-2 ** 40, 2 ** 40))
    contribs = torch.randint(lo, hi, (A, n), generator=g,
                             dtype=torch.int64).to(cuda_device)
    if case == "one_slot":
        slot = torch.full((n,), 7, dtype=torch.int32)
    elif case == "one_percent_live":
        slot = torch.where(torch.rand(n, generator=g) < 0.01, 3, T).to(
            torch.int32)
    elif case == "none_live":
        slot = torch.full((n,), T, dtype=torch.int32)
    else:
        slot = torch.randint(0, T, (n,), generator=g, dtype=torch.int32)
    slot = slot.to(cuda_device)
    rows = _card_rows(n, g, cuda_device)
    got = masked_slot_sums(slot, contribs, T)
    got_rows = masked_slot_sums_rows(slot, rows, T)
    torch.cuda.synchronize()
    assert torch.equal(got, masked_slot_sums_reference(slot, contribs, T))
    assert torch.equal(got_rows,
                       masked_slot_sums_rows_reference(slot, rows, T))


@pytest.mark.cuda
@pytest.mark.parametrize("T", [3, 12, 40, 6000])
def test_wide_rows_call_is_split(cuda_device, T):
    """More described rows than one launch streams columns, or more
    outputs than its shared memory holds: several launches, one output."""
    n = 100_003
    g = torch.Generator().manual_seed(T)
    slot = torch.randint(-1, T + 2, (n,), generator=g,
                         dtype=torch.int32).to(cuda_device)
    rows = _card_rows(n, g, cuda_device) * 3 + _card_rows(n, g, cuda_device) * 2
    launches = masked_slot_sums_rows.launches
    got = masked_slot_sums_rows(slot, rows, T)
    torch.cuda.synchronize()
    assert torch.equal(got, masked_slot_sums_rows_reference(slot, rows, T))
    assert masked_slot_sums_rows.launches > launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 4, 26])
def test_rows_kernel_takes_strided_columns(cuda_device, T):
    """Stride-0 views (a literal, a broadcast join side) and every-other
    views give the sums of their contiguous copies."""
    n = 300_001
    g = torch.Generator().manual_seed(T)
    slot = torch.randint(-1, T + 2, (n,), generator=g,
                         dtype=torch.int32).to(cuda_device)
    wide = torch.randint(-BIG, BIG, (2 * n,), generator=g,
                         dtype=torch.int64).to(cuda_device)
    flags = (torch.rand(2 * n, generator=g) >= 0.3).to(cuda_device)
    seven = torch.tensor([7], dtype=torch.int64, device=cuda_device).expand(n)
    three = torch.tensor([3], dtype=torch.int32, device=cuda_device).expand(n)
    yes = torch.tensor([True], device=cuda_device).expand(n)
    rows = [(None, yes), (seven, yes), (three, flags[:n]), (seven, None),
            (wide[::2], flags[::2]), (None, flags[1::2]), (wide[1::2], yes)]
    launches = masked_slot_sums_rows.launches
    got = masked_slot_sums_rows(slot, rows, T)
    torch.cuda.synchronize()
    assert torch.equal(got, masked_slot_sums_rows_reference(slot, rows, T))
    assert masked_slot_sums_rows.launches == launches + 1


@pytest.mark.cuda
def test_kernel_rejects_mixed_devices(cuda_device):
    with pytest.raises(ValueError):
        masked_slot_sums(torch.zeros(4, dtype=torch.int32, device=cuda_device),
                         torch.zeros((1, 4), dtype=torch.int64), 2)


QUERIES = {
    # (sql, kernel launches on the card)
    "q1": (TPCH_QUERIES[1], 1),
    # the fused sums, plus max(l_tax)'s per-slot validity count
    "no_key": ("select sum(l_extendedprice * (1 - l_discount)) as s, "
               "count(*) as n, max(l_tax) as t from lineitem "
               "where l_shipdate < date '1995-01-01'", 2),
    # literal arguments bind to stride-0 views
    "literals": ("select count(1) as n, sum(1) as s, count('x') as c "
                 "from lineitem", 1),
    "literals_grouped": (
        "select l_linestatus, count(1) as n, sum(1) as s, sum(2.5) as d, "
        "avg(3) as a from lineitem group by l_linestatus "
        "order by l_linestatus", 1),
    # a broadcast cross-join column; the derived table's aggregate makes
    # two calls (its count(*), and max's per-slot validity count)
    "broadcast": ("select sum(m.top) as s, count(m.top) as c from lineitem, "
                  "(select max(l_quantity) as top from lineitem) m", 3),
    "broadcast_grouped": (
        "select l_linestatus, sum(m.top) as s, count(m.top) as c, "
        "sum(l_quantity * m.top) as p from lineitem, "
        "(select max(l_quantity) as top from lineitem) m "
        "group by l_linestatus order by l_linestatus", 3),
    # an int32 column goes to the kernel as it is
    "int32": ("select sum(l_linenumber) as s, avg(l_linenumber) as a, "
              "count(l_linenumber) as c from lineitem where l_quantity < 10",
              1),
    "int32_grouped": ("select l_returnflag, sum(l_linenumber) as s "
                      "from lineitem group by l_returnflag "
                      "order by l_returnflag", 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("query", sorted(QUERIES))
def test_query_on_card_matches_cpu(cuda_device, query):
    sql, card_launches = QUERIES[query]
    fields, cols = generate_tpch(0.01, tables=["lineitem"])["lineitem"]
    out = {}
    for dev in ("cpu", cuda_device):
        ctx = SessionContext(device=dev)
        ctx.register_host("lineitem", fields, cols)
        before = masked_slot_sums_rows.launches
        out[str(dev)] = ctx.sql(sql).to_numpy()
        launched = masked_slot_sums_rows.launches - before
        assert launched == (0 if dev == "cpu" else card_launches)
    for name, (values, valid) in out["cpu"].items():
        got_values, got_valid = out[str(cuda_device)][name]
        np.testing.assert_array_equal(got_valid, valid, err_msg=name)
        np.testing.assert_array_equal(got_values, values, err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("q,card_launches", [(3, 0), (5, 1)])
def test_join_query_on_card_matches_cpu(cuda_device, q, card_launches):
    """TPC-H Q3 (sorted-layout aggregate) and Q5 (the kernel, T = 26) on
    the card against the CPU, over all six tables at SF 0.01."""
    out = {}
    for dev in ("cpu", cuda_device):
        ctx = SessionContext(device=dev)
        register_tpch(ctx, 0.01)
        before = masked_slot_sums_rows.launches
        out[str(dev)] = ctx.sql(TPCH_QUERIES[q]).to_numpy()
        launched = masked_slot_sums_rows.launches - before
        assert launched == (0 if dev == "cpu" else card_launches)
    for name, (values, valid) in out["cpu"].items():
        got_values, got_valid = out[str(cuda_device)][name]
        np.testing.assert_array_equal(got_valid, valid, err_msg=name)
        np.testing.assert_array_equal(got_values, values, err_msg=name)


WIDE_SQL = "select g, sum(x) as s from {} group by g order by s"


@pytest.mark.cuda
def test_narrowing_rides_the_run_flags(cuda_device, monkeypatch):
    """A SUM wide by its bound and read by ORDER BY is narrowed on the
    card: the narrowing and its out-of-range mark make no host sync (the
    sync debug mode raises on one), and the mark is read with the run's
    other flags, in its one `verdict` read. A value past int64 then fails
    the query; one that fits answers as on the CPU."""
    from ballista_tpu_torch.exec.plan import Run
    from ballista_tpu_torch.schema import INT64, Field, decimal, narrow_wide
    words = torch.tensor(
        [[0, 5], [2 ** 31, 0], [-2 ** 31, 7], [-1, 2 ** 32 - 1]],
        dtype=torch.int64, device=cuda_device)
    valid = torch.tensor([True, False, True, True], device=cuda_device)
    run = Run({})
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        values, passed = narrow_wide(words)
        run.flag_wide((passed & valid).any(), "s")
        verdict = run.verdict()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert values.cpu()[[0, 2, 3]].tolist() == [5, -2 ** 63 + 7, -1]
    assert int(verdict) == 0
    run.flag_wide(passed.any(), "t")
    with pytest.raises(NotImplementedError, match="t: its value passes int64"):
        run.overflowed(int(run.verdict()))

    reads = []
    monkeypatch.setattr(Run, "verdict", lambda self, _f=Run.verdict:
                        reads.append(1) or _f(self))
    fields = [Field("g", INT64), Field("x", decimal(18, 6))]
    tables = {"fits": [9 * 10 ** 17] + [1] * 10, "past": [9 * 10 ** 17] * 11}
    out = {}
    for dev in ("cpu", cuda_device):
        ctx = SessionContext(device=dev)
        for name, x in tables.items():
            ctx.register_numpy(name, {"g": np.zeros(len(x), np.int64),
                                      "x": np.array(x, np.int64)},
                               fields=fields)
        reads.clear()
        out[str(dev)] = ctx.sql(WIDE_SQL.format("fits")).to_numpy()
        assert reads == [1]
        with pytest.raises(NotImplementedError, match="wide decimal"):
            ctx.sql(WIDE_SQL.format("past")).collect()
    assert out["cpu"]["s"][0].tolist() == [9 * 10 ** 17 + 10]
    for name, (values, valid) in out["cpu"].items():
        got_values, got_valid = out[str(cuda_device)][name]
        np.testing.assert_array_equal(got_valid, valid, err_msg=name)
        np.testing.assert_array_equal(got_values, values, err_msg=name)
