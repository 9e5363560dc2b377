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
from ballista_tpu_torch.ops.masked_sums import (a_chunk, masked_slot_sums,
                                                masked_slot_sums_reference)

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
    assert masked_slot_sums.launches == launches + -(-A // a_chunk(T))


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
        before = masked_slot_sums.launches
        out[str(dev)] = ctx.sql(sql).to_numpy()
        launched = masked_slot_sums.launches - before
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
        before = masked_slot_sums.launches
        out[str(dev)] = ctx.sql(TPCH_QUERIES[q]).to_numpy()
        launched = masked_slot_sums.launches - before
        assert launched == (0 if dev == "cpu" else card_launches)
    for name, (values, valid) in out["cpu"].items():
        got_values, got_valid = out[str(cuda_device)][name]
        np.testing.assert_array_equal(got_valid, valid, err_msg=name)
        np.testing.assert_array_equal(got_values, values, err_msg=name)
