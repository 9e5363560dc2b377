"""Timing helpers the card-side scripts share (`chip_smoke.py`,
`kernel_probe`)."""

from __future__ import annotations

import statistics
import time

import torch


def cuda_ms(fn, iters=20, warm=3, queued=False):
    """Mean warm milliseconds per call, from CUDA events. With `queued`,
    the card first spins for some milliseconds while the host enqueues
    every call, so the events bracket device work alone (the calls' own
    kernels and memsets back to back); without it a call shorter than its
    host-side launch is timed at the host's pace."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters=200):
    """Median milliseconds of host time one call takes to return, the card
    left to run behind (the median, because a shared host's mean is set
    by its few longest calls)."""
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e3


def library_ms(slot, contribs, T):
    """The time of the one PyTorch call that computes the same sums as the
    kernel from a contribution matrix int64[A, n], `index_add_`, its index
    and output prepared beforehand. The port never calls it outside the
    plain version."""
    idx = torch.where((slot >= 0) & (slot < T), slot, T).to(torch.int64)
    out = torch.zeros((T + 1, contribs.shape[0]), dtype=torch.int64,
                      device=slot.device)
    src = contribs.T
    return cuda_ms(lambda: out.index_add_(0, idx, src))
