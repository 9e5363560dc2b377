"""masked_sums_roofline_pct: the kernel entry
`ops.masked_sums.masked_slot_sums_rows` against its bound at the H100
SXM's published 3.35 TB/s: the bytes its calls must move over the device
time of every operation launched inside them (profiler trace).

The bytes come from the entry's arguments, not from the kernel's launch
parameters, so any kernel behind the same entry is held to the same work:
every slot (int32) once, the 32-byte sectors of each described column
that hold a live row (a dead row's values are never needed), and the
T x A int64 sums once. A frozen copy of the formula of `chip_smoke.py
bound`. Every such call is bound by bytes.

`ENTRY` names the entry that a traced run wraps for this metric
(`port.EntryWrap`), and `call_bytes` is called with each call's
arguments."""

import torch

HBM_BYTES_PER_S = 3.35e12
ENTRY = ("ballista_tpu_torch.ops.masked_sums", "masked_slot_sums_rows")


def call_bytes(row_slot, rows, T):
    """The bytes one call must move, as a device scalar (no sync)."""
    n = int(row_slot.shape[0])
    fixed = 4 * n + 8 * T * len(rows)
    total = torch.tensor(fixed, dtype=torch.int64, device=row_slot.device)
    if n == 0:
        return total
    live = (row_slot >= 0) & (row_slot < T)
    seen, sectors = {}, {}
    for row in rows:
        for t in row[:2]:           # (data, validity[, half-word mode])
            if isinstance(t, torch.Tensor):
                seen[t.data_ptr()] = t
    for t in seen.values():
        size = t.element_size()
        if size not in sectors:
            per = max(32 // size, 1)
            hit = torch.cat([live, live.new_zeros(-n % per)]).view(-1, per)
            sectors[size] = torch.clamp(hit.any(1).sum() * 32, max=n * size)
        total = total + sectors[size]
    return total


def read(rec):
    e = rec.entries.get("masked_sums_roofline_pct")
    if e is None or not e.device_s or not e.bytes:
        return None
    return 100.0 * e.bytes / HBM_BYTES_PER_S / e.device_s
