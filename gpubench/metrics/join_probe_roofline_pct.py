"""join_probe_roofline_pct: the unique-build join probe
`ops.merge_join.probe_unique` against the floor any equi-join probe must
move at the H100 SXM's published 3.35 TB/s: that floor over the device
time of every operation launched inside the entry's calls (profiler
trace).

The floor comes from the entry's arguments, not from the kernels behind
it, so any probe behind the same entry is held to the same work: every
tensor argument (the build and probe keys, their validities, the two live
masks) read once, counted once per storage by `data_ptr`, and the int64
match of every probe row written once.

`ENTRY` names the entry that a traced run wraps for this metric
(`port.EntryWrap`), and `call_bytes` is called with each call's
arguments."""

import torch

HBM_BYTES_PER_S = 3.35e12
ENTRY = ("ballista_tpu_torch.ops.merge_join", "probe_unique")


def call_bytes(build_keys, build_valids, build_live, probe_keys,
               probe_valids, probe_live):
    """The bytes one call must move: the sizes of its tensors, known on the
    host (no device work, no sync)."""
    seen = {}
    for t in (*build_keys, *build_valids, build_live, *probe_keys,
              *probe_valids, probe_live):
        if isinstance(t, torch.Tensor):
            seen[t.data_ptr()] = max(seen.get(t.data_ptr(), 0),
                                     t.numel() * t.element_size())
    return sum(seen.values()) + 8 * int(probe_live.shape[0])


def read(rec):
    e = rec.entries.get("join_probe_roofline_pct")
    if e is None or not e.device_s or not e.bytes:
        return None
    return 100.0 * e.bytes / HBM_BYTES_PER_S / e.device_s
