"""peak_device_gib: torch.cuda.max_memory_allocated() over set-up and the
window, tables resident, in GiB."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
