"""device_ms_per_query: the union of the device's operations (kernels,
copies, fills) over the traced window, per query answered, in ms.
Profiler trace."""


def read(rec):
    if rec.trace is None or not rec.latencies_s or rec.trace.busy_s <= 0:
        return None
    return rec.trace.busy_s / len(rec.latencies_s) * 1e3
