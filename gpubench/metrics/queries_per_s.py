"""queries_per_s: queries answered in the window over the window's seconds
(TPC-H's throughput quantity, one stream). Host clock."""


def read(rec):
    return len(rec.latencies_s) / rec.window_s if rec.latencies_s else None
