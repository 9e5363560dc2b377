"""query_p95_ms: the 95th percentile (nearest rank) of every latency of
the window. Host clock."""

import math


def read(rec):
    lat = sorted(rec.latencies_s)
    if not lat:
        return None
    return lat[max(math.ceil(0.95 * len(lat)) - 1, 0)] * 1e3
