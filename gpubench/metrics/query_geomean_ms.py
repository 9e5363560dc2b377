"""query_geomean_ms: geometric mean of every latency of the window, from
the call of ctx.sql to the synchronize after collect() (TPC-H's power
quantity: a short query weighs as much as a long one). Host clock."""

import math


def read(rec):
    lat = rec.latencies_s
    if not lat:
        return None
    return math.exp(sum(math.log(x) for x in lat) / len(lat)) * 1e3
