"""overflow_reruns_per_query: whole-plan re-runs after an overflowed
capacity (the "output overflowed capacity" warnings of
SessionContext.converge) per query answered. A count of the program."""


def read(rec):
    return rec.reruns / len(rec.latencies_s) if rec.latencies_s else None
