"""The same reading as ``entry.host_ms``, in the bf16 recipe's cell."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "entry"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    host = r.host_s("bench.entry")
    return 1e3 * host / r.requests if host and r.requests else None
