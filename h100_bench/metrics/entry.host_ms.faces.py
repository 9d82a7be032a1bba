"""The same reading as ``entry.host_ms``, in the faces cell, whose rate is ``hr_mps.faces``."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "entry"
MOVES = "hr_mps.faces"
WORKLOADS = ["sr_x8_f32.faces"]


def read(r):
    host = r.host_s("bench.entry")
    return 1e3 * host / r.requests if host and r.requests else None
