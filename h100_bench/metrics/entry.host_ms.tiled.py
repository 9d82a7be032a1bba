"""The same reading as ``entry.host_ms``, in the tiled cell, whose rate is ``hr_mps.tiled``."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "entry"
MOVES = "hr_mps.tiled"
WORKLOADS = ["sr_x4_f32.tiles"]


def read(r):
    host = r.host_s("bench.entry")
    return 1e3 * host / r.requests if host and r.requests else None
