"""The same reading as ``library.device_ms``, in the tiled cell, whose rate is ``hr_mps.tiled``."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "flow and library ops"
MOVES = "hr_mps.tiled"
WORKLOADS = ["sr_x4_f32.tiles"]


def read(r):
    dev = r.device_s.get("library")
    return 1e3 * dev / r.requests if dev and r.requests else None
