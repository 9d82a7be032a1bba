"""The same reading as ``library.device_ms``, in the faces cell, whose rate is ``hr_mps.faces``."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "flow and library ops"
MOVES = "hr_mps.faces"
WORKLOADS = ["sr_x8_f32.faces"]


def read(r):
    dev = r.device_s.get("library")
    return 1e3 * dev / r.requests if dev and r.requests else None
