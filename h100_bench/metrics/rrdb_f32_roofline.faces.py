"""The same reading as ``rrdb_f32_roofline``, in the faces cell, whose rate is ``hr_mps.faces``."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "RRDB kernel"
MOVES = "hr_mps.faces"
WORKLOADS = ["sr_x8_f32.faces"]


def read(r):
    return r.roofline_pct("rrdb")
