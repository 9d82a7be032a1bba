"""The same reading as ``chain_f32_roofline``, in the faces cell, whose rate is ``hr_mps.faces``."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "chain kernel"
MOVES = "hr_mps.faces"
WORKLOADS = ["sr_x8_f32.faces"]


def read(r):
    return r.roofline_pct("chain")
