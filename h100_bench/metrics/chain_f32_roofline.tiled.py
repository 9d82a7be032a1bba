"""The same reading as ``chain_f32_roofline``, in the tiled cell, whose rate is ``hr_mps.tiled``."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "chain kernel"
MOVES = "hr_mps.tiled"
WORKLOADS = ["sr_x4_f32.tiles"]


def read(r):
    return r.roofline_pct("chain")
