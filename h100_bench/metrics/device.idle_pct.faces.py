"""The same reading as ``device.idle_pct``, in the faces cell, whose rate is ``hr_mps.faces``."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "hr_mps.faces"
WORKLOADS = ["sr_x8_f32.faces"]


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.window_s > 0 else None
