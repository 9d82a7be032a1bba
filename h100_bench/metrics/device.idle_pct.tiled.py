"""The same reading as ``device.idle_pct``, in the tiled cell, whose rate is ``hr_mps.tiled``."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "hr_mps.tiled"
WORKLOADS = ["sr_x4_f32.tiles"]


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.window_s > 0 else None
