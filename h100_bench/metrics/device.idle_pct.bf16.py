"""The same reading as ``device.idle_pct``, in the bf16 recipe's cell."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.window_s > 0 else None
