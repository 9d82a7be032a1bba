"""The share of the traced window in which no operation ran on the card."""

UNIT, BETTER, SOURCE = "%", "lower", "device_trace"
LAYER = "device"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s) if r.window_s > 0 else None
