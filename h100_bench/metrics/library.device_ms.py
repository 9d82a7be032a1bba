"""Device milliseconds a request of what the entry call launched outside the port's
kernel wrappers: the flow's library operations (``flow/*``, ``ops/nets.py``, invconv,
ActNorm, squeezes, cuDNN convolutions)."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "flow and library ops"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    dev = r.device_s.get("library")
    return 1e3 * dev / r.requests if dev and r.requests else None
