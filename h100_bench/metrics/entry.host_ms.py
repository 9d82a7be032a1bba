"""Host milliseconds a request inside the entry call (the model's ``reverse`` or
``forward``), until it returns: the time the host takes to issue a pass."""

UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"
LAYER = "entry"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    host = r.host_s("bench.entry")
    return 1e3 * host / r.requests if host and r.requests else None
