"""The same reading as ``library.device_ms``, in the bf16 recipe's cell."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "flow and library ops"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    dev = r.device_s.get("library")
    return 1e3 * dev / r.requests if dev and r.requests else None
