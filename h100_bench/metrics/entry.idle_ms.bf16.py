"""The same reading as ``entry.idle_ms``, in the bf16 recipe's cell."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "entry"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    return program_trace.program_idle_ms(r)
