"""The same reading as ``cond.device_ms``, in the faces cell, whose rate is ``hr_mps.faces``."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "conditional flow"
MOVES = "hr_mps.faces"
WORKLOADS = ["sr_x8_f32.faces"]


def read(r):
    return program_trace.device_ms(r, "hcflow.cond")
