"""Device milliseconds a request launched with the program's ``hcflow.cast`` span
innermost: in the bf16 recipe, the library convolutions' casts (``ops/nets.py``
``conv2d``: each operand to bf16, the output back to float32), full-resolution
elementwise passes; not the convolutions between them, which stay in their layer's
span."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "flow and library ops"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    return program_trace.device_ms(r, "hcflow.cast")
