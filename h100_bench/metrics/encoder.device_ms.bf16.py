"""The same reading as ``encoder.device_ms``, in the bf16 recipe's cell: the encoder's
bf16 library convolutions and the concatenations, not their casts (``hcflow.cast``)."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "conditional encoder"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    return program_trace.device_ms(r, "hcflow.encoder")
