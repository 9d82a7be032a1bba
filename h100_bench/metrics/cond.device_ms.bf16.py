"""The same reading as ``cond.device_ms``, in the bf16 recipe's cell: the conditional
flow's work outside the chain kernel, its bf16 library convolutions included and their
casts (``hcflow.cast``) left out."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "conditional flow"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    return program_trace.device_ms(r, "hcflow.cond")
