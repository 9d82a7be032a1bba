"""Device milliseconds a request launched with a level's conditional flow span
(``hcflow.cond``, ``flow/conditional.py``) innermost: the prior heads, the sampling or
whitening, the hoisted cond convolutions and the split-off steps outside the chain
kernel."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "conditional flow"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    return program_trace.device_ms(r, "hcflow.cond")
