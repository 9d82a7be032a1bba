"""Host self milliseconds a request in the conditional flow's spans (``hcflow.cond``):
their time on the host less that of the spans inside them (the encoder, the kernel
wrappers): the host's issue of the prior, the sampling or whitening and the split-off
steps."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "conditional flow"
MOVES = "hr_mps"
WORKLOADS = ["rescaling_x4_f32.ingest"]


def read(r):
    return program_trace.host_self_ms(r, "hcflow.cond")
