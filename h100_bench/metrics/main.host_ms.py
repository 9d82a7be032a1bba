"""Host self milliseconds a request in the main chains' spans (``hcflow.main``): their
time on the host less that of the kernel wrappers' spans inside them: the host's issue
of the main flow steps."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "program_span"
LAYER = "main chain"
MOVES = "hr_mps"
WORKLOADS = ["rescaling_x4_f32.ingest"]


def read(r):
    return program_trace.host_self_ms(r, "hcflow.main")
