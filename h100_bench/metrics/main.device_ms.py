"""Device milliseconds a request launched with a level's main chain span
(``hcflow.main``, ``flow/flownet.py``) innermost: the main flow steps on library
operations (the forward main chains of the downscale), not the chain kernels."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "main chain"
MOVES = "hr_mps"
WORKLOADS = ["rescaling_x4_f32.ingest"]


def read(r):
    return program_trace.device_ms(r, "hcflow.main")
