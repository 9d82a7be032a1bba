"""Device milliseconds a request launched with the conditioning encoder's span
(``hcflow.encoder``, ``flow/conditional.py`` ``cond_feature``) innermost: its library
convolutions, ``conv_first`` and ``trunk_conv1``, and the concatenations, not the RRDB
kernel."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "conditional encoder"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    return program_trace.device_ms(r, "hcflow.encoder")
