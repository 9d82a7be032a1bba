"""Device idle milliseconds a request in gaps that open while a span of the program
(``hcflow.*``) is the innermost span open: the card waiting on the program's own host
work, put down to the program's layer that was running on the host."""

from h100_bench import program_trace

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "entry"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    return program_trace.program_idle_ms(r)
