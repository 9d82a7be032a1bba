"""The same reading as ``step_mfu``, in the faces cell, whose rate is ``hr_mps.faces``."""

from h100_bench import work

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "whole step"
MOVES = "hr_mps.faces"
WORKLOADS = ["sr_x8_f32.faces"]


def read(r):
    if r.calls.model_flops <= 0 or r.window_s <= 0:
        return None
    return 100.0 * r.calls.model_flops / r.window_s / work.PEAK_TF32
