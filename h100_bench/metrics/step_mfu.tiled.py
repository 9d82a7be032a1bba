"""The same reading as ``step_mfu``, in the tiled cell, whose rate is ``hr_mps.tiled``."""

from h100_bench import work

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "whole step"
MOVES = "hr_mps.tiled"
WORKLOADS = ["sr_x4_f32.tiles"]


def read(r):
    if r.calls.model_flops <= 0 or r.window_s <= 0:
        return None
    return 100.0 * r.calls.model_flops / r.window_s / work.PEAK_TF32
