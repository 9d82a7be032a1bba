"""The whole serving pass's share of the card's float32 peak: the model FLOP of the
window's entry calls as made (their shapes and the option file's topology,
``work.model_flops``) over the traced window and the 495 TFLOP/s TF32 peak, which
bounds any float32 implementation."""

from h100_bench import work

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "whole step"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    if r.calls.model_flops <= 0 or r.window_s <= 0:
        return None
    return 100.0 * r.calls.model_flops / r.window_s / work.PEAK_TF32
