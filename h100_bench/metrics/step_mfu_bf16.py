"""The whole serving pass's share of the card's bf16 peak: the model FLOP of the window's
entry calls as made (their shapes and the option file's topology, ``work.model_flops``)
over the traced window and the 989 TFLOP/s dense bf16 tensor-core peak.  The recipe keeps
the 1x1 invconvs and the affine updates in float32, charged here at the bf16 peak too, so
the share slightly understates how near the pass runs to what its recipe allows."""

from h100_bench.metrics.rrdb_bf16_roofline import PEAK_BF16

UNIT, BETTER, SOURCE = "%", "higher", "host_clock"
LAYER = "whole step"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    if r.calls.model_flops <= 0 or r.window_s <= 0:
        return None
    return 100.0 * r.calls.model_flops / r.window_s / PEAK_BF16
