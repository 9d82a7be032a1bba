"""Straight-through-estimator quantization, as ``hcflow_tpu/ops/quant.py``.

The forward clamps to [0, 1] and rounds to steps of 1/255; the backward is the
identity (gradients flow through the rounding unchanged).
"""

from __future__ import annotations

import torch


class _QuantizeSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0

    @staticmethod
    def backward(ctx, g):
        return g


def quantize_ste(x: torch.Tensor) -> torch.Tensor:
    """round(clamp(x, 0, 1) * 255) / 255 forward, identity backward."""
    return _QuantizeSTE.apply(x)
