"""ActNorm: per-channel affine ``y = (x + bias) * exp(logs)`` on NHWC tensors, with the
data-dependent init :func:`calibrate`."""

from __future__ import annotations

import torch


def init(num_channels: int) -> dict:
    return {
        "bias": torch.zeros(num_channels),
        "logs": torch.zeros(num_channels),
    }


def forward(params: dict, x: torch.Tensor, logdet=None):
    y = (x + params["bias"]) * torch.exp(params["logs"])
    if logdet is not None:
        logdet = logdet + params["logs"].sum() * (x.shape[1] * x.shape[2])
    return y, logdet


def inverse(params: dict, y: torch.Tensor, logdet=None):
    x = y * torch.exp(-params["logs"]) - params["bias"]
    if logdet is not None:
        logdet = logdet - params["logs"].sum() * (y.shape[1] * y.shape[2])
    return x, logdet


def calibrate(x: torch.Tensor, scale: float = 1.0) -> dict:
    """Data-dependent init: forward() of the result has zero mean and unit variance
    per channel on x."""
    bias = -x.mean(dim=(0, 1, 2))
    var = ((x + bias) ** 2).mean(dim=(0, 1, 2))
    logs = torch.log(scale / (torch.sqrt(var) + 1e-6))
    return {"bias": bias.to(x.dtype), "logs": logs.to(x.dtype)}
