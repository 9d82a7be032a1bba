"""ActNorm: per-channel affine ``y = (x + bias) * exp(logs)`` on NHWC tensors."""

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
