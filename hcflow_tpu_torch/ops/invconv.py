"""Invertible 1x1 convolution: a channel matmul ``y = x @ W.T`` on NHWC tensors.

Only the plain weight is ported; the LU parametrisation comes with training.  All
products here are float32: the invertible path must round-trip.
"""

from __future__ import annotations

import torch

from . import nets


def init(generator: torch.Generator, num_channels: int) -> dict:
    """Random orthogonal init (QR of a Gaussian), as in Glow."""
    g = torch.randn(num_channels, num_channels, generator=generator, dtype=torch.float64)
    w = torch.linalg.qr(g)[0]
    return {"weight": w.float()}


def _apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    with nets.exact_f32():
        return torch.einsum("bhwi,oi->bhwo", x, w)


def precompute(params: dict) -> dict:
    """Attach the inverse weight and log|det W| once, out of the hot path."""
    w = params["weight"]
    return {**params, "w_inv": torch.linalg.inv(w), "logdet_w": torch.linalg.slogdet(w)[1]}


def _logdet_w(params: dict) -> torch.Tensor:
    ld_w = params.get("logdet_w")
    return torch.linalg.slogdet(params["weight"])[1] if ld_w is None else ld_w


def forward(params: dict, x: torch.Tensor, logdet=None):
    y = _apply(params["weight"], x)
    if logdet is not None:
        logdet = logdet + _logdet_w(params) * (x.shape[1] * x.shape[2])
    return y, logdet


def inverse(params: dict, y: torch.Tensor, logdet=None):
    w_inv = params.get("w_inv")
    if w_inv is None:
        w_inv = torch.linalg.inv(params["weight"])
    x = _apply(w_inv, y)
    if logdet is not None:
        logdet = logdet - _logdet_w(params) * (y.shape[1] * y.shape[2])
    return x, logdet
