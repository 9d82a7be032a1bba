"""Invertible 1x1 convolution: a channel matmul ``y = x @ W.T`` on NHWC tensors, with
a plain weight or LU-decomposed, as the JAX package's ``hcflow_tpu/ops/invconv.py``.

The LU parametrisation ``W = P L (U + diag(sign_s * exp(log_s)))`` makes the logdet
``sum(log_s)``; P and sign_s come from the init and, as in the JAX package, are
params like the others.  All products here are float32: the invertible path must
round-trip.
"""

from __future__ import annotations

import scipy.linalg
import torch

from . import nets


def _orthogonal(generator: torch.Generator, num_channels: int) -> torch.Tensor:
    g = torch.randn(num_channels, num_channels, generator=generator, dtype=torch.float64)
    return torch.linalg.qr(g)[0]


def init(generator: torch.Generator, num_channels: int) -> dict:
    """Random orthogonal init (QR of a Gaussian), as in Glow."""
    return {"weight": _orthogonal(generator, num_channels).float()}


def init_lu(generator: torch.Generator, num_channels: int) -> dict:
    """The LU parametrisation of a random orthogonal weight (scipy's ``lu``, as the
    JAX package factors it)."""
    p, l, u = scipy.linalg.lu(_orthogonal(generator, num_channels).numpy())
    s = torch.from_numpy(u.diagonal().copy())
    return {"p": torch.from_numpy(p).float(), "sign_s": torch.sign(s).float(),
            "l": torch.from_numpy(l).float(), "log_s": torch.log(s.abs()).float(),
            "u": torch.from_numpy(u).triu(1).float()}


def _apply(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    with nets.exact_f32():
        return torch.einsum("bhwi,oi->bhwo", x, w)


def _lu_weight(params: dict):
    """(L with a unit diagonal, U with diag(sign_s * exp(log_s)))."""
    c = params["l"].shape[0]
    l_mask = torch.tril(torch.ones(c, c, dtype=params["l"].dtype, device=params["l"].device), -1)
    l = params["l"] * l_mask + torch.eye(c, dtype=l_mask.dtype, device=l_mask.device)
    u = params["u"] * l_mask.T + torch.diag(params["sign_s"] * torch.exp(params["log_s"]))
    return l, u


def precompute(params: dict) -> dict:
    """Attach the inverse weight and log|det W| once, out of the hot path; an LU
    invconv is left as it is (its logdet is already a sum)."""
    if "weight" not in params:
        return params
    w = params["weight"]
    return {**params, "w_inv": torch.linalg.inv(w), "logdet_w": torch.linalg.slogdet(w)[1]}


def _logdet_w(params: dict) -> torch.Tensor:
    if "weight" not in params:
        return params["log_s"].sum()
    ld_w = params.get("logdet_w")
    return torch.linalg.slogdet(params["weight"])[1] if ld_w is None else ld_w


def forward(params: dict, x: torch.Tensor, logdet=None):
    if "weight" in params:
        w = params["weight"]
    else:
        l, u = _lu_weight(params)
        with nets.exact_f32():
            w = params["p"] @ l @ u
    y = _apply(w, x)
    if logdet is not None:
        logdet = logdet + _logdet_w(params) * (x.shape[1] * x.shape[2])
    return y, logdet


def inverse(params: dict, y: torch.Tensor, logdet=None):
    if "weight" in params:
        w_inv = params.get("w_inv")
        if w_inv is None:
            w_inv = torch.linalg.inv(params["weight"])
    else:
        l, u = _lu_weight(params)
        with nets.exact_f32():
            w_inv = torch.linalg.inv(u) @ torch.linalg.inv(l) @ torch.linalg.inv(params["p"])
    x = _apply(w_inv, y)
    if logdet is not None:
        logdet = logdet - _logdet_w(params) * (y.shape[1] * y.shape[2])
    return x, logdet
