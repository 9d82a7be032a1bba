"""Diagonal Gaussian and Laplace densities over NHWC feature maps."""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)
LOG_2 = math.log(2.0)


def gaussian_likelihood(mean, logs, x):
    """Elementwise log N(x; mean, exp(logs)^2)."""
    return -0.5 * (logs * 2.0 + ((x - mean) ** 2) * torch.exp(-2.0 * logs) + LOG_2PI)


def gaussian_logp(mean, logs, x):
    """Sum of the elementwise log-likelihood over (H, W, C); shape (B,)."""
    return gaussian_likelihood(mean, logs, x).sum(dim=(1, 2, 3))


def gaussian_sample(generator, mean, logs, eps_std, mesh=None) -> torch.Tensor:
    """mean + exp(logs) * eps with eps ~ N(0, eps_std^2), drawn from ``generator``
    (a generator on the device of ``mean``, or None for the global one).  Under a
    ``mesh`` (``parallel.mesh.Mesh``) mean is this rank's part: eps is drawn for the
    whole batch and image and this rank takes its part, so that a seed gives the same
    image however the ranks split it."""
    kw = dict(generator=generator, device=mean.device, dtype=mean.dtype)
    eps = torch.randn(mean.shape, **kw) if mesh is None else mesh.draw(torch.randn, mean.shape,
                                                                         **kw)
    return mean + torch.exp(logs) * (eps * eps_std)


def laplace_likelihood(mean, logs, x):
    """Elementwise log Laplace(x; mean, exp(logs)); mean and logs None: the standard one."""
    if mean is None and logs is None:
        return -(x.abs() + LOG_2)
    return -(logs + (x - mean).abs() * torch.exp(-logs) + LOG_2)


def laplace_logp(mean, logs, x):
    """Sum of the elementwise Laplace log-likelihood over (H, W, C); shape (B,)."""
    return laplace_likelihood(mean, logs, x).sum(dim=(1, 2, 3))
