"""Pixel and GAN losses, as ``hcflow_tpu/train/losses.py`` (the reference's loss.py:
pixel and feature criteria, the GAN criterion on raw logits for gan / ragan / lsgan /
wgangp, and the WGAN-GP gradient penalty)."""

from __future__ import annotations

import torch


def l1(pred, target):
    return (pred - target).abs().mean()


def l2(pred, target):
    return ((pred - target) ** 2).mean()


def charbonnier(pred, target, eps: float = 1e-6):
    return torch.sqrt((pred - target) ** 2 + eps).mean()


def pixel_criterion(name: str):
    return {"l1": l1, "l2": l2, "cb": charbonnier}[name]


# ------------------------------------------------------------------- GAN losses
def _bce_with_logits(logits, target: float):
    # stable: max(x, 0) - x * t + log(1 + exp(-|x|))
    return (logits.clamp(min=0.0) - logits * target
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def gan_loss(gan_type: str, logits, target_is_real: bool):
    """Discriminator / generator criterion on raw logits (the reference's loss.py)."""
    t = 1.0 if target_is_real else 0.0
    if gan_type in ("gan", "ragan"):
        return _bce_with_logits(logits, t)
    if gan_type == "lsgan":
        return ((logits - t) ** 2).mean()
    if gan_type == "wgangp":
        return -logits.mean() if target_is_real else logits.mean()
    raise NotImplementedError(f"GAN type {gan_type} is not implemented")


def gradient_penalty(d_apply, d_params, real, fake, generator=None, alpha=None):
    """WGAN-GP gradient penalty on random interpolates of real and fake (NHWC).

    ``alpha`` (B, 1, 1, 1) gives the interpolation weights explicitly; else they are
    drawn uniform from ``generator`` (on real's device).  Differentiable in
    ``d_params``: the input gradient is taken with ``create_graph=True``."""
    if alpha is None:
        alpha = torch.rand((real.shape[0], 1, 1, 1), generator=generator, device=real.device,
                           dtype=real.dtype)
    interp = (real * alpha + fake * (1.0 - alpha)).detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(d_params, interp).sum(), interp, create_graph=True)
    norms = torch.sqrt((grads ** 2).sum(dim=(1, 2, 3)) + 1e-12)
    return ((norms - 1.0) ** 2).mean()
