"""Volume-preserving checkerboard squeeze on NHWC tensors.

Output channel index of :func:`squeeze2d` is ``c * f * f + fh * f + fw`` (channel-major),
the order the JAX package and the reference checkpoints use.
"""

from __future__ import annotations

import torch


def squeeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Space-to-depth: (B,H,W,C) -> (B,H/f,W/f,C*f*f)."""
    if factor == 1:
        return x
    B, H, W, C = x.shape
    if H % factor or W % factor:
        raise ValueError(f"spatial size {(H, W)} is not divisible by {factor}")
    x = x.reshape(B, H // factor, factor, W // factor, factor, C)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (B, H/f, W/f, C, fh, fw)
    return x.reshape(B, H // factor, W // factor, C * factor * factor)


def unsqueeze2d(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Depth-to-space; inverse of :func:`squeeze2d`."""
    if factor == 1:
        return x
    B, H, W, C = x.shape
    f2 = factor * factor
    if C % f2:
        raise ValueError(f"{C} channels are not divisible by {f2}")
    x = x.reshape(B, H, W, C // f2, factor, factor)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (B, H, fh, W, fw, C')
    return x.reshape(B, H * factor, W * factor, C // f2)


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample on NHWC."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
