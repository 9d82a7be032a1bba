"""Volume-preserving spatial reshuffles on NHWC tensors: checkerboard squeeze and Haar.

- squeeze: output channel index ``c * f * f + fh * f + fw`` (channel-major);
- haar: output channel index ``k * C + c`` (filter-major), the four Haar filters k in
  the order (LL, -cols, -rows, -diag), scaled by 1/4 on the forward pass.

Both orders are the ones the JAX package and the reference checkpoints use.
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


def haar_squeeze2d(x: torch.Tensor) -> torch.Tensor:
    """Orthogonal Haar downsampling: (B,H,W,C) -> (B,H/2,W/2,4C), filter-major."""
    B, H, W, C = x.shape
    if H % 2 or W % 2:
        raise ValueError(f"spatial size {(H, W)} is not even")
    b = x.reshape(B, H // 2, 2, W // 2, 2, C)
    x00, x01 = b[:, :, 0, :, 0], b[:, :, 0, :, 1]
    x10, x11 = b[:, :, 1, :, 0], b[:, :, 1, :, 1]
    f = [
        (x00 + x01 + x10 + x11) * 0.25,
        (x00 - x01 + x10 - x11) * 0.25,
        (x00 + x01 - x10 - x11) * 0.25,
        (x00 - x01 - x10 + x11) * 0.25,
    ]
    return torch.stack(f, 3).reshape(B, H // 2, W // 2, 4 * C)


def haar_unsqueeze2d(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`haar_squeeze2d`."""
    B, H, W, C4 = x.shape
    if C4 % 4:
        raise ValueError(f"{C4} channels are not divisible by 4")
    f0, f1, f2, f3 = x.reshape(B, H, W, 4, C4 // 4).unbind(3)
    rows = [
        torch.stack([f0 + f1 + f2 + f3, f0 - f1 + f2 - f3], 3),  # x00, x01
        torch.stack([f0 + f1 - f2 - f3, f0 - f1 - f2 + f3], 3),  # x10, x11
    ]
    out = torch.stack(rows, 2)  # (B, H, 2, W, 2, C)
    return out.reshape(B, H * 2, W * 2, C4 // 4)


def nearest_upsample(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Nearest-neighbour upsample on NHWC."""
    return x.repeat_interleave(factor, dim=1).repeat_interleave(factor, dim=2)
