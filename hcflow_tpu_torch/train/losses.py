"""Pixel losses, as ``hcflow_tpu/train/losses.py``."""

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
