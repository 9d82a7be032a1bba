"""Tiled (patch-wise) inference for very large images.

The counterpart of the JAX package's ``hcflow_tpu/cli/tiled.py`` (the reference's
data/util.py test_patchwise, present but unused there): fixed-size LR tiles with
overlap are batched into one padded array and pushed through the reverse flow
together (one shape, so the kernels see full batches), then the HR tiles are blended
back with overlap cropping.  The same tile grid, reflect padding, zero-padded last
batch and blend as JAX's; the latents of successive batches come from one
``torch.Generator`` in turn, where JAX folds the batch index into its key.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def tiled_reverse(
    reverse_fn: Callable,
    params,
    lr: np.ndarray,
    scale: int,
    eps_std: float,
    generator=None,
    tile: int = 64,
    overlap: int = 8,
    batch: int = 8,
) -> np.ndarray:
    """Run the reverse flow over an arbitrarily large LR image (HWC numpy in [0,1]).

    reverse_fn(params, lr_batch, eps_std, generator) -> hr_batch, NHWC numpy in and out
    (the model's reverse on the serving device).
    """
    h, w, c = lr.shape
    if h <= tile and w <= tile:
        return np.asarray(reverse_fn(params, lr[None], eps_std, generator)[0])

    stride = tile - 2 * overlap
    ny = max(1, math.ceil((h - 2 * overlap) / stride))
    nx = max(1, math.ceil((w - 2 * overlap) / stride))

    # pad so every tile is full-size (reflect, then crop at the end)
    pad_h = max(0, (ny - 1) * stride + tile - h)
    pad_w = max(0, (nx - 1) * stride + tile - w)
    lr_pad = np.pad(lr, ((0, pad_h), (0, pad_w), (0, 0)), mode="reflect")

    coords = [(iy * stride, ix * stride) for iy in range(ny) for ix in range(nx)]
    tiles = np.stack([lr_pad[y : y + tile, x : x + tile] for y, x in coords])

    hr_tiles = []
    for i in range(0, len(tiles), batch):
        chunk = tiles[i : i + batch]
        n = len(chunk)
        if n < batch:  # every batch of one shape
            chunk = np.concatenate([chunk, np.zeros((batch - n, tile, tile, c), chunk.dtype)])
        out = reverse_fn(params, chunk, eps_std, generator)
        hr_tiles.append(np.asarray(out[:n]))
    hr_tiles = np.concatenate(hr_tiles)

    out = np.zeros(((h + pad_h) * scale, (w + pad_w) * scale, c), np.float32)
    s_tile, s_ov = tile * scale, overlap * scale
    for (y, x), t in zip(coords, hr_tiles):
        y0 = 0 if y == 0 else s_ov
        x0 = 0 if x == 0 else s_ov
        out[y * scale + y0 : y * scale + s_tile, x * scale + x0 : x * scale + s_tile] = t[
            y0:, x0:
        ]
    return out[: h * scale, : w * scale]
