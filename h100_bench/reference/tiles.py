"""The tiled serving protocol, written plainly: the predictor's tile plan and blend.

An LR image (H, W, C) is first reflect-padded to even sides (the predictor's LR
convention; the HR is cropped back at the end).  Tiles of ``tile`` x ``tile`` LR pixels
start every ``tile - 2 * overlap`` pixels along each side, as many as cover the image
less one overlap at each end; the image is reflect-padded at the bottom and right so
that the last tiles are whole.  The tiles, in row-major order, go through the model
``batch`` at a time, the last batch filled up with zero tiles.  The HR canvas takes each
tile in order, later tiles writing over earlier ones, each tile less its first
``overlap * scale`` rows (columns) where it is not in the first row (column).
"""

from __future__ import annotations

import math

import numpy as np


def plan(h: int, w: int, tile: int, overlap: int):
    """(tile origins in row-major order, bottom padding, right padding)."""
    stride = tile - 2 * overlap
    ny = max(1, math.ceil((h - 2 * overlap) / stride))
    nx = max(1, math.ceil((w - 2 * overlap) / stride))
    origins = [(iy * stride, ix * stride) for iy in range(ny) for ix in range(nx)]
    return origins, max(0, (ny - 1) * stride + tile - h), max(0, (nx - 1) * stride + tile - w)


def tiled(run_batch, lr: np.ndarray, scale: int, tile: int, overlap: int, batch: int):
    """HR (H * scale, W * scale, C) float32 from ``run_batch(b, tiles)``, which maps the
    b-th batch of LR tiles (N, tile, tile, C) to its HR tiles (N, tile * s, tile * s, C)."""
    h0, w0 = lr.shape[:2]
    lr = np.pad(lr, ((0, h0 % 2), (0, w0 % 2), (0, 0)), mode="reflect")
    h, w, c = lr.shape
    if h <= tile and w <= tile:
        return run_batch(0, lr[None])[0][: h0 * scale, : w0 * scale]
    origins, ph, pw = plan(h, w, tile, overlap)
    lr = np.pad(lr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
    tiles = [lr[y: y + tile, x: x + tile] for y, x in origins]
    hr_tiles = []
    for b, i in enumerate(range(0, len(tiles), batch)):
        chunk = tiles[i: i + batch]
        chunk += [np.zeros_like(tiles[0])] * (batch - len(chunk))
        hr_tiles.extend(run_batch(b, np.stack(chunk))[: min(batch, len(tiles) - i)])
    canvas = np.zeros(((h + ph) * scale, (w + pw) * scale, c), np.float32)
    s_tile, s_ov = tile * scale, overlap * scale
    for (y, x), t in zip(origins, hr_tiles):
        y0, x0 = (0 if y == 0 else s_ov), (0 if x == 0 else s_ov)
        canvas[y * scale + y0: y * scale + s_tile, x * scale + x0: x * scale + s_tile] = t[y0:, x0:]
    return canvas[: h0 * scale, : w0 * scale]
