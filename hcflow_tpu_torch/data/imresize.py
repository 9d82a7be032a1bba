"""MATLAB-faithful bicubic resize, expressed as two matrix multiplications.

A copy of the numpy part of the JAX package's ``hcflow_tpu/data/imresize.py`` (its
``imresize_jax`` is JAX's and stays there), kept here so that the port needs no JAX.
The algorithm is the reference's imresize / imresize_np, MATLAB's: cubic kernel (a=-0.5
Keys kernel in MATLAB's piecewise form), antialiasing (kernel stretched by 1/scale when
downscaling), weight normalization, and *symmetric* edge padding.

Instead of the reference's per-row gather loops, the whole resize is precomputed into
one dense (out_len, in_len) matrix per axis, folding the symmetric mirroring into the
matrix.  Application is then ``M_h @ img @ M_w.T``, two matrix products.  Matrices are
cached per (in_len, out_len, scale, antialias).
"""

from __future__ import annotations

import functools
import math

import numpy as np


def _cubic(x: np.ndarray) -> np.ndarray:
    ax = np.abs(x)
    ax2, ax3 = ax**2, ax**3
    return (1.5 * ax3 - 2.5 * ax2 + 1) * (ax <= 1) + (
        -0.5 * ax3 + 2.5 * ax2 - 4 * ax + 2
    ) * ((ax > 1) & (ax <= 2))


@functools.lru_cache(maxsize=256)
def resize_matrix(
    in_length: int, out_length: int, scale: float = None, antialias: bool = True
) -> np.ndarray:
    """Dense (out_length, in_length) MATLAB-bicubic resize matrix (float32).

    ``scale`` is the *requested* scale factor — MATLAB uses it (not out/in) in the
    coordinate mapping, which differs when ceil() changes the ratio.  Symmetric
    boundary handling is folded in: out = M @ x equals MATLAB imresize along one axis.
    """
    if scale is None:
        scale = out_length / in_length
    kernel_width = 4.0
    if scale < 1 and antialias:
        kernel_width /= scale

    x = np.arange(1, out_length + 1, dtype=np.float64)
    u = x / scale + 0.5 * (1 - 1 / scale)
    left = np.floor(u - kernel_width / 2)
    P = int(math.ceil(kernel_width)) + 2
    indices = left[:, None] + np.arange(P)[None, :]  # 1-based input coords
    dist = u[:, None] - indices
    if scale < 1 and antialias:
        weights = scale * _cubic(dist * scale)
    else:
        weights = _cubic(dist)
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # drop all-zero boundary columns (reference: calculate_weights_indices)
    if not np.isclose(np.sum(weights == 0, axis=0)[0], 0):
        indices, weights = indices[:, 1:], weights[:, 1:]
    if not np.isclose(np.sum(weights == 0, axis=0)[-1], 0):
        indices, weights = indices[:, :-1], weights[:, :-1]
    weights = weights / np.sum(weights, axis=1, keepdims=True)

    # fold symmetric mirroring into a dense matrix over true input coords
    m = np.zeros((out_length, in_length), np.float64)
    idx0 = indices.astype(np.int64) - 1  # 0-based, may be out of range
    for k in range(out_length):
        for p in range(idx0.shape[1]):
            e = idx0[k, p]
            if e < 0:
                e = -e - 1  # mirror of img[:sym] is reversed
            elif e >= in_length:
                e = 2 * in_length - 1 - e
            m[k, e] += weights[k, p]
    return m.astype(np.float32)


def imresize(img: np.ndarray, scale: float, antialias: bool = True) -> np.ndarray:
    """MATLAB imresize on an HWC (or HW) float numpy image; no rounding/clipping."""
    squeeze = img.ndim == 2
    if squeeze:
        img = img[:, :, None]
    in_h, in_w, c = img.shape
    out_h, out_w = int(math.ceil(in_h * scale)), int(math.ceil(in_w * scale))
    mh = resize_matrix(in_h, out_h, scale, antialias)
    mw = resize_matrix(in_w, out_w, scale, antialias)
    out = np.einsum("oh,hwc->owc", mh, img.astype(np.float32))
    out = np.einsum("pw,owc->opc", mw, out)
    return out[:, :, 0] if squeeze else out
