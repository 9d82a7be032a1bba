"""Evaluation metrics: PSNR / MATLAB-equivalent SSIM (+Y-channel), sample diversity.

A copy of the JAX package's ``hcflow_tpu/utils/metrics.py`` (numpy and scipy only),
kept here so that the port needs no JAX.  It follows the reference's utils/util.py
(calculate_psnr, ssim/calculate_ssim with the 11x11 sigma-1.5 Gaussian window,
calculate_psnr_ssim) and test_HCFlow.py (diversity = mean pixel std over samples).

Inputs are HWC **RGB** float [0,1] numpy images; internally scaled to [0,255] float64
as the reference does.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

from ..data.util import rgb2ycbcr


def calculate_psnr(img1: np.ndarray, img2: np.ndarray) -> float:
    """PSNR on [0,255]-scale inputs (pass *255 like the reference call sites)."""
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    mse = np.mean((img1 - img2) ** 2)
    if mse == 0:
        return float("inf")
    return 20 * math.log10(255.0 / math.sqrt(mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    # cv2.getGaussianKernel-equivalent 1-D kernel, outer-product window
    ax = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(ax**2) / (2.0 * sigma**2))
    k /= k.sum()
    return np.outer(k, k)


def _filter2d_same(img: np.ndarray, window: np.ndarray) -> np.ndarray:
    """cv2.filter2D(borderType=REFLECT_101)-equivalent correlation."""
    from scipy.ndimage import correlate

    return correlate(img, window, mode="mirror")


def _ssim_single(img1: np.ndarray, img2: np.ndarray) -> float:
    c1 = (0.01 * 255) ** 2
    c2 = (0.03 * 255) ** 2
    img1 = img1.astype(np.float64)
    img2 = img2.astype(np.float64)
    window = _gaussian_window()
    mu1 = _filter2d_same(img1, window)[5:-5, 5:-5]
    mu2 = _filter2d_same(img2, window)[5:-5, 5:-5]
    mu1_sq, mu2_sq, mu1_mu2 = mu1**2, mu2**2, mu1 * mu2
    sigma1_sq = _filter2d_same(img1**2, window)[5:-5, 5:-5] - mu1_sq
    sigma2_sq = _filter2d_same(img2**2, window)[5:-5, 5:-5] - mu2_sq
    sigma12 = _filter2d_same(img1 * img2, window)[5:-5, 5:-5] - mu1_mu2
    ssim_map = ((2 * mu1_mu2 + c1) * (2 * sigma12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (sigma1_sq + sigma2_sq + c2)
    )
    return float(ssim_map.mean())


def calculate_ssim(img1: np.ndarray, img2: np.ndarray) -> float:
    """MATLAB-equivalent SSIM on [0,255]-scale images; mean over channels if RGB."""
    if img1.shape != img2.shape:
        raise ValueError("Input images must have the same dimensions.")
    if img1.ndim == 2:
        return _ssim_single(img1, img2)
    if img1.ndim == 3 and img1.shape[2] == 3:
        return float(np.mean([_ssim_single(img1[:, :, i], img2[:, :, i]) for i in range(3)]))
    if img1.ndim == 3 and img1.shape[2] == 1:
        return _ssim_single(img1[:, :, 0], img2[:, :, 0])
    raise ValueError("Wrong input image dimensions.")


def calculate_psnr_ssim(img1: np.ndarray, img2: np.ndarray, crop_border: int = 0):
    """(psnr, ssim, psnr_y, ssim_y) on HWC RGB float [0,1] images (reference util.py)."""
    if crop_border:
        img1c = img1[crop_border:-crop_border, crop_border:-crop_border]
        img2c = img2[crop_border:-crop_border, crop_border:-crop_border]
    else:
        img1c, img2c = img1, img2
    psnr = calculate_psnr(img1c * 255, img2c * 255)
    ssim = calculate_ssim(img1c * 255, img2c * 255)
    psnr_y = ssim_y = 0.0
    if img2.ndim == 3 and img2.shape[2] == 3:
        y1 = rgb2ycbcr(img1, only_y=True)
        y2 = rgb2ycbcr(img2, only_y=True)
        if crop_border:
            y1 = y1[crop_border:-crop_border, crop_border:-crop_border]
            y2 = y2[crop_border:-crop_border, crop_border:-crop_border]
        psnr_y = calculate_psnr(y1 * 255, y2 * 255)
        ssim_y = calculate_ssim(y1 * 255, y2 * 255)
    return psnr, ssim, psnr_y, ssim_y


def diversity(samples: Sequence[np.ndarray]) -> float:
    """Mean per-pixel std over a set of samples (reference test_HCFlow.py), on [0,255]."""
    stack = np.stack([s.astype(np.float64) * 255 for s in samples], axis=0)
    return float(np.mean(np.std(stack, axis=0)))
