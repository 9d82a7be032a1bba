"""Host-side image IO, augmentation and color-space helpers.

A copy of the JAX package's ``hcflow_tpu/data/util.py`` (numpy and OpenCV only), kept
here so that the port needs no JAX: the reference's read_img, augment, modcrop and
bgr2ycbcr/channel_convert.  Images here are HWC **RGB** float32 in [0,1] (the NHWC
convention of both packages); the reference's internal BGR convention is confined to
the cv2 boundary.
"""

from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".tif", ".npy")


def scan_images(root: str) -> List[str]:
    assert os.path.isdir(root), f"{root} is not a valid directory"
    paths = []
    for dirpath, _, fnames in sorted(os.walk(root)):
        for f in sorted(fnames):
            if f.lower().endswith(IMG_EXTENSIONS):
                paths.append(os.path.join(dirpath, f))
    assert paths, f"{root} has no valid image file"
    return paths


def read_img(path: str) -> np.ndarray:
    """Read an image file (or .npy) -> HWC RGB float32 [0,1]; gray -> 3ch, alpha dropped."""
    if path.endswith(".npy"):
        img = np.load(path)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
    else:
        import cv2

        raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert raw is not None, f"failed to read {path}"
        if raw.dtype == np.uint16:
            img = raw.astype(np.float32) / 65535.0
        else:
            img = raw.astype(np.float32) / 255.0
        if img.ndim == 2:
            img = img[:, :, None]
        if img.shape[2] == 4:
            img = img[:, :, :3]
        if img.shape[2] == 3:
            img = img[:, :, ::-1]  # BGR (cv2) -> RGB
    if img.ndim == 2:
        img = img[:, :, None]
    if img.shape[2] == 1:
        img = np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def modcrop(img: np.ndarray, scale: int) -> np.ndarray:
    h, w = img.shape[:2]
    return img[: h - h % scale, : w - w % scale]


def augment(imgs: Sequence[np.ndarray], hflip: bool, rot: bool, rng: np.random.Generator):
    """Joint random horizontal flip / vertical flip / transpose (data/util.py:116-135)."""
    do_hflip = hflip and rng.random() < 0.5
    do_vflip = rot and rng.random() < 0.5
    do_rot90 = rot and rng.random() < 0.5

    def _aug(img):
        if do_hflip:
            img = img[:, ::-1]
        if do_vflip:
            img = img[::-1]
        if do_rot90:
            img = img.transpose(1, 0, 2)
        return np.ascontiguousarray(img)

    return [_aug(i) for i in imgs]


def paired_random_crop(
    hr: np.ndarray, lr: np.ndarray, gt_size: int, scale: int, rng: np.random.Generator
):
    """LR-grid-aligned paired crop (GT_dataset.py:85-100)."""
    lr_size = gt_size // scale
    h, w = lr.shape[:2]
    y = int(rng.integers(0, max(h - lr_size, 0) + 1))
    x = int(rng.integers(0, max(w - lr_size, 0) + 1))
    lr_c = lr[y : y + lr_size, x : x + lr_size]
    hr_c = hr[y * scale : y * scale + gt_size, x * scale : x * scale + gt_size]
    return hr_c, lr_c


def rgb2ycbcr(img: np.ndarray, only_y: bool = True) -> np.ndarray:
    """ITU-R BT.601 full-swing, matching the reference's bgr2ycbcr on RGB input.

    img: HWC RGB float [0,1]; output in [0,1] (Y in [16/255, 235/255]).
    """
    in_type = img.dtype
    img = img.astype(np.float64) * 255.0
    if only_y:
        out = np.dot(img, [65.481, 128.553, 24.966]) / 255.0 + 16.0
    else:
        out = (
            np.matmul(
                img,
                np.array(
                    [
                        [65.481, -37.797, 112.0],
                        [128.553, -74.203, -93.786],
                        [24.966, 112.0, -18.214],
                    ]
                )
                / 255.0,
            )
            + [16, 128, 128]
        )
    return (out / 255.0).astype(in_type)


def rgb2gray(img: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma (cv2 BGR2GRAY weights, RGB order): 0.299R+0.587G+0.114B."""
    in_type = img.dtype
    out = np.dot(img.astype(np.float64), [0.299, 0.587, 0.114])
    return out.astype(in_type)


def channel_convert(in_c: int, tar_type: str, img_list):
    """Color-space conversion for the dataset ``color:`` option.

    Behavioral reference: codes/data/util.py:171-182 (conversion among color, gray
    and y) — operating here on RGB images (the reference converts BGR; its
    bgr2ycbcr on BGR equals rgb2ycbcr on RGB, and the gray weights likewise).
    Returns HWC arrays: 'gray'/'y' produce 1-channel, 'RGB' on gray replicates.
    """
    if in_c == 3 and tar_type == "gray":
        return [np.expand_dims(rgb2gray(im), axis=2) for im in img_list]
    if in_c == 3 and tar_type == "y":
        return [np.expand_dims(rgb2ycbcr(im, only_y=True), axis=2) for im in img_list]
    if in_c == 1 and tar_type == "RGB":
        return [np.repeat(im if im.ndim == 3 else im[..., None], 3, axis=2)
                for im in img_list]
    return list(img_list)


def img_to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def save_img(path: str, img: np.ndarray) -> None:
    """Save an HWC RGB float [0,1] image as PNG."""
    import cv2

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    cv2.imwrite(path, img_to_uint8(img)[:, :, ::-1])
