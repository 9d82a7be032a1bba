"""Offline data prep: PNG -> .npy trees and paired HR/LR crop pickles (.pklv4).

The counterpart of the JAX package's ``hcflow_tpu/cli/prepare_data.py`` (the
reference's scripts/png2npy.py and prepare_data_pkl.py): the same files from the same
images, host-side numpy only.

Usage:
  python -m hcflow_tpu_torch.cli.prepare_data png2npy --input DIR --output DIR
  python -m hcflow_tpu_torch.cli.prepare_data pkl --input DIR --output DIR \\
      [--crops 47 --size 160 --scales 4 8 --subset_frac 0.01]
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..data.imresize import imresize
from ..data.util import img_to_uint8, read_img, scan_images


def png2npy(input_dir: str, output_dir: str) -> int:
    """Every image under input_dir as a uint8 HWC .npy at the same relative path."""
    paths = scan_images(input_dir)
    os.makedirs(output_dir, exist_ok=True)
    for p in paths:
        img = img_to_uint8(read_img(p))
        rel = os.path.relpath(p, input_dir)
        out = os.path.join(output_dir, os.path.splitext(rel)[0] + ".npy")
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        np.save(out, img)
    return len(paths)


def prepare_pkl(
    input_dir: str,
    output_dir: str,
    crops_per_image: int = 47,
    crop_size: int = 160,
    scales=(4,),
    subset_frac: float = 0.01,
    seed: int = 0,
    augment: bool = False,
    zooms=(1.0,),
) -> dict:
    """Random HR crops and their MATLAB-bicubic LR counterparts -> .pklv4 files (lists
    of HWC uint8): ``tr.pklv4``, ``tr_X<s>.pklv4`` per scale and their first
    ``subset_frac`` as ``*_sub<frac>.pklv4``.  ``augment``/``zooms``: each crop from a
    random bicubic zoom of its image, with a random flip/rot90 (the JAX package's
    extension).  Returns {file name: number of crops}."""
    rng = np.random.default_rng(seed)
    paths = scan_images(input_dir)
    os.makedirs(output_dir, exist_ok=True)
    zooms = tuple(zooms) or (1.0,)
    hr_crops = []
    for p in paths:
        base = read_img(p)
        zoomed = [base if z == 1.0 else np.clip(imresize(base, z), 0, 1) for z in zooms]
        for _ in range(crops_per_image):
            img = zoomed[int(rng.integers(0, len(zoomed)))] if augment else zoomed[0]
            h, w = img.shape[:2]
            if h < crop_size or w < crop_size:
                continue
            y = int(rng.integers(0, h - crop_size + 1))
            x = int(rng.integers(0, w - crop_size + 1))
            c = img[y : y + crop_size, x : x + crop_size]
            if augment:
                c = np.rot90(c, int(rng.integers(0, 4)))
                if rng.integers(0, 2):
                    c = c[:, ::-1]
            hr_crops.append(img_to_uint8(np.ascontiguousarray(c)))

    out = {}

    def dump(name, data):
        with open(os.path.join(output_dir, name), "wb") as f:
            pickle.dump(data, f, protocol=4)
        out[name] = len(data)

    dump("tr.pklv4", hr_crops)
    n_sub = max(1, int(len(hr_crops) * subset_frac))
    dump(f"tr_sub{subset_frac}.pklv4", hr_crops[:n_sub])
    for s in scales:
        lr = [img_to_uint8(np.clip(imresize(c.astype(np.float32) / 255.0, 1.0 / s), 0, 1))
              for c in hr_crops]
        dump(f"tr_X{s}.pklv4", lr)
        dump(f"tr_X{s}_sub{subset_frac}.pklv4", lr[:n_sub])
    return out


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    p1 = sub.add_parser("png2npy")
    p1.add_argument("--input", required=True)
    p1.add_argument("--output", required=True)
    p2 = sub.add_parser("pkl")
    p2.add_argument("--input", required=True)
    p2.add_argument("--output", required=True)
    p2.add_argument("--crops", type=int, default=47)
    p2.add_argument("--size", type=int, default=160)
    p2.add_argument("--scales", type=int, nargs="+", default=[4])
    p2.add_argument("--subset_frac", type=float, default=0.01)
    p2.add_argument("--augment", action="store_true",
                    help="random dihedral + zoom variants per crop")
    p2.add_argument("--zooms", type=float, nargs="+", default=[1.0])
    args = parser.parse_args(argv)
    if args.cmd == "png2npy":
        print(f"converted {png2npy(args.input, args.output)} images")
    else:
        out = prepare_pkl(args.input, args.output, args.crops, args.size, tuple(args.scales),
                          args.subset_frac, augment=args.augment, zooms=tuple(args.zooms))
        for k, v in out.items():
            print(f"{k}: {v} crops")


if __name__ == "__main__":
    main()
