"""Dataset classes: GT (on-the-fly bicubic LR), paired GT/LQ variants, LQ-only, pkl/npy.

The counterpart of the JAX package's ``hcflow_tpu/data/datasets.py`` (numpy only), with
the same classes, items and randomness, after the reference's
data/{GT,GTLQ,GTLQx,GTLQnpy,LQ,LRHR_PKL}_dataset.py.  All items are dicts of HWC RGB
float32 [0,1] numpy arrays with keys 'GT'/'LQ' plus their source paths; training items
are paired-cropped (LR-grid aligned) and flip/rot augmented; val/test items are
modcropped.

Randomness is an explicit per-item ``np.random.Generator`` seeded from (seed, epoch,
index), so the item stream does not depend on global RNG state or on which process
decodes it.  A dataset pickles (its image sources are objects, not closures), so the
loader's worker processes can be started with ``spawn``.
"""

from __future__ import annotations

import os
import pickle
import numpy as np

from .imresize import imresize
from .util import (augment, channel_convert, modcrop, paired_random_crop,
                   read_img, scan_images)


class _PathReader:
    """Reads image i of a list of paths."""

    def __init__(self, paths):
        self.paths = paths

    def __call__(self, i: int) -> np.ndarray:
        return read_img(self.paths[i])


class _LmdbReader:
    """Reads image i of an LMDB root: flat BGR uint8 buffers keyed by name (listed in
    meta_info.pkl), opened lazily as the reference does (GTLQ_dataset.py) and converted
    to the RGB float [0,1] convention at this boundary.  The open reader is not
    pickled: a copy reopens it."""

    def __init__(self, root: str):
        from .lmdb_backend import paths_from_lmdb

        self.root = root
        self.keys, self._sizes = paths_from_lmdb(root)
        self._reader = None

    def __getstate__(self):
        return {**self.__dict__, "_reader": None}

    def __call__(self, i: int) -> np.ndarray:
        if self._reader is None:
            from .lmdb_backend import LmdbReader

            self._reader = LmdbReader(self.root)
        img = self._reader.read(self.keys[i], self._sizes[i]).astype(np.float32) / 255.0
        if img.shape[2] == 1:
            img = np.repeat(img, 3, axis=2)
        return np.ascontiguousarray(img[:, :, ::-1])  # BGR -> RGB


def _image_source(opt: dict, root_key: str):
    """(names, read_fn) for a dataroot, honoring ``data_type: lmdb``: LMDB keys, or the
    image files under the folder."""
    root = opt[root_key]
    if opt.get("data_type") == "lmdb":
        src = _LmdbReader(root)
        return src.keys, src
    paths = scan_images(root)
    return paths, _PathReader(paths)


class _Base:
    def __init__(self, opt: dict):
        self.opt = opt
        self.phase = opt.get("phase", "train")
        self.scale = opt.get("scale", 4)
        self.gt_size = opt.get("GT_size", 160)
        self.use_flip = bool(opt.get("use_flip", False))
        self.use_rot = bool(opt.get("use_rot", False))
        self.seed = opt.get("seed", 0)
        self.color = opt.get("color")  # optional 'gray'/'y'/'RGB' channel_convert
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.epoch, index])

    def _train_pair(self, hr, lr, rng):
        hr, lr = paired_random_crop(hr, lr, self.gt_size, self.scale, rng)
        hr, lr = augment([hr, lr], self.use_flip, self.use_rot, rng)
        return hr, lr

    def _finish(self, item: dict) -> dict:
        """Apply the optional ``color:`` conversion to image entries
        (GT_dataset.py:100-103: channel_convert after augmentation)."""
        if self.color:
            for k in ("GT", "LQ"):
                if k in item:
                    item[k] = channel_convert(item[k].shape[2], self.color,
                                              [item[k]])[0].astype(np.float32)
        return item


class GTDataset(_Base):
    """HR images only; LR generated on the fly with MATLAB bicubic (GT_dataset.py:82)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.gt_paths, self._read_gt = _image_source(opt, "dataroot_GT")
        if opt.get("n_max"):
            self.gt_paths = self.gt_paths[: opt["n_max"]]

    def __len__(self):
        return len(self.gt_paths)

    def __getitem__(self, index):
        rng = self._rng(index)
        hr = self._read_gt(index)
        hr = modcrop(hr, self.scale)
        lr = imresize(hr, 1.0 / self.scale)
        if self.phase == "train":
            hr, lr = self._train_pair(hr, lr, rng)
        return self._finish({"GT": hr, "LQ": np.clip(lr, 0, 1),
                             "GT_path": self.gt_paths[index],
                             "LQ_path": self.gt_paths[index]})


class GTLQDataset(_Base):
    """Paired HR/LR from two directories (GTLQ_dataset.py)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.gt_paths, self._read_gt = _image_source(opt, "dataroot_GT")
        self.lq_paths, self._read_lq = _image_source(opt, "dataroot_LQ")
        assert len(self.gt_paths) == len(self.lq_paths), (
            len(self.gt_paths), len(self.lq_paths))
        if opt.get("n_max"):
            self.gt_paths = self.gt_paths[: opt["n_max"]]
            self.lq_paths = self.lq_paths[: opt["n_max"]]

    def __len__(self):
        return len(self.gt_paths)

    def __getitem__(self, index):
        rng = self._rng(index)
        hr = self._read_gt(index)
        lr = self._read_lq(index)
        if self.phase == "train":
            hr, lr = self._train_pair(hr, lr, rng)
        else:
            hr = modcrop(hr, self.scale)
            lr = lr[: hr.shape[0] // self.scale, : hr.shape[1] // self.scale]
        return self._finish({"GT": hr, "LQ": lr, "GT_path": self.gt_paths[index],
                             "LQ_path": self.lq_paths[index]})


class GTLQxDataset(GTLQDataset):
    """Paired, with the LR path derived by convention (GTLQx_dataset.py:84):
    ``<GT path with HR->LR_bicubic/X{scale}>/<name>x{scale}.png``."""

    def __init__(self, opt: dict):
        _Base.__init__(self, opt)
        self.gt_paths = scan_images(opt["dataroot_GT"])
        scale = self.scale
        self.lq_paths = [
            p.replace("HR", f"LR_bicubic/X{scale}").replace(".png", f"x{scale}.png")
            for p in self.gt_paths
        ]
        if opt.get("dataroot_LQ"):
            # fall back to the explicit LQ root when the convention path is missing
            self.lq_paths = [
                lp if os.path.isfile(lp)
                else os.path.join(opt["dataroot_LQ"],
                                  os.path.basename(gp).replace(".png", f"x{scale}.png"))
                for lp, gp in zip(self.lq_paths, self.gt_paths)
            ]
        self._read_gt = _PathReader(self.gt_paths)
        self._read_lq = _PathReader(self.lq_paths)


class GTLQnpyDataset(GTLQDataset):
    """Paired .npy arrays for fast decode (GTLQnpy_dataset.py)."""


class LQDataset(_Base):
    """LR only (real-world inference, no GT) — LQ_dataset.py."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        self.lq_paths, self._read_lq = _image_source(opt, "dataroot_LQ")

    def __len__(self):
        return len(self.lq_paths)

    def __getitem__(self, index):
        lr = self._read_lq(index)
        return self._finish({"LQ": lr, "LQ_path": self.lq_paths[index]})


class LRHRPKLDataset(_Base):
    """Entire .pklv4 pickles of HWC uint8 crops loaded into RAM — the recommended fast
    training path (LRHR_PKL_dataset.py:50-91)."""

    def __init__(self, opt: dict):
        super().__init__(opt)
        n_max = opt.get("n_max") or int(1e8)
        self.hr_images = self._load(opt["dataroot_GT"], n_max)
        self.lr_images = self._load(opt["dataroot_LQ"], n_max)
        assert len(self.hr_images) == len(self.lr_images)
        self.use_crop = bool(opt.get("use_crop", False))

    @staticmethod
    def _load(path, n_max):
        assert os.path.isfile(path), path
        with open(path, "rb") as f:
            images = pickle.load(f)
        assert len(images) > 0, path
        return images[:n_max]

    def __len__(self):
        return len(self.hr_images)

    def __getitem__(self, index):
        rng = self._rng(index)
        hr = self.hr_images[index]
        lr = self.lr_images[index]
        hr = (hr.astype(np.float32) / 255.0) if hr.dtype == np.uint8 else hr.astype(np.float32)
        lr = (lr.astype(np.float32) / 255.0) if lr.dtype == np.uint8 else lr.astype(np.float32)
        if self.phase == "train":
            if self.use_crop:
                hr, lr = paired_random_crop(hr, lr, self.gt_size, self.scale, rng)
            hr, lr = augment([hr, lr], self.use_flip, self.use_rot, rng)
        return self._finish({"GT": hr, "LQ": lr, "GT_path": str(index),
                             "LQ_path": str(index)})


_DATASETS = {
    "GT": GTDataset,
    "GTLQ": GTLQDataset,
    "GTLQx": GTLQxDataset,
    "GTLQnpy": GTLQnpyDataset,
    "LQ": LQDataset,
    "LRHR_PKL": LRHRPKLDataset,
}


def create_dataset(dataset_opt: dict):
    """mode -> dataset dispatch (the reference's data/__init__.py), explicit registry."""
    mode = dataset_opt["mode"]
    if mode not in _DATASETS:
        raise NotImplementedError(f"Dataset [{mode}] is not recognized.")
    return _DATASETS[mode](dataset_opt)
