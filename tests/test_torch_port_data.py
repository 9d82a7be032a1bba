"""The port's data pipeline (``hcflow_tpu_torch/data``) against the JAX package's on the
same inputs: image IO, the helpers, MATLAB bicubic, every dataset mode (folders, .npy,
LMDB, pkl), the sampler and the sync, threaded and process-pool loaders.  The two are
numpy code with the same arithmetic, so every comparison is ``np.array_equal``.

Images are synthetic, written to a temp tree: smooth random images from a seed.
"""

import os
import pickle
from pathlib import Path

import numpy as np
import pytest

from hcflow_tpu import data as jdata
from hcflow_tpu.data import lmdb_backend as jlmdb
from hcflow_tpu.data import util as jutil
from hcflow_tpu.data.imresize import imresize as jimresize
from hcflow_tpu.data.imresize import resize_matrix as jresize_matrix
from hcflow_tpu_torch import data as pdata
from hcflow_tpu_torch.data import lmdb_backend as plmdb
from hcflow_tpu_torch.data import util as putil
from hcflow_tpu_torch.data.imresize import imresize, resize_matrix

SCALE = 4


def _smooth(rng, h, w):
    img = np.kron(rng.uniform(0.05, 0.95, (h // 8, w // 8, 3)), np.ones((8, 8, 1)))
    return (img + 0.03 * rng.standard_normal(img.shape)).clip(0, 1).astype(np.float32)


def _equal_items(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def _equal_batches(xs, ys):
    xs, ys = list(xs), list(ys)
    assert len(xs) == len(ys) > 0
    for a, b in zip(xs, ys):
        _equal_items(a, b)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A dataset tree: HR/ and LR_bicubic/X4/ PNG pairs (GTLQ and GTLQx names), npy
    pairs, a gray PNG, and LMDBs of the same images."""
    root = tmp_path_factory.mktemp("ds")
    rng = np.random.default_rng(0)
    for d in ("HR", "LR", f"LR_bicubic/X{SCALE}", "npy/HR", "npy/LR"):
        os.makedirs(root / d)
    hrs = []
    for i in range(5):
        hr = _smooth(rng, 48, 64 + 8 * i)
        lr = np.clip(imresize(hr, 1 / SCALE), 0, 1)
        hrs.append(hr)
        putil.save_img(str(root / "HR" / f"{i:03d}.png"), hr)
        putil.save_img(str(root / "LR" / f"{i:03d}.png"), lr)
        putil.save_img(str(root / f"LR_bicubic/X{SCALE}" / f"{i:03d}x{SCALE}.png"), lr)
        np.save(root / "npy/HR" / f"{i:03d}.npy", hr)
        np.save(root / "npy/LR" / f"{i:03d}.npy", lr)
    for name, imgs in (("HR", hrs), ("LR", [imresize(h, 1 / SCALE) for h in hrs])):
        u8 = [putil.img_to_uint8(np.clip(im, 0, 1))[:, :, ::-1] for im in imgs]  # BGR
        plmdb.write_lmdb(str(root / f"{name}.lmdb"),
                         {f"{i:03d}": im.tobytes() for i, im in enumerate(u8)},
                         [f"3_{im.shape[0]}_{im.shape[1]}" for im in u8])
    with open(root / "hr.pklv4", "wb") as f:
        pickle.dump([putil.img_to_uint8(h) for h in hrs], f)
    with open(root / "lr.pklv4", "wb") as f:
        pickle.dump([putil.img_to_uint8(np.clip(imresize(h, 1 / SCALE), 0, 1)) for h in hrs], f)
    return root


def test_read_and_save_img_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.random((13, 21, 3)).astype(np.float32)
    gray = rng.random((9, 7)).astype(np.float32)
    putil.save_img(str(tmp_path / "p.png"), img)
    jutil.save_img(str(tmp_path / "j.png"), img)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()
    back = putil.read_img(str(tmp_path / "p.png"))
    assert back.shape == img.shape and back.dtype == np.float32
    assert np.array_equal(back, putil.img_to_uint8(img).astype(np.float32) / 255.0)
    # gray, 16-bit and .npy sources decode as JAX's reader decodes them
    import cv2

    cv2.imwrite(str(tmp_path / "g.png"), putil.img_to_uint8(gray))
    cv2.imwrite(str(tmp_path / "w.png"), (img * 65535).astype(np.uint16))
    np.save(tmp_path / "u.npy", putil.img_to_uint8(img))
    for name in ("g.png", "w.png", "u.npy", "p.png"):
        a, b = putil.read_img(str(tmp_path / name)), jutil.read_img(str(tmp_path / name))
        assert a.shape[2] == 3 and a.dtype == b.dtype and np.array_equal(a, b), name


def test_image_helpers_match_jax():
    rng = np.random.default_rng(2)
    img = rng.random((24, 32, 3)).astype(np.float32)
    assert np.array_equal(putil.modcrop(img[:23, :31], SCALE), jutil.modcrop(img[:23, :31], SCALE))
    for only_y in (True, False):
        assert np.array_equal(putil.rgb2ycbcr(img, only_y), jutil.rgb2ycbcr(img, only_y))
    assert np.array_equal(putil.rgb2gray(img), jutil.rgb2gray(img))
    for in_c, tar in ((3, "gray"), (3, "y"), (1, "RGB"), (3, "RGB")):
        src = [img if in_c == 3 else img[:, :, :1]]
        got, ref = putil.channel_convert(in_c, tar, src), jutil.channel_convert(in_c, tar, src)
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    lr = imresize(img, 1 / SCALE)
    for seed in range(4):
        a = putil.paired_random_crop(img, lr, 16, SCALE, np.random.default_rng(seed))
        b = jutil.paired_random_crop(img, lr, 16, SCALE, np.random.default_rng(seed))
        a = putil.augment(list(a), True, True, np.random.default_rng(seed + 10))
        b = jutil.augment(list(b), True, True, np.random.default_rng(seed + 10))
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(putil.img_to_uint8(img * 1.2 - 0.1), jutil.img_to_uint8(img * 1.2 - 0.1))


@pytest.mark.parametrize("scale", [0.25, 0.125, 0.5, 4.0])
def test_imresize_matches_jax(scale):
    img = np.random.default_rng(3).random((37, 53, 3)).astype(np.float32)
    src = img[:9, :11] if scale > 1 else img
    assert np.array_equal(imresize(src, scale), jimresize(src, scale))
    assert np.array_equal(imresize(src[:, :, 0], scale), jimresize(src[:, :, 0], scale))
    n = src.shape[0]
    assert np.array_equal(resize_matrix(n, int(np.ceil(n * scale)), scale),
                          jresize_matrix(n, int(np.ceil(n * scale)), scale))


def _modes(root):
    """(name, dataset option) of every mode, in val and train phases."""
    train = {"phase": "train", "GT_size": 16, "use_flip": True, "use_rot": True, "seed": 3}
    pairs = {"dataroot_GT": str(root / "HR"), "dataroot_LQ": str(root / "LR")}
    return [
        ("GT_val", {"mode": "GT", "phase": "val", "dataroot_GT": str(root / "HR")}),
        ("GT_train", {"mode": "GT", **train, "dataroot_GT": str(root / "HR"), "n_max": 3}),
        ("GTLQ_val", {"mode": "GTLQ", "phase": "val", **pairs}),
        ("GTLQ_train", {"mode": "GTLQ", **train, **pairs}),
        ("GTLQ_gray", {"mode": "GTLQ", "phase": "val", "color": "gray", **pairs}),
        ("GTLQ_lmdb", {"mode": "GTLQ", **train, "data_type": "lmdb",
                       "dataroot_GT": str(root / "HR.lmdb"), "dataroot_LQ": str(root / "LR.lmdb")}),
        ("GTLQx", {"mode": "GTLQx", "phase": "val", "dataroot_GT": str(root / "HR")}),
        ("GTLQnpy", {"mode": "GTLQnpy", **train, "dataroot_GT": str(root / "npy/HR"),
                     "dataroot_LQ": str(root / "npy/LR")}),
        ("LQ", {"mode": "LQ", "phase": "test", "dataroot_LQ": str(root / "LR")}),
        ("LQ_lmdb", {"mode": "LQ", "phase": "test", "data_type": "lmdb",
                     "dataroot_LQ": str(root / "LR.lmdb")}),
        ("LRHR_PKL", {"mode": "LRHR_PKL", **train, "use_crop": True,
                      "dataroot_GT": str(root / "hr.pklv4"),
                      "dataroot_LQ": str(root / "lr.pklv4")}),
    ]


MODES = [m for m, _ in _modes(Path("."))]


@pytest.mark.parametrize("mode", MODES)
def test_dataset_items_match_jax(tree, mode):
    opt = dict(_modes(tree))[mode]
    opt["scale"] = SCALE
    ds, jds = pdata.create_dataset(dict(opt)), jdata.create_dataset(dict(opt))
    assert type(ds).__name__ == type(jds).__name__ and len(ds) == len(jds) > 0
    for epoch in (0, 1):
        ds.set_epoch(epoch)
        jds.set_epoch(epoch)
        for i in range(len(ds)):
            _equal_items(ds[i], jds[i])


def test_unknown_mode_raises():
    with pytest.raises(NotImplementedError, match="Dataset"):
        pdata.create_dataset({"mode": "nope"})


def test_lmdb_backend_matches_jax(tmp_path):
    rng = np.random.default_rng(4)
    items = {f"k{i:04d}": rng.integers(0, 256, size=int(rng.integers(1, 3000)),
                                       dtype=np.uint8).tobytes() for i in range(300)}
    port, ref = tmp_path / "p" / "db", tmp_path / "j" / "db"
    plmdb.write_lmdb(str(port), items, ["3_1_1"])
    jlmdb.write_lmdb(str(ref), items, ["3_1_1"])
    for f in ("data.mdb", "meta_info.pkl"):
        assert (port / f).read_bytes() == (ref / f).read_bytes()
    r = plmdb.PureLmdbReader(str(ref))
    assert len(r) == 300 and {k.decode(): v for k, v in r.items()} == items
    assert r.get(b"k0042") == items["k0042"] and r.get(b"missing") is None
    r.close()
    assert plmdb.paths_from_lmdb(str(ref)) == jlmdb.paths_from_lmdb(str(ref))


def test_enlarged_sampler_matches_jax():
    for ratio, replicas in ((1, 1), (20, 2), (3, 4)):
        for rank in range(replicas):
            a = pdata.EnlargedSampler(10, ratio, replicas, rank, seed=5)
            b = jdata.EnlargedSampler(10, ratio, replicas, rank, seed=5)
            assert a.total_size == b.total_size and a.per_replica == b.per_replica
            for epoch in (0, 3):
                assert np.array_equal(a.indices(epoch), b.indices(epoch))


@pytest.mark.parametrize("workers", [0, 1, 2])
def test_loader_stream_matches_jax(tree, workers):
    """The sync (0), threaded (1) and process-pool (2) streams against JAX's sync
    stream, over two epochs of a shuffled, augmented training set."""
    opt = dict(dict(_modes(tree))["GTLQ_train"], scale=SCALE, batch_size=2, n_workers=workers)
    ds, jds = pdata.create_dataset(dict(opt)), jdata.create_dataset(dict(opt))
    loader = pdata.create_dataloader(ds, opt)
    jloader = jdata.create_dataloader(jds, dict(opt, n_workers=0))
    assert loader.num_workers == workers and len(loader) == len(jloader) == 2
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        _equal_batches(loader, jloader)
    # the test loader: batch 1, in order, no workers (the JAX package's too)
    test = pdata.create_dataloader(ds, {**opt, "phase": "test"})
    assert (test.batch_size, test.shuffle, test.num_workers) == (1, False, 0)
    _equal_batches(test, jdata.create_dataloader(jds, {**opt, "phase": "test"}))


def test_loader_with_sampler_matches_jax(tree):
    opt = dict(dict(_modes(tree))["GT_train"], scale=SCALE, batch_size=4)
    ds, jds = pdata.create_dataset(dict(opt)), jdata.create_dataset(dict(opt))
    for rank in (0, 1):
        s = pdata.EnlargedSampler(len(ds), 4, 2, rank)
        js = jdata.EnlargedSampler(len(jds), 4, 2, rank)
        a = pdata.create_dataloader(ds, opt, sampler=s, num_replicas=2)
        b = jdata.create_dataloader(jds, dict(opt, n_workers=0), sampler=js, num_replicas=2)
        assert a.batch_size == b.batch_size == 2
        _equal_batches(a, b)


def test_pool_loader_raises_a_worker_error(tree):
    opt = dict(dict(_modes(tree))["GTLQ_val"], scale=SCALE)
    ds = pdata.create_dataset(opt)
    ds._read_lq = pdata.datasets._PathReader([str(tree / "missing.png")] * len(ds))
    loader = pdata.DataLoader(ds, batch_size=1, num_workers=2)
    with pytest.raises(RuntimeError, match="decode worker failed"):
        list(loader)
