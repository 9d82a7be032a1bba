"""The port's serving entry points on the CPU against the JAX package's:

- ``tiled_reverse``: bit for bit against JAX's with a nearest-upsample reverse (the
  tile grid, reflect padding, zero-padded last batch and blend); the tiny trained
  checkpoint's reverse at heat 0 through both within 1e-5 (float32, the same weights);
- ``Predictor``: odd-sized input (reflect-padded to a factor-2 grid, the SR cropped
  back), plain and tiled, all three ``fused`` values;
- ``test.main --cpu`` on an option file of the tiny checkpoint with a GT/LQ and an
  LQ-only dataset: the results' keys equal JAX's ``main``'s, the saved files;
- without a card and without ``--cpu`` both CLIs raise, naming ``--cpu``.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu.cli import test as jtest
from hcflow_tpu.cli.tiled import tiled_reverse as jtiled_reverse
from hcflow_tpu.utils import config as jconfig
from hcflow_tpu.utils.checkpoint import load_any as jload_any
from hcflow_tpu_torch.cli import predict, test
from hcflow_tpu_torch.cli.tiled import tiled_reverse
from hcflow_tpu_torch.data.imresize import imresize
from hcflow_tpu_torch.data.util import read_img, save_img
from hcflow_tpu_torch.utils import config
from hcflow_tpu_torch.utils.checkpoint import load_any

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTH = os.path.join(ROOT, "weights", "ref_trained", "tiny_x4_400_G.pth")
YML = os.path.join(ROOT, "weights", "ref_trained", "tiny_x4_parity.yml")
TINY_FD = {
    "K": 3, "L": 2, "flow_permutation": "invconv", "flow_coupling": "Affine",
    "nn_module": "FCN", "hidden_channels": 8, "cond_channels": None,
    "splitOff": {
        "enable": True, "after_flowstep": [1, 1], "flow_permutation": "invconv",
        "flow_coupling": "Affine", "nn_module": "FCN", "hidden_channels": 8,
        "RRDB_nb": [1, 1], "RRDB_nf": 8, "RRDB_gc": 8,
    },
}


@pytest.mark.parametrize("shape,tile,batch", [((150, 141, 3), 64, 8), ((40, 36, 3), 16, 3),
                                              ((30, 20, 3), 32, 8)])
def test_tiled_reverse_matches_jax(shape, tile, batch):
    lr = np.random.default_rng(0).random(shape).astype(np.float32)
    calls, jcalls = [], []

    def nearest(params, x, eps_std, generator):
        calls.append(x.shape)
        return np.repeat(np.repeat(np.asarray(x), 4, 1), 4, 2) * eps_std

    def jnearest(params, key, x, eps_std):
        jcalls.append(x.shape)
        return np.repeat(np.repeat(np.asarray(x), 4, 1), 4, 2) * eps_std

    got = tiled_reverse(nearest, None, lr, 4, 0.5, None, tile=tile, overlap=4, batch=batch)
    ref = jtiled_reverse(jnearest, None, jax.random.PRNGKey(0), lr, 4, 0.5, tile=tile,
                         overlap=4, batch=batch)
    assert got.shape == (shape[0] * 4, shape[1] * 4, 3) and calls == jcalls
    assert np.array_equal(got, ref)


def test_tiled_reverse_of_the_trained_checkpoint_matches_jax():
    opt = yaml.safe_load(open(YML))
    spec, jspec = config.model_spec_from_opt(opt), jconfig.model_spec_from_opt(opt)
    params = spec.flow.precompute_inference(load_any(PTH, spec.flow, device="cpu"))
    jp = jspec.flow.precompute_inference(jload_any(PTH, jspec.flow))
    rng = np.random.default_rng(1)
    lr = np.kron(rng.uniform(0.1, 0.9, (5, 4, 3)), np.ones((8, 9, 1))).astype(np.float32)

    def rev(p, x, eps_std, generator):
        return spec.reverse(p, torch.from_numpy(x), eps_std, generator=generator).numpy()

    got = tiled_reverse(rev, params, lr, 4, 0.0, torch.Generator().manual_seed(0), tile=16,
                        overlap=4, batch=4)
    ref = jtiled_reverse(jax.jit(jspec.reverse), jp, jax.random.PRNGKey(0), lr, 4, 0.0,
                         tile=16, overlap=4, batch=4)
    assert got.shape == (160, 144, 3)
    assert np.abs(got - np.asarray(ref)).max() <= 1e-5


@pytest.fixture
def tiny_opt(tmp_path):
    path = str(tmp_path / "opt.yml")
    with open(path, "w") as f:
        yaml.safe_dump({"name": "t", "model": "HCFlow_SR", "scale": 4, "quant": 64,
                        "network_G": {"in_nc": 3, "flowDownsampler": TINY_FD},
                        "val": {"heats": [0.0], "n_sample": 1}}, f)
    return path


@pytest.mark.parametrize("fused", ["all", "chains", "off", None])
def test_predictor_padding_and_output(tmp_path, tiny_opt, fused):
    img = np.random.default_rng(0).random((11, 13, 3)).astype(np.float32)
    save_img(str(tmp_path / "in.png"), img)
    pred = predict.Predictor("general", opt_path=tiny_opt, fused=fused, device="cpu")
    packs = set(pred.params["level0"]["cond"]) | set(pred.params["level0"])
    assert ("steps_fused" in packs) == (fused in ("all", "chains"))
    assert ("trunk0_fused" in packs) == (fused == "all")
    out = pred.predict(str(tmp_path / "in.png"), out_path=str(tmp_path / "out.png"), heat=0.0)
    sr = read_img(out)
    assert sr.shape == (44, 52, 3)
    # the tiled path (an LR over max_tile), through the CLI
    save_img(str(tmp_path / "big.png"), np.random.default_rng(1).random((41, 37, 3)))
    args = ["--image", str(tmp_path / "big.png"), "--opt", tiny_opt, "--cpu", "--heat", "0.0",
            "--out", str(tmp_path / "big_sr.png")] + (["--fused", fused] if fused else [])
    predict.main(args)
    assert read_img(str(tmp_path / "big_sr.png")).shape == (164, 148, 3)
    tiled = pred.predict(str(tmp_path / "big.png"), str(tmp_path / "t.png"), 0.0, max_tile=32)
    assert read_img(tiled).shape == (164, 148, 3)


def _opt_file(tmp_path, root):
    """The tiny checkpoint's option file with a GT/LQ test set and an LQ-only one."""
    rng = np.random.default_rng(2)
    for d in ("HR", "LR", "real"):
        os.makedirs(tmp_path / "ds" / d)
    for i in range(2):
        hr = np.kron(rng.uniform(0.1, 0.9, (6, 8, 3)), np.ones((8, 8, 1))).astype(np.float32)
        save_img(str(tmp_path / "ds" / "HR" / f"{i}.png"), hr)
        save_img(str(tmp_path / "ds" / "LR" / f"{i}.png"), np.clip(imresize(hr, 0.25), 0, 1))
    save_img(str(tmp_path / "ds" / "real" / "odd.png"), rng.random((13, 9, 3)))
    opt = yaml.safe_load(open(YML))
    opt["datasets"] = {
        "test_1": {"name": "pairs", "mode": "GTLQ", "dataroot_GT": str(tmp_path / "ds" / "HR"),
                   "dataroot_LQ": str(tmp_path / "ds" / "LR")},
        "test_2": {"name": "real", "mode": "LQ", "dataroot_LQ": str(tmp_path / "ds" / "real")},
    }
    opt["path"] = {"root": str(root), "pretrain_model_G": PTH}
    opt["val"] = {"heats": [0.0, 0.9], "n_sample": 2, "seed": 3}
    path = str(tmp_path / "tiny.yml")
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return path


def test_test_main_matches_jax_keys(tmp_path):
    res = test.main(["--opt", _opt_file(tmp_path, tmp_path / "port"), "--cpu"])
    ref = jtest.main(["--opt", _opt_file(tmp_path / "j", tmp_path / "jax"), "--cpu"])
    assert sorted(res) == sorted(ref) == ["pairs", "real"]
    for name in res:
        assert sorted(res[name]) == sorted(ref[name])
        assert all(np.isfinite(v) for v in res[name].values())
    assert res["real"] == {"nll": 0.0, "n_images": 1}
    assert abs(res["pairs"]["psnr@0.0"] - ref["pairs"]["psnr@0.0"]) <= 0.01
    for name, n in (("pairs", 2), ("real", 1)):
        port = sorted(os.listdir(tmp_path / "port" / "results" / "tiny_x4_parity" / name))
        assert port == sorted(os.listdir(tmp_path / "jax" / "results" / "tiny_x4_parity" / name))
        assert len(port) == n * 2 * 2


def test_clis_without_a_card_raise_naming_cpu(tmp_path, tiny_opt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    save_img(str(tmp_path / "in.png"), np.zeros((8, 8, 3)))
    with pytest.raises(RuntimeError, match="--cpu"):
        predict.main(["--image", str(tmp_path / "in.png"), "--opt", tiny_opt])
    with pytest.raises(RuntimeError, match="--cpu"):
        test.main(["--opt", tiny_opt])
    with pytest.raises(RuntimeError, match="--cpu"):
        predict.Predictor("general", opt_path=tiny_opt)
