"""The port's option files, metrics, checkpoints, logging and LPIPS
(``hcflow_tpu_torch/utils``, ``models/lpips.py``) against the JAX package's on the CPU.

- ``parse`` gives JAX's dict on every option file of the repo; ``model_spec_from_opt``
  gives the port's spec field for field as JAX's, and raises, naming the key, on a
  value the port does not implement;
- the metrics equal JAX's to 1e-12 (the same float64 numpy and scipy code);
- ``load_any`` reads the tiny trained ``.pth`` as ``params_from_state_dict`` does and a
  ``.ckpt`` that JAX's ``save_checkpoint`` wrote as ``params_from_jax`` does; retention
  leaves the files JAX's leaves;
- LPIPS on JAX's ``random_params`` within 1e-5 of JAX's LPIPS (float32 convs summed
  in another order).
"""

import dataclasses
import glob
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu.models import lpips as jlpips
from hcflow_tpu.utils import checkpoint as jckpt
from hcflow_tpu.utils import config as jconfig
from hcflow_tpu.utils import metrics as jmetrics
from hcflow_tpu_torch.convert import params_from_jax, params_from_state_dict
from hcflow_tpu_torch.models import lpips
from hcflow_tpu_torch.train.trainer import tree_leaves
from hcflow_tpu_torch.utils import checkpoint, config, metrics
from hcflow_tpu_torch.utils.logging import TBWriter, setup_logger

from _torch_port_util import TINY_CKPT, perturb, to_jax

ROOT = Path(__file__).resolve().parents[1]
OPTION_FILES = sorted(os.path.relpath(p, ROOT) for p in glob.glob(str(ROOT / "configs" / "*.yml")))
OPTION_FILES.append("weights/ref_trained/tiny_x4_parity.yml")
PTH = ROOT / "weights" / "ref_trained" / "tiny_x4_400_G.pth"


def _is_train(path):
    return os.path.basename(path).startswith(("train", "smoke"))


@pytest.mark.parametrize("path", OPTION_FILES)
def test_parse_matches_jax(path):
    for is_train in (_is_train(path), not _is_train(path)):
        if is_train and "train" not in (yaml.safe_load((ROOT / path).read_text()) or {}):
            continue  # JAX's debug-name overrides need a train section
        assert config.parse(str(ROOT / path), is_train) == jconfig.parse(str(ROOT / path), is_train)


def _same(a, b):
    return (tuple(a) if isinstance(a, (list, tuple)) else a) == (
        tuple(b) if isinstance(b, (list, tuple)) else b)


@pytest.mark.parametrize("path", OPTION_FILES)
def test_model_spec_from_opt_matches_jax(path):
    opt = config.parse(str(ROOT / path), _is_train(path))
    port, ref = config.model_spec_from_opt(opt), jconfig.model_spec_from_opt(opt)
    assert type(port).__name__ == type(ref).__name__
    assert getattr(port, "quant", None) == getattr(ref, "quant", None)
    pf, jf = port.flow, ref.flow
    compared = 0
    for f in dataclasses.fields(pf):
        if not hasattr(jf, f.name):
            continue
        a, b = getattr(pf, f.name), getattr(jf, f.name)
        if f.name in ("K", "after_splitoff"):  # JAX repeats a scalar L + 1 times
            b = tuple(b)[: jf.L]
        assert _same(a, b), f.name
        compared += 1
    assert compared == len(dataclasses.fields(pf))  # every field of the port's spec
    # what the port fixes, JAX reads from the file: the split-off steps and cond_channels
    assert (jf.so_flow_permutation, jf.so_flow_coupling, jf.so_nn_module) == (
        "invconv", "Affine", "FCN")
    assert jf.cond_channels is None
    for lp, lj in zip(pf.levels, jf.levels):
        assert (lp.channels, lp.n_main, lp.split_channels) == (lj.channels, lj.n_main,
                                                              lj.split_channels)
        assert lp.cond_spec.conv_first_in == lj.cond_spec.conv_first_in
        assert lp.cond_spec.n_flow_step == lj.cond_spec.n_flow_step


@pytest.mark.parametrize("key,value", [
    ("flow_permutation", "random"), ("flow_coupling", "AffineInjector"),
    ("nn_module", "RRDB"), ("squeeze", "pixelshuffle"), ("cond_channels", 64),
    ("splitOff.flow_coupling", "Affine3shift"), ("splitOff.nn_module", "DenseBlock"),
    ("compute_dtype", "float16"),
])
def test_unsupported_value_raises_naming_its_key(key, value):
    opt = config.parse(str(ROOT / "configs" / "test_SR_DF2K_4X_HCFlow.yml"), is_train=False)
    fd = opt["network_G"]["flowDownsampler"]
    if key.startswith("splitOff."):
        fd["splitOff"][key.split(".")[1]] = value
    elif key == "compute_dtype":
        opt["network_G"][key] = value
    else:
        fd[key] = value
    with pytest.raises(NotImplementedError, match=key.replace(".", r"\.")):
        config.model_spec_from_opt(opt)


def test_opt_get():
    opt = {"a": {"b": None, "c": {"d": 3}}}
    for keys, default in ((["a", "c", "d"], 0), (["a", "b"], 7), (["x"], None),
                          (["a", "c", "e"], 1)):
        assert config.opt_get(opt, keys, default) == jconfig.opt_get(opt, keys, default)
    assert config.opt_get(None, ["a"], 5) == 5


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((40, 36, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    for crop in (0, 4):
        got, ref = metrics.calculate_psnr_ssim(a, b, crop), jmetrics.calculate_psnr_ssim(a, b, crop)
        assert np.allclose(got, ref, rtol=0, atol=1e-12)
    gray = (a[:, :, 0] * 255, b[:, :, 0] * 255)
    assert abs(metrics.calculate_ssim(*gray) - jmetrics.calculate_ssim(*gray)) <= 1e-12
    assert abs(metrics.calculate_psnr(*gray) - jmetrics.calculate_psnr(*gray)) <= 1e-12
    assert metrics.calculate_psnr(a, a) == float("inf")
    samples = [a, b, np.clip(a * 0.9, 0, 1)]
    assert abs(metrics.diversity(samples) - jmetrics.diversity(samples)) <= 1e-12
    with pytest.raises(ValueError):
        metrics.calculate_ssim(a, b[:-1])


# ------------------------------------------------------------------ checkpoints
def _spec():
    from hcflow_tpu_torch.models import HCFlowSRSpec

    return HCFlowSRSpec.for_scale(4, **TINY_CKPT)


def _assert_same_params(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0
    assert all(x.dtype == torch.float32 and torch.equal(x, y) for x, y in zip(la, lb))


def test_load_any_reads_the_reference_pth():
    spec = _spec()
    got = checkpoint.load_any(str(PTH), spec.flow, device="cpu")
    _assert_same_params(got, params_from_state_dict(torch.load(PTH, map_location="cpu"), spec,
                                                    device="cpu"))


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_any_reads_a_jax_ckpt(tmp_path, wrapped):
    """A .ckpt of the JAX package (its pickle backend; numpy in JAX's layout), as its
    train and convert CLIs save it ({"params": ..., "step": ...}) or bare."""
    spec = _spec()
    params = perturb(spec.init(0, device="cpu"), seed=3)
    jp = to_jax(params)
    path = str(tmp_path / "400_G.ckpt")
    jckpt.save_checkpoint(path, {"params": jp, "step": 400} if wrapped else jp)
    got = checkpoint.load_any(path, spec, device="cpu")
    _assert_same_params(got, params_from_jax(jp, spec, device="cpu"))
    _assert_same_params(got, params)


def test_orbax_directory_raises(tmp_path):
    """A directory that is not an orbax checkpoint raises, naming what it lacks (an
    orbax checkpoint is read: tests/test_torch_port_orbax.py)."""
    (tmp_path / "1000_G.ckpt").mkdir()
    with pytest.raises(ValueError, match="not an orbax checkpoint: it has no _METADATA"):
        checkpoint.load_any(str(tmp_path / "1000_G.ckpt"), _spec())


def test_save_and_load_checkpoint_round_trip(tmp_path):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3), "l": [torch.ones(2)]}, "step": 7}
    checkpoint.save_checkpoint(str(tmp_path / "m" / "7_G.ckpt"), tree)
    back = checkpoint.load_checkpoint(str(tmp_path / "m" / "7_G.ckpt"))
    assert back["step"] == 7 and isinstance(back["params"]["w"], np.ndarray)
    assert np.array_equal(back["params"]["w"], tree["params"]["w"].numpy())
    assert np.array_equal(back["params"]["l"][0], np.ones(2, np.float32))
    # the JAX package reads it too
    assert np.array_equal(jckpt.load_checkpoint(str(tmp_path / "m" / "7_G.ckpt"))["params"]["w"],
                          back["params"]["w"])


def test_retention_matches_jax(tmp_path):
    iters = [1000, 2000, 5000, 6000, 10000, 10500, 11000, 12000]
    for d in ("p", "j"):
        os.makedirs(tmp_path / d)
        for it in iters:
            (tmp_path / d / f"{it}_G.ckpt").write_bytes(b"x")
            (tmp_path / d / f"{it}.state").write_bytes(b"x")
        (tmp_path / d / "latest_G.ckpt").write_bytes(b"x")
    for suffix in (".ckpt", ".state"):
        assert (checkpoint.list_checkpoints(str(tmp_path / "p"), suffix)
                == jckpt.list_checkpoints(str(tmp_path / "j"), suffix))
        assert (os.path.basename(checkpoint.latest_checkpoint(str(tmp_path / "p"), suffix))
                == os.path.basename(jckpt.latest_checkpoint(str(tmp_path / "j"), suffix)))
        checkpoint.prune_checkpoints(str(tmp_path / "p"), suffix)
        jckpt.prune_checkpoints(str(tmp_path / "j"), suffix)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    kept = os.listdir(tmp_path / "p")
    assert "5000_G.ckpt" in kept and "1000.state" not in kept
    assert checkpoint.latest_checkpoint(str(tmp_path / "none")) is None


def test_logger_and_tb_writer(tmp_path):
    log = setup_logger("port_test_logger", str(tmp_path / "logs"))
    log.info("hello")
    for h in log.handlers:
        h.flush()
    files = os.listdir(tmp_path / "logs")
    assert len(files) == 1 and "hello" in (tmp_path / "logs" / files[0]).read_text()
    assert setup_logger("port_test_logger") is log
    tb = TBWriter(None)
    tb.add_scalar("x", 1.0, 0)
    tb.close()


# ------------------------------------------------------------------------ LPIPS
def test_lpips_matches_jax(tmp_path):
    jp = jlpips.random_params(seed=0)
    path = str(tmp_path / "alex.npz")
    jlpips.save_npz(path, jp)
    params = lpips.load(path, device="cpu")
    assert params["conv0"]["w"].shape == (64, 3, 11, 11)
    rng = np.random.default_rng(5)
    a = rng.random((2, 72, 80, 3)).astype(np.float32) * 2 - 1
    b = np.clip(a + rng.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    got = lpips.lpips_distance(params, torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(jlpips.lpips_distance(jp, a, b))
    assert got.shape == (2,) and np.abs(got - ref).max() <= 1e-5, (got, ref)
    # the metric on [0, 1] numpy images, as the Evaluator calls it
    m, jm = lpips.make_metric(params), jlpips.make_metric(jp)
    x, y = (a[0] + 1) / 2, (b[0] + 1) / 2
    assert abs(m(x, y) - jm(x, y)) <= 1e-5 and m(x, x) == 0.0
    assert lpips.load(str(tmp_path / "missing.npz"), device="cpu") is None


def test_lpips_random_params():
    p = lpips.random_params(seed=0, device="cpu")
    assert [p[f"conv{i}"]["w"].shape[0] for i in range(5)] == [64, 192, 384, 256, 256]
    assert all(torch.allclose(p[f"lin{i}"]["w"].sum(), torch.tensor(1.0)) for i in range(5))
    assert torch.equal(p["conv2"]["w"], lpips.random_params(seed=0, device="cpu")["conv2"]["w"])
    x = torch.rand(1, 64, 64, 3) * 2 - 1
    assert float(lpips.lpips_distance(p, x, -x)[0]) > 0
