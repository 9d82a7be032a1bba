"""The port's ``Evaluator`` (``hcflow_tpu_torch/cli/evaluate.py``) against the JAX
package's on the CPU, on 2 synthetic GT/LQ pairs:

- the tiny trained checkpoint (``weights/ref_trained/tiny_x4_400_G.pth``), float32 and
  bf16 recipes, on the plain and on the fused params (the kernels' plain versions);
- the rescaling model at a small width (random weights, perturbed), float32 recipe.

At heat 0 the reverse is deterministic, so the SR metrics are held tight: ``psnr*`` (and
``bic_psnr``) within 0.01 dB, ``ssim*`` within 1e-4 (measured: 1.8e-5 dB and 1.8e-6 in
float32, 1.1e-3 dB and 6.3e-5 in bf16, where the two packages round to bf16 at other
places). ``bic_ssim`` is taken on the 16x24 bicubic downscale, where one window covers a
tenth of the image: within 2e-4 (measured 6.6e-7 in float32, 1.05e-4 in bf16). The SR
forward's dequantization noise is drawn from a torch generator in the port and from a
JAX key in JAX, so its NLL and LR metrics agree only up to that noise: JAX's own spread
over 4 keys on these images was 4.92 bits/dim (NLL), 0.050 / 0.075 dB (LR PSNR / PSNR_Y)
and 2.5e-3 / 8.4e-3 (LR SSIM / SSIM_Y); the tolerance is 3x that spread. The rescaling
forward draws no noise: its z_mean and LR metrics are held like the SR metrics. The
same keys, and the same saved file names.
"""

import os

import jax
import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu.cli.evaluate import Evaluator as JEvaluator
from hcflow_tpu.data import DataLoader as JDataLoader
from hcflow_tpu.data import create_dataset as jcreate_dataset
from hcflow_tpu.models.hcflow_rescaling import HCFlowRescalingSpec as JHCFlowRescalingSpec
from hcflow_tpu.utils import config as jconfig
from hcflow_tpu.utils.checkpoint import load_any as jload_any
from hcflow_tpu_torch.cli.evaluate import Evaluator
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.data import DataLoader, create_dataset
from hcflow_tpu_torch.data.imresize import imresize
from hcflow_tpu_torch.data.util import save_img
from hcflow_tpu_torch.models import HCFlowRescalingSpec
from hcflow_tpu_torch.utils import config
from hcflow_tpu_torch.utils.checkpoint import load_any

from _torch_port_util import perturb, to_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PTH = os.path.join(ROOT, "weights", "ref_trained", "tiny_x4_400_G.pth")
YML = os.path.join(ROOT, "weights", "ref_trained", "tiny_x4_parity.yml")
HEATS = [0.0, 0.9]
# 3 x JAX's spread over 4 keys (module docstring)
NOISE_TOL = {"nll": 3 * 4.92, "lr_psnr": 3 * 0.050, "lr_psnr_y": 3 * 0.075,
             "lr_ssim": 3 * 2.5e-3, "lr_ssim_y": 3 * 8.4e-3}
TINY_RS = dict(K=(4, 4), after_splitoff=(2, 2), hidden_channels=8, so_hidden_channels=8,
               rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=8)


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """2 GT/LQ pairs, HR 64x96 (smooth random), LR its MATLAB bicubic x1/4."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    os.makedirs(root / "HR")
    os.makedirs(root / "LR")
    for i in range(2):
        hr = np.kron(rng.uniform(0.1, 0.9, (8, 12, 3)), np.ones((8, 8, 1)))
        hr = (hr + 0.02 * rng.standard_normal(hr.shape)).clip(0, 1).astype(np.float32)
        save_img(str(root / "HR" / f"{i:02d}.png"), hr)
        save_img(str(root / "LR" / f"{i:02d}.png"), np.clip(imresize(hr, 0.25), 0, 1))
    return {"name": "pairs", "mode": "GTLQ", "phase": "test", "scale": 4,
            "dataroot_GT": str(root / "HR"), "dataroot_LQ": str(root / "LR")}


def _check_heat0(got: dict, ref: dict, noisy=()):
    assert sorted(got) == sorted(ref)
    assert got["n_images"] == ref["n_images"] == 2
    for k, v in ref.items():
        if k in noisy:
            assert abs(got[k] - v) <= NOISE_TOL[k], (k, got[k], v)
        elif k.startswith(("psnr", "bic_psnr", "lr_psnr")) and ("@0.0" in k or "@" not in k):
            assert abs(got[k] - v) <= 0.01, (k, got[k], v)
        elif k == "bic_ssim@0.0":
            assert abs(got[k] - v) <= 2e-4, (k, got[k], v)
        elif "@0.0" in k or k.startswith(("lr_ssim", "z_mean")):
            assert abs(got[k] - v) <= 1e-4, (k, got[k], v)
    for heat in HEATS[1:]:  # sampled: the two generators differ, the images vary
        assert got[f"diversity@{heat}"] > 0 and ref[f"diversity@{heat}"] > 0
    assert got["diversity@0.0"] == ref["diversity@0.0"] == 0.0


def _run_both(spec, params, jspec, jp, dopt, tmp_path, rescaling=False):
    """Port on the plain and the fused params, and JAX; with the saved file names."""
    out = []
    for fused in (False, True):
        pp = spec.flow.precompute_inference(params, fused=fused)
        ev = Evaluator(spec, pp, HEATS, n_sample=2, scale=4, device="cpu", rescaling=rescaling,
                       save_dir=str(tmp_path / f"port{int(fused)}"), suffix="x")
        out.append(ev.run(DataLoader(create_dataset(dopt)), torch.Generator().manual_seed(1)))
    jev = JEvaluator(jspec, jp, HEATS, n_sample=2, scale=4, rescaling=rescaling,
                     save_dir=str(tmp_path / "jax"), suffix="x")
    ref = jev.run(JDataLoader(jcreate_dataset(dopt)), jax.random.PRNGKey(1))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 2 * len(HEATS) * 2 and "SR_00_0.9_1_x.png" in names
    for fused in (0, 1):
        assert sorted(os.listdir(tmp_path / f"port{fused}")) == names
    return out, ref


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_sr_evaluator_matches_jax_on_the_trained_checkpoint(pairs, tmp_path, cd):
    opt = yaml.safe_load(open(YML))
    if cd:
        opt["network_G"]["compute_dtype"] = cd
    spec, jspec = config.model_spec_from_opt(opt), jconfig.model_spec_from_opt(opt)
    params = load_any(PTH, spec.flow, device="cpu")
    out, ref = _run_both(spec, params, jspec, jload_any(PTH, jspec.flow), pairs, tmp_path)
    for got in out:
        _check_heat0(got, ref, noisy=tuple(NOISE_TOL))


def test_rescaling_evaluator_matches_jax(pairs, tmp_path):
    spec = HCFlowRescalingSpec.default_x4(**TINY_RS)
    jp = to_jax(perturb(spec.init(0, device="cpu"), scale=0.02))
    params = params_from_jax(jp, spec, device="cpu")
    jspec = JHCFlowRescalingSpec.default_x4(**TINY_RS)
    out, ref = _run_both(spec, params, jspec, jp, pairs, tmp_path, rescaling=True)
    assert "z_mean" in ref and "nll" not in ref
    for got in out:
        _check_heat0(got, ref)


def test_evaluator_real_images_and_lpips(pairs, tmp_path):
    """An LQ-only dataset (real images: the reverse only, no metrics) and an LPIPS
    function, as test.main gives them."""
    opt = yaml.safe_load(open(YML))
    spec = config.model_spec_from_opt(opt)
    params = spec.flow.precompute_inference(load_any(PTH, spec.flow, device="cpu"))
    lq = create_dataset({"mode": "LQ", "phase": "test", "dataroot_LQ": pairs["dataroot_LQ"]})
    ev = Evaluator(spec, params, [0.0], device="cpu", save_dir=str(tmp_path))
    res = ev.run(DataLoader(lq), torch.Generator().manual_seed(0), real_image=True)
    assert res == {"nll": 0.0, "n_images": 2}
    assert sorted(os.listdir(tmp_path)) == ["SR_00_0.0_0.png", "SR_01_0.0_0.png"]
    lines = []

    class _Log:
        def info(self, msg):
            lines.append(msg)

    ev = Evaluator(spec, params, [0.0], device="cpu", logger=_Log(), lpips_label="lpips_rand",
                   lpips_fn=lambda a, b: float(np.abs(a - b).mean()))
    res = ev.run(DataLoader(create_dataset(pairs)), torch.Generator().manual_seed(0))
    assert 0 < res["lpips_rand@0.0"] < 1
    assert any(ln.startswith("---- average (2 images") and "lpips_rand" in ln for ln in lines)
