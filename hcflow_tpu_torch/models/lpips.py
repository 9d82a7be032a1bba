"""LPIPS perceptual metric (AlexNet backbone) in PyTorch.

The counterpart of the JAX package's ``hcflow_tpu/models/lpips.py``.  The reference
evaluates LPIPS through the ``lpips`` pip package with the AlexNet backbone, on inputs
scaled to [-1, 1].  Algorithm (Zhang et al. 2018): run both images through AlexNet's
conv features (5 stages), unit-normalize each feature map over channels, take the
squared difference, apply the learned per-channel linear weights, average spatially,
sum over stages.

Params: ``conv{i}`` {"w" OIHW, "b"} and ``lin{i}`` {"w" (C,)}.  :func:`load` reads the
``.npz`` the JAX package's ``save_npz`` writes (HWIO conv weights); it returns None
when the file is absent, and callers then skip LPIPS.  :func:`convert_lpips_torch`
reads an ``lpips.LPIPS(net='alex')`` state_dict and :func:`save_npz` writes that
``.npz`` (``cli/convert.py lpips``).  The learned weights are not in the repository.
The convs run in float32 without TF32 (``nets.exact_f32``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .. import convert
from ..ops import nets
from .hcflow_sr import device_for

# AlexNet feature config: (out_ch, kernel, stride, padding), with maxpool after 0,1
_ALEX = (
    (64, 11, 4, 2),
    (192, 5, 1, 2),
    (384, 3, 1, 1),
    (256, 3, 1, 1),
    (256, 3, 1, 1),
)
_POOL_AFTER = {0, 1}
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _features(params: dict, x: torch.Tensor) -> list:
    """AlexNet's five ReLU outputs, NCHW."""
    feats = []
    h = x
    for i, (_, _, s, p) in enumerate(_ALEX):
        conv = params[f"conv{i}"]
        h = F.relu(F.conv2d(h, conv["w"], conv["b"], stride=s, padding=p))
        feats.append(h)
        if i in _POOL_AFTER:
            h = F.max_pool2d(h, 3, 2)
    return feats


def _unit_normalize(f, eps=1e-10):
    return f / (torch.sqrt(torch.sum(f**2, dim=1, keepdim=True)) + eps)


@torch.no_grad()
def lpips_distance(params: dict, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """LPIPS distance per batch element. img0/img1: NHWC RGB in [-1, 1]."""
    shift = img0.new_tensor(_SHIFT).view(1, 3, 1, 1)
    scale = img0.new_tensor(_SCALE).view(1, 3, 1, 1)
    with nets.exact_f32():
        f0s = _features(params, (img0.permute(0, 3, 1, 2) - shift) / scale)
        f1s = _features(params, (img1.permute(0, 3, 1, 2) - shift) / scale)
    total = 0.0
    for i, (f0, f1) in enumerate(zip(f0s, f1s)):
        d = (_unit_normalize(f0) - _unit_normalize(f1)) ** 2
        w = params[f"lin{i}"]["w"].view(1, -1, 1, 1)  # (C,) nonneg linear weights
        total = total + torch.sum(d * w, dim=1).mean(dim=(1, 2))
    return total


def random_params(seed: int = 0, device="cuda") -> dict:
    """Deterministic He-init random AlexNet LPIPS, the documented substitute when the
    learned weights are unavailable (as the JAX package's ``random_params``, from a
    torch generator: its values differ from JAX's).

    Random-feature perceptual distances correlate with human judgments well above
    pixel metrics (Zhang et al. 2018, CVPR, Table 5: untrained nets beat L2/SSIM).  The
    learned per-channel lin weights are replaced by a uniform 1/C average.  Callers
    must label the metric distinctly (``lpips_rand``): values are NOT comparable to
    true LPIPS numbers.
    """
    device = device_for(device)
    g = torch.Generator().manual_seed(seed)
    params = {}
    cin = 3
    for i, (cout, k, _, _) in enumerate(_ALEX):
        std = float(np.sqrt(2.0 / (k * k * cin)))
        params[f"conv{i}"] = {"w": (torch.randn((cout, cin, k, k), generator=g) * std).to(device),
                              "b": torch.zeros(cout, device=device)}
        params[f"lin{i}"] = {"w": torch.full((cout,), 1.0 / cout, device=device)}
        cin = cout
    return params


# converted weights in the JAX package's .npz layout (HWIO convs): None when absent
load = convert.load_npz
save_npz = convert.save_npz


# the torchvision AlexNet feature index of each conv stage, under the two key layouts
# of lpips.LPIPS(net='alex') state_dicts
_ALEX_KEYS = ((("slice1", 0), 0), (("slice2", 3), 3), (("slice3", 6), 6), (("slice4", 8), 8),
              (("slice5", 10), 10))


def convert_lpips_torch(sd, device="cuda") -> dict:
    """An ``lpips.LPIPS(net='alex')`` state_dict (net.slice{1..5}.<idx>.weight/bias or
    net.features.<idx>.*, and lin{0..4}.model.1.weight or lins.{i}.model.1.weight) as
    params (OIHW convs) on ``device``."""
    device = device_for(device)

    def t(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32).to(device)

    params = {}
    for i, ((sl, idx), fidx) in enumerate(_ALEX_KEYS):
        for key in (f"net.{sl}.{idx}.weight", f"net.features.{fidx}.weight"):
            if key in sd:
                params[f"conv{i}"] = {"w": t(sd[key]), "b": t(sd[key.replace("weight", "bias")])}
                break
        else:
            raise KeyError(f"missing alexnet conv {i}")
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight"):
            if key in sd:
                params[f"lin{i}"] = {"w": t(sd[key]).reshape(-1)}
                break
        else:
            raise KeyError(f"missing lpips lin{i}")
    return params


def make_metric(params: dict):
    """Returns lpips(img0_hwc01, img1_hwc01) -> float on [0,1] numpy images, computed on
    the params' device."""
    device = params["conv0"]["w"].device

    def metric(a, b):
        a = torch.as_tensor(np.asarray(a, np.float32), device=device)[None] * 2.0 - 1.0
        b = torch.as_tensor(np.asarray(b, np.float32), device=device)[None] * 2.0 - 1.0
        return float(lpips_distance(params, a, b)[0])

    return metric
