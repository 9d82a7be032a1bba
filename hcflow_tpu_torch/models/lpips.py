"""LPIPS perceptual metric (AlexNet backbone) in PyTorch.

The counterpart of the JAX package's ``hcflow_tpu/models/lpips.py``.  The reference
evaluates LPIPS through the ``lpips`` pip package with the AlexNet backbone, on inputs
scaled to [-1, 1].  Algorithm (Zhang et al. 2018): run both images through AlexNet's
conv features (5 stages), unit-normalize each feature map over channels, take the
squared difference, apply the learned per-channel linear weights, average spatially,
sum over stages.

Params: ``conv{i}`` {"w" OIHW, "b"} and ``lin{i}`` {"w" (C,)}.  :func:`load` reads the
``.npz`` the JAX package's ``save_npz`` writes (HWIO conv weights); it returns None
when the file is absent, and callers then skip LPIPS.  The learned weights are not in
the repository.  The convs run in float32 without TF32 (``nets.exact_f32``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import nets

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


def random_params(seed: int = 0, device="cpu") -> dict:
    """Deterministic He-init random AlexNet LPIPS, the documented substitute when the
    learned weights are unavailable (as the JAX package's ``random_params``, from a
    torch generator: its values differ from JAX's).

    Random-feature perceptual distances correlate with human judgments well above
    pixel metrics (Zhang et al. 2018, CVPR, Table 5: untrained nets beat L2/SSIM).  The
    learned per-channel lin weights are replaced by a uniform 1/C average.  Callers
    must label the metric distinctly (``lpips_rand``): values are NOT comparable to
    true LPIPS numbers.
    """
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


def load(path: str, device="cpu") -> Optional[dict]:
    """Load converted LPIPS weights (the JAX package's ``.npz``: HWIO convs); None if
    the file is absent."""
    try:
        data = np.load(path)
    except (FileNotFoundError, OSError):
        return None
    params: dict = {}
    for k in data.files:
        name, leaf = k.rsplit("/", 1)
        a = np.asarray(data[k], np.float32)
        if a.ndim == 4:  # HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        params.setdefault(name, {})[leaf] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
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
