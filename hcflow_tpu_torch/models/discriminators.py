"""Discriminators for GAN fine-tuning (HCFlow++), as the JAX package's
``hcflow_tpu/models/discriminators.py`` (the reference's discriminator_vgg_arch.py).

- ``VGGDiscriminatorSpec``: discriminator_vgg_128 / _160, a VGG-style stack of 3x3
  stride-1 and 4x4 stride-2 convs (padding 1) with BatchNorm and leaky ReLU, then two
  linear layers; the input size sets the flattened width of ``linear1``.
- ``PatchGANDiscriminatorSpec``: stride-1 valid 3x3 convs with BatchNorm, a
  1-channel prediction map.

BatchNorm normalises with the current batch's statistics and the biased variance, and
keeps no running statistics (the discriminators are trained only, as in the JAX
package).  With ``sync_bn`` (data parallelism over several processes) the statistics
are those of the global batch, reduced over the ranks by a differentiable all-reduce,
as the JAX package gets them on a sharded batch.  Params: convs {"w" OIHW, "b"}, ``bn{i}`` {"scale", "bias"}, linears {"w"
(in, out), "b"}.  NHWC in; the convs run in float32 without TF32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..ops import nets
from ..parallel.mesh import moments
from .hcflow_sr import device_for, to_device


def _bn_init(c):
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def _bn_apply(p, x, sync, eps=1e-5):
    """Batch statistics over (N, H, W), the biased variance; over every rank's batch
    with ``sync``."""
    mean, var = moments(x, (0, 1, 2), sync)
    return (x - mean) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _conv_init(g, cin, cout, k, bias):
    """PyTorch's default conv init, U(+-1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(cin * k * k)
    p = {"w": (torch.rand((cout, cin, k, k), generator=g) * 2 - 1) * bound}
    if bias:
        p["b"] = (torch.rand(cout, generator=g) * 2 - 1) * bound
    return p


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _conv(x, w, b=None, stride=1, padding=0):
    """NHWC x OIHW -> NHWC at the given stride and padding, float32 without TF32."""
    with nets.exact_f32():
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


@dataclasses.dataclass(frozen=True)
class VGGDiscriminatorSpec:
    """discriminator_vgg_128 / discriminator_vgg_160 (``input_size`` 128 or 160)."""

    input_size: int = 160
    in_nc: int = 3
    nf: int = 64
    sync_bn: bool = False  # BatchNorm over the global batch of every rank

    @property
    def final_hw(self) -> int:
        return self.input_size // 2 ** 5

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (PyTorch's default inits, drawn on the CPU from a
        torch generator; the values differ from the JAX package's)."""
        device = device_for(device)
        g = torch.Generator().manual_seed(seed)
        nf = self.nf
        chans = [(self.in_nc, nf), (nf, nf), (nf, nf * 2), (nf * 2, nf * 2), (nf * 2, nf * 4),
                 (nf * 4, nf * 4), (nf * 4, nf * 8), (nf * 8, nf * 8), (nf * 8, nf * 8),
                 (nf * 8, nf * 8)]
        params = {}
        for i, (cin, cout) in enumerate(chans):
            # conv0 3x3 with bias; then 4x4 stride 2 (odd i) and 3x3 (even i), no bias
            params[f"conv{i}"] = _conv_init(g, cin, cout, 3 if i % 2 == 0 else 4, i == 0)
            if i > 0:
                params[f"bn{i}"] = _bn_init(cout)
        fc_in = nf * 8 * self.final_hw ** 2
        b1 = 1.0 / math.sqrt(fc_in)
        params["linear1"] = {"w": (torch.rand((fc_in, 100), generator=g) * 2 - 1) * b1,
                             "b": torch.zeros(100)}
        params["linear2"] = {"w": (torch.rand((100, 1), generator=g) * 2 - 1) * 0.1,
                             "b": torch.zeros(1)}
        return to_device(params, device)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC in [0, 1], input_size square; returns (B, 1) logits."""
        fea = _lrelu(_conv(x, params["conv0"]["w"], params["conv0"]["b"], padding=1))
        for i in range(1, 10):
            w = params[f"conv{i}"]["w"]
            fea = _conv(fea, w, stride=2, padding=1) if i % 2 == 1 else _conv(fea, w, padding=1)
            fea = _lrelu(_bn_apply(params[f"bn{i}"], fea, self.sync_bn))
        # the flatten in NCHW order, as the reference's
        fea = fea.permute(0, 3, 1, 2).reshape(fea.shape[0], -1)
        with nets.exact_f32():
            fea = _lrelu(fea @ params["linear1"]["w"] + params["linear1"]["b"])
            return fea @ params["linear2"]["w"] + params["linear2"]["b"]


@dataclasses.dataclass(frozen=True)
class PatchGANDiscriminatorSpec:
    """PatchGAN: stride-1 valid 3x3 convs with BatchNorm, a 1-channel map."""

    in_nc: int = 3
    ndf: int = 64
    n_layers: int = 5
    sync_bn: bool = False  # BatchNorm over the global batch of every rank

    def init(self, seed: int = 0, device="cuda") -> dict:
        device = device_for(device)
        g = torch.Generator().manual_seed(seed)
        params = {"conv_in": _conv_init(g, self.in_nc, self.ndf, 3, True)}
        for i in range(self.n_layers):
            params[f"conv{i}"] = _conv_init(g, self.ndf, self.ndf, 3, False)
            params[f"bn{i}"] = _bn_init(self.ndf)
        params["conv_out"] = _conv_init(g, self.ndf, 1, 3, False)
        return to_device(params, device)

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC; returns the (B, H - 2 (n_layers + 2), W - ..., 1) prediction map."""
        h = _lrelu(_conv(x, params["conv_in"]["w"], params["conv_in"]["b"]))
        for i in range(self.n_layers):
            h = _lrelu(_bn_apply(params[f"bn{i}"], _conv(h, params[f"conv{i}"]["w"]),
                                 self.sync_bn))
        return _conv(h, params["conv_out"]["w"])
