"""VGG19 feature extractor for the perceptual loss (HCFlow++), as the JAX package's
``hcflow_tpu/models/vgg.py``.

torchvision's vgg19 features through layer 34 (conv5_4, before its ReLU), on inputs
normalised by ImageNet's mean and std, with 2x2 max pools between the blocks; frozen.
The pretrained ImageNet weights are not in the repository: ``load_npz`` reads a
converted file (the JAX package's ``.npz``, HWIO convs; ``cli/convert.py vgg`` writes
one from a torchvision state_dict), and ``random_features`` is the documented opt-in
substitute (``train.feature_fallback: random``).  Params: ``conv{b}_{c}`` {"w" OIHW,
"b"}.  NHWC in, NHWC out; the convs run in float32 without TF32.
"""

from __future__ import annotations

import dataclasses
import math
import numpy as np
import torch
import torch.nn.functional as F

from .. import convert
from ..ops import nets
from .hcflow_sr import device_for

# VGG19 cfg 'E': the conv widths of each block
_BLOCKS = ((64, 64), (128, 128), (256, 256, 256, 256), (512, 512, 512, 512), (512, 512, 512, 512))

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv_names():
    return [f"conv{b + 1}_{c + 1}" for b, chans in enumerate(_BLOCKS) for c in range(len(chans))]


@dataclasses.dataclass(frozen=True)
class VGG19FeatureSpec:
    """Features through conv5_4 before its ReLU (``feature_layer`` 34)."""

    feature_layer: int = 34
    use_input_norm: bool = True

    def conv_names(self):
        return _conv_names()

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random N(0, 0.02) weights from ``seed`` (the architecture only; drawn on the
        CPU from a torch generator, so they differ from the JAX package's)."""
        device = device_for(device)
        g = torch.Generator().manual_seed(seed)
        params, cin = {}, 3
        for name, cout in zip(_conv_names(), [c for chans in _BLOCKS for c in chans]):
            params[name] = {"w": (torch.randn((cout, cin, 3, 3), generator=g) * 0.02).to(device),
                            "b": torch.zeros(cout, device=device)}
            cin = cout
        return params

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x: NHWC in [0, 1]; returns the conv5_4 features (before the ReLU), NHWC."""
        if self.use_input_norm:
            x = (x - x.new_tensor(_IMAGENET_MEAN)) / x.new_tensor(_IMAGENET_STD)
        # torchvision's feature indices walk conv, relu, ..., pool; stop at the conv at
        # feature_layer (34: conv5_4, no ReLU after it)
        idx = 0
        for b, chans in enumerate(_BLOCKS):
            for c in range(len(chans)):
                p = params[f"conv{b + 1}_{c + 1}"]
                x = nets.conv2d(x, p["w"], p["b"])
                if idx == self.feature_layer:
                    return x
                x = F.relu(x)
                idx += 2
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            idx += 1
        return x


def random_features(seed: int = 0, device="cuda") -> dict:
    """Deterministic He-initialised random VGG19 features (std sqrt(2 / fan_in)), the
    documented perceptual-loss substitute when pretrained weights are unavailable
    (random-weight conv features: He, Wang & Hopcroft, NeurIPS 2016; Ulyanov et al.,
    Deep Image Prior, 2018).  Weaker than ImageNet-pretrained conv5_4 features, not comparable to
    them; from a torch generator, so the values differ from the JAX package's."""
    params = VGG19FeatureSpec().init(seed, device)
    for p in params.values():
        cin = p["w"].shape[1]
        p["w"] = p["w"] / 0.02 * math.sqrt(2.0 / (9 * cin))
    return params


def convert_torch_state_dict(sd, device="cuda") -> dict:
    """A torchvision ``vgg19().features`` state_dict (keys ``features.<i>.weight``)
    as params (OIHW, as torchvision keeps them) on ``device``."""
    device = device_for(device)
    params, idx = {}, 0
    for b, chans in enumerate(_BLOCKS):
        for c in range(len(chans)):
            params[f"conv{b + 1}_{c + 1}"] = {
                k: torch.as_tensor(np.asarray(sd[f"features.{idx}.{leaf}"]),
                                   dtype=torch.float32).to(device)
                for k, leaf in (("w", "weight"), ("b", "bias"))}
            idx += 2  # conv, relu
        idx += 1  # pool
    return params


# converted weights in the JAX package's .npz layout (HWIO convs), read and written as
# both packages do
load_npz = convert.load_npz
save_npz = convert.save_npz
