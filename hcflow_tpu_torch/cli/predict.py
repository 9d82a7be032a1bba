"""Single-image serving: ``python -m hcflow_tpu_torch.cli.predict --image x.png [--cpu]``.

The counterpart of the JAX package's ``hcflow_tpu/cli/predict.py`` (the reference's
predict.py, a cog Predictor): two model flavors, 'celeb' (CelebA x8) and 'general'
(DF2K x4), built from the shipped test configs; one LR image in, one SR PNG out.  The
checkpoint is loaded once and large inputs go through tiled inference.

It runs on the card unless ``device="cpu"`` (``--cpu``) is given; without a card it
raises.  ``fused`` takes the JAX package's three values: "all" (the default on the
card: ``precompute_inference(params, fused=True)``, every chain and RRDB trunk
through the kernels), "chains" (the chains only, ``trunks=False``) and "off" (the
plain path, the default on the CPU).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..data.util import read_img, save_img
from ..models.hcflow_sr import device_for
from ..utils import config as config_mod
from ..utils.checkpoint import load_any
from .tiled import tiled_reverse

_CONFIGS = {
    "general": "configs/test_SR_DF2K_4X_HCFlow.yml",
    "celeb": "configs/test_SR_CelebA_8X_HCFlow.yml",
}
_DEFAULT_HEAT = {"general": 0.9, "celeb": 0.8}
_FUSED = {"all": dict(fused=True), "chains": dict(fused=True, trunks=False),
          "off": dict(fused=False)}


class Predictor:
    def __init__(self, model_type: str = "general", opt_path: str = None,
                 checkpoint: str = None, repo_root: str = None, fused: str = None,
                 device="cuda"):
        self.device = device_for(device)
        root = repo_root or os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
        opt_path = opt_path or os.path.join(root, _CONFIGS[model_type])
        self.opt = config_mod.parse(opt_path, is_train=False)
        self.scale = self.opt.get("scale", 4)
        self.model = config_mod.model_spec_from_opt(self.opt)
        ckpt = checkpoint or config_mod.opt_get(self.opt, ["path", "pretrain_model_G"])
        if ckpt and os.path.exists(ckpt):
            params = load_any(ckpt, self.model.flow, device=self.device)
        else:
            params = self.model.init(0, device=self.device)
        if fused is None:
            fused = "all" if self.device.type == "cuda" else "off"
        self.params = self.model.flow.precompute_inference(params, **_FUSED[fused])
        self.default_heat = _DEFAULT_HEAT.get(model_type, 0.9)

    @torch.no_grad()
    def reverse(self, params, lr: np.ndarray, heat: float, generator) -> np.ndarray:
        """The model's reverse on an NHWC numpy LR batch, on the serving device."""
        x = torch.from_numpy(np.ascontiguousarray(lr, np.float32)).to(self.device)
        return self.model.reverse(params, x, heat, generator=generator).cpu().numpy()

    def predict(self, image_path: str, out_path: str = None, heat: float = None,
                seed: int = 0, max_tile: int = 128) -> str:
        heat = self.default_heat if heat is None else heat
        lr = read_img(image_path)
        # reference LQ convention (predict.py / GTLQx test path): reflect-pad the LR
        # up to a factor-2 grid, crop the SR back afterwards
        h, w = lr.shape[:2]
        ph, pw = (-h) % 2, (-w) % 2
        if ph or pw:
            lr = np.pad(lr, ((0, ph), (0, pw), (0, 0)), mode="reflect")
        generator = torch.Generator(device=self.device).manual_seed(seed)
        if max(lr.shape[:2]) > max_tile:
            sr = tiled_reverse(self.reverse, self.params, lr, self.scale, heat, generator,
                               tile=max_tile, overlap=8)
        else:
            sr = self.reverse(self.params, lr[None], heat, generator)[0]
        sr = sr[: h * self.scale, : w * self.scale]
        out_path = out_path or (os.path.splitext(image_path)[0] + f"_SR_{heat:.1f}.png")
        save_img(out_path, sr)
        return out_path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image", required=True)
    parser.add_argument("--model_type", choices=list(_CONFIGS), default="general")
    parser.add_argument("--opt", default=None, help="override option file")
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument("--heat", type=float, default=None)
    parser.add_argument("--out", default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--fused", choices=list(_FUSED), default=None,
                        help="kernels: all (default on the card), chains only, or off "
                             "(default on the CPU)")
    args = parser.parse_args(argv)
    pred = Predictor(args.model_type, args.opt, args.checkpoint, fused=args.fused,
                     device="cpu" if args.cpu else "cuda")
    out = pred.predict(args.image, args.out, args.heat, args.seed)
    print(out)


if __name__ == "__main__":
    main()
