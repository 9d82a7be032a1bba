"""Checkpoint conversion CLI: reference .pth -> the JAX package's .ckpt format (which
both packages serve), plus VGG19 and LPIPS weights -> their .npz.

The counterpart of the JAX package's ``hcflow_tpu/cli/convert.py``, host-only (torch
on the CPU, numpy):

  python -m hcflow_tpu_torch.cli.convert model --pth SR_CelebA_X8_HCFlow++.pth \\
      --opt configs/test_SR_CelebA_8X_HCFlow.yml --out weights/SR_CelebA_X8.ckpt
  python -m hcflow_tpu_torch.cli.convert vgg --pth vgg19-imagenet.pth --out weights/vgg19_features.npz
  python -m hcflow_tpu_torch.cli.convert lpips --pth lpips_alex.pth --out weights/lpips_alex.npz
"""

from __future__ import annotations

import argparse

import torch


def _load_pth(path):
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: v.detach().numpy() for k, v in raw.items()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    sub = parser.add_subparsers(dest="cmd", required=True)
    pm = sub.add_parser("model")
    pm.add_argument("--pth", required=True)
    pm.add_argument("--opt", required=True, help="option YAML describing the topology")
    pm.add_argument("--out", required=True)
    for name in ("vgg", "lpips"):
        p = sub.add_parser(name)
        p.add_argument("--pth", required=True)
        p.add_argument("--out", required=True)
    args = parser.parse_args(argv)

    if args.cmd == "model":
        from ..convert import params_from_state_dict, params_to_jax
        from ..utils import config as config_mod
        from ..utils.checkpoint import save_checkpoint

        opt = config_mod.parse(args.opt, is_train=False)
        spec = config_mod.model_spec_from_opt(opt)
        params = params_from_state_dict(_load_pth(args.pth), spec.flow, device="cpu")
        save_checkpoint(args.out, {"params": params_to_jax(params, spec), "source": args.pth})
    elif args.cmd == "vgg":
        from ..models.vgg import convert_torch_state_dict, save_npz

        save_npz(args.out, convert_torch_state_dict(_load_pth(args.pth), device="cpu"))
    else:
        from ..models.lpips import convert_lpips_torch, save_npz

        save_npz(args.out, convert_lpips_torch(_load_pth(args.pth), device="cpu"))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
