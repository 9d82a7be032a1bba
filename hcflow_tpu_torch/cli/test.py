"""Evaluation CLI: ``python -m hcflow_tpu_torch.cli.test --opt <yml> [--cpu]``.

The counterpart of the JAX package's ``hcflow_tpu/cli/test.py`` (the reference's
test_HCFlow.py): option-file driven evaluation over the configured test datasets with
the full metric set, saving SR images under ``results/<name>/<dataset>/``.

It runs on the card unless ``--cpu`` is given; without a card and without ``--cpu``
it raises.  On the card the model is served as ``Predictor`` serves it,
``precompute_inference(params, fused=True)``: the RRDB, chain and (rescaling) chain3s
kernels, in the recipe the option file sets (the shipped test configs set none: the
float32 kernels); the SR forward reads the trunk packs as the reverse does.  With
``--cpu`` the plain path runs.
"""

from __future__ import annotations

import argparse
import os

import torch

from ..data import create_dataloader, create_dataset
from ..models import lpips as lpips_mod
from ..models.hcflow_sr import device_for
from ..utils import config as config_mod
from ..utils.checkpoint import load_any
from ..utils.logging import setup_logger
from .evaluate import Evaluator


def main(argv=None) -> dict:
    """Evaluate every dataset of the option file; returns {dataset name: averages}."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", required=True, help="path to option YAML file")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = parser.parse_args(argv)
    device = device_for("cpu" if args.cpu else "cuda")

    opt = config_mod.parse(args.opt, is_train=False)
    results_root = opt["path"]["results_root"]
    os.makedirs(results_root, exist_ok=True)
    logger = setup_logger("base", opt["path"]["log"])
    logger.info(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}")

    model_spec = config_mod.model_spec_from_opt(opt)

    ckpt_path = config_mod.opt_get(opt, ["path", "pretrain_model_G"])
    if ckpt_path and os.path.exists(ckpt_path):
        logger.info(f"loading checkpoint {ckpt_path}")
        params = load_any(ckpt_path, model_spec.flow, device=device)
    else:
        logger.warning("no pretrained checkpoint found - using random init")
        params = model_spec.init(0, device=device)
    params = model_spec.flow.precompute_inference(params, fused=device.type == "cuda")

    heats = config_mod.opt_get(opt, ["val", "heats"], [0.0])
    n_sample = config_mod.opt_get(opt, ["val", "n_sample"], 1)
    seed = config_mod.opt_get(opt, ["val", "seed"], 1)

    # LPIPS (AlexNet): only with converted weights, or the opt-in random fallback
    lpips_path = config_mod.opt_get(opt, ["path", "lpips_npz"], "weights/lpips_alex.npz")
    lpips_params = lpips_mod.load(lpips_path, device=device)
    lpips_label = "lpips"
    if lpips_params is None and config_mod.opt_get(
        opt, ["val", "lpips_fallback"], "off"
    ) == "random":
        logger.warning(
            f"no LPIPS weights at {lpips_path}; reporting 'lpips_rand' (He-init "
            "random AlexNet, uniform lin weights - NOT comparable to true LPIPS; "
            "opt-in via val.lpips_fallback: random; see models/lpips.py:random_params)"
        )
        lpips_params = lpips_mod.random_params(seed=0, device=device)
        lpips_label = "lpips_rand"
    lpips_fn = lpips_mod.make_metric(lpips_params) if lpips_params else None
    if lpips_fn is None:
        logger.info(f"LPIPS disabled (no weights at {lpips_path})")

    all_results = {}
    for phase, dataset_opt in sorted((opt.get("datasets") or {}).items()):
        name = dataset_opt.get("name", phase)
        ds = create_dataset(dataset_opt)
        loader = create_dataloader(ds, {**dataset_opt, "phase": "test"})
        logger.info(f"dataset [{name}]: {len(ds)} images")
        evaluator = Evaluator(
            model_spec,
            params,
            heats,
            n_sample=n_sample,
            scale=opt.get("scale", 4),
            lpips_fn=lpips_fn,
            lpips_label=lpips_label,
            logger=logger,
            save_dir=os.path.join(results_root, name),
            suffix=opt.get("suffix") or "",
            rescaling="rescaling" in (opt.get("model") or "").lower(),
            device=device,
        )
        generator = torch.Generator(device=device).manual_seed(seed)
        real_image = dataset_opt.get("mode") == "LQ"
        all_results[name] = evaluator.run(loader, generator, real_image=real_image)
    return all_results


if __name__ == "__main__":
    main()
