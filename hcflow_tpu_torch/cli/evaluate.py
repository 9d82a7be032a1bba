"""Shared evaluation pipeline: forward NLL, reverse sampling grid, full metric set.

The counterpart of the JAX package's ``hcflow_tpu/cli/evaluate.py``, after the
reference's test_HCFlow.py.  Per image: the forward flow's NLL and generated LR (the
LR-consistency check), reverse samples per (heat, n_sample), PSNR/SSIM(+Y), LPIPS
(when weights are available), bicubic-downscale consistency ("bicHR"), sample
diversity; per-dataset averages.  Metrics are computed on uint8-quantized images
exactly as the reference does (its tensor2img round trip).  The same keys, log lines
and saved file names as JAX's Evaluator.

The model runs on ``device`` (the card unless the caller asks for the CPU), under
``torch.no_grad()``: on the card the kernel wrappers refuse autograd inputs.  Its
randomness (the forward's dequantization noise, the latents) comes from one
``torch.Generator`` on that device, in turn, where JAX splits a key per image.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Optional

import numpy as np
import torch

from ..data.imresize import imresize
from ..data.util import img_to_uint8, save_img
from ..models.hcflow_sr import device_for
from ..utils.metrics import calculate_psnr_ssim, diversity


def _quantize(img: np.ndarray) -> np.ndarray:
    return img_to_uint8(img).astype(np.float32) / 255.0


class Evaluator:
    """Runs the full HCFlow eval protocol over a loader of single-image batches.

    ``params`` are on ``device`` already, as the caller serves them: packed by
    ``precompute_inference(params, fused=True)`` for the kernels, or not.
    """

    def __init__(
        self,
        model_spec,
        params,
        heats,
        n_sample: int = 1,
        scale: int = 4,
        crop_border: Optional[int] = None,
        lpips_fn: Optional[Callable] = None,
        lpips_label: str = "lpips",
        logger=None,
        save_dir: Optional[str] = None,
        suffix: str = "",
        rescaling: bool = False,
        device="cuda",
    ):
        self.model = model_spec
        self.params = params
        self.heats = list(heats)
        self.n_sample = n_sample
        self.scale = scale
        self.crop_border = scale if crop_border is None else crop_border
        self.lpips_fn = lpips_fn
        self.lpips_label = lpips_label
        self.logger = logger
        self.save_dir = save_dir
        self.suffix = suffix
        self.rescaling = rescaling
        self.device = device_for(device)
        # the reference's eval logs z1.mean() under its nll slot for rescaling; the value
        # is kept under its own name, as the JAX package does
        self.nll_label = "z_mean" if rescaling else "nll"

    def _log(self, msg):
        if self.logger:
            self.logger.info(msg)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

    def sample(self, reverse_input: np.ndarray, heat: float, generator) -> np.ndarray:
        """The n_sample draws at ``heat`` from one LR image (1, H, W, 3), as one batch:
        (n_sample, H * scale, W * scale, 3) numpy in [0, 1]."""
        rep = self._tensor(np.repeat(reverse_input, self.n_sample, axis=0))
        return self.model.reverse(self.params, rep, float(heat), generator=generator).cpu().numpy()

    @torch.no_grad()
    def run(self, loader, generator: torch.Generator, real_image: bool = False) -> dict:
        """Evaluate every batch of ``loader``; ``generator`` (on the device) draws the
        forward's noise and the latents.  Returns the per-dataset averages."""
        per_image = defaultdict(list)
        idx = 0
        for batch in loader:
            idx += 1
            lr = batch["LQ"]
            img_path = batch.get("GT_path", batch.get("LQ_path"))[0]
            img_name = os.path.splitext(os.path.basename(str(img_path)))[0]

            nll = 0.0
            reverse_input = lr
            if not real_image and "GT" in batch:
                hr = self._tensor(batch["GT"])
                if self.rescaling:
                    # rescaling protocol (the reference's HCFlow_Rescaling_model.test):
                    # downscale with the model, quantize, and reconstruct HR from THAT
                    # generated LR
                    fake_lr, fake_zs = self.model.forward(self.params, hr)
                    nll = float(fake_zs[0].mean())  # logged as z_mean (ref logs z1.mean())
                    fake_lr = fake_lr.cpu().numpy()
                    reverse_input = _quantize(fake_lr[0])[None]
                else:
                    fake_lr, nll_t = self.model.forward(self.params, hr, self._tensor(lr),
                                                        generator=generator)
                    nll = float(nll_t)
                    fake_lr = fake_lr.cpu().numpy()
                gt_lr = _quantize(lr[0])
                sr_lr = _quantize(fake_lr[0])
                lr_metrics = calculate_psnr_ssim(gt_lr, sr_lr, 0)
                per_image["lr_psnr"].append(lr_metrics[0])
                per_image["lr_ssim"].append(lr_metrics[1])
                per_image["lr_psnr_y"].append(lr_metrics[2])
                per_image["lr_ssim_y"].append(lr_metrics[3])
            per_image[self.nll_label].append(nll)

            for heat in self.heats:
                srs = self.sample(reverse_input, heat, generator)
                sr_imgs = []
                for sample in range(self.n_sample):
                    sr_img = _quantize(srs[sample])
                    sr_imgs.append(sr_img)
                    if self.save_dir:
                        sfx = f"_{self.suffix}" if self.suffix else ""
                        save_img(
                            os.path.join(
                                self.save_dir, f"SR_{img_name}_{heat:.1f}_{sample}{sfx}.png"
                            ),
                            sr_img,
                        )
                    if not real_image and "GT" in batch:
                        gt_img = _quantize(batch["GT"][0])
                        m = calculate_psnr_ssim(gt_img, sr_img, self.crop_border)
                        per_image[f"psnr@{heat}"].append(m[0])
                        per_image[f"ssim@{heat}"].append(m[1])
                        per_image[f"psnr_y@{heat}"].append(m[2])
                        per_image[f"ssim_y@{heat}"].append(m[3])
                        bic_gt = imresize(gt_img, 1 / self.scale)
                        bic_sr = imresize(sr_img, 1 / self.scale)
                        bm = calculate_psnr_ssim(bic_gt, bic_sr, 0)
                        per_image[f"bic_psnr@{heat}"].append(bm[0])
                        per_image[f"bic_ssim@{heat}"].append(bm[1])
                        if self.lpips_fn is not None:
                            per_image[f"{self.lpips_label}@{heat}"].append(
                                float(self.lpips_fn(gt_img, sr_img))
                            )
                if not real_image and "GT" in batch:
                    per_image[f"diversity@{heat}"].append(diversity(sr_imgs))
                    self._log(
                        f"{img_name:20s} heat:{heat:.1f} "
                        f"PSNR/SSIM/PSNR_Y/SSIM_Y: "
                        f"{np.mean(per_image[f'psnr@{heat}'][-self.n_sample:]):.2f}/"
                        f"{np.mean(per_image[f'ssim@{heat}'][-self.n_sample:]):.4f}/"
                        f"{np.mean(per_image[f'psnr_y@{heat}'][-self.n_sample:]):.2f}/"
                        f"{np.mean(per_image[f'ssim_y@{heat}'][-self.n_sample:]):.4f}, "
                        f"{self.nll_label.upper()}: {nll:.4f}"
                    )

        averages = {k: float(np.mean(v)) for k, v in per_image.items() if v}
        averages["n_images"] = idx
        for heat in self.heats:
            if f"psnr@{heat}" in averages:
                self._log(
                    f"---- average ({idx} images, {self.n_sample} samples, heat {heat:.1f}): "
                    f"PSNR/SSIM/PSNR_Y/SSIM_Y: {averages[f'psnr@{heat}']:.2f}/"
                    f"{averages[f'ssim@{heat}']:.4f}/{averages[f'psnr_y@{heat}']:.2f}/"
                    f"{averages[f'ssim_y@{heat}']:.4f}, "
                    f"bicHR PSNR/SSIM: {averages.get(f'bic_psnr@{heat}', 0):.2f}/"
                    f"{averages.get(f'bic_ssim@{heat}', 0):.4f}, "
                    f"LR PSNR/SSIM: {averages.get('lr_psnr', 0):.2f}/"
                    f"{averages.get('lr_ssim', 0):.4f}, "
                    f"diversity: {averages.get(f'diversity@{heat}', 0):.4f}, "
                    f"{self.nll_label.upper()}: {averages.get(self.nll_label, 0):.4f}"
                    + (f", {self.lpips_label}: "
                       f"{averages[f'{self.lpips_label}@{heat}']:.4f}"
                       if f"{self.lpips_label}@{heat}" in averages else "")
                )
        return averages
