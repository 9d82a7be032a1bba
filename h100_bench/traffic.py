"""The one generator of requests, driven by a traffic mix's parameters.

A mix (``traffic/<name>.json``) names its ``entry`` (what a request asks of the model:
``reverse``, LR -> HR; ``tiled_reverse``, LR -> HR through the tiled predictor path;
``forward``, HR -> 8-bit LR codes and latents), the size of its images (``lr_hw`` or
``hr_hw``, height and width), the requests kept in flight (``in_flight``, a closed
loop), the ``heat`` at which the latents are drawn, the ``pool`` of distinct images
and the ``sample`` of window requests checked against the reference; the ``reverse``
entry also a ``batch`` of images a request (default 1), the tiled entry ``tile``,
``overlap`` and ``tile_batch``.

Inputs are 8-bit images, as a server receives photos and an image store keeps its LR
codes: smooth random fields with fine noise, made on the device from the seed at
set-up and kept in pinned host memory.  Request r takes the B = ``batch`` images
``(r * B + j) % pool``, j = 0 ... B - 1, and its own latents, drawn on the device from
(seed, r, batch) at the mix's heat; every seed gives the same sizes and the same number
of requests for the same time.  A request is its B images: ``hr_mp`` counts them all,
and what a per-layer metric gives a request it gives a batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .weights import mix


class Traffic:
    def __init__(self, params: dict, top, scale: int, seed: int, device):
        self.p, self.top, self.scale, self.seed = params, top, scale, seed
        self.device = torch.device(device)
        self.entry = params["entry"]
        if self.entry == "forward":
            self.hr_hw = tuple(params["hr_hw"])
            self.lr_hw = (self.hr_hw[0] // scale, self.hr_hw[1] // scale)
        else:
            self.lr_hw = tuple(params["lr_hw"])
            self.hr_hw = (self.lr_hw[0] * scale, self.lr_hw[1] * scale)
        if "batch" in params and self.entry != "reverse":
            raise ValueError(f"traffic key 'batch' is for the reverse entry, not {self.entry!r}")
        self.batch = params.get("batch", 1)
        self.in_flight = params.get("in_flight", 1)
        self.heat = params.get("heat", 1.0)
        self.sample = params.get("sample", 2)
        self.hr_mp = self.batch * self.hr_hw[0] * self.hr_hw[1] / 1e6  # HR megapixels a request

    def images(self) -> torch.Tensor:
        """The pool of input images, uint8 NHWC in pinned host memory (on the CPU,
        ordinary memory)."""
        n = self.p.get("pool", 4)
        h, w = self.hr_hw if self.entry == "forward" else self.lr_hw
        gen = torch.Generator(device=self.device).manual_seed(mix(self.seed, "images"))
        coarse = torch.rand(n, 3, h // 16 + 2, w // 16 + 2, generator=gen, device=self.device)
        img = F.interpolate(coarse, size=(h, w), mode="bicubic", align_corners=False)
        img = img + 0.05 * torch.randn(img.shape, generator=gen, device=self.device)
        u8 = torch.round(img.clamp(0.0, 1.0) * 255.0).to(torch.uint8).permute(0, 2, 3, 1)
        out = torch.empty(u8.shape, dtype=torch.uint8, pin_memory=self.device.type == "cuda")
        out.copy_(u8)
        return out

    def image_ids(self, r: int, pool: int) -> list:
        """The pool indices of request r's images."""
        return [(r * self.batch + j) % pool for j in range(self.batch)]

    def eps_shapes(self, B: int, lr_hw) -> list:
        """NHWC shapes of the whitened latents of a batch of B images of LR size lr_hw."""
        L = self.top.L
        shapes = []
        for i, (_, _, a, _) in enumerate(self.top.levels):
            f = 2 ** (L - 1 - i)
            shapes.append((B, lr_hw[0] * f, lr_hw[1] * f, a))
        return shapes

    def eps(self, r: int, b: int = 0, B: int = 1, lr_hw=None) -> list:
        """Request r's latents (for its batch b of B images of LR size lr_hw), one NHWC
        tensor a level on the device, the heat already in them."""
        gen = torch.Generator(device=self.device).manual_seed(mix(self.seed, "eps", r, b))
        return [torch.randn(s, generator=gen, device=self.device) * self.heat
                for s in self.eps_shapes(B, lr_hw or self.lr_hw)]
