"""Top-level HCFlow SR model: HR <-> (LR, latents) with a Dirac-LR NLL objective.

Forward (the NLL, training): dequantization noise ``hr + U(0, 1) / quant``, logdet
starting at ``-log(quant) * pixels``; the flow maps HR to a fake LR plus per-level
latents whose prior log-density accumulates into logdet; the fake LR is quantized
(straight-through) and tied to the true LR by a narrow Gaussian ("Dirac") with logs
-6; the NLL is in bits per dimension.  Reverse: sample the per-level latents at
temperature eps_std conditioned on the LR image, invert the flow, clamp to [0, 1].
``calibrate`` is the one-time data-dependent ActNorm init on a real batch.

On a ('data', 'spatial') mesh (``parallel.mesh.make_mesh``) a rank holds its batch rows
and a band of their rows: the forward sums the bands' objectives over the spatial group
(differentiably), so that every rank of it returns the NLL of its whole images, and
``calibrate`` calibrates on the gathered global batch, as one process does.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from ..flow.flownet import FlowNetSpec
from ..parallel import halo
from ..ops.densities import gaussian_logp
from ..ops.quant import quantize_ste


def device_for(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA on a machine without it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' (--cpu on the command "
                           "line) to run on the CPU")
    return device


def to_device(tree, device):
    """Every tensor of a nested dict/list of params moved to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    return tree.to(device)


@dataclasses.dataclass(frozen=True)
class HCFlowSRSpec:
    flow: FlowNetSpec
    quant: int = 256  # dequantization levels of the HR image

    @classmethod
    def for_scale(cls, scale: int, quant: int = None, **flow_kwargs) -> "HCFlowSRSpec":
        """The shipped topologies, as hcflow_tpu/models/hcflow_sr.py builds them: x4 =>
        L=2, K=26 with 13 split-off steps, RRDB nb 7, quant 64; x8 (the CelebA-8X face
        model) => L=3, K=26 with 13 split-off steps at every level, RRDB nb 5, quant
        256.  Both nf 64, gc 32, coupling width 64 unless overridden."""
        if scale == 4:
            defaults = dict(L=2, K=(26, 26), after_splitoff=(13, 13), rrdb_nb=(7, 7))
            quant = 64 if quant is None else quant
        elif scale == 8:
            defaults = dict(L=3, K=(26, 26, 26), after_splitoff=(13, 13, 13), rrdb_nb=(5, 5))
            quant = 256 if quant is None else quant
        else:
            raise NotImplementedError(f"scale {scale} is not implemented")
        defaults.update(flow_kwargs)
        return cls(flow=FlowNetSpec(sr=True, **defaults), quant=quant)

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (drawn on the CPU, so the same on every machine),
        on ``device``."""
        device = device_for(device)
        return to_device(self.flow.init(torch.Generator().manual_seed(seed)), device)

    def _dequantize(self, hr: torch.Tensor, generator, noise, mesh=None):
        """(hr + noise / quant, logdet -log(quant) * pixels); noise in [0, 1) drawn from
        ``generator`` (on hr's device) unless given: one of the two is required.
        ``mesh``: hr is this rank's part, the noise drawn for the global batch and this
        rank's part taken, and the logdet counts the part's pixels."""
        B, H, W, _ = hr.shape
        if noise is None:
            if generator is None:
                raise ValueError("pass the dequantization noise or a generator to draw it")
            kw = dict(generator=generator, device=hr.device, dtype=hr.dtype)
            noise = (torch.rand(hr.shape, **kw) if mesh is None
                     else mesh.draw(torch.rand, hr.shape, **kw))
        logdet = hr.new_full((B,), -math.log(self.quant) * (H * W))
        return hr + noise / self.quant, logdet

    # ------------------------------------------------------------- normal flow
    def forward(self, params: dict, hr: torch.Tensor, lr: torch.Tensor, generator=None,
                noise=None, mesh=None):
        """HR -> (fake LR in [0, 1], NLL in bits/dim, the batch mean); hr and lr NHWC in
        [0, 1].  ``noise``: explicit dequantization noise in [0, 1) of hr's shape (zeros
        for a deterministic NLL); else drawn from ``generator``.  Differentiable: the
        NLL step's loss.  ``mesh``: hr, lr and the noise are this rank's parts (bands of
        its batch rows), the fake LR returned its part; the NLL is its rows' whole
        images', equal on every rank of a spatial group."""
        pixels = hr.shape[1] * hr.shape[2]
        x, logdet = self._dequantize(hr, generator, noise, mesh)
        z, logdet = self.flow.normal_flow(params, x, logdet, mesh)
        fake_lr = quantize_ste(z)
        # a narrow Gaussian, approximating a Dirac delta, ties the fake LR to the true LR
        objective = logdet + gaussian_logp(lr, torch.full_like(lr, -6.0), fake_lr)
        if halo.sharded(mesh):  # every term is a sum over pixels: sum the bands'
            objective, pixels = mesh.spatial_sum(objective), pixels * mesh.spatial
        nll = (-objective / (math.log(2.0) * pixels)).mean()
        return fake_lr.clamp(0.0, 1.0), nll

    # ------------------------------------------------------------ reverse flow
    def reverse(self, params: dict, lr: torch.Tensor, eps_std, generator=None,
                eps_list=None, grad: bool = False, mesh=None) -> torch.Tensor:
        """LR -> HR sample at temperature eps_std; NHWC, clamped to [0, 1].

        ``generator`` draws the latents (a generator on lr's device); ``eps_list``
        gives them explicitly instead, one whitened latent per level.  Serving runs
        without autograd; ``grad=True`` records the graph (the pixel step's loss).
        ``mesh`` (``parallel.mesh.make_mesh``): lr is this rank's part of the global LR
        (``mesh.shard``) and the HR returned its part (``mesh.gather`` joins them);
        ``eps_list`` stays global.
        """
        with torch.set_grad_enabled(grad):
            hr = self.flow.reverse_flow(params, lr, eps_std, generator, eps_list, mesh)
            return hr.clamp(0.0, 1.0)

    # ------------------------------------------------------------- calibration
    @torch.no_grad()
    def calibrate(self, params: dict, hr: torch.Tensor, lr: torch.Tensor = None,
                  generator=None, noise=None, mesh=None) -> dict:
        """The one-time data-dependent ActNorm init on a real batch (hr dequantized as
        the forward does); returns new params.  lr is not read (the JAX package's
        signature carries it).  ``mesh``: hr and the noise are this rank's parts; every
        rank calibrates on the gathered global batch, as one process does."""
        if mesh is not None:
            hr, noise = mesh.gather(hr), None if noise is None else mesh.gather(noise)
        x, logdet = self._dequantize(hr, generator, noise)
        return self.flow.calibrate(params, x, logdet)[0]
