"""Top-level HCFlow rescaling model: HR <-> (LR, whitened latents), no NLL.

Rescaling serving is the eval protocol of the JAX package (``cli/evaluate.py``): the
forward downscales HR to an LR image (clamped to [0, 1]) plus one whitened latent
per level; the LR is quantized to 8 bits (:func:`quantize`); the reverse
reconstructs HR from that LR at temperature eps_std (1.0 in the shipped test
config), sampling the latents or taking them explicitly.  Training
(``train/trainer.py`` ``make_rescaling_step``) runs both directions with
``grad=True``; ``calibrate`` is the data-dependent ActNorm init on a real batch.
"""

from __future__ import annotations

import dataclasses

import torch

from ..flow.flownet import FlowNetSpec
from ..utils import profiling
from .hcflow_sr import device_for, to_device


def quantize(x: torch.Tensor) -> torch.Tensor:
    """The eval protocol's 8-bit LR: round(clip(x, 0, 1) * 255) / 255."""
    return torch.round(x.clamp(0.0, 1.0) * 255.0) / 255.0


@dataclasses.dataclass(frozen=True)
class HCFlowRescalingSpec:
    flow: FlowNetSpec

    @classmethod
    def default_x4(cls, **flow_kwargs) -> "HCFlowRescalingSpec":
        """The shipped x4 topology (train_Rescaling_DF2K_4X_HCFlow.yml): L=2, K=14 with
        6 split-off steps, Haar squeeze, no permutation, Affine3shift/DenseBlock main
        chains of growth 32, Affine/FCN split-off chains of width 64, RRDB nb (2, 1),
        nf 64, gc 16."""
        defaults = dict(
            L=2, K=(14, 14), after_splitoff=(6, 6), squeeze="haar", flow_permutation="none",
            flow_coupling="Affine3shift", nn_module="DenseBlock", hidden_channels=32,
            sr=False, so_hidden_channels=64, rrdb_nb=(2, 1), rrdb_nf=64, rrdb_gc=16,
        )
        defaults.update(flow_kwargs)
        return cls(flow=FlowNetSpec(**defaults))

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (drawn on the CPU, so the same on every machine),
        on ``device``."""
        device = device_for(device)
        return to_device(self.flow.init(torch.Generator().manual_seed(seed)), device)

    @profiling.spanned("hcflow.forward")
    def forward(self, params: dict, hr: torch.Tensor, grad: bool = False, mesh=None):
        """HR -> (LR clamped to [0, 1], [whitened latent per level]); NHWC.  Serving
        runs without autograd; ``grad=True`` records the graph (the training step).
        ``mesh`` (``parallel.mesh.make_mesh``): hr is this rank's part of the global HR
        (``mesh.shard``), and the outputs are its parts."""
        with torch.set_grad_enabled(grad):
            z, fake_zs = self.flow.normal_flow(params, hr, mesh=mesh)
            return z.clamp(0.0, 1.0), fake_zs

    @profiling.spanned("hcflow.reverse")
    def reverse(self, params: dict, lr: torch.Tensor, eps_std, generator=None,
                eps_list=None, grad: bool = False, mesh=None) -> torch.Tensor:
        """LR -> HR at temperature eps_std; NHWC, clamped to [0, 1].

        ``generator`` draws the latents (a generator on lr's device); ``eps_list``
        gives them explicitly instead, one whitened latent per level.  ``grad=True``
        records the graph (the training step's inverse leg).  ``mesh``: as
        :meth:`forward`; ``eps_list`` stays global.
        """
        with torch.set_grad_enabled(grad):
            hr = self.flow.reverse_flow(params, lr, eps_std, generator, eps_list, mesh)
            return hr.clamp(0.0, 1.0)

    @torch.no_grad()
    def calibrate(self, params: dict, hr: torch.Tensor, mesh=None) -> dict:
        """The one-time data-dependent ActNorm init on a real batch; returns new params.
        ``mesh``: hr is this rank's part; every rank calibrates on the gathered global
        batch, as one process does."""
        if mesh is not None:
            hr = mesh.gather(hr)
        return self.flow.calibrate(params, hr)[0]
