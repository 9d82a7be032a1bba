"""Top-level HCFlow SR model, serving direction: LR -> HR sampling.

Reverse: sample the per-level latents at temperature eps_std conditioned on the LR
image, invert the flow, clamp to [0, 1].  Training (the forward NLL) is not ported.
"""

from __future__ import annotations

import dataclasses

import torch

from ..flow.flownet import FlowNetSpec


def device_for(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA on a machine without it."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass device='cpu' to run on the CPU")
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

    @classmethod
    def for_scale(cls, scale: int, **flow_kwargs) -> "HCFlowSRSpec":
        """The shipped topologies, as hcflow_tpu/models/hcflow_sr.py builds them: x4 =>
        L=2, K=26 with 13 split-off steps, RRDB nb 7; x8 (the CelebA-8X face model) =>
        L=3, K=26 with 13 split-off steps at every level, RRDB nb 5.  Both nf 64, gc
        32, coupling width 64 unless overridden."""
        if scale == 4:
            defaults = dict(L=2, K=(26, 26), after_splitoff=(13, 13), rrdb_nb=(7, 7))
        elif scale == 8:
            defaults = dict(L=3, K=(26, 26, 26), after_splitoff=(13, 13, 13), rrdb_nb=(5, 5))
        else:
            raise NotImplementedError(f"scale {scale} is not implemented")
        defaults.update(flow_kwargs)
        return cls(flow=FlowNetSpec(**defaults))

    def init(self, seed: int = 0, device="cuda") -> dict:
        """Random params from ``seed`` (drawn on the CPU, so the same on every machine),
        on ``device``."""
        device = device_for(device)
        return to_device(self.flow.init(torch.Generator().manual_seed(seed)), device)

    @torch.no_grad()
    def reverse(self, params: dict, lr: torch.Tensor, eps_std, generator=None,
                eps_list=None) -> torch.Tensor:
        """LR -> HR sample at temperature eps_std; NHWC, clamped to [0, 1].

        ``generator`` draws the latents (a generator on lr's device); ``eps_list``
        gives them explicitly instead, one whitened latent per level.
        """
        hr = self.flow.reverse_flow(params, lr, eps_std, generator, eps_list)
        return hr.clamp(0.0, 1.0)
