"""Affine coupling (kind ``Affine``, FCN net), inverse direction.

The net's output is split even/odd into (shift, scale) (the reference's "cross" split)
and the scale is bounded by ``logscale = 0.318 * atan(2 * scale)``.  The rescaling
kinds (Affine3shift, DenseBlock nets) come with their slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import nets


def clamp_logscale(scale: torch.Tensor) -> torch.Tensor:
    return 0.318 * torch.atan(2.0 * scale)


def cross_split(h: torch.Tensor):
    return h[..., 0::2], h[..., 1::2]


@dataclasses.dataclass(frozen=True)
class CouplingSpec:
    in_channels: int
    cond_channels: Optional[int] = None
    hidden_channels: int = 64
    compute_dtype: Optional[str] = None

    @property
    def c1(self) -> int:
        return self.in_channels // 2

    def init(self, generator: torch.Generator) -> dict:
        c = self.in_channels
        fin = self.c1 + (self.cond_channels or 0)
        return {"f": nets.init_fcn(generator, fin, (c - self.c1) * 2, self.hidden_channels)}

    @property
    def supports_hoisting(self) -> bool:
        """The cond contribution to conv1 can be precomputed outside the step loop."""
        return bool(self.cond_channels)

    def _inverse_from(self, h, z1, z2, logdet):
        shift, scale = cross_split(h)
        logscale = clamp_logscale(scale)
        z2 = z2 * torch.exp(-logscale) - shift
        if logdet is not None:
            logdet = logdet - logscale.sum(dim=(1, 2, 3))
        return torch.cat([z1, z2], -1), logdet

    def inverse(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        z1, z2 = z[..., : self.c1], z[..., self.c1 :]
        x = z1 if self.cond_channels is None else torch.cat([z1, u], -1)
        h = nets.apply_fcn(params["f"], x, self.compute_dtype)
        return self._inverse_from(h, z1, z2, logdet)

    def inverse_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        z1, z2 = z[..., : self.c1], z[..., self.c1 :]
        h = nets.apply_fcn_hoisted(params["f"], z1, u_contrib, self.compute_dtype)
        return self._inverse_from(h, z1, z2, logdet)
