"""One Glow-style flow step, ActNorm -> invconv -> Affine coupling (FCN net);
inverse direction.

The inverse runs the three inverses in reverse order.  Only the SR steps' kinds are
ported: invconv permutation with a plain weight, Affine coupling with an FCN net.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import actnorm, coupling, invconv


@dataclasses.dataclass(frozen=True)
class FlowStepSpec:
    in_channels: int
    cond_channels: Optional[int] = None
    hidden_channels: int = 64
    compute_dtype: Optional[str] = None

    @property
    def coupling_spec(self) -> coupling.CouplingSpec:
        return coupling.CouplingSpec(
            in_channels=self.in_channels,
            cond_channels=self.cond_channels,
            hidden_channels=self.hidden_channels,
            compute_dtype=self.compute_dtype,
        )

    def init(self, generator: torch.Generator) -> dict:
        return {
            "actnorm": actnorm.init(self.in_channels),
            "invconv": invconv.init(generator, self.in_channels),
            "coupling": self.coupling_spec.init(generator),
        }

    def inverse(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        z, logdet = self.coupling_spec.inverse(params["coupling"], z, u, logdet)
        z, logdet = invconv.inverse(params["invconv"], z, logdet)
        return actnorm.inverse(params["actnorm"], z, logdet)

    def inverse_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        z, logdet = self.coupling_spec.inverse_hoisted(params["coupling"], z, u_contrib, logdet)
        z, logdet = invconv.inverse(params["invconv"], z, logdet)
        return actnorm.inverse(params["actnorm"], z, logdet)
