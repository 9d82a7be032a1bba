"""One Glow-style flow step: ActNorm -> (invertible 1x1 conv) -> coupling.

The inverse runs the three inverses in reverse order; :meth:`FlowStepSpec.calibrate`
is the forward that also data-initialises the step's ActNorms.  Ported kinds: permutation
``invconv`` (plain weight) or ``none``; coupling ``Affine`` or ``Affine3shift`` with an
``FCN`` or ``DenseBlock`` net.
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
    flow_permutation: str = "invconv"  # 'invconv' | 'none'
    flow_coupling: str = "Affine"  # 'Affine' | 'Affine3shift'
    nn_module: str = "FCN"  # 'FCN' | 'DenseBlock'
    lr_vs_others: bool = True  # Affine3shift only

    @property
    def coupling_spec(self) -> coupling.CouplingSpec:
        return coupling.CouplingSpec(
            in_channels=self.in_channels,
            cond_channels=self.cond_channels,
            hidden_channels=self.hidden_channels,
            compute_dtype=self.compute_dtype,
            kind=self.flow_coupling,
            nn_module=self.nn_module,
            lr_vs_others=self.lr_vs_others,
        )

    def init(self, generator: torch.Generator) -> dict:
        params = {"actnorm": actnorm.init(self.in_channels)}
        if self.flow_permutation == "invconv":
            params["invconv"] = invconv.init(generator, self.in_channels)
        elif self.flow_permutation != "none":
            raise ValueError(f"flow_permutation {self.flow_permutation} is not ported")
        params["coupling"] = self.coupling_spec.init(generator)
        return params

    def forward(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        z, logdet = actnorm.forward(params["actnorm"], z, logdet)
        if "invconv" in params:
            z, logdet = invconv.forward(params["invconv"], z, logdet)
        return self.coupling_spec.forward(params["coupling"], z, u, logdet)

    def forward_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        """Forward with the coupling's cond term precomputed (see stack.py)."""
        z, logdet = actnorm.forward(params["actnorm"], z, logdet)
        if "invconv" in params:
            z, logdet = invconv.forward(params["invconv"], z, logdet)
        return self.coupling_spec.forward_hoisted(params["coupling"], z, u_contrib, logdet)

    def inverse(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        z, logdet = self.coupling_spec.inverse(params["coupling"], z, u, logdet)
        if "invconv" in params:
            z, logdet = invconv.inverse(params["invconv"], z, logdet)
        return actnorm.inverse(params["actnorm"], z, logdet)

    def inverse_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        z, logdet = self.coupling_spec.inverse_hoisted(params["coupling"], z, u_contrib, logdet)
        if "invconv" in params:
            z, logdet = invconv.inverse(params["invconv"], z, logdet)
        return actnorm.inverse(params["actnorm"], z, logdet)

    def calibrate(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        """The forward with the data-dependent inits of the flow ActNorm and the
        coupling net's ActNorms; returns (params, z, logdet)."""
        new = dict(params)
        new["actnorm"] = actnorm.calibrate(z)
        z, logdet = actnorm.forward(new["actnorm"], z, logdet)
        if "invconv" in params:
            z, logdet = invconv.forward(params["invconv"], z, logdet)
        new["coupling"], z, logdet = self.coupling_spec.calibrate(params["coupling"], z, u, logdet)
        return new, z, logdet
