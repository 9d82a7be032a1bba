"""One Glow-style flow step: ActNorm -> permutation -> coupling.

The inverse runs the three inverses in reverse order; :meth:`FlowStepSpec.calibrate`
is the forward that also data-initialises the step's ActNorms.  The kinds are the JAX
package's (``hcflow_tpu/flow/flowstep.py``): permutation ``invconv`` (plain weight,
or LU-decomposed with ``lu_decomposed``), ``reverse``, ``shuffle`` or ``none``;
coupling ``Affine``, ``Affine3shift``, ``AffineInjector`` (needs cond) or
``noCoupling``, with an ``FCN`` or ``DenseBlock`` net.  The forward takes a spatial
``mesh``: the coupling's nets exchange their halos conv by conv, and ActNorm and the
permutation, local to a pixel, add the band's share of the logdet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import actnorm, coupling, invconv, permute


@dataclasses.dataclass(frozen=True)
class FlowStepSpec:
    in_channels: int
    cond_channels: Optional[int] = None
    hidden_channels: int = 64
    compute_dtype: Optional[str] = None
    flow_permutation: str = "invconv"  # 'invconv' | 'reverse' | 'shuffle' | 'none'
    flow_coupling: str = "Affine"  # 'Affine' | 'Affine3shift' | 'AffineInjector' | 'noCoupling'
    nn_module: str = "FCN"  # 'FCN' | 'DenseBlock'
    lr_vs_others: bool = True  # Affine3shift only
    lu_decomposed: bool = False  # invconv only

    @property
    def coupling_spec(self) -> Optional[coupling.CouplingSpec]:
        if self.flow_coupling == "noCoupling":
            return None
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
            ini = invconv.init_lu if self.lu_decomposed else invconv.init
            params["invconv"] = ini(generator, self.in_channels)
        elif self.flow_permutation in ("reverse", "shuffle"):
            params["permute"] = permute.init(self.in_channels,
                                             shuffle=self.flow_permutation == "shuffle")
        elif self.flow_permutation != "none":
            raise ValueError(f"unknown flow_permutation {self.flow_permutation}")
        cs = self.coupling_spec
        if cs is not None:
            params["coupling"] = cs.init(generator)
        return params

    @staticmethod
    def _permute(params: dict, z, logdet, inverse: bool = False):
        if "invconv" in params:
            return (invconv.inverse if inverse else invconv.forward)(params["invconv"], z, logdet)
        if "permute" in params:
            return (permute.inverse if inverse else permute.forward)(params["permute"], z, logdet)
        return z, logdet

    def forward(self, params: dict, z: torch.Tensor, u=None, logdet=None, mesh=None):
        z, logdet = actnorm.forward(params["actnorm"], z, logdet)
        z, logdet = self._permute(params, z, logdet)
        cs = self.coupling_spec
        return (z, logdet) if cs is None else cs.forward(params["coupling"], z, u, logdet, mesh)

    def forward_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None,
                        mesh=None):
        """Forward with the coupling's cond term precomputed (see stack.py)."""
        z, logdet = actnorm.forward(params["actnorm"], z, logdet)
        z, logdet = self._permute(params, z, logdet)
        return self.coupling_spec.forward_hoisted(params["coupling"], z, u_contrib, logdet,
                                                  mesh)

    def inverse(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        cs = self.coupling_spec
        if cs is not None:
            z, logdet = cs.inverse(params["coupling"], z, u, logdet)
        z, logdet = self._permute(params, z, logdet, inverse=True)
        return actnorm.inverse(params["actnorm"], z, logdet)

    def inverse_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        z, logdet = self.coupling_spec.inverse_hoisted(params["coupling"], z, u_contrib, logdet)
        z, logdet = self._permute(params, z, logdet, inverse=True)
        return actnorm.inverse(params["actnorm"], z, logdet)

    def calibrate(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        """The forward with the data-dependent inits of the flow ActNorm and the
        coupling nets' ActNorms; returns (params, z, logdet).

        The permutation runs as in :meth:`forward`.  (The JAX package's calibrate
        applies an invconv but skips a ``reverse`` / ``shuffle`` permutation, so its
        couplings calibrate on unpermuted channels; the port follows the reference,
        whose ActNorm inits run inside the forward.)"""
        new = dict(params)
        new["actnorm"] = actnorm.calibrate(z)
        z, logdet = actnorm.forward(new["actnorm"], z, logdet)
        z, logdet = self._permute(params, z, logdet)
        cs = self.coupling_spec
        if cs is None:
            return new, z, logdet
        new["coupling"], z, logdet = cs.calibrate(params["coupling"], z, u, logdet)
        return new, z, logdet
