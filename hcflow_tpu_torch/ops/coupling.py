"""Affine couplings: kind ``Affine`` (SR) and ``Affine3shift`` (rescaling).

- ``Affine``: z splits in halves; a net on (z1, cond) predicts shift/scale for z2.
- ``Affine3shift``: z splits into the 3 LR channels and the c-3 others.  With
  ``lr_vs_others=True`` the LR channels drive an affine transform of the others;
  with ``False`` the others drive a shift-only transform of the LR channels, and the
  output keeps the LR channels first.

The net (``FCN`` or ``DenseBlock``) output is split even/odd into (shift, scale) (the
reference's "cross" split) and the scale is bounded by
``logscale = 0.318 * atan(2 * scale)``.
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
    kind: str = "Affine"  # 'Affine' | 'Affine3shift'
    nn_module: str = "FCN"  # 'FCN' | 'DenseBlock'
    lr_vs_others: bool = True  # Affine3shift only

    @property
    def c1(self) -> int:
        return self.in_channels // 2

    def _f_channels(self):
        c, cc = self.in_channels, self.cond_channels or 0
        if self.kind == "Affine3shift":
            return (3 + cc, (c - 3) * 2) if self.lr_vs_others else (c - 3 + cc, 3)
        if self.kind != "Affine":
            raise ValueError(f"coupling kind {self.kind} is not ported")
        return self.c1 + cc, (c - self.c1) * 2

    def init(self, generator: torch.Generator) -> dict:
        fin, fout = self._f_channels()
        if self.nn_module == "FCN":
            return {"f": nets.init_fcn(generator, fin, fout, self.hidden_channels)}
        if self.nn_module == "DenseBlock":
            return {"f": nets.init_dense_block(generator, fin, fout, self.hidden_channels)}
        raise ValueError(f"unknown nn_module {self.nn_module}")

    def _net(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        if self.nn_module == "FCN":
            return nets.apply_fcn(params["f"], x, self.compute_dtype)
        return nets.apply_dense_block(params["f"], x, self.compute_dtype)

    def _f_input(self, z1, u):
        return z1 if self.cond_channels is None else torch.cat([z1, u], -1)

    @property
    def supports_hoisting(self) -> bool:
        """The cond contribution to conv1 can be precomputed outside the step loop."""
        return self.kind == "Affine" and self.nn_module == "FCN" and bool(self.cond_channels)

    # ------------------------------------------------------------------- forward
    def _forward_from(self, h, z1, z2, logdet):
        shift, scale = cross_split(h)
        logscale = clamp_logscale(scale)
        z2 = (z2 + shift) * torch.exp(logscale)
        if logdet is not None:
            logdet = logdet + logscale.sum(dim=(1, 2, 3))
        return torch.cat([z1, z2], -1), logdet

    def forward(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        if self.kind == "Affine3shift" and not self.lr_vs_others:
            z2, z1 = z[..., :3], z[..., 3:]
            z2 = z2 + self._net(params, self._f_input(z1, u))
            return torch.cat([z2, z1], -1), logdet
        n1 = 3 if self.kind == "Affine3shift" else self.c1
        z1, z2 = z[..., :n1], z[..., n1:]
        return self._forward_from(self._net(params, self._f_input(z1, u)), z1, z2, logdet)

    def forward_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        z1, z2 = z[..., : self.c1], z[..., self.c1 :]
        h = nets.apply_fcn_hoisted(params["f"], z1, u_contrib, self.compute_dtype)
        return self._forward_from(h, z1, z2, logdet)

    # ------------------------------------------------------------------- inverse
    def _inverse_from(self, h, z1, z2, logdet):
        shift, scale = cross_split(h)
        logscale = clamp_logscale(scale)
        z2 = z2 * torch.exp(-logscale) - shift
        if logdet is not None:
            logdet = logdet - logscale.sum(dim=(1, 2, 3))
        return torch.cat([z1, z2], -1), logdet

    def inverse(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        if self.kind == "Affine3shift":
            # as in hcflow_tpu/ops/coupling.py:248-261: the shift-only inverse ignores
            # cond, and neither inverse adds to logdet
            if not self.lr_vs_others:
                z2, z1 = z[..., :3], z[..., 3:]
                return torch.cat([z2 - self._net(params, z1), z1], -1), logdet
            z1, z2 = z[..., :3], z[..., 3:]
            h = self._net(params, self._f_input(z1, u))
            return self._inverse_from(h, z1, z2, None)[0], logdet
        z1, z2 = z[..., : self.c1], z[..., self.c1 :]
        return self._inverse_from(self._net(params, self._f_input(z1, u)), z1, z2, logdet)

    def inverse_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        z1, z2 = z[..., : self.c1], z[..., self.c1 :]
        h = nets.apply_fcn_hoisted(params["f"], z1, u_contrib, self.compute_dtype)
        return self._inverse_from(h, z1, z2, logdet)

    # --------------------------------------------------------------- calibration
    def calibrate(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        """The forward that also data-initialises the net's ActNorms (an FCN's; a
        DenseBlock has none).  Returns (params, z, logdet)."""
        if self.kind == "Affine3shift":
            z1 = z[..., :3] if self.lr_vs_others else z[..., 3:]
        else:
            z1 = z[..., : self.c1]
        new = dict(params)
        if self.nn_module == "FCN":
            new["f"] = nets.calib_fcn(params["f"], self._f_input(z1, u))[0]
        return (new, *self.forward(new, z, u, logdet))
