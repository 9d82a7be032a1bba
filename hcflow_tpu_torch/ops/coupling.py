"""Affine couplings: kind ``Affine`` (SR), ``Affine3shift`` (rescaling) and
``AffineInjector``.

- ``Affine``: z splits in halves; a net on (z1, cond) predicts shift/scale for z2.
- ``Affine3shift``: z splits into the 3 LR channels and the c-3 others.  With
  ``lr_vs_others=True`` the LR channels drive an affine transform of the others;
  with ``False`` the others drive a shift-only transform of the LR channels, and the
  output keeps the LR channels first.
- ``AffineInjector`` (SRFlow's): a net ``f_injector`` on the cond alone predicts
  shift/scale for every channel, then an ``Affine`` coupling follows; it needs cond.

The net (``FCN`` or ``DenseBlock``) output is split even/odd into (shift, scale) (the
reference's "cross" split) and the scale is bounded by
``logscale = 0.318 * atan(2 * scale)``.  The forward takes a spatial ``mesh`` (None by
default): its nets then exchange one row each side before each 3x3 conv
(``nets.conv2d``), so that the affine arithmetic and its logdet see only the band's own
pixels.
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
    kind: str = "Affine"  # 'Affine' | 'Affine3shift' | 'AffineInjector'
    nn_module: str = "FCN"  # 'FCN' | 'DenseBlock'
    lr_vs_others: bool = True  # Affine3shift only

    @property
    def c1(self) -> int:
        return self.in_channels // 2

    def _f_channels(self):
        c, cc = self.in_channels, self.cond_channels or 0
        if self.kind == "Affine3shift":
            return (3 + cc, (c - 3) * 2) if self.lr_vs_others else (c - 3 + cc, 3)
        if self.kind not in ("Affine", "AffineInjector"):
            raise ValueError(f"coupling kind {self.kind} is not ported")
        return self.c1 + cc, (c - self.c1) * 2

    def _net_init(self, generator, fin, fout):
        if self.nn_module == "FCN":
            return nets.init_fcn(generator, fin, fout, self.hidden_channels)
        if self.nn_module == "DenseBlock":
            return nets.init_dense_block(generator, fin, fout, self.hidden_channels)
        raise ValueError(f"unknown nn_module {self.nn_module}")

    def init(self, generator: torch.Generator) -> dict:
        fin, fout = self._f_channels()
        params = {"f": self._net_init(generator, fin, fout)}
        if self.kind == "AffineInjector":
            params["f_injector"] = self._net_init(generator, self.cond_channels,
                                                  self.in_channels * 2)
        return params

    def _net(self, params: dict, x: torch.Tensor, net: str = "f", mesh=None) -> torch.Tensor:
        if self.nn_module == "FCN":
            return nets.apply_fcn(params[net], x, self.compute_dtype, mesh)
        return nets.apply_dense_block(params[net], x, self.compute_dtype, mesh)

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

    def forward(self, params: dict, z: torch.Tensor, u=None, logdet=None, mesh=None):
        if self.kind == "AffineInjector":  # the injector's affine on every channel first
            shift, scale = cross_split(self._net(params, u, "f_injector", mesh))
            logscale = clamp_logscale(scale)
            z = (z + shift) * torch.exp(logscale)
            if logdet is not None:
                logdet = logdet + logscale.sum(dim=(1, 2, 3))
        if self.kind == "Affine3shift" and not self.lr_vs_others:
            z2, z1 = z[..., :3], z[..., 3:]
            z2 = z2 + self._net(params, self._f_input(z1, u), mesh=mesh)
            return torch.cat([z2, z1], -1), logdet
        n1 = 3 if self.kind == "Affine3shift" else self.c1
        z1, z2 = z[..., :n1], z[..., n1:]
        h = self._net(params, self._f_input(z1, u), mesh=mesh)
        return self._forward_from(h, z1, z2, logdet)

    def forward_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None,
                        mesh=None):
        z1, z2 = z[..., : self.c1], z[..., self.c1 :]
        h = nets.apply_fcn_hoisted(params["f"], z1, u_contrib, self.compute_dtype, mesh)
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
        h = self._net(params, self._f_input(z1, u))
        if self.kind != "AffineInjector":
            return self._inverse_from(h, z1, z2, logdet)
        # as hcflow_tpu/ops/coupling.py writes it: the AffineInjector inverse adds
        # nothing to logdet
        z = self._inverse_from(h, z1, z2, None)[0]
        shift, scale = cross_split(self._net(params, u, "f_injector"))
        return z * torch.exp(-clamp_logscale(scale)) - shift, logdet

    def inverse_hoisted(self, params: dict, z: torch.Tensor, u_contrib, logdet=None):
        z1, z2 = z[..., : self.c1], z[..., self.c1 :]
        h = nets.apply_fcn_hoisted(params["f"], z1, u_contrib, self.compute_dtype)
        return self._inverse_from(h, z1, z2, logdet)

    # --------------------------------------------------------------- calibration
    def calibrate(self, params: dict, z: torch.Tensor, u=None, logdet=None):
        """The forward that also data-initialises the nets' ActNorms (an FCN's; a
        DenseBlock has none).  Returns (params, z, logdet).  ``AffineInjector``: the
        injector first, then ``f`` on the injected z (the JAX package's order)."""
        new = dict(params)
        fcn = self.nn_module == "FCN"
        if self.kind == "AffineInjector" and fcn:
            new["f_injector"] = nets.calib_fcn(params["f_injector"], u)[0]
            z_in, _ = self.forward({**params, "f_injector": new["f_injector"]}, z, u)
            z1 = z_in[..., : self.c1]
        elif self.kind == "Affine3shift":
            z1 = z[..., :3] if self.lr_vs_others else z[..., 3:]
        else:
            z1 = z[..., : self.c1]
        if fcn:
            new["f"] = nets.calib_fcn(params["f"], self._f_input(z1, u))[0]
        return (new, *self.forward(new, z, u, logdet))
