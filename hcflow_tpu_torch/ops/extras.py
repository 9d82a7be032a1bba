"""The ops of the reference's inventory that no shipped config uses, as the JAX
package's ``hcflow_tpu/ops/extras.py``:

- the sigmoid flow: forward ``sigmoid(x)`` with logdet ``-sum(softplus(x) +
  softplus(-x))``; inverse the logit with logdet ``-sum(log y + log(1 - y))``;
- the masked ActNorm: ActNorm applied to the batch elements a (B,) mask selects,
  the others (and their logdet) passed through;
- ``Split2dSpec``: a channel split whose dropped half is scored against, or sampled
  from, a Gaussian that a zero-init conv predicts from the kept half (plus cond
  features); Split2d, Split2d_LR and the conditional variant;
- ``RDNSpec``: conv_first -> RRDB trunk -> trunk_conv + skip -> conv_last, the last
  zero-initialised (for use inside a flow).

NHWC tensors, OIHW conv weights, as everywhere in this package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from . import actnorm, nets
from .densities import gaussian_logp

_AXES = (1, 2, 3)


# ---------------------------------------------------------------- sigmoid flow
def sigmoid_forward(x: torch.Tensor, logdet=None):
    y = torch.sigmoid(x)
    if logdet is not None:
        logdet = logdet - (F.softplus(x) + F.softplus(-x)).sum(dim=_AXES)
    return y, logdet


def sigmoid_inverse(y: torch.Tensor, logdet=None):
    x = -torch.log(1.0 / y - 1.0)
    if logdet is not None:
        logdet = logdet - (torch.log(y) + torch.log1p(-y)).sum(dim=_AXES)
    return x, logdet


# -------------------------------------------------------------- masked ActNorm
def masked_actnorm_forward(params: dict, x: torch.Tensor, mask: torch.Tensor, logdet=None):
    """ActNorm on the batch elements where the (B,) bool ``mask`` is set."""
    y, ld = actnorm.forward(params, x, logdet)
    out = torch.where(mask[:, None, None, None], y, x)
    if logdet is not None:
        logdet = torch.where(mask, ld, logdet)
    return out, logdet


def masked_actnorm_inverse(params: dict, y: torch.Tensor, mask: torch.Tensor, logdet=None):
    x, ld = actnorm.inverse(params, y, logdet)
    out = torch.where(mask[:, None, None, None], x, y)
    if logdet is not None:
        logdet = torch.where(mask, ld, logdet)
    return out, logdet


# -------------------------------------------------------- learned-prior splits
@dataclasses.dataclass(frozen=True)
class Split2dSpec:
    """``num_channels_pass`` channels continue; the rest are scored against (forward)
    or sampled from (inverse) N(mean, exp(logs) + logs_eps), predicted from the kept
    half and ``cond_channels`` of cond features ``ft``."""

    num_channels: int
    num_channels_pass: int
    cond_channels: int = 0
    logs_eps: float = 0.0

    @property
    def num_channels_consume(self) -> int:
        return self.num_channels - self.num_channels_pass

    def init(self) -> dict:
        cin = self.num_channels_pass + self.cond_channels
        return {"conv": nets.init_conv_zeros(cin, self.num_channels_consume * 2, 3)}

    def _prior(self, params: dict, z1, ft=None):
        h = z1 if ft is None else torch.cat([z1, ft], -1)
        h = nets.apply_conv_zeros(params["conv"], h)
        return h[..., 0::2], h[..., 1::2]

    def forward(self, params: dict, x: torch.Tensor, logdet, ft=None):
        """Returns (z1, logdet, eps): eps is the whitened dropped half."""
        z1, z2 = x[..., : self.num_channels_pass], x[..., self.num_channels_pass :]
        mean, logs = self._prior(params, z1, ft)
        eps = (z2 - mean) / (torch.exp(logs) + self.logs_eps)
        return z1, logdet + gaussian_logp(mean, logs, z2), eps

    def inverse(self, params: dict, z1: torch.Tensor, logdet, eps: Optional[torch.Tensor] = None,
                eps_std: float = 1.0, ft=None, generator=None):
        """(z, logdet) from the kept half and the whitened dropped half ``eps``, or
        one drawn from ``generator`` at temperature ``eps_std``."""
        mean, logs = self._prior(params, z1, ft)
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype) * eps_std
        z2 = mean + (torch.exp(logs) + self.logs_eps) * eps
        return torch.cat([z1, z2], -1), logdet - gaussian_logp(mean, logs, z2)


# ------------------------------------------------------------------------- RDN
@dataclasses.dataclass(frozen=True)
class RDNSpec:
    """conv_first -> nb RRDBs -> trunk_conv + skip -> conv_last (zero for flow use)."""

    in_channels: int
    out_channels: int
    nb: int = 3
    nf: int = 64
    gc: int = 32

    def init(self, generator: torch.Generator) -> dict:
        nf = self.nf
        return {
            "conv_first": {"w": nets.xavier_normal(generator, (nf, self.in_channels, 3, 3), 0.1),
                           "b": torch.zeros(nf)},
            "trunk": nets.init_rrdb_trunk(generator, self.nb, nf, self.gc),
            "trunk_conv": {"w": nets.xavier_normal(generator, (nf, nf, 3, 3), 0.1),
                           "b": torch.zeros(nf)},
            "conv_last": {"w": torch.zeros(self.out_channels, nf, 3, 3),
                          "b": torch.zeros(self.out_channels)},
        }

    def apply(self, params: dict, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        def conv(name, h):
            return nets.conv2d(h, params[name]["w"], params[name]["b"], compute_dtype)

        h = conv("conv_first", x)
        h = conv("trunk_conv", nets.apply_rrdb_trunk(params["trunk"], h, compute_dtype)) + h
        return conv("conv_last", h)
