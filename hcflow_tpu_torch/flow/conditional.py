"""Per-level conditional flow: RRDB encoder, prior, conditional flow steps.

A split-off latent ``a`` (the channels removed at a hierarchy level) is modelled
conditionally on ``u`` (the retained channels, concatenated with the upsampled
conditioning features of the deeper levels):

- conditioning encoder: conv_first -> RRDB trunk0 = feat1 -> RRDB trunk1 ->
  trunk_conv1, plus the conv_first skip = feat2.  SR (``sr=True``): the cond
  features are cat(feat1, feat2), 2 nf channels; rescaling (``sr=False``): feat2
  alone, nf channels;
- a zero-init conv prior head maps them to (mean, logs); the rescaling prior bounds
  logs by ``0.318 * atan(2 * logs)``;
- ``n_flow_step`` conditional flow steps on a.

Reverse (both kinds): ``z = mean + exp(logs) * eps``, then the steps inverted.
Forward: the steps, then SR adds the prior's log-density of z into logdet (the NLL),
rescaling returns the whitened ``fake_z = (z - mean) * exp(-logs)``.  ``encode_eps``
gives the whitened latent of both kinds, which ``reverse(..., eps=...)`` inverts;
``calibrate`` is the forward with the steps' data-dependent ActNorm inits.

The steps are the JAX package's kinds (``flow_permutation``, ``flow_coupling``,
``nn_module``; flow/flowstep.py); those that support it (Affine/FCN) run with their
cond terms hoisted into one wide conv (flow/stack.py).  The encoder runs in
``encoder_dtype`` when set (the shipped SR training recipe: bf16 encoders, float32
couplings), else in ``compute_dtype``; with ``remat_trunks`` and grad enabled each
RRDB's activations are recomputed in the backward pass, with ``remat_steps`` each
step's.  With packed
weights attached by ``FlowNetSpec.precompute_inference(fused=True)`` the trunks run an
RRDB kernel (ops/rrdb.py: per RRDB, or the whole trunk in one launch when packed with
``resident_trunk``; bf16 or float32, as the encoder dtype is), in the forward as in the
reverse, and the inverse steps the inverse-chain kernel (ops/chain.py); otherwise the
plain step-by-step path runs.  With a spatial ``mesh`` (``parallel/mesh.py``; None, the
default, is the unsharded pass) u is this rank's band of rows, and every unit runs on
the band plus the rows of halo it reads, on either path: each 3x3 conv 1, each RRDB 15
(a resident trunk 15 nb), a K-step chain its nets' sum (2K for FCN nets), its hoisted
cond terms one more (``parallel/halo.py``).  The SR forward (the NLL) runs its steps on
the band alone, each net's 3x3 convs exchanging one row, so that its logdet and the
prior's log-density sum over the band's own pixels: the band's share of the image's,
which the caller sums over the spatial group.  Every path is differentiable.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from ..ops import chain, coupling, densities, nets, rrdb
from ..parallel import halo
from ..utils import profiling
from . import stack
from .flowstep import FlowStepSpec


@dataclasses.dataclass(frozen=True)
class ConditionalFlowSpec:
    num_channels: int  # channels entering the split at this level
    num_channels_split: int  # channels retained (passed on); a has the rest
    n_flow_step: int = 0
    num_levels_condition: int = 0
    sr: bool = True  # SR prior and cond features, or the rescaling ones
    rrdb_nb: Sequence[int] = (5, 5)
    rrdb_nf: int = 64
    rrdb_gc: int = 32
    flow_permutation: str = "invconv"
    flow_coupling: str = "Affine"
    nn_module: str = "FCN"
    hidden_channels: int = 64
    compute_dtype: Optional[str] = None  # 'bfloat16' => coupling and encoder nets in bf16
    encoder_dtype: Optional[str] = None  # overrides compute_dtype for the RRDB encoder
    remat_steps: bool = False  # recompute each step's activations in the backward pass
    remat_trunks: bool = True  # recompute the trunks' activations in the backward pass

    @property
    def a_channels(self) -> int:
        return self.num_channels - self.num_channels_split

    @property
    def cond_channels(self) -> int:
        return 2 * self.rrdb_nf if self.sr else self.rrdb_nf  # cat(feat1, feat2) or feat2

    @property
    def encoder_compute_dtype(self) -> Optional[str]:
        return self.encoder_dtype if self.encoder_dtype is not None else self.compute_dtype

    @property
    def conv_first_in(self) -> int:
        return self.num_channels_split + self.cond_channels * self.num_levels_condition

    @property
    def step_spec(self) -> FlowStepSpec:
        return FlowStepSpec(
            in_channels=self.a_channels,
            cond_channels=self.cond_channels,
            hidden_channels=self.hidden_channels,
            compute_dtype=self.compute_dtype,
            flow_permutation=self.flow_permutation,
            flow_coupling=self.flow_coupling,
            nn_module=self.nn_module,
        )

    @property
    def hoists(self) -> bool:
        """The steps' cond terms can be precomputed as one wide conv."""
        cs = self.step_spec.coupling_spec
        return cs is not None and cs.supports_hoisting

    def init(self, generator: torch.Generator) -> dict:
        nf = self.rrdb_nf
        w_first, b_first = nets.torch_default_conv(generator, (nf, self.conv_first_in, 3, 3))
        w_trunk, b_trunk = nets.torch_default_conv(generator, (nf, nf, 3, 3))
        params = {
            "conv_first": {"w": w_first, "b": b_first},
            "trunk0": nets.init_rrdb_trunk(generator, self.rrdb_nb[0], nf, self.rrdb_gc),
            "trunk1": nets.init_rrdb_trunk(generator, self.rrdb_nb[1], nf, self.rrdb_gc),
            "trunk_conv1": {"w": w_trunk, "b": b_trunk},
            "f": nets.init_conv_zeros(self.cond_channels, self.a_channels * 2, 3),
        }
        if self.n_flow_step > 0:
            params["steps"] = stack.init_stack(self.step_spec, generator, self.n_flow_step)
        return params

    # ------------------------------------------------------------------- encoder
    def _trunk(self, params: dict, name: str, x: torch.Tensor, cd, mesh=None) -> torch.Tensor:
        packed = params.get(f"{name}_fused")
        if packed is not None:
            return rrdb.trunk_apply(packed, x, mesh)
        return nets.apply_rrdb_trunk(params[name], x, cd, remat=self.remat_trunks, mesh=mesh)

    @profiling.spanned("hcflow.encoder")
    def cond_feature(self, params: dict, u: torch.Tensor, mesh=None) -> torch.Tensor:
        """The encoder's cond features of u; ``mesh``: on this rank's band of u, each conv
        and RRDB (or trunk kernel) on the band plus the halo it reads."""
        cd = self.encoder_compute_dtype
        first = nets.conv2d(u, params["conv_first"]["w"], params["conv_first"]["b"], cd, mesh)
        feat1 = self._trunk(params, "trunk0", first, cd, mesh)
        tc = params["trunk_conv1"]
        feat2 = nets.conv2d(self._trunk(params, "trunk1", feat1, cd, mesh), tc["w"], tc["b"], cd,
                            mesh)
        if not self.sr:
            return feat2 + first
        return torch.cat([feat1, feat2 + first], -1)

    def _prior(self, params: dict, cond: torch.Tensor, mesh=None):
        """(mean, logs); the rescaling prior bounds logs as the couplings do."""
        h = nets.apply_conv_zeros(params["f"], cond, mesh=mesh)
        mean, logs = h[..., 0::2], h[..., 1::2]
        return mean, logs if self.sr else coupling.clamp_logscale(logs)

    def _run_steps(self, params: dict, z: torch.Tensor, cond: torch.Tensor,
                   mesh=None) -> torch.Tensor:
        """Invert the steps: the chain kernel when packed, else the plain path; ``mesh``:
        on this rank's band plus the chain's halo (``stack.on_band``)."""
        ss, steps = self.step_spec, params["steps"]
        packed = params.get("steps_fused")
        if packed is not None:  # the cond terms in the pack's layout (a padded hid)
            return stack.on_band(
                lambda z, uc: chain.inverse_chain(packed, z, chain.pad_uc(packed, uc)), z, cond,
                chain.halo_rows(packed), mesh, stack.Hoist(ss, steps))
        rows = nets.halo_rows(steps)
        if self.hoists:
            return stack.on_band(
                lambda z, uc: stack.inverse_stack_uc(ss, steps, z, uc, remat=self.remat_steps)[0],
                z, cond, rows, mesh, stack.Hoist(ss, steps))
        return stack.on_band(
            lambda z, u: stack.inverse_stack(ss, steps, z, u, remat=self.remat_steps)[0], z, cond,
            rows, mesh)

    # ------------------------------------------------------------------- forward
    def _forward_steps(self, params: dict, z: torch.Tensor, cond: torch.Tensor, logdet,
                       mesh=None):
        if self.n_flow_step == 0:
            return z, logdet
        ss, steps, remat = self.step_spec, params["steps"], self.remat_steps
        fn = stack.forward_stack_hoisted if self.hoists else stack.forward_stack
        if not halo.sharded(mesh) or logdet is not None:  # a logdet: each conv exchanges
            return fn(ss, steps, z, cond, logdet, remat=remat, mesh=mesh)
        if self.hoists:
            return stack.on_band(lambda z, uc: stack.forward_stack_uc(ss, steps, z, uc,
                                                                      remat=remat)[0],
                                 z, cond, nets.halo_rows(steps), mesh, stack.Hoist(ss, steps)), None
        return stack.on_band(lambda z, u: fn(ss, steps, z, u, remat=remat)[0], z, cond,
                             nets.halo_rows(steps), mesh), None

    @profiling.spanned("hcflow.cond")
    def forward(self, params: dict, a: torch.Tensor, u: torch.Tensor, logdet=None, mesh=None):
        """Run the steps on a.  SR: add the prior's log-density of the result into
        logdet (shape (B,)) and return (logdet, cond); rescaling: return (fake_z,
        cond), the result whitened against the prior.  ``mesh``: a and u are this rank's
        bands; SR adds the band's share of the log-density."""
        cond = self.cond_feature(params, u, mesh)
        z, logdet = self._forward_steps(params, a, cond, logdet, mesh)
        mean, logs = self._prior(params, cond, mesh)
        if self.sr:
            return logdet + densities.gaussian_logp(mean, logs, z), cond
        return (z - mean) * torch.exp(-logs), cond

    @profiling.spanned("hcflow.cond")
    def encode_eps(self, params: dict, a: torch.Tensor, u: torch.Tensor, cond=None):
        """The whitened latent of a under the conditional prior, (f(a) - mean) /
        std, which ``reverse(..., eps=...)`` maps back to a.  ``cond``: the level's
        cond features when already computed (they are ``cond_feature(params, u)``)."""
        if cond is None:
            cond = self.cond_feature(params, u)
        z = self._forward_steps(params, a, cond, None)[0]
        mean, logs = self._prior(params, cond)
        return (z - mean) * torch.exp(-logs)

    # --------------------------------------------------------------- calibration
    def calibrate(self, params: dict, a: torch.Tensor, u: torch.Tensor, logdet=None):
        """The forward with the steps' data-dependent ActNorm inits.  Returns (params,
        logdet, cond) for SR, (params, fake_z, cond) for rescaling."""
        new = dict(params)
        cond = self.cond_feature(params, u)
        z = a
        if self.n_flow_step > 0:
            new["steps"], z, logdet = stack.calibrate_stack(self.step_spec, params["steps"], z,
                                                            cond, logdet)
        mean, logs = self._prior(params, cond)
        if self.sr:
            return new, logdet + densities.gaussian_logp(mean, logs, z), cond
        return new, (z - mean) * torch.exp(-logs), cond

    # ------------------------------------------------------------------- reverse
    @profiling.spanned("hcflow.cond")
    def reverse(self, params: dict, u: torch.Tensor, eps_std, generator=None, eps=None,
                mesh=None):
        """Sample a from the conditional prior at temperature eps_std (or take the
        explicit whitened latent ``eps``: z = mean + exp(logs) * eps, eps_std unused)
        and invert the steps.  Returns (a, cond).  ``mesh``: u and eps are this rank's
        parts, and a sample is drawn for the whole batch and image
        (``densities.gaussian_sample``)."""
        cond = self.cond_feature(params, u, mesh)
        mean, logs = self._prior(params, cond, mesh)
        if eps is None:
            z = densities.gaussian_sample(generator, mean, logs, eps_std, mesh)
        else:
            z = mean + torch.exp(logs) * eps
        if self.n_flow_step > 0:
            z = self._run_steps(params, z, cond, mesh)
        return z, cond
