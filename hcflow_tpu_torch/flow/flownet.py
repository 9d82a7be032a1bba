"""Hierarchical flow network: L levels of (squeeze -> main flow steps -> split +
conditional flow), for the SR and the rescaling models.

Per level: squeeze (checkerboard or Haar) -> K[level] - after_splitoff[level] main
flow steps -> channel split (C//2 retained at inner levels, the 3 LR channels at the
deepest).  Level i's conditioning input is cat(z_i, up_2(cf_{i+1}), up_4(cf_{i+2}),
...), the retained channels plus the nearest-upsampled cond features of every deeper
level.

- reverse (both models): the levels deepest first; the level's conditional flow
  samples the split-off channels, the main steps are inverted, the result is
  unsqueezed;
- forward (``normal_flow``): HR -> LR z plus the logdet with every level's prior
  log-density (SR) or one whitened latent per level (rescaling); ``encode`` gives the
  whitened latents of both kinds, which ``reverse_flow(..., eps_list=...)`` inverts;
  ``calibrate`` is the forward with every data-dependent ActNorm init.

With a spatial ``mesh`` (``parallel/mesh.py``; None, the default, is the unsharded pass)
a rank serves or trains its band of the image's rows: the reverse and the rescaling
forward run every unit on the band plus the halo it reads (``parallel/halo.py``); the SR
forward, which sums a logdet, runs each chain on the band alone, its nets exchanging a
row before each 3x3 conv, and returns the band's share of the logdet; squeezes, the
split, the concat and the nearest upsample are local to a band, whose height doubles at
every level up.  Every path is differentiable, the exchanges too.

The rescaling main chains alternate Affine3shift steps (``lr_vs_others`` True at even
k, False at odd k) with DenseBlock nets and no permutation; their steps differ in
shape, so a chain is a list of per-step dicts like every other chain here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops import chain, chain3s, nets, rrdb
from ..ops.squeeze import (
    haar_squeeze2d,
    haar_unsqueeze2d,
    nearest_upsample,
    squeeze2d,
    unsqueeze2d,
)
from ..parallel import halo
from ..utils import profiling
from . import stack
from .conditional import ConditionalFlowSpec
from .flowstep import FlowStepSpec


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    level: int
    channels: int  # channels after this level's squeeze
    n_main: int
    split_channels: int  # retained channels after the split
    main_spec: FlowStepSpec  # template (lr_vs_others alternates per step, see below)
    cond_spec: ConditionalFlowSpec
    alternate_lrvsothers: bool = False  # Affine3shift parity alternation (rescaling)

    def main_step_spec(self, k: int) -> FlowStepSpec:
        if not self.alternate_lrvsothers:
            return self.main_spec
        return dataclasses.replace(self.main_spec, lr_vs_others=(k % 2 == 0))


@dataclasses.dataclass(frozen=True)
class FlowNetSpec:
    """SR defaults: invconv permutation, Affine couplings with FCN nets, checkerboard
    squeeze.  The rescaling model sets the Haar squeeze, no permutation, Affine3shift
    couplings with DenseBlock nets and ``sr=False``."""

    in_channels: int = 3
    L: int = 2
    K: Sequence[int] = (26, 26)
    after_splitoff: Sequence[int] = (13, 13)
    squeeze: str = "checkerboard"  # 'checkerboard' | 'haar'
    flow_permutation: str = "invconv"  # main chains: 'invconv' | 'reverse' | 'shuffle' | 'none'
    flow_coupling: str = "Affine"  # main chains: 'Affine' | 'Affine3shift' | 'noCoupling'
    nn_module: str = "FCN"  # main chains: 'FCN' | 'DenseBlock'
    sr: bool = True
    hidden_channels: int = 64
    # the split-off (conditional) flows' steps
    so_flow_permutation: str = "invconv"
    so_flow_coupling: str = "Affine"  # 'Affine' | 'AffineInjector' | 'noCoupling'
    so_nn_module: str = "FCN"
    so_hidden_channels: int = 64
    rrdb_nb: Sequence[int] = (5, 5)
    rrdb_nf: int = 64
    rrdb_gc: int = 32
    compute_dtype: Optional[str] = None  # 'bfloat16' => coupling/encoder nets in bf16
    encoder_dtype: Optional[str] = None  # encoder-only override (bf16 encoders + f32 couplings)
    remat_steps: bool = False  # recompute each flow step's activations in the backward pass
    remat_trunks: bool = True  # recompute the RRDB trunks' activations in the backward pass

    @property
    def levels(self) -> Tuple[LevelSpec, ...]:
        out = []
        c = self.in_channels
        for level in range(self.L):
            c = c * 4
            split_c = c // 2 if level < self.L - 1 else 3
            main = FlowStepSpec(
                in_channels=c,
                hidden_channels=self.hidden_channels,
                compute_dtype=self.compute_dtype,
                flow_permutation=self.flow_permutation,
                flow_coupling=self.flow_coupling,
                nn_module=self.nn_module,
            )
            cond = ConditionalFlowSpec(
                num_channels=c,
                num_channels_split=split_c,
                n_flow_step=self.after_splitoff[level],
                num_levels_condition=self.L - 1 - level,
                sr=self.sr,
                rrdb_nb=tuple(self.rrdb_nb),
                rrdb_nf=self.rrdb_nf,
                rrdb_gc=self.rrdb_gc,
                flow_permutation=self.so_flow_permutation,
                flow_coupling=self.so_flow_coupling,
                nn_module=self.so_nn_module,
                hidden_channels=self.so_hidden_channels,
                compute_dtype=self.compute_dtype,
                encoder_dtype=self.encoder_dtype,
                remat_steps=self.remat_steps,
                remat_trunks=self.remat_trunks,
            )
            out.append(LevelSpec(
                level=level,
                channels=c,
                n_main=self.K[level] - self.after_splitoff[level],
                split_channels=split_c,
                main_spec=main,
                cond_spec=cond,
                alternate_lrvsothers=self.flow_coupling == "Affine3shift",
            ))
            c = split_c
        return tuple(out)

    # ----------------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> dict:
        """Fresh params on the CPU (the generator is a CPU generator)."""
        params = {}
        for lv in self.levels:
            params[f"level{lv.level}"] = {
                "main": [lv.main_step_spec(k).init(generator) for k in range(lv.n_main)],
                "cond": lv.cond_spec.init(generator),
            }
        return params

    # -------------------------------------------------------------------- squeeze
    def _squeeze(self, x):
        return haar_squeeze2d(x) if self.squeeze == "haar" else squeeze2d(x)

    def _unsqueeze(self, x):
        return haar_unsqueeze2d(x) if self.squeeze == "haar" else unsqueeze2d(x)

    # --------------------------------------------------------------- main chains
    @profiling.spanned("hcflow.main")
    def _main_forward(self, lv: LevelSpec, main: list, z: torch.Tensor, logdet=None,
                      mesh=None):
        # as the JAX package: the homogeneous chains recompute with remat_steps, the
        # alternating rescaling chains do not
        remat = self.remat_steps and not lv.alternate_lrvsothers

        def run(z, logdet=logdet, mesh=None):
            for k, p in enumerate(main):
                z, logdet = stack.run_step(lv.main_step_spec(k).forward, p, z, None, logdet,
                                           mesh, remat=remat)
            return z, logdet

        if not halo.sharded(mesh) or logdet is not None:  # a logdet: each conv exchanges
            return run(z, mesh=mesh)
        return halo.banded(lambda t: run(t)[0], z, nets.halo_rows(main), mesh, "chain"), None

    def _split_forward(self, params: dict, hr: torch.Tensor, logdet=None, calibrate=False,
                       mesh=None):
        """Squeeze and main steps at every level: (ys, a_s, logdet, new main chains)."""
        z = hr
        ys, a_s, mains = [], [], []
        for lv in self.levels:
            z = self._squeeze(z)
            main = params[f"level{lv.level}"]["main"]
            if calibrate:
                new = []
                for k, p in enumerate(main):
                    p, z, logdet = lv.main_step_spec(k).calibrate(p, z, None, logdet)
                    new.append(p)
                mains.append(new)
            else:
                z, logdet = self._main_forward(lv, main, z, logdet, mesh)
            ys.append(z[..., : lv.split_channels])
            a_s.append(z[..., lv.split_channels :])
            z = ys[-1]
        return ys, a_s, logdet, mains

    @profiling.spanned("hcflow.main")
    def _main_inverse(self, lv: LevelSpec, level_params: dict, z: torch.Tensor,
                      mesh=None) -> torch.Tensor:
        """The chain kernels when packed, else the plain step loop; ``mesh``: on this
        rank's band plus the chain's halo."""
        if lv.n_main == 0:
            return z
        packed3s = level_params.get("main3s_fused")
        if packed3s is not None:
            return halo.banded(lambda t: chain3s.inverse_chain(packed3s, t)[0], z,
                               chain3s.halo_rows(packed3s), mesh, "chain")
        packed = level_params.get("main_fused")
        if packed is not None:
            return halo.banded(lambda t: chain.inverse_chain(packed, t), z,
                               chain.halo_rows(packed), mesh, "chain")
        remat = self.remat_steps and not lv.alternate_lrvsothers
        main = level_params["main"]

        def run(z):
            for k in reversed(range(lv.n_main)):
                z = stack.run_step(lv.main_step_spec(k).inverse, main[k], z, remat=remat)[0]
            return z

        return halo.banded(run, z, nets.halo_rows(main), mesh, "chain")

    def _cond_input(self, i: int, y_i: torch.Tensor, cond_feats) -> torch.Tensor:
        """cat(y_i, up_2(cf_{i+1}), up_4(cf_{i+2}), ...)."""
        pieces = [y_i]
        for j in range(i + 1, self.L):
            pieces.append(nearest_upsample(cond_feats[j], 2 ** (j - i)))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, -1)

    # -------------------------------------------------------------------- forward
    def normal_flow(self, params: dict, hr: torch.Tensor, logdet=None, mesh=None):
        """HR (NHWC) -> LR z.  SR: returns (z, logdet), logdet (B,) accumulating every
        step's log-determinant and every level's prior log-density (from zeros when
        None); rescaling: returns (z, [whitened latent fake_z per level]).  ``mesh``: hr
        is this rank's band, and so are the outputs (SR: the band's share of the
        logdet)."""
        if self.sr and logdet is None:
            logdet = hr.new_zeros(hr.shape[0])
        ys, a_s, logdet, _ = self._split_forward(params, hr, logdet, mesh=mesh)
        cond_feats = [None] * self.L
        fake_zs = [None] * self.L
        for i in reversed(range(self.L)):
            u = self._cond_input(i, ys[i], cond_feats)
            out, cond_feats[i] = self.levels[i].cond_spec.forward(
                params[f"level{i}"]["cond"], a_s[i], u, logdet, mesh)
            if self.sr:
                logdet = out
            else:
                fake_zs[i] = out
        return ys[-1], (logdet if self.sr else fake_zs)

    def encode(self, params: dict, hr: torch.Tensor):
        """HR -> (z, [whitened latent eps per level]): ``reverse_flow(params, z,
        eps_std, eps_list=eps)`` reconstructs hr up to float32 rounding."""
        ys, a_s, _, _ = self._split_forward(params, hr)
        cond_feats = [None] * self.L
        eps_list = [None] * self.L
        for i in reversed(range(self.L)):
            cs, cp = self.levels[i].cond_spec, params[f"level{i}"]["cond"]
            u = self._cond_input(i, ys[i], cond_feats)
            cond_feats[i] = cs.cond_feature(cp, u)
            eps_list[i] = cs.encode_eps(cp, a_s[i], u, cond=cond_feats[i])
        return ys[-1], eps_list

    # -------------------------------------------------------------------- reverse
    def reverse_flow(self, params: dict, lr: torch.Tensor, eps_std, generator=None,
                     eps_list=None, mesh=None) -> torch.Tensor:
        """LR (NHWC) -> HR, sampling the split-off latents at temperature eps_std from
        ``generator``, or taking the explicit whitened latents ``eps_list[level]``.
        ``mesh``: lr is this rank's part and so is the HR returned; ``eps_list`` stays
        global (every rank takes its part), and a sample is drawn for the whole image."""
        z = lr
        cond_feats = [None] * self.L
        for i in reversed(range(self.L)):
            lv = self.levels[i]
            u = self._cond_input(i, z, cond_feats)
            eps = None if eps_list is None else eps_list[i]
            if eps is not None and mesh is not None:
                eps = mesh.shard(eps)
            a, cond_feats[i] = lv.cond_spec.reverse(
                params[f"level{i}"]["cond"], u, eps_std, generator, eps=eps, mesh=mesh)
            z = self._main_inverse(lv, params[f"level{i}"], torch.cat([z, a], -1), mesh)
            z = self._unsqueeze(z)
        return z

    # ---------------------------------------------------------------- calibration
    def calibrate(self, params: dict, hr: torch.Tensor, logdet=None):
        """The data-dependent ActNorm init pass, in forward order; returns (params, z,
        logdet) for SR, (params, z, [fake_z per level]) for rescaling."""
        if self.sr and logdet is None:
            logdet = hr.new_zeros(hr.shape[0])
        ys, a_s, logdet, mains = self._split_forward(params, hr, logdet, calibrate=True)
        new = {f"level{lv.level}": {**params[f"level{lv.level}"], "main": m}
               for lv, m in zip(self.levels, mains)}
        cond_feats = [None] * self.L
        fake_zs = [None] * self.L
        for i in reversed(range(self.L)):
            u = self._cond_input(i, ys[i], cond_feats)
            new[f"level{i}"]["cond"], out, cond_feats[i] = self.levels[i].cond_spec.calibrate(
                params[f"level{i}"]["cond"], a_s[i], u, logdet)
            if self.sr:
                logdet = out
            else:
                fake_zs[i] = out
        return new, ys[-1], (logdet if self.sr else fake_zs)

    # --------------------------------------------------------------- inference prep
    def precompute_inference(self, params: dict, fused: bool = False,
                             resident_trunk: bool = False, trunks: bool = True) -> dict:
        """Attach the invconv inverses for serving; with ``fused`` also pack, for the
        serving path on the card, what the card's kernels take, as the JAX package's
        ``precompute_inference(fused="all")`` packs (hcflow_tpu/flow/flownet.py:297):

        - every chain the chain kernel computes (``chain.supported``: Affine/FCN/
          plain invconv steps, any width; a split-off chain's cond terms must also
          hoist) for the chain kernel (ops/chain.py), in the coupling dtype, its
          coupling width padded up to 32 or 64;
        - every alternating rescaling main chain that ``chain3s.supported`` accepts
          (a growth that is a multiple of 8) for ops/chain3s.py, in the coupling dtype,
          its growth padded up to 16, 32 or 64;
        - every RRDB trunk for the RRDB kernels (ops/rrdb.py), in the encoder dtype
          (``encoder_dtype``, else ``compute_dtype``), when nf and gc are multiples of
          8 (the JAX package's gate), each padded up to 16, 32 or 64: per RRDB, or
          with ``resident_trunk`` one stacked pack a trunk for the resident-trunk
          kernel, the counterpart of the JAX package's ``HCFLOW_RDB_TRUNK=1``.

        The padding is exact: the padded channels have zero weights and biases and stay
        0.  Params on the CPU get exactly these packs, which the kernels' plain versions
        run.  For params on the card each site asks its kernel's predicate
        (``chain.packs``, ``chain3s.packs``, ``rrdb.packs_trunk``; all of them:
        :meth:`kernel_packs`), a function of the widths and the device alone: a chain
        or trunk whose padded widths the kernel does not take (chain: hid or c over 64;
        chain3s: a growth over 64 or c - 3 over 32; RRDB: nf or gc over 64) is not
        packed and serves on the plain path, as the JAX package's VMEM gate sends what
        does not fit to its step loop; every pack made reaches a kernel that takes it.
        Every other chain serves on the plain path, as in the JAX package.  Each pack
        is bf16 or float32 as its dtype says, and every kernel takes both: the bf16
        recipe gets bf16 packs, the float32 recipe (the shipped test configs set no
        ``compute_dtype``) float32 packs, whose kernels run 3xTF32 products (float32
        accuracy), and the shipped training recipe (bf16 encoders, float32 couplings)
        float32 chain packs and bf16 trunk packs.  ``trunks=False`` packs the chains
        only, the counterpart of the JAX package's ``fused=True``.  Training params never
        carry packs (no kernel has a backward pass)."""
        dev = params["level0"]["cond"]["conv_first"]["w"].device
        packs = self.kernel_packs(dev, trunks) if fused else {}
        new = {}
        for lv in self.levels:
            lp = dict(params[f"level{lv.level}"])
            lp["main"] = stack.precompute_invconv(lp["main"])
            cond = dict(lp["cond"])
            so, names = lv.cond_spec, packs.get(lv.level, ())
            if so.n_flow_step > 0:
                cond["steps"] = stack.precompute_invconv(cond["steps"])
            if "main3s_fused" in names:
                lp["main3s_fused"] = chain3s.pack_inverse_chain3s(lp["main"], self.compute_dtype)
            if "main_fused" in names:
                lp["main_fused"] = chain.pack_inverse_chain(lp["main"], self.compute_dtype,
                                                            padded=True)
            if "steps_fused" in names:
                cond["steps_fused"] = chain.pack_inverse_chain(cond["steps"], so.compute_dtype,
                                                               padded=True)
            for trunk in ("trunk0", "trunk1"):
                if f"{trunk}_fused" in names:
                    cond[f"{trunk}_fused"] = rrdb.pack_rrdb_trunk(
                        cond[trunk], so.encoder_compute_dtype, resident=resident_trunk)
            lp["cond"] = cond
            new[f"level{lv.level}"] = lp
        return new

    def kernel_packs(self, device, trunks: bool = True) -> dict:
        """The packs that ``precompute_inference(params, fused=True, trunks=trunks)``
        attaches for params on ``device``, by level: {level: the set of "main_fused",
        "main3s_fused" (in the level's params), "steps_fused", "trunk0_fused",
        "trunk1_fused" (in its "cond")}.  A function of the widths and the device's type
        alone, so that a card's choices can be read without one."""
        out = {}
        for lv in self.levels:
            so, hid, names = lv.cond_spec, self.hidden_channels, set()
            if lv.alternate_lrvsothers:
                if chain3s.packs(lv, hid, device):
                    names.add("main3s_fused")
            elif lv.n_main > 0 and chain.packs(lv.main_spec, lv.channels, hid, device):
                names.add("main_fused")
            if (so.n_flow_step > 0 and so.hoists
                    and chain.packs(so.step_spec, so.a_channels, so.hidden_channels, device)):
                names.add("steps_fused")
            if trunks and rrdb.packs_trunk(so.rrdb_nf, so.rrdb_gc, device):
                names |= {"trunk0_fused", "trunk1_fused"}
            out[lv.level] = names
        return out
