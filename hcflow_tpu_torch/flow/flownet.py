"""Hierarchical flow network, SR reverse direction: L levels of (squeeze -> main flow
steps -> split + conditional flow).

Per level: checkerboard squeeze -> K[level] - after_splitoff[level] main flow steps
-> channel split (C//2 retained at inner levels, the 3 LR channels at the deepest).
The reverse pass walks the levels deepest first: level i's conditioning input is
cat(z_i, up_2(cf_{i+1}), up_4(cf_{i+2}), ...), the retained channels plus the
nearest-upsampled cond features of every deeper level; the level's conditional
flow samples the split-off channels, the main steps are inverted and the result is
unsqueezed.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..ops import chain, rrdb
from ..ops.squeeze import nearest_upsample, unsqueeze2d
from . import stack
from .conditional import ConditionalFlowSpec
from .flowstep import FlowStepSpec


@dataclasses.dataclass(frozen=True)
class LevelSpec:
    level: int
    channels: int  # channels after this level's squeeze
    n_main: int
    split_channels: int  # retained channels after the split
    main_spec: FlowStepSpec
    cond_spec: ConditionalFlowSpec


@dataclasses.dataclass(frozen=True)
class FlowNetSpec:
    """SR flow: invconv permutation, Affine couplings with FCN nets, checkerboard squeeze."""

    in_channels: int = 3
    L: int = 2
    K: Sequence[int] = (26, 26)
    after_splitoff: Sequence[int] = (13, 13)
    hidden_channels: int = 64
    so_hidden_channels: int = 64
    rrdb_nb: Sequence[int] = (5, 5)
    rrdb_nf: int = 64
    rrdb_gc: int = 32
    compute_dtype: Optional[str] = None  # 'bfloat16' => coupling/encoder nets in bf16

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
            )
            cond = ConditionalFlowSpec(
                num_channels=c,
                num_channels_split=split_c,
                n_flow_step=self.after_splitoff[level],
                num_levels_condition=self.L - 1 - level,
                rrdb_nb=tuple(self.rrdb_nb),
                rrdb_nf=self.rrdb_nf,
                rrdb_gc=self.rrdb_gc,
                hidden_channels=self.so_hidden_channels,
                compute_dtype=self.compute_dtype,
            )
            out.append(LevelSpec(
                level=level,
                channels=c,
                n_main=self.K[level] - self.after_splitoff[level],
                split_channels=split_c,
                main_spec=main,
                cond_spec=cond,
            ))
            c = split_c
        return tuple(out)

    # ----------------------------------------------------------------------- init
    def init(self, generator: torch.Generator) -> dict:
        """Fresh params on the CPU (the generator is a CPU generator)."""
        params = {}
        for lv in self.levels:
            params[f"level{lv.level}"] = {
                "main": stack.init_stack(lv.main_spec, generator, lv.n_main),
                "cond": lv.cond_spec.init(generator),
            }
        return params

    # -------------------------------------------------------------------- reverse
    def _main_inverse(self, lv: LevelSpec, level_params: dict, z: torch.Tensor) -> torch.Tensor:
        if lv.n_main == 0:
            return z
        packed = level_params.get("main_fused")
        if packed is not None:
            return chain.inverse_chain(packed, z)
        return stack.inverse_stack(lv.main_spec, level_params["main"], z)[0]

    def _cond_input(self, i: int, y_i: torch.Tensor, cond_feats) -> torch.Tensor:
        """cat(y_i, up_2(cf_{i+1}), up_4(cf_{i+2}), ...)."""
        pieces = [y_i]
        for j in range(i + 1, self.L):
            pieces.append(nearest_upsample(cond_feats[j], 2 ** (j - i)))
        return pieces[0] if len(pieces) == 1 else torch.cat(pieces, -1)

    def reverse_flow(self, params: dict, lr: torch.Tensor, eps_std, generator=None,
                     eps_list=None) -> torch.Tensor:
        """LR (NHWC) -> HR, sampling the split-off latents at temperature eps_std from
        ``generator``, or taking the explicit whitened latents ``eps_list[level]``."""
        z = lr
        cond_feats = [None] * self.L
        for i in reversed(range(self.L)):
            lv = self.levels[i]
            u = self._cond_input(i, z, cond_feats)
            a, cond_feats[i] = lv.cond_spec.reverse(
                params[f"level{i}"]["cond"], u, eps_std, generator,
                eps=None if eps_list is None else eps_list[i],
            )
            z = self._main_inverse(lv, params[f"level{i}"], torch.cat([z, a], -1))
            z = unsqueeze2d(z)
        return z

    # --------------------------------------------------------------- inference prep
    def precompute_inference(self, params: dict, fused: bool = False) -> dict:
        """Attach the invconv inverses for serving; with ``fused`` also pack every
        chain for the inverse-chain kernel and every RRDB trunk for the RRDB kernel
        (the serving path on the card)."""
        new = {}
        for lv in self.levels:
            lp = dict(params[f"level{lv.level}"])
            lp["main"] = stack.precompute_invconv(lp["main"])
            cond = dict(lp["cond"])
            so = lv.cond_spec
            if so.n_flow_step > 0:
                cond["steps"] = stack.precompute_invconv(cond["steps"])
            if fused:
                if lv.n_main > 0:
                    lp["main_fused"] = chain.pack_inverse_chain(lp["main"], self.compute_dtype)
                if so.n_flow_step > 0:
                    cond["steps_fused"] = chain.pack_inverse_chain(cond["steps"], so.compute_dtype)
                for trunk in ("trunk0", "trunk1"):
                    cond[f"{trunk}_fused"] = rrdb.pack_rrdb_trunk(cond[trunk], so.compute_dtype)
            lp["cond"] = cond
            new[f"level{lv.level}"] = lp
        return new
