"""Params in this package's layout from the JAX package's params or from a reference
PyTorch checkpoint (``.pth`` state_dict).

The JAX package keeps conv weights HWIO, stacks the K steps of a chain and the nb
RRDBs of a trunk along a leading axis (for ``lax.scan``), and nests dicts; the
rescaling model's main chains, whose steps differ in shape, it keeps as lists of
per-step dicts.  Here conv weights are OIHW and every chain or trunk is a list of
per-step / per-RRDB dicts.

A reference state_dict names its tensors by module path (``flow.layers.<i>.actnorm.bias``,
``flow.level0_condFlow.RRDB_trunk0.0.RDB1.conv1.weight``, ...);
:func:`params_from_state_dict` walks them with the names of
``hcflow_tpu/utils/convert.py`` (``convert_flownet``, ``convert_invconv``), a copy kept
here so that no JAX is needed: conv weights stay OIHW, ActNorm bias/logs (1,C,1,1) and
Conv2dZeros logs (C,1,1) become (C,), a ``module.`` prefix is stripped.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.hcflow_sr import device_for


def _convert(tree, device, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, k) for k, v in tree.items()}
    t = torch.from_numpy(np.array(tree, dtype=np.float32))
    if key == "w" and t.ndim == 4:  # HWIO -> OIHW
        t = t.permute(3, 2, 0, 1).contiguous()
    return t.to(device)


def _leading(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return np.shape(tree)[0]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def _unstack(tree, device) -> list:
    """A stacked subtree (leading scan axis) as a list of converted per-entry dicts."""
    return [_convert(_index(tree, i), device) for i in range(_leading(tree))]


def _steps(tree, device) -> list:
    """A chain: a list of per-step dicts converted one by one, or a stacked tree."""
    if isinstance(tree, (list, tuple)):
        return [_convert(p, device) for p in tree]
    return _unstack(tree, device)


def params_from_jax(tree: dict, spec, device="cuda") -> dict:
    """Convert ``FlowNetSpec.init`` params of the JAX package (every leaf a numpy
    array) for ``spec`` (an ``HCFlowSRSpec``, ``HCFlowRescalingSpec`` or
    ``FlowNetSpec`` of this package).

    Derived entries (invconv inverses, packed kernel weights) are not carried over:
    ``precompute_inference`` makes them.
    """
    device = device_for(device)
    flow = getattr(spec, "flow", spec)
    out = {}
    for lv in flow.levels:
        lp = tree[f"level{lv.level}"]
        c = lp["cond"]
        cond = {k: _convert(c[k], device) for k in ("conv_first", "trunk_conv1", "f")}
        for name in ("trunk0", "trunk1"):
            cond[name] = _unstack(c[name], device)
        if lv.cond_spec.n_flow_step > 0:
            cond["steps"] = _unstack(c["steps"], device)
        out[f"level{lv.level}"] = {"main": _steps(lp["main"], device), "cond": cond}
    return out


# ------------------------------------------------------------ reference state_dicts
def _j(p: str, name: str) -> str:
    return f"{p}.{name}" if p else name


class _StateDict:
    """A reference state_dict read as float32 tensors on one device."""

    def __init__(self, state_dict, device):
        self.sd = {(k[7:] if k.startswith("module.") else k): v for k, v in state_dict.items()}
        self.device = device

    def __call__(self, name: str, vec: bool = False) -> torch.Tensor:
        t = torch.as_tensor(self.sd[name]).detach().to(self.device, torch.float32)
        return t.reshape(-1).contiguous() if vec else t.contiguous()

    def actnorm(self, p):
        return {"bias": self(_j(p, "bias"), True), "logs": self(_j(p, "logs"), True)}

    def conv(self, p):
        return {"w": self(_j(p, "weight")), "b": self(_j(p, "bias"))}

    def conv_actnorm(self, p):
        return {"w": self(_j(p, "weight")), "actnorm": self.actnorm(_j(p, "actnorm"))}

    def conv_zeros(self, p):
        return {**self.conv(p), "logs": self(_j(p, "logs"), True)}

    def net(self, p, nn_module):
        if nn_module == "FCN":
            return {"conv1": self.conv_actnorm(_j(p, "conv1")),
                    "conv2": self.conv_actnorm(_j(p, "conv2")),
                    "conv3": self.conv_zeros(_j(p, "conv3"))}
        return {f"conv{i}": self.conv(_j(p, f"conv{i}")) for i in range(1, 6)}

    def rrdb(self, p):
        return {f"rdb{i}": {f"conv{k}": self.conv(_j(p, f"RDB{i}.conv{k}")) for k in range(1, 6)}
                for i in range(1, 4)}

    def flowstep(self, p, spec):
        params = {"actnorm": self.actnorm(_j(p, "actnorm"))}
        if spec.flow_permutation == "invconv":
            # the plain weight; an LU-parametrised invconv is not ported
            params["invconv"] = {"weight": self(_j(p, "permute.weight"))}
        params["coupling"] = {"f": self.net(_j(p, "affine.f"), spec.nn_module)}
        return params


def params_from_state_dict(state_dict, spec, device="cuda", prefix: str = "flow") -> dict:
    """Params for ``spec`` (an ``HCFlowSRSpec``, ``HCFlowRescalingSpec`` or
    ``FlowNetSpec``) from a reference checkpoint's state_dict (tensors or arrays, as
    ``torch.load`` of a released ``.pth`` gives them), on ``device``.

    The reference's layer list per level is: squeeze, the main FlowSteps, Split; the
    conditional flows are ``level<i>_condFlow``.  Derived entries (invconv inverses,
    packed kernel weights) are left to ``precompute_inference``.
    """
    sd = _StateDict(state_dict, device_for(device))
    flow = getattr(spec, "flow", spec)
    pre = f"{prefix}." if prefix else ""
    out, idx = {}, 0
    for lv in flow.levels:
        idx += 1  # the squeeze layer
        main = [sd.flowstep(f"{pre}layers.{idx + k}", lv.main_step_spec(k))
                for k in range(lv.n_main)]
        idx += lv.n_main + 1  # the main steps, the Split layer
        cs, p = lv.cond_spec, f"{pre}level{lv.level}_condFlow"
        cond = {"conv_first": sd.conv(_j(p, "conv_first")),
                "trunk0": [sd.rrdb(_j(p, f"RRDB_trunk0.{i}")) for i in range(cs.rrdb_nb[0])],
                "trunk1": [sd.rrdb(_j(p, f"RRDB_trunk1.{i}")) for i in range(cs.rrdb_nb[1])],
                "trunk_conv1": sd.conv(_j(p, "trunk_conv1")),
                "f": sd.conv_zeros(_j(p, "f"))}
        if cs.n_flow_step > 0:
            cond["steps"] = [sd.flowstep(_j(p, f"additional_flow_steps.{k}"), cs.step_spec)
                             for k in range(cs.n_flow_step)]
        out[f"level{lv.level}"] = {"main": main, "cond": cond}
    return out
