"""Params in this package's layout from the JAX package's params or from a reference
PyTorch checkpoint (``.pth`` state_dict), and back to the JAX package's layout.

The JAX package keeps conv weights HWIO, stacks the K steps of a chain and the nb
RRDBs of a trunk along a leading axis (for ``lax.scan``), and nests dicts; the
rescaling model's main chains, whose steps differ in shape, it keeps as lists of
per-step dicts.  Here conv weights are OIHW and every chain or trunk is a list of
per-step / per-RRDB dicts.

A reference state_dict names its tensors by module path (``flow.layers.<i>.actnorm.bias``,
``flow.level0_condFlow.RRDB_trunk0.0.RDB1.conv1.weight``, ...);
:func:`params_from_state_dict` walks them with the names of
``hcflow_tpu/utils/convert.py`` (``convert_flownet``, ``convert_invconv``,
``convert_flowstep``), a copy kept here so that no JAX is needed: conv weights stay
OIHW, ActNorm bias/logs (1,C,1,1) and Conv2dZeros logs (C,1,1) become (C,), a
``module.`` prefix is stripped; an invconv is a plain weight or LU factors, an
AffineInjector coupling has ``affine.f_injector`` beside ``affine.f``, a noCoupling
step has no coupling.

:func:`params_to_jax` is the inverse of :func:`params_from_jax`: numpy in the JAX
package's layout, what the training checkpoints (``<iter>_G.ckpt``) hold so that both
packages serve them.  :func:`heads_from_jax` / :func:`heads_to_jax` carry the VGG19
feature and discriminator params across (4-D conv weights HWIO <-> OIHW, linear
weights as they are).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.hcflow_sr import device_for
from .ops import permute


def _convert(tree, device, key=None):
    if isinstance(tree, dict):
        return {k: _convert(v, device, k) for k, v in tree.items()}
    a = np.asarray(tree)  # a permutation's indices stay int32, every other leaf float32
    t = torch.from_numpy(np.array(a, dtype=np.int32 if a.dtype.kind in "iu" else np.float32))
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


def heads_from_jax(tree: dict, device="cuda") -> dict:
    """VGG19 feature or discriminator params of the JAX package (numpy) on ``device``."""
    return _convert(tree, device_for(device))


def _to_numpy(tree, key=None):
    if isinstance(tree, dict):
        return {k: _to_numpy(v, k) for k, v in tree.items()}
    a = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return a.transpose(2, 3, 1, 0) if key == "w" and a.ndim == 4 else a  # OIHW -> HWIO


def heads_to_jax(tree: dict) -> dict:
    """VGG19 feature or discriminator params as the JAX package's numpy tree."""
    return _to_numpy(tree)


def load_npz(path: str, device="cuda"):
    """Head params (VGG19, LPIPS) from the JAX package's ``.npz`` layout ("<name>/<leaf>"
    arrays, HWIO convs) on ``device``, convs OIHW; None when the file is absent."""
    try:
        data = np.load(path)
    except (FileNotFoundError, OSError):
        return None
    return _convert(_unflatten(data), device_for(device))


def _unflatten(data) -> dict:
    tree: dict = {}
    for k in data.files:
        name, leaf = k.rsplit("/", 1)
        tree.setdefault(name, {})[leaf] = np.asarray(data[k], np.float32)
    return tree


def save_npz(path: str, params: dict) -> None:
    """Head params in the JAX package's ``.npz`` layout, which both packages read."""
    np.savez(path, **{f"{name}/{leaf}": a for name, sub in heads_to_jax(params).items()
                      for leaf, a in sub.items()})


def _stack(per: list):
    """Per-entry trees stacked along a new leading axis (the JAX package's scan layout)."""
    if isinstance(per[0], dict):
        return {k: _stack([p[k] for p in per]) for k in per[0]}
    return np.stack(per)


def params_to_jax(params: dict, spec) -> dict:
    """This package's params for ``spec`` (an ``HCFlowSRSpec``, ``HCFlowRescalingSpec``
    or ``FlowNetSpec``) as the JAX package's ``FlowNetSpec.init`` layout, numpy: conv
    weights HWIO, every chain and trunk stacked along a leading axis, except the
    rescaling main chains (steps of different shapes), which stay lists.  Derived
    entries (invconv inverses, packed kernel weights) are dropped."""
    def step(p):  # a step's invconv keeps its params, not its precomputed inverse
        if "invconv" not in p:
            return _to_numpy(p)
        inv = {k: v for k, v in p["invconv"].items() if k not in ("w_inv", "logdet_w")}
        return _to_numpy({**p, "invconv": inv})

    flow = getattr(spec, "flow", spec)
    out = {}
    for lv in flow.levels:
        lp = params[f"level{lv.level}"]
        main = [step(p) for p in lp["main"]]
        if not lv.alternate_lrvsothers:
            main = _stack(main) if main else []
        c = lp["cond"]
        cond = {k: _to_numpy(c[k]) for k in ("conv_first", "trunk_conv1", "f")}
        for name in ("trunk0", "trunk1"):
            cond[name] = _stack([_to_numpy(r) for r in c[name]])
        if lv.cond_spec.n_flow_step > 0:
            cond["steps"] = _stack([step(p) for p in c["steps"]])
        out[f"level{lv.level}"] = {"main": main, "cond": cond}
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

    def invconv(self, p):
        """The plain weight, or the LU factors (the JAX package's names)."""
        if _j(p, "weight") in self.sd:
            return {"weight": self(_j(p, "weight"))}
        return {k: self(_j(p, k)) for k in ("p", "sign_s", "l", "log_s", "u")}

    def permute(self, p, spec):
        """A reverse permutation's indices (the reversal); the reference keeps a
        permutation's indices out of its state_dict, so a shuffle cannot be rebuilt."""
        if spec.flow_permutation == "shuffle":
            raise ValueError(f"{p}: a shuffle permutation's indices are not in the state_dict")
        return {k: v.to(self.device) for k, v in permute.init(spec.in_channels).items()}

    def flowstep(self, p, spec):
        params = {"actnorm": self.actnorm(_j(p, "actnorm"))}
        if spec.flow_permutation == "invconv":
            params["invconv"] = self.invconv(_j(p, "permute"))
        elif spec.flow_permutation in ("reverse", "shuffle"):
            params["permute"] = self.permute(_j(p, "permute"), spec)
        if spec.flow_coupling != "noCoupling":
            params["coupling"] = {"f": self.net(_j(p, "affine.f"), spec.nn_module)}
        if spec.flow_coupling == "AffineInjector":
            params["coupling"]["f_injector"] = self.net(_j(p, "affine.f_injector"),
                                                        spec.nn_module)
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
