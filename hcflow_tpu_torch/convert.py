"""Params of the JAX package, as numpy arrays, in this package's layout.

The JAX package keeps conv weights HWIO, stacks the K steps of a chain and the nb
RRDBs of a trunk along a leading axis (for ``lax.scan``), and nests dicts; the
rescaling model's main chains, whose steps differ in shape, it keeps as lists of
per-step dicts.  Here conv weights are OIHW and every chain or trunk is a list of
per-step / per-RRDB dicts.
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
