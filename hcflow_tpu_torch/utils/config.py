"""Option files: YAML with the reference's schema -> the port's model specs.

The counterpart of the JAX package's ``hcflow_tpu/utils/config.py``: the same YAML
layout (top-level name/model/scale/quant, ``datasets.{train,val,test_*}``,
``network_G.flowDownsampler`` with K, L, squeeze, flow_permutation, flow_coupling,
nn_module, hidden_channels and ``splitOff.*``, ``train``, ``val``, ``logger``,
``path``), the same ``opt_get`` (missing keys and nulls resolve to the default, the
reference's NoneDict) and the same ``parse`` derivations: the is_train flag, scale
propagation into the datasets, the experiment/result directory layout, the debug-mode
frequency overrides and relative -> absolute LR milestones.

``flownet_spec_from_opt`` and ``model_spec_from_opt`` make this package's
``FlowNetSpec``, ``HCFlowSRSpec`` and ``HCFlowRescalingSpec``.  A value the port does
not implement raises ``NotImplementedError`` naming its key; none is dropped.
"""

from __future__ import annotations

import os
from typing import Sequence

import yaml

from ..flow.flownet import FlowNetSpec
from ..models.hcflow_rescaling import HCFlowRescalingSpec
from ..models.hcflow_sr import HCFlowSRSpec


def opt_get(opt, keys: Sequence[str], default=None):
    if opt is None:
        return default
    cur = opt
    for k in keys:
        if not isinstance(cur, dict) or k not in cur or cur[k] is None:
            return default
        cur = cur[k]
    return cur


def load_yaml(path: str) -> dict:
    with open(path, "r") as f:
        return yaml.safe_load(f)


def parse(path: str, is_train: bool = True) -> dict:
    """Parse an option YAML with the reference's derivations (its options/options.py)."""
    opt = load_yaml(path)
    opt["is_train"] = is_train
    scale = opt.get("scale")

    for phase, dataset in (opt.get("datasets") or {}).items():
        phase = phase.split("_")[0]
        dataset["phase"] = phase
        if scale is not None:
            dataset["scale"] = scale
        if dataset.get("dataroot_GT"):
            dataset["dataroot_GT"] = os.path.expanduser(dataset["dataroot_GT"])
        if dataset.get("dataroot_LQ"):
            dataset["dataroot_LQ"] = os.path.expanduser(dataset["dataroot_LQ"])

    opt.setdefault("path", {})
    opt["path"]["root"] = opt["path"].get("root") or os.getcwd()
    if is_train:
        exp_root = os.path.join(opt["path"]["root"], "experiments", opt.get("name", "exp"))
        opt["path"]["experiments_root"] = exp_root
        opt["path"]["models"] = os.path.join(exp_root, "models")
        opt["path"]["training_state"] = os.path.join(exp_root, "training_state")
        opt["path"]["log"] = exp_root
        opt["path"]["val_images"] = os.path.join(exp_root, "val_images")
        if "debug" in opt.get("name", ""):
            opt["train"]["val_freq"] = 8
            opt["logger"]["print_freq"] = 1
            opt["logger"]["save_checkpoint_freq"] = 8
    else:
        results_root = os.path.join(opt["path"]["root"], "results", opt.get("name", "exp"))
        opt["path"]["results_root"] = results_root
        opt["path"]["log"] = results_root

    # relative -> absolute LR milestones
    train = opt.get("train") or {}
    niter = train.get("niter")
    if train.get("lr_steps_rel") and niter:
        train["lr_steps"] = [int(r * niter) for r in train["lr_steps_rel"]]

    if scale is not None and "network_G" in opt:
        opt["network_G"]["scale"] = scale
    return opt


# ------------------------------------------------------------------------- specs
# what the port implements, by option key: the values for which the JAX package's
# model_spec_from_opt builds a model whose forward and reverse run
_SUPPORTED = {
    "flowDownsampler.squeeze": ("checkerboard", "haar"),
    "flowDownsampler.flow_permutation": ("invconv", "reverse", "shuffle", "none"),
    "flowDownsampler.flow_coupling": ("Affine", "Affine3shift", "noCoupling"),
    "flowDownsampler.nn_module": ("FCN", "DenseBlock"),
    "flowDownsampler.cond_channels": (None,),
    "flowDownsampler.splitOff.flow_permutation": ("invconv", "reverse", "shuffle", "none"),
    "flowDownsampler.splitOff.flow_coupling": ("Affine", "AffineInjector", "noCoupling"),
    "flowDownsampler.splitOff.nn_module": ("FCN",),
    "compute_dtype": (None, "bfloat16"),
    "encoder_dtype": (None, "bfloat16"),
}
# why a value (or any value of a key) that the JAX package names is refused
_WHY = {
    ("flowDownsampler.flow_coupling", "AffineInjector"):
        "the main flow steps get no cond features (the JAX package passes u=None there, "
        "and its injector net needs them); it is a split-off coupling",
    "flowDownsampler.cond_channels":
        "the main flow steps get no cond features, so a coupling there cannot take them",
}


def _supported(key: str, value):
    if value not in _SUPPORTED[key]:
        why = _WHY.get((key, value), _WHY.get(key))
        raise NotImplementedError(
            f"network_G.{key} = {value!r} is not implemented in the port "
            f"(it implements {', '.join(map(repr, _SUPPORTED[key]))})"
            + (f": {why}" if why else ""))
    return value


def _per_level(value, L: int) -> tuple:
    """A per-level option: a list (its first L entries) or one value for every level."""
    return tuple(value)[:L] if isinstance(value, (list, tuple)) else (value,) * L


def flownet_spec_from_opt(opt: dict, sr: bool = True) -> FlowNetSpec:
    """Build a FlowNetSpec from the ``network_G.flowDownsampler`` section."""
    fd = opt_get(opt, ["network_G", "flowDownsampler"], {})
    so = fd.get("splitOff", {}) or {}
    L = fd.get("L", 2)

    def value(key, default, section=fd, prefix="flowDownsampler."):
        return _supported(prefix + key, section.get(key, default))

    def so_value(key, default):
        return value(key, default, so, "flowDownsampler.splitOff.")

    value("cond_channels", None)
    net = opt.get("network_G") or {}
    return FlowNetSpec(
        in_channels=opt_get(opt, ["network_G", "in_nc"], 3),
        L=L,
        K=_per_level(fd.get("K", 26), L),
        after_splitoff=_per_level(so.get("after_flowstep", 0), L),
        squeeze=value("squeeze", "checkerboard"),
        flow_permutation=value("flow_permutation", "invconv"),
        flow_coupling=value("flow_coupling", "Affine"),
        nn_module=value("nn_module", "FCN"),
        hidden_channels=fd.get("hidden_channels", 64),
        sr=sr,
        so_flow_permutation=so_value("flow_permutation", "invconv"),
        so_flow_coupling=so_value("flow_coupling", "Affine"),
        so_nn_module=so_value("nn_module", "FCN"),
        so_hidden_channels=so.get("hidden_channels", 64),
        rrdb_nb=tuple(so.get("RRDB_nb", (5, 5))),
        rrdb_nf=so.get("RRDB_nf", 64),
        rrdb_gc=so.get("RRDB_gc", 32),
        compute_dtype=_supported("compute_dtype", net.get("compute_dtype")
                                 or fd.get("compute_dtype")),
        encoder_dtype=_supported("encoder_dtype", net.get("encoder_dtype")
                                 or fd.get("encoder_dtype")),
    )


def model_spec_from_opt(opt: dict):
    """Top-level model spec from a parsed option dict (SR or rescaling)."""
    model = (opt.get("model") or "HCFlow_SR").lower()
    if "rescaling" in model:
        return HCFlowRescalingSpec(flow=flownet_spec_from_opt(opt, sr=False))
    quant = opt.get("quant", 256)
    return HCFlowSRSpec(flow=flownet_spec_from_opt(opt, sr=True), quant=quant)
