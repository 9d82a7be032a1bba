"""The one trained checkpoint of the repo, weights/ref_trained/tiny_x4_400_G.pth (the
reference PyTorch model trained for 400 steps at weights/ref_trained/tiny_x4_parity.yml),
in the port against the JAX package on the CPU.

- ``params_from_state_dict`` (no JAX) gives the params that the JAX package's
  ``load_any`` followed by ``params_from_jax`` gives, leaf for leaf;
- the explicit spec the port serves it with is the one ``model_spec_from_opt`` builds
  from the yml;
- the port's x4 reverse matches JAX's on the latents of JAX's ``encode``, on the plain
  and the fused params (the kernels' plain versions here), in the float32 and the bf16
  recipe.  Tolerances as tests/test_torch_port_model.py: 1e-4 in float32, 1e-2 in
  bf16, on the [0, 1] image scale (measured: 2.3e-6 and 4.7e-3).

The images are synthetic (no dataset is in the repo): smooth random HR images.
"""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu.utils import config as jconfig
from hcflow_tpu.utils.checkpoint import load_any
from hcflow_tpu_torch.convert import params_from_jax, params_from_state_dict
from hcflow_tpu_torch.models import HCFlowSRSpec
from hcflow_tpu_torch.train.trainer import tree_leaves

from _torch_port_util import TINY_CKPT, jax_run

CKPT = Path(__file__).resolve().parents[1] / "weights" / "ref_trained"
PTH, YML = CKPT / "tiny_x4_400_G.pth", CKPT / "tiny_x4_parity.yml"
TOL = {None: 1e-4, "bfloat16": 1e-2}


def _jax_spec(cd=None):
    opt = yaml.safe_load(YML.read_text())
    if cd:
        opt["network_G"]["compute_dtype"] = cd
    return jconfig.model_spec_from_opt(opt)


def test_explicit_spec_equals_the_yml():
    port, ref = HCFlowSRSpec.for_scale(4, **TINY_CKPT), _jax_spec()
    assert port.quant == ref.quant == 64
    jflow = ref.flow
    for f in dataclasses.fields(port.flow):
        if hasattr(jflow, f.name):
            a, b = getattr(port.flow, f.name), getattr(jflow, f.name)
            if f.name == "K":  # the yml's scalar K is repeated L + 1 times
                b = b[: jflow.L]
            assert (tuple(a) if isinstance(a, (list, tuple)) else a) == (
                tuple(b) if isinstance(b, (list, tuple)) else b), f.name
    for lp, lj in zip(port.flow.levels, jflow.levels):
        assert (lp.channels, lp.n_main, lp.split_channels) == (lj.channels, lj.n_main,
                                                              lj.split_channels)
        assert lp.cond_spec.n_flow_step == lj.cond_spec.n_flow_step
        assert lp.cond_spec.conv_first_in == lj.cond_spec.conv_first_in


def test_params_from_state_dict_equals_load_any():
    spec = HCFlowSRSpec.for_scale(4, **TINY_CKPT)
    native = params_from_state_dict(torch.load(PTH, map_location="cpu"), spec, device="cpu")
    via_jax = params_from_jax(jax.tree.map(np.asarray, load_any(str(PTH), _jax_spec().flow)),
                              spec, device="cpu")
    a, b = tree_leaves(native), tree_leaves(via_jax)
    assert len(a) == len(b) == 446  # every tensor of the state_dict
    for x, y in zip(a, b):
        assert x.dtype == torch.float32 and torch.equal(x, y)
    # the module. prefix of a DataParallel state_dict is stripped
    sd = {f"module.{k}": v for k, v in torch.load(PTH, map_location="cpu").items()}
    again = tree_leaves(params_from_state_dict(sd, spec, device="cpu"))
    assert all(torch.equal(x, y) for x, y in zip(again, a))


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_reverse_matches_jax_on_the_trained_checkpoint(cd):
    rng = np.random.default_rng(0)
    hr = np.kron(rng.uniform(0.1, 0.9, size=(2, 8, 8, 3)), np.ones((1, 4, 4, 1)))
    hr = (hr + 0.02 * rng.standard_normal(hr.shape)).clip(0, 1).astype(np.float32)
    jspec = _jax_spec(cd)
    jp = load_any(str(PTH), jspec.flow)
    z, eps = jax_run(jspec.flow.encode, jp, hr)
    ref = np.array(jax_run(lambda p, x, e: jspec.flow.reverse_flow(
        p, jax.random.PRNGKey(0), x, 0.9, eps_list=e), jspec.flow.precompute_inference(jp), z, eps))
    assert np.abs(ref - hr).max() < (1e-4 if cd is None else 5e-2)  # JAX's own round trip

    spec = HCFlowSRSpec.for_scale(4, compute_dtype=cd, **TINY_CKPT)
    params = params_from_state_dict(torch.load(PTH, map_location="cpu"), spec, device="cpu")
    zt, epst = torch.from_numpy(np.array(z)), [torch.from_numpy(np.array(e)) for e in eps]
    for fused in (False, True):
        pp = spec.flow.precompute_inference(params, fused=fused)
        assert ("main_fused" in pp["level0"]) == fused
        got = spec.flow.reverse_flow(pp, zt, 0.9, eps_list=epst)
        err = (got - torch.from_numpy(ref)).abs().max().item()
        assert err <= TOL[cd], (fused, err)
