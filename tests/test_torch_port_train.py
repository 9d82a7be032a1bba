"""The port's SR training slice against the JAX package on the CPU, at x4: the SR
forward (NLL), calibration, encode and the NLL and pixel steps (the x8 counterparts
are in tests/test_torch_port_train_x8.py; the checks and their tolerances are in
tests/_torch_port_util.py); the optimizer, the schedules, the STE, TF32 in the backward
pass and the kernels' refusal of autograd.

Params come from the port's inits (perturbed so that the zero-initialised layers do
work) and reach JAX through ``to_jax``; inputs and the dequantization noise are made
with numpy and handed to both, so no random draw differs.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu.ops.quant import quantize_ste as jquantize_ste
from hcflow_tpu.train import schedules as jschedules
from hcflow_tpu.train import trainer as jtrainer
from hcflow_tpu_torch.flow import stack
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.ops import chain, chain3s, nets, rrdb
from hcflow_tpu_torch.ops.quant import quantize_ste
from hcflow_tpu_torch.train import losses, schedules, trainer

from _torch_port_util import (RECIPE_IDS, RECIPES, TRAIN_OPT, _t, check_calibrate, check_encode,
                              check_sr_forward, check_steps, close_scaled, sr_case)

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------ x4: the SR forward, calibrate, encode, steps
@pytest.mark.parametrize("cd,ed", RECIPES, ids=RECIPE_IDS)
def test_sr_forward_matches_jax(cd, ed):
    check_sr_forward(4, cd, ed)


def test_calibrate_matches_jax():
    check_calibrate(4)


@pytest.mark.parametrize("cd,ed", RECIPES, ids=RECIPE_IDS)
def test_encode_matches_jax_and_round_trips(cd, ed):
    check_encode(4, cd, ed)


@pytest.mark.parametrize("cd,ed", [(None, None), (None, "bfloat16")], ids=["f32", "bf16_encoders"])
def test_nll_and_pixel_steps_match_jax(cd, ed):
    check_steps(4, cd, ed)


def test_steps_run_without_tf32_in_the_backward(monkeypatch):
    """Every float32 conv's backward runs with TF32 off: a whole step is under
    nets.exact_f32(), not only each forward conv."""
    model, params, _, _, hr, lr, noise = sr_case(4, None, "bfloat16")
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return g

    conv2d = nets.conv2d
    monkeypatch.setattr(nets, "conv2d", lambda *a, **k: Probe.apply(conv2d(*a, **k)))
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
        state = trainer.init_state(params, tx)
        state, _ = trainer.make_sr_nll_step(model, tx)(state, _t(hr), _t(lr), noise=_t(noise))
        trainer.make_sr_pixel_step(model, tx, 1.0, losses.l1)(
            state, _t(hr), _t(lr), generator=torch.Generator().manual_seed(0))
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert len(seen) > 20 and not any(a or b for a, b in seen)


# ----------------------------------------------------------------------- optimizer
def _opt_cases():
    clip_value = {"max_grad_clip": 5, "lr_G": 1e-3}
    clip_norm = {"max_grad_norm": 1.0, "lr_G": 1e-3, "weight_decay_G": 1e-2}
    both = {"max_grad_clip": 5, "max_grad_norm": 100, "lr_G": 1e-3, "lr_steps": [2]}
    return [("clip_value", clip_value, 20.0), ("clip_norm", clip_norm, 3.0),
            ("recipe", both, 1.0)]


@pytest.mark.parametrize("name,train_opt,gscale", _opt_cases(), ids=[c[0] for c in _opt_cases()])
def test_optimizer_matches_optax(name, train_opt, gscale):
    """Three updates fed the same gradients, the second one non-finite (skipped: params
    and optimizer state kept), at the iteration the caller gives."""
    rng = np.random.default_rng(7)
    params = {"a": {"w": rng.standard_normal((4, 3, 3, 3)).astype(np.float32)},
              "b": [rng.standard_normal((5,)).astype(np.float32) for _ in range(2)]}
    grads = [jax.tree.map(lambda t: (gscale * rng.standard_normal(t.shape)).astype(np.float32),
                          params) for _ in range(3)]
    grads[1]["b"][0][2] = np.nan
    sched = jschedules.schedule_from_opt(train_opt)
    tx = jtrainer.make_optimizer(train_opt, sched)
    jstate = jtrainer.init_state(jax.tree.map(jnp.asarray, params), tx)

    ptx = trainer.make_optimizer(train_opt, schedules.schedule_from_opt(train_opt))
    pstate = trainer.init_state(jax.tree.map(torch.from_numpy, params,
                                             is_leaf=lambda x: isinstance(x, np.ndarray)), ptx)
    for it, g in enumerate(grads):
        jstate = jtrainer._apply(tx, jstate, jax.tree.map(jnp.asarray, g), advance_step=True)
        leaves = [torch.from_numpy(np.asarray(x)) for x in trainer.tree_leaves(g)]
        applied = ptx.update(leaves, pstate.opt_state, pstate.params, pstate.step)
        pstate.step += 1
        assert applied == (it != 1)
        for a, b in zip(trainer.tree_leaves(pstate.params), jax.tree.leaves(jstate.params)):
            close_scaled(a, b, 1e-6, f"{name} update {it}")
    assert pstate.opt_state["count"] == 2 and pstate.opt_state["total_notfinite"] == 1


def test_reverse_grad_clip_matches_jax():
    rng = np.random.default_rng(3)
    g = [rng.standard_normal((6, 5)).astype(np.float32) * 4 for _ in range(3)]
    ref = jtrainer._clip_global_norm([jnp.asarray(x) for x in g], 2.0)
    got = trainer._clip_global_norm([torch.from_numpy(x) for x in g], 2.0)
    for a, b in zip(got, ref):
        close_scaled(a, b, 1e-6)


# ----------------------------------------------------------------------- schedules
@pytest.mark.parametrize("cfg", sorted(p.name for p in (REPO / "configs").glob("train_SR_*.yml")))
def test_schedules_match_jax(cfg):
    train_opt = yaml.safe_load((REPO / "configs" / cfg).read_text())["train"]
    ref, got = jschedules.schedule_from_opt(train_opt), schedules.schedule_from_opt(train_opt)
    niter = int(train_opt.get("niter", 100000))
    marks = set(train_opt.get("lr_steps") or []) | set(train_opt.get("restarts") or [])
    steps = {0, 1, 7, niter // 3, niter - 1, niter} | {m + d for m in marks for d in (-1, 0, 1)}
    for s in sorted(x for x in steps if x >= 0):
        assert got(s) == pytest.approx(float(ref(s)), rel=1e-6, abs=1e-12), (cfg, s)
    assert schedules.restart_steps(train_opt) == jschedules.restart_steps(train_opt)


def test_cosine_and_warmup_schedules_match_jax():
    opt = {"lr_G": 2e-4, "lr_scheme": "CosineAnnealingLR_Restart", "T_period": [10, 20, 30],
           "restart_weights": [1, 0.5, 0.25], "eta_min": 1e-7, "warmup_iter": 4,
           "clear_state": True}
    ref, got = jschedules.schedule_from_opt(opt), schedules.schedule_from_opt(opt)
    for s in range(0, 65, 3):
        assert got(s) == pytest.approx(float(ref(s)), rel=1e-5, abs=1e-12), s
    assert schedules.restart_steps(opt) == jschedules.restart_steps(opt) == {11, 31}
    opt = {"lr_G": 1e-3, "lr_steps": [5, 15], "restarts": [10], "restart_weights": [0.5]}
    ref, got = jschedules.schedule_from_opt(opt), schedules.schedule_from_opt(opt)
    for s in range(0, 20):
        assert got(s) == pytest.approx(float(ref(s)), rel=1e-6), s


# ------------------------------------------------------------ STE and the kernels
def test_quantize_ste_forward_and_identity_gradient():
    x = np.random.default_rng(5).uniform(-0.2, 1.2, size=(2, 3, 4, 3)).astype(np.float32)
    xt = _t(x).requires_grad_(True)
    y = quantize_ste(xt)
    close_scaled(y, jquantize_ste(jnp.asarray(x)), 0.0)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    (y * w).sum().backward()
    assert torch.equal(xt.grad, w)
    gj = jax.grad(lambda a: jnp.sum(jquantize_ste(a) * w.numpy()))(jnp.asarray(x))
    close_scaled(xt.grad, gj, 0.0)


def test_kernel_wrappers_refuse_autograd():
    """No kernel has a backward pass: the wrappers raise for an input that requires
    grad (on the CPU too, so the rule is tested here), and training states refuse
    params with packs."""
    spec = FlowStepSpec(in_channels=6, hidden_channels=8)
    steps = stack.precompute_invconv(stack.init_stack(spec, torch.Generator().manual_seed(1), 2))
    pk = chain.pack_inverse_chain(steps, padded=True)
    z = torch.randn(1, 4, 5, 6, requires_grad=True)
    with pytest.raises(ValueError, match="no backward pass"):
        chain.inverse_chain(pk, z)
    with torch.no_grad():
        assert chain.inverse_chain(pk, z).shape == z.shape
    trunk = nets.init_rrdb_trunk(torch.Generator().manual_seed(2), 1, 8, 4)
    x = torch.randn(1, 4, 5, 8, requires_grad=True)
    for p in (rrdb.pack_rrdb_trunk(trunk), rrdb.pack_rrdb_trunk(trunk, resident=True)):
        with pytest.raises(ValueError, match="no backward pass"):
            rrdb.trunk_apply(p, x)
    specs = [FlowStepSpec(in_channels=6, hidden_channels=4, flow_permutation="none",
                          flow_coupling="Affine3shift", nn_module="DenseBlock",
                          lr_vs_others=(k % 2 == 0)) for k in range(2)]
    pk3 = chain3s.pack_inverse_chain3s([s.init(torch.Generator().manual_seed(3)) for s in specs])
    with pytest.raises(ValueError, match="no backward pass"):
        chain3s.inverse_chain(pk3, z)
    model, params = sr_case(4, None, None)[:2]
    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    with pytest.raises(ValueError, match="packed kernel weights"):
        trainer.init_state(model.flow.precompute_inference(params, fused=True), tx)


def test_forward_draws_its_noise_from_the_generator():
    """Without explicit noise the dequantization noise comes from the generator the
    caller passes (the same seed gives the same NLL), and one of the two is required."""
    model, params, _, _, hr, lr, _ = sr_case(4, None, None)

    def nll(seed):
        return model.forward(params, _t(hr), _t(lr), generator=torch.Generator().manual_seed(seed))[1]

    assert torch.equal(nll(3), nll(3)) and not torch.equal(nll(3), nll(4))
    with pytest.raises(ValueError, match="generator"):
        model.forward(params, _t(hr), _t(lr))
    with pytest.raises(ValueError, match="generator"):
        model.calibrate(params, _t(hr), _t(lr))
