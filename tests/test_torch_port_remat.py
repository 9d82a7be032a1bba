"""``train.remat_steps`` in the port (``flow/stack.py`` ``run_step``, the counterpart of
the JAX package's ``_maybe_remat``): each flow step's activations recomputed in the
backward pass gives the same gradients bit for bit, for the SR NLL and pixel steps and
the rescaling joint step; the steps do recompute; the recomputation runs under the TF32
flags of the first forward, also when the backward pass runs outside
``nets.exact_f32``; ``cli.train`` trains with it."""

import dataclasses

import numpy as np
import pytest
import torch

from hcflow_tpu_torch.cli import train
from hcflow_tpu_torch.flow import flowstep, stack
from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
from hcflow_tpu_torch.ops import nets
from hcflow_tpu_torch.train import losses, schedules, trainer

from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import TINY, TRAIN_OPT, perturb, train_data, train_option_file


def _remat(model, on):
    return dataclasses.replace(model, flow=dataclasses.replace(model.flow, remat_steps=on))


def _grads(model, step_of, *args):
    params = perturb(model.init(0, device="cpu"), scale=0.02)
    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    out = []
    for on in (False, True):
        step = step_of(_remat(model, on), tx)
        out.append(step(trainer.init_state(params, tx), *args)[-1]["grads"])
    return out


def _batch(hw, scale, seed=0):
    rng = np.random.default_rng(seed)
    hr = rng.uniform(size=(2, hw, hw, 3)).astype(np.float32)
    lr = hr.reshape(2, hw // scale, scale, hw // scale, scale, 3).mean((2, 4))
    return torch.from_numpy(hr), torch.from_numpy(lr), rng


@pytest.mark.parametrize("kind", ["nll", "pixel"])
def test_sr_step_gradients_equal_with_remat(kind):
    model = HCFlowSRSpec.for_scale(4, encoder_dtype="bfloat16", **TINY)
    hr, lr, rng = _batch(16, 4)
    if kind == "nll":
        noise = torch.from_numpy(rng.uniform(size=hr.shape).astype(np.float32))
        a, b = _grads(model, lambda m, tx: trainer.make_sr_nll_step(m, tx), hr, lr, None, noise)
    else:
        eps = trainer.sample_latents(model, lr.shape, 0.0, torch.Generator().manual_seed(0), "cpu")
        a, b = _grads(model, lambda m, tx: trainer.make_sr_pixel_step(
            m, tx, 1.0, losses.pixel_criterion("l1")), hr, lr, None, eps)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_rescaling_step_gradients_equal_with_remat():
    model = HCFlowRescalingSpec.default_x4(rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=8, K=(3, 3),
                                           after_splitoff=(1, 1), hidden_channels=8,
                                           so_hidden_channels=8)
    hr, lr, _ = _batch(16, 4)
    eps = trainer.sample_latents(model, lr.shape, 1.0, torch.Generator().manual_seed(0), "cpu",
                                 deepest_first=False)
    a, b = _grads(model, lambda m, tx: trainer.make_rescaling_step(m, tx, 5e-2, 1e-5, 1.0),
                  hr, lr, None, eps)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_remat_recomputes_the_steps(monkeypatch):
    """The step loops checkpoint each step: with remat_steps the steps' forward runs
    again in the backward pass."""
    calls = []
    real = flowstep.actnorm.forward
    monkeypatch.setattr(flowstep.actnorm, "forward", lambda *a, **k: calls.append(1) or real(*a, **k))
    model = HCFlowSRSpec.for_scale(4, **TINY)
    hr, lr, rng = _batch(16, 4)
    noise = torch.from_numpy(rng.uniform(size=hr.shape).astype(np.float32))
    counts = []
    for on in (False, True):
        calls.clear()
        params = trainer.init_state(model.init(0, device="cpu"), trainer.make_optimizer(
            TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))).params
        nll = _remat(model, on).forward(params, hr, lr, noise=noise)[1]
        torch.autograd.grad(nll, trainer.param_leaves(params), allow_unused=True)
        counts.append(len(calls))
    # per step its ActNorm and its FCN's two conv ActNorms; every step twice with remat
    assert counts == [3 * sum(TINY["K"]), 6 * sum(TINY["K"])]


def test_recomputation_runs_under_the_first_forwards_tf32_flags():
    seen = []

    def fn(x):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return (x * 2).sin()

    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x = torch.ones(3, requires_grad=True)
        with nets.exact_f32():
            y = stack.run_step(fn, x, remat=True)
        y.sum().backward()  # outside exact_f32: TF32 allowed here
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [(False, False), (False, False)]  # the forward, then its recomputation


def test_cli_trains_with_remat_steps(tmp_path):
    data = train_data(tmp_path / "data")
    opt = train_option_file(tmp_path / "opt.yml", "train_SR_DF2K_4X_HCFlow.yml", data,
                            tmp_path / "run", val_freq=100, remat_steps=True)
    state = train.main(["--opt", opt, "--cpu", "--max_steps", "1"])
    assert state.step == 1
    assert all(torch.isfinite(t).all() for t in trainer.tree_leaves(state.params))
