"""The port's rescaling training step against the JAX package on the CPU.

``make_rescaling_step`` bare (latents at temperature 0) and with the ++ heads (VGG19
features and a PatchGAN, latents at 0.8): the loss terms, every gradient leaf and the
params after one update against ``jax.value_and_grad`` of the JAX step's loss built
from the JAX package's own functions (the forward, its straight-through quantizer, the
reverse with the latents given through ``reverse_flow(..., eps_list=...)``, so no
random draw differs) and its optimizer, at ``recipe_tol`` (float32: 1e-4 x max(1,
max |ref|)); the reverse leg under recomputation gives the gradient it gives without.

A rescaling model of K (3, 3) with one split-off step a level, hidden 8, RRDB nb
(1, 1), nf 8, gc 8, at HR 64 x 64, batch 2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcflow_tpu.models import vgg as jvgg
from hcflow_tpu.models.hcflow_rescaling import HCFlowRescalingSpec as JHCFlowRescalingSpec
from hcflow_tpu.ops.quant import quantize_ste as jquantize_ste
from hcflow_tpu.train import losses as jlosses
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.models import HCFlowRescalingSpec, vgg
from hcflow_tpu_torch.train import losses, schedules, trainer

from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import (TRAIN_OPT, _check_grads, _t, check_update, close_scaled, head_data,
                              jax_run, patchgan, perturb, recipe_tol, to_jax, vgg_params,
                              with_jax_update)

TOL = recipe_tol(None, None)
TINY_RS = dict(K=(3, 3), after_splitoff=(1, 1), hidden_channels=8, so_hidden_channels=8,
               rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=8)
RS_W = dict(weight_lr=0.05, weight_z=1e-5, weight_hr=1.0)
FEA_W, GAN_W = 0.05, 0.5


@functools.lru_cache(maxsize=None)
def _rs_case(eps_std):
    model = HCFlowRescalingSpec.default_x4(**TINY_RS)
    jmodel = JHCFlowRescalingSpec.default_x4(**TINY_RS)
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    params = params_from_jax(jp, model, device="cpu")
    hr, lr = head_data(6)
    rng = np.random.default_rng(7)
    eps = [eps_std * rng.standard_normal(s).astype(np.float32)
           for s in trainer.latent_shapes(model, lr.shape)]
    return model, params, jmodel, jp, hr, lr, eps


def _jax_loss(jmodel, jdspec, hr, lr, eps, heads):
    """The JAX step's loss (hcflow_tpu/train/trainer.py make_rescaling_step) with the
    latents given: w_lr L2 + w_z mean(z^2) + w_hr L1, each finite-guarded, and with
    ``heads`` the perceptual and adversarial terms on the same fake HR."""

    def fin(x):
        return jnp.where(jnp.isfinite(x), x, 0.0)

    def loss(p, fp, dp):
        fake_lr, fake_zs = jmodel.forward(p, hr)
        l_lr = RS_W["weight_lr"] * jlosses.l2(fake_lr, lr)
        z = jnp.concatenate([z.reshape(z.shape[0], -1) for z in fake_zs], axis=1)
        l_z = RS_W["weight_z"] * jnp.mean(z ** 2)
        fake_hr = jnp.clip(jmodel.flow.reverse_flow(p, jax.random.PRNGKey(0),
                                                    jquantize_ste(fake_lr), 1.0, eps_list=eps),
                           0.0, 1.0)
        l_hr = RS_W["weight_hr"] * jlosses.l1(fake_hr, hr)
        total = fin(l_lr) + fin(l_z) + fin(l_hr)
        terms = {"l_g_lr": l_lr, "l_g_z": l_z, "l_g_hr": l_hr}
        if heads:
            spec = jvgg.VGG19FeatureSpec()
            terms["l_g_fea"] = FEA_W * jlosses.l1(spec.apply(fp, fake_hr),
                                                  jax.lax.stop_gradient(spec.apply(fp, hr)))
            terms["l_g_gan"] = GAN_W * jlosses.gan_loss("gan", jdspec.apply(dp, fake_hr), True)
            total = total + fin(terms["l_g_fea"]) + fin(terms["l_g_gan"])
        return total, (fake_hr, terms)

    return loss


@pytest.mark.parametrize("eps_std,heads", [(0.0, False), (0.8, True)], ids=["bare", "heads"])
def test_rescaling_step_matches_jax(eps_std, heads):
    model, params, jmodel, jp, hr, lr, eps = _rs_case(eps_std)
    jf, f = vgg_params()
    dspec, jdspec, d, jd = patchgan()
    loss = _jax_loss(jmodel, jdspec, hr, lr, eps, heads)
    (jfake, jterms), jg, jnew = jax_run(with_jax_update(loss, True), jp, jf, jd)

    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    state = trainer.init_state(params, tx)
    kw = dict(fea_weight=FEA_W, gan_weight=GAN_W, fea_criterion=losses.l1, d_apply=dspec.apply,
              f_apply=vgg.VGG19FeatureSpec().apply) if heads else {}
    step = trainer.make_rescaling_step(model, tx, **RS_W, eps_std_reverse=eps_std, **kw)
    teps = [_t(e) for e in eps]
    if heads:
        state, fake, m = step(state, _t(hr), _t(lr), d, f, eps_list=teps)
        close_scaled(fake, jfake, TOL, "fake HR")
        assert not fake.requires_grad
    else:
        state, m = step(state, _t(hr), _t(lr), eps_list=teps)
    assert sorted(k for k in m if k != "grads") == sorted(jterms)
    for k in jterms:
        close_scaled(m[k], jterms[k], TOL, k)
    _check_grads(model, m["grads"], jg, TOL)
    assert state.step == 1 and state.opt_state["count"] == 1
    check_update(model, state, jnew, jg, TOL)


def test_rescaling_reverse_leg_recomputed_gives_the_same_gradient(monkeypatch):
    """torch.utils.checkpoint replays the reverse leg in the backward pass: with the
    latents drawn before that region the recomputation sees the same ones, and the
    gradient is the one without recomputation (a pass-through ``checkpoint``), bit
    for bit."""
    model, params, _, _, hr, lr, _ = _rs_case(0.8)
    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    grads = {}
    for remat in (True, False):
        if not remat:
            monkeypatch.setattr(trainer, "checkpoint", lambda fn, *a, **k: fn(*a))
        step = trainer.make_rescaling_step(model, tx, **RS_W, eps_std_reverse=0.8)
        _, m = step(trainer.init_state(params, tx), _t(hr), _t(lr),
                    generator=torch.Generator().manual_seed(11))
        grads[remat] = m["grads"]
    assert len(grads[True]) == len(grads[False])
    for a, b in zip(grads[True], grads[False]):
        assert torch.equal(a, b)
    assert sum(float(g.abs().max()) > 0 for g in grads[True]) > len(grads[True]) // 2


def test_rescaling_calibrate_matches_jax():
    """The data-dependent ActNorm init of the rescaling model (the JAX package's
    ``HCFlowRescalingSpec.calibrate``)."""
    model, params, jmodel, jp, hr, _, _ = _rs_case(0.0)
    new_j = jax_run(jmodel.calibrate, jp, hr)
    new = model.calibrate(params, _t(hr))
    got = trainer.tree_leaves(new)
    ref = trainer.tree_leaves(params_from_jax(jax.tree.map(np.asarray, new_j), model,
                                              device="cpu"))
    assert len(got) == len(ref)
    for i, (a, b) in enumerate(zip(got, ref)):
        close_scaled(a, b.numpy(), TOL, f"leaf {i}")
    assert not torch.equal(new["level0"]["main"][0]["actnorm"]["logs"],
                           params["level0"]["main"][0]["actnorm"]["logs"])
