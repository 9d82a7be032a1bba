"""The port's HCFlow++ heads and the rescaling training step against the JAX package
on the CPU:

- ``gan_loss`` in all four types and ``gradient_penalty`` with explicit weights;
- ``VGG19FeatureSpec.apply`` and both discriminators' ``apply`` on the same weights
  (carried across by ``convert.heads_from_jax``), to 1e-5 x max |ref|;
- ``make_sr_feagan_step`` (gan and ragan, features on) and ``make_d_step``: the loss
  terms, every gradient leaf and the params after one update against
  ``jax.value_and_grad`` of the same loss built from the JAX package's own functions
  (the latents given explicitly through ``reverse_flow(..., eps_list=...)``, so no
  random draw differs) and its optimizer, at ``recipe_tol`` (float32: 1e-4 x max(1,
  max |ref|)); the VGG discriminator's gradient, as the G step's head and in its own
  D step, in float64 on both sides (float32 gradients there flip at leaky-ReLU kinks).

Small topologies: the SR model of ``_torch_port_util.TINY`` at HR 64 x 64, batch 2
(the VGG discriminator's input halves five times).  The rescaling step's tests are in
tests/test_torch_port_rescaling_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcflow_tpu.models import discriminators as jdisc
from hcflow_tpu.models import vgg as jvgg
from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec
from hcflow_tpu.train import losses as jlosses
from hcflow_tpu.train import schedules as jschedules
from hcflow_tpu.train import trainer as jtrainer
from hcflow_tpu_torch.convert import heads_from_jax, heads_to_jax, params_from_jax
from hcflow_tpu_torch.models import HCFlowSRSpec
from hcflow_tpu_torch.models import discriminators, vgg
from hcflow_tpu_torch.train import losses, schedules, trainer

from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import (HEAD_B, HEAD_HW, TINY, TRAIN_OPT, _check_grads, _t, check_update,
                              close_scaled, head_data, jax_run, jax_update, patchgan, perturb,
                              recipe_tol, to_jax, vgg_params, with_jax_update)

HEAD_TOL = 1e-5  # a head's output, float32 summed in another order, x max |ref|
TOL = recipe_tol(None, None)  # the steps: the float32 recipe, 1e-4 x max(1, max |ref|)
B, HW = HEAD_B, HEAD_HW


def _rel(port, ref, tol, what):
    ref = np.asarray(ref)
    err = float(np.abs(port.detach().numpy() - ref).max())
    assert port.shape == ref.shape and err <= tol * float(np.abs(ref).max()), (what, err)


# ------------------------------------------------------------------------ losses
@pytest.mark.parametrize("gan_type", ["gan", "ragan", "lsgan", "wgangp"])
def test_gan_loss_matches_jax(gan_type):
    x = np.random.default_rng(0).normal(0, 3, (4, 1)).astype(np.float32)
    for real in (True, False):
        got = losses.gan_loss(gan_type, _t(x), real)
        ref = jlosses.gan_loss(gan_type, jnp.asarray(x), real)
        assert abs(float(got) - float(ref)) <= 1e-6 * max(1.0, abs(float(ref))), (real, got, ref)
    with pytest.raises(NotImplementedError):
        losses.gan_loss("hinge", _t(x), True)


def test_gradient_penalty_matches_jax():
    spec, jspec = (discriminators.PatchGANDiscriminatorSpec(ndf=8, n_layers=2),
                   jdisc.PatchGANDiscriminatorSpec(ndf=8, n_layers=2))
    d = spec.init(0, device="cpu")
    jd = heads_to_jax(d)
    rng = np.random.default_rng(1)
    real, fake = (rng.uniform(size=(3, 12, 12, 3)).astype(np.float32) for _ in range(2))
    key = jax.random.PRNGKey(3)
    alpha = np.asarray(jax.random.uniform(key, (3, 1, 1, 1)))  # what JAX's draws from key
    ref = jax_run(lambda dp, r, f: jlosses.gradient_penalty(jspec.apply, dp, key, r, f),
                  jd, real, fake)
    d = trainer.tree_map(lambda t: t.requires_grad_(True), d)
    got = losses.gradient_penalty(spec.apply, d, _t(real), _t(fake), alpha=_t(alpha))
    assert abs(got.item() - float(ref)) <= 1e-5 * max(1.0, abs(float(ref))), (got, ref)
    # differentiable in D's params (the penalty trains D)
    g = torch.autograd.grad(got, trainer.tree_leaves(d), allow_unused=True)
    assert any(t is not None and float(t.abs().max()) > 0 for t in g)
    drawn = losses.gradient_penalty(spec.apply, d, _t(real), _t(fake),
                                    generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn)


# ------------------------------------------------------------------------- heads
def test_vgg_features_match_jax():
    jp, p = vgg_params()
    assert p["conv1_1"]["w"].shape == (64, 3, 3, 3) and len(p) == 16
    assert jp["conv1_1"]["w"].shape == (3, 3, 3, 64)
    back = heads_from_jax(jp, device="cpu")
    assert all(torch.equal(back[n][k], p[n][k]) for n in p for k in p[n])
    x = head_data(0)[0]
    ref = jax_run(jvgg.VGG19FeatureSpec().apply, jp, x)
    got = vgg.VGG19FeatureSpec().apply(p, _t(x))
    assert got.shape == (B, HW // 16, HW // 16, 512)
    _rel(got, ref, HEAD_TOL, "conv5_4 features")


def test_vgg_npz_round_trip_and_random_features(tmp_path):
    jp, p = vgg_params()
    path = str(tmp_path / "vgg.npz")
    vgg.save_npz(path, p)
    back = jvgg.load_npz(path)  # the JAX package reads the port's file
    for name in jp:
        for leaf in jp[name]:
            assert np.array_equal(np.asarray(back[name][leaf]), jp[name][leaf]), (name, leaf)
    again = vgg.load_npz(path, device="cpu")
    assert all(torch.equal(again[n]["w"], p[n]["w"]) for n in p)
    assert vgg.load_npz(str(tmp_path / "missing.npz"), device="cpu") is None
    # a torchvision-style state_dict (features.<i>.weight, conv/relu/pool indices)
    sd, idx = {}, 0
    for b, n in enumerate((2, 2, 4, 4, 4)):
        for c in range(n):
            sd[f"features.{idx}.weight"] = p[f"conv{b + 1}_{c + 1}"]["w"].numpy()
            sd[f"features.{idx}.bias"] = p[f"conv{b + 1}_{c + 1}"]["b"].numpy()
            idx += 2
        idx += 1
    conv = vgg.convert_torch_state_dict(sd, device="cpu")
    assert all(torch.equal(conv[n]["w"], p[n]["w"]) for n in p)
    jconv = jvgg.convert_torch_state_dict(sd)
    assert all(np.array_equal(np.asarray(jconv[n]["w"]), jp[n]["w"]) for n in jp)
    # He init: std sqrt(2 / fan_in), deterministic from the seed
    r = vgg.random_features(seed=0, device="cpu")
    assert abs(float(r["conv3_1"]["w"].std()) - (2 / (9 * 128)) ** 0.5) < 2e-3
    assert torch.equal(r["conv5_4"]["w"], vgg.random_features(seed=0, device="cpu")["conv5_4"]["w"])


@pytest.mark.parametrize("kind", ["vgg", "patchgan"])
def test_discriminators_match_jax(kind):
    """On the same weights; the VGG discriminator at the shipped ++ recipe's input 160
    (discriminator_vgg_160), batch 2: its last BatchNorms see 5 x 5 maps (statistics over
    fewer values amplify float32 rounding: 1e-5 x max at input 64, 1e-6 at 160)."""
    if kind == "vgg":
        size, B = 160, 2
        spec, jspec = discriminators.VGGDiscriminatorSpec(size), jdisc.VGGDiscriminatorSpec(size)
    else:
        size, B = HW, 4
        spec, jspec = (discriminators.PatchGANDiscriminatorSpec(ndf=8, n_layers=3),
                       jdisc.PatchGANDiscriminatorSpec(ndf=8, n_layers=3))
    p = spec.init(1, device="cpu")
    jp = heads_to_jax(p)
    # JAX's own init gives the same tree of the same shapes
    jinit = jax.eval_shape(jspec.init, jax.random.PRNGKey(0))
    assert jax.tree.structure(jinit) == jax.tree.structure(jp)
    assert all(a.shape == b.shape for a, b in zip(jax.tree.leaves(jinit), jax.tree.leaves(jp)))
    x = np.random.default_rng(1).uniform(size=(B, size, size, 3)).astype(np.float32)
    ref = jax_run(jspec.apply, jp, x)
    got = spec.apply(p, _t(x))
    _rel(got, ref, HEAD_TOL, kind)


# ------------------------------------------------------------------ SR fea/GAN step
EPS_STD = 0.9


@functools.lru_cache(maxsize=None)
def _sr_case():
    model = HCFlowSRSpec.for_scale(4, **TINY)
    jmodel = JHCFlowSRSpec.for_scale(4, **TINY)
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    params = params_from_jax(jp, model, device="cpu")
    hr, lr = head_data(2)
    rng = np.random.default_rng(3)
    eps = [EPS_STD * rng.standard_normal(s).astype(np.float32)
           for s in trainer.latent_shapes(model, lr.shape)]
    return model, params, jmodel, jp, hr, lr, eps


VGG_D64 = (discriminators.VGGDiscriminatorSpec(HW, nf=16),
           jdisc.VGGDiscriminatorSpec(HW, nf=16))


def _vgg_d64():
    """(port spec, JAX spec, port params, JAX params) of the VGG discriminator at HR 64,
    its params in float64, and each spec's apply in float64 on a float32 image with float32
    logits: the G steps' adversarial head where it must be held against JAX (see
    :func:`test_d_step_matches_jax`: in float32 its gradient flips at leaky-ReLU kinks),
    at nf 16 (float64 convolutions are slow on the CPU)."""
    spec, jspec = VGG_D64
    d = trainer.tree_map(lambda t: t.double(), spec.init(2, device="cpu"))
    jd = heads_to_jax(d)

    def apply(p, x):
        return spec.apply(p, x.double()).float()

    def japply(p, x):
        return jspec.apply(p, x.astype(jnp.float64)).astype(jnp.float32)

    return apply, japply, d, jd


def _feagan_step(gan_type, head):
    model, params, jmodel, jp, hr, lr, eps = _sr_case()
    jf, f = vgg_params()
    if head == "patchgan":
        dspec, jdspec, d, jd = patchgan()
        d_apply, jd_apply = dspec.apply, jdspec.apply
    else:
        d_apply, jd_apply, d, jd = _vgg_d64()
    fea_w, gan_w = 0.05, 0.5

    def loss(p, fp, dp):
        fake = jnp.clip(jmodel.flow.reverse_flow(p, jax.random.PRNGKey(0), lr, EPS_STD,
                                                 eps_list=eps), 0.0, 1.0)
        spec = jvgg.VGG19FeatureSpec()
        l_fea = fea_w * jlosses.l1(spec.apply(fp, fake), jax.lax.stop_gradient(spec.apply(fp, hr)))
        pred_fake = jd_apply(dp, fake)
        if gan_type == "ragan":
            pred_real = jax.lax.stop_gradient(jd_apply(dp, hr))
            l_gan = (jlosses.gan_loss("ragan", pred_real - jnp.mean(pred_fake), False)
                     + jlosses.gan_loss("ragan", pred_fake - jnp.mean(pred_real), True)) / 2.0
        else:
            l_gan = jlosses.gan_loss(gan_type, pred_fake, True)
        l_gan = gan_w * l_gan
        return l_fea + l_gan, (fake, l_fea, l_gan)

    if head == "patchgan":
        (jfake, jl_fea, jl_gan), jg, jnew = jax_run(with_jax_update(loss, False), jp, jf, jd)
    else:
        # x64 lets the float64 head run in JAX; the float32 G is unchanged by it
        with jax.enable_x64(True):
            (_, (jfake, jl_fea, jl_gan)), jg = jax_run(
                jax.value_and_grad(loss, has_aux=True), jp, jf, jd)
        jnew = jax_run(lambda p, g: jax_update(p, g, False), jp, jg)

    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    state = trainer.init_state(params, tx)
    step = trainer.make_sr_feagan_step(
        model, tx, EPS_STD, gan_type=gan_type, gan_weight=gan_w, fea_weight=fea_w,
        fea_criterion=losses.l1, d_apply=d_apply, f_apply=vgg.VGG19FeatureSpec().apply)
    state, fake, m = step(state, _t(hr), _t(lr), d, f, eps_list=[_t(e) for e in eps])
    close_scaled(fake, jfake, TOL, "fake HR")
    close_scaled(m["l_g_fea"], jl_fea, TOL, "l_g_fea")
    close_scaled(m["l_g_gan"], jl_gan, TOL, "l_g_gan")
    _check_grads(model, m["grads"], jg, TOL)
    assert state.step == 0 and state.opt_state["count"] == 1 and not fake.requires_grad
    check_update(model, state, jnew, jg, TOL)
    return model, params, tx, step, hr, lr, d, f


@pytest.mark.parametrize("gan_type,head", [("gan", "patchgan"), ("ragan", "patchgan"),
                                           ("gan", "vgg")], ids=["gan", "ragan", "gan-vgg"])
def test_sr_feagan_step_matches_jax(gan_type, head):
    """With a PatchGAN head, and with the shipped ++ recipe's (discriminator_vgg, gan):
    the gradient that reaches G through it, the head in float64 on both sides
    (:func:`_vgg_d64`), G in float32 at ``recipe_tol``."""
    model, params, tx, step, hr, lr, d, f = _feagan_step(gan_type, head)
    if (gan_type, head) != ("gan", "patchgan"):
        return
    # drawn latents: a generator gives the same step twice
    s1 = trainer.init_state(params, tx)
    s2 = trainer.init_state(params, tx)
    _, f1, _ = step(s1, _t(hr), _t(lr), d, f, generator=torch.Generator().manual_seed(4))
    _, f2, _ = step(s2, _t(hr), _t(lr), d, f, generator=torch.Generator().manual_seed(4))
    assert torch.equal(f1, f2)


@pytest.mark.parametrize("kind,gan_type", [("patchgan", "gan"), ("patchgan", "ragan"),
                                           ("vgg", "gan")])
def test_d_step_matches_jax(kind, gan_type):
    """The D step: its losses and logits, its gradients and its params after one update
    (Adam's first update: see :func:`check_update`).  The VGG discriminator (the shipped
    ++ recipe's D) is held on its float32 losses and logits, and on its gradients and
    updated params in float64 on both sides (:func:`_vgg_d_step64`): its float32 gradient
    runs back through nine BatchNorm + leaky-ReLU layers over small maps, where an
    activation within float32 rounding of the kink takes the other slope in one
    framework, and BatchNorm's statistics carry that element's change to its whole
    channel: at input 64 and at 160 the port's float32 gradient and JAX's, and the
    port's float64 one and JAX's float32 one, differ by more than ``recipe_tol``."""
    hr = _sr_case()[4]
    fake = np.clip(hr + 0.1 * np.random.default_rng(5).standard_normal(hr.shape), 0, 1
                   ).astype(np.float32)
    if kind == "vgg":
        spec, jspec = discriminators.VGGDiscriminatorSpec(HW), jdisc.VGGDiscriminatorSpec(HW)
        d = spec.init(2, device="cpu")
        jd = heads_to_jax(d)
    else:
        spec, jspec, d, jd = patchgan()
    opt = {**TRAIN_OPT, "lr_G": 1e-4, "beta1_D": 0.5, "beta2_D": 0.999}
    jtx = jtrainer.make_d_optimizer(opt, jschedules.schedule_from_opt(opt))
    jstate, jm = jax_run(jtrainer.make_d_step(jspec.apply, jtx, gan_type),
                         jtrainer.init_state(jd, jtx), hr, fake)
    tx = trainer.make_d_optimizer(opt, schedules.schedule_from_opt(opt))
    assert (tx.b1, tx.b2, tx.clip_value, tx.clip_norm) == (0.5, 0.999, None, None)
    state = trainer.init_state(d, tx)
    state, m = trainer.make_d_step(spec.apply, tx, gan_type)(state, _t(hr), _t(fake))
    assert sorted(k for k in m if k != "grads") == sorted(jm)
    for k in jm:
        close_scaled(m[k], jm[k], TOL, k)
    assert state.step == 1 == int(jstate.step) and state.opt_state["count"] == 1
    ref = heads_from_jax(jax.tree.map(np.asarray, jstate.params), device="cpu")
    if kind == "vgg":
        assert all(torch.isfinite(t).all() for t in trainer.tree_leaves(state.params))
        _vgg_d_step64(opt, hr, fake)
        return
    g = heads_from_jax(jax.tree.map(np.asarray, jax_run(
        jax.grad(lambda dp: _d_loss(jspec, gan_type, dp, hr, fake)), jd)), device="cpu")
    for i, (a, b) in enumerate(zip(m["grads"], trainer.tree_leaves(g))):
        close_scaled(a, b.numpy(), TOL, f"D grad leaf {i}")
    for name in ref:
        for leaf in ref[name]:
            a, b, gl = state.params[name][leaf].detach(), ref[name][leaf], g[name][leaf]
            sure = gl.abs() > TOL * max(1.0, float(gl.abs().max()))
            if sure.any():
                close_scaled(a[sure], b[sure].numpy(), TOL, f"D {name}.{leaf}")
            assert float((a - b).abs().max()) <= 2 * opt["lr_G"] * (1 + 1e-3), (name, leaf)


def _d_loss(jdspec, gan_type, dp, hr, fake):
    """JAX's D loss (hcflow_tpu/train/trainer.py make_d_step)."""
    pred_real, pred_fake = jdspec.apply(dp, hr), jdspec.apply(dp, fake)
    if gan_type == "ragan":
        return (jlosses.gan_loss("ragan", pred_real - jnp.mean(pred_fake), True)
                + jlosses.gan_loss("ragan", pred_fake - jnp.mean(pred_real), False)) / 2.0
    return (jlosses.gan_loss(gan_type, pred_real, True)
            + jlosses.gan_loss(gan_type, pred_fake, False))


D64_TOL = 1e-9  # float64 on both sides, summed in another order, x max |ref|


def _heads64(tree):
    """A JAX head tree (HWIO convs) as float64 tensors in the port's layout (OIHW)."""
    return {n: {k: torch.from_numpy(np.array(v).transpose(3, 2, 0, 1) if np.ndim(v) == 4
                                    else np.array(v)) for k, v in leaves.items()}
            for n, leaves in tree.items()}


def _vgg_d_step64(opt, hr, fake):
    """The VGG discriminator's D step (nf 16) with params and images in float64 in both
    packages: the gradient of every leaf and the params after one update by JAX's D
    optimizer, to 1e-9 x max |ref|."""
    spec, jspec = VGG_D64
    d = trainer.tree_map(lambda t: t.double(), spec.init(3, device="cpu"))
    hr64, fake64 = hr.astype(np.float64), fake.astype(np.float64)
    with jax.enable_x64(True):
        jd = heads_to_jax(d)
        jtx = jtrainer.make_d_optimizer(opt, jschedules.schedule_from_opt(opt))
        jg = jax_run(jax.grad(lambda dp: _d_loss(jspec, "gan", dp, hr64, fake64)), jd)
        jnew = jax_run(lambda p, g: jtrainer._apply(jtx, jtrainer.init_state(p, jtx), g,
                                                    True).params, jd, jg)
    g, new = (trainer.tree_leaves(_heads64(jax.tree.map(np.asarray, t))) for t in (jg, jnew))
    tx = trainer.make_d_optimizer(opt, schedules.schedule_from_opt(opt))
    state, m = trainer.make_d_step(spec.apply, tx, "gan")(trainer.init_state(d, tx), _t(hr64),
                                                          _t(fake64))
    assert all(a.dtype == torch.float64 for a in m["grads"])
    scale = max(float(b.abs().max()) for b in g)
    for i, (a, b) in enumerate(zip(m["grads"], g)):
        err = float((a - b).abs().max())
        assert a.shape == b.shape and err <= D64_TOL * scale, (f"D grad leaf {i}", err)
    for i, (a, b) in enumerate(zip(trainer.tree_leaves(state.params), new)):
        err = float((a.detach() - b).abs().max())
        assert err <= D64_TOL * max(1.0, float(b.abs().max())), (f"D param leaf {i}", err)
