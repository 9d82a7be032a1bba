"""Train steps, as ``hcflow_tpu/train/trainer.py``: the reference's separate G
updates per iteration, each its own step, and the rescaling model's joint step.

1. NLL step: the forward flow's NLL, one update; it alone advances ``TrainState.step``.
2. Pixel step (HCFlow+): the reverse at eps_std 0 against HR with a pixel loss, one
   update, the step not advanced.
3. Fea/GAN step (HCFlow++): the reverse at ``eps_std_reverse``, a perceptual loss on
   VGG19 features and the adversarial loss of a discriminator, one update.
4. D step: the discriminator's update on real and fake HR; it advances the D state's
   own step, which drives D's schedule.
5. Rescaling step: one joint update of the forward and the inverse flow through the
   straight-through quantizer, with the fea/GAN terms added to the same backward
   when the heads are on.

Randomness is explicit: a step draws its latents from the ``generator`` it is given
(or takes them as ``eps_list``), so a step repeated from a restored state draws what
it drew before.

Data parallelism: every factory takes an optional ``reducer``
(``parallel.DataParallel``).  Each rank computes its pass on its rows of the global
batch; the reducer averages the gradients over the ranks between the backward pass
and the update (before any clipping), so every rank clips, takes the skip decision and
updates on the same gradient, and the ranks' params stay bit-identical; the
relativistic GAN loss takes its batch means over the global batch through it.  The
metrics are this rank's.

A ('data', 'spatial') mesh (``parallel.mesh.make_mesh``): every factory also takes an
optional ``mesh``, and a rank passes its part of the batch: its rows and, on a spatial
axis, a band of their image rows (``Mesh.shard``).  The model calls run on the band with
the halo exchange; the NLL is summed over the spatial group (every rank of it holds the
NLL of its whole images); the pixel, feature, LR, latent and HR losses are means over
the band's pixels (the bands are equal, so their mean over the ranks is the global
mean); the discriminators see the spatial group's gathered images
(``Mesh.gather_rows``), VGG19 features run on the band.  ``DataParallel.average`` of the
gradients over the whole world is then the gradient of the global loss (the
``parallel/mesh.py`` docstring says why).  With a mesh, latents given as ``eps_list``
and those drawn from ``generator`` are the global batch's (every rank takes its part);
the dequantization noise given is this rank's part, like hr.

Integer leaves of the params (a permutation's indices) are fixed: they get no
gradient and no update.

The optimizer is optax's chain, written out: clip by value (``max_grad_clip``), clip
by global norm (``max_grad_norm``), weight decay added to the gradient before Adam,
Adam(beta1, beta2), then ``-schedule(state.step)`` times the update; a gradient with a
non-finite value skips the update and keeps the optimizer state (``apply_if_finite``).

Precision: a whole step (forward, backward and update) runs under
``nets.exact_f32()``, so that the float32 convolutions and matrix products of the
backward pass, which run inside ``backward()`` long after each forward conv has left
its own ``exact_f32`` block, run without TF32 too.  The steps run the plain path:
params with packed kernel weights are refused (no kernel has a backward pass).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional

import torch

from torch.utils.checkpoint import checkpoint

from ..ops import nets
from ..ops.quant import quantize_ste
from ..parallel import halo
from .losses import gan_loss, l1, l2


def tree_leaves(tree) -> list:
    """The tensors of a nested dict/list, in a fixed order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def param_leaves(tree) -> list:
    """The leaves the optimizer updates: the floating-point ones, in
    :func:`tree_leaves` order."""
    return [t for t in tree_leaves(tree) if t.is_floating_point()]


def _has_packs(tree) -> bool:
    if isinstance(tree, dict):
        return any(k.endswith("_fused") or _has_packs(v) for k, v in tree.items())
    if isinstance(tree, list):
        return any(_has_packs(v) for v in tree)
    return False


@dataclasses.dataclass
class TrainState:
    step: int  # training iterations taken (advanced by the NLL step only)
    params: Any  # nested dict/list of leaf tensors that require grad
    opt_state: dict


class Optimizer:
    """optax's ``apply_if_finite(chain(clip, clip_by_global_norm, add_decayed_weights,
    scale_by_adam, -schedule(step)))`` on the leaves of a param tree, in place."""

    def __init__(self, schedule, clip_value=None, clip_norm=None, weight_decay=0.0,
                 b1=0.9, b2=0.99, eps=1e-8):
        self.schedule, self.clip_value, self.clip_norm = schedule, clip_value, clip_norm
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps

    def init(self, params) -> dict:
        leaves = param_leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves], "notfinite_count": 0,
                "total_notfinite": 0}

    @torch.no_grad()
    def update(self, grads: list, opt_state: dict, params, step: int) -> bool:
        """Apply one update from ``grads`` (one per leaf of ``params``, in
        :func:`param_leaves` order) at iteration ``step``; returns whether it was
        applied (False: a gradient was not finite, nothing changed but the counters)."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all().item()
        if not finite:
            opt_state["notfinite_count"] += 1
            opt_state["total_notfinite"] += 1
            return False
        opt_state["notfinite_count"] = 0
        leaves = param_leaves(params)
        g = list(grads)
        if self.clip_value:
            g = [t.clamp(-self.clip_value, self.clip_value) for t in g]
        if self.clip_norm:
            norm = global_norm(g)
            if not norm < self.clip_norm:
                g = torch._foreach_mul(torch._foreach_div(g, norm), self.clip_norm)
        if self.weight_decay:
            g = torch._foreach_add(g, leaves, alpha=self.weight_decay)
        count = opt_state["count"] + 1
        mu, nu = opt_state["mu"], opt_state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        den = torch._foreach_sqrt(torch._foreach_div(nu, 1.0 - self.b2 ** count))
        torch._foreach_add_(den, self.eps)
        torch._foreach_add_(leaves, torch._foreach_div(mu_hat, den), alpha=-self.schedule(step))
        opt_state["count"] = count
        return True


def global_norm(tensors) -> torch.Tensor:
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_d_optimizer(train_opt: dict, schedule) -> Optimizer:
    """The discriminator's Adam(beta1_D, beta2_D), no clipping, under the same skip of
    a non-finite gradient (the JAX package's ``make_d_optimizer``)."""
    return Optimizer(schedule, b1=train_opt.get("beta1_D", 0.9),
                     b2=train_opt.get("beta2_D", 0.99))


def make_optimizer(train_opt: dict, schedule) -> Optimizer:
    return Optimizer(
        schedule,
        clip_value=train_opt.get("max_grad_clip"),
        clip_norm=train_opt.get("max_grad_norm"),
        weight_decay=train_opt.get("weight_decay_G", 0) or 0,
        b1=train_opt.get("beta1", 0.9),
        b2=train_opt.get("beta2", 0.99),
    )


def init_state(params, tx: Optimizer) -> TrainState:
    """A train state on copies of ``params`` (leaves that require grad): the steps
    update them in place and leave the caller's params as they were."""
    if _has_packs(params):
        raise ValueError("training params must not carry packed kernel weights: no kernel "
                         "has a backward pass")
    params = tree_map(lambda t: t.detach().clone().requires_grad_(t.is_floating_point()), params)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def replace_params(state: TrainState, params) -> TrainState:
    """``state`` with ``params`` (the same tree structure, e.g. calibrated) as its
    leaves: each one a leaf that requires grad, sharing the given storage."""
    return dataclasses.replace(
        state, params=tree_map(lambda t: t.detach().requires_grad_(t.is_floating_point()),
                               params))


def detached(params):
    """The params as tensors that do not require grad, sharing their storage (what
    validation and the D step's no-grad reverse read)."""
    return tree_map(lambda t: t.detach(), params)


def _grads(loss: torch.Tensor, params, reducer=None) -> list:
    """d loss / d leaf for every leaf of :func:`param_leaves` (zeros for a leaf the
    loss does not reach), averaged over the ranks by ``reducer``."""
    leaves = param_leaves(params)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]
    return gs if reducer is None else reducer.average(gs)


def _mean(reducer):
    return torch.mean if reducer is None else reducer.mean


def _apply(tx: Optimizer, state: TrainState, grads: list, advance_step: bool) -> TrainState:
    tx.update(grads, state.opt_state, state.params, state.step)
    return dataclasses.replace(state, step=state.step + (1 if advance_step else 0))


# ---------------------------------------------------------------------- SR steps
def make_sr_nll_step(model, tx: Optimizer, nll_weight: float = 1.0, reducer=None, mesh=None):
    """G pass 1: the forward flow's NLL (HCFlow_SR_model.py:195-203).

    ``step(state, hr, lr, generator=None, noise=None) -> (state, metrics)``: the
    dequantization noise is ``noise`` or drawn from ``generator``.  metrics: ``nll``,
    ``grad_norm`` (of the unclipped gradient) and ``grads`` (one per leaf of
    ``param_leaves(state.params)``, unclipped)."""

    def step(state: TrainState, hr, lr, generator=None, noise=None):
        with nets.exact_f32():
            _, nll = model.forward(state.params, hr, lr, generator=generator, noise=noise,
                                   mesh=mesh)
            grads = _grads(nll_weight * nll, state.params, reducer)
            gnorm = global_norm(grads)
            state = _apply(tx, state, grads, advance_step=True)
        return state, {"nll": nll.detach(), "grad_norm": gnorm, "grads": grads}

    return step


def _clip_global_norm(grads: list, max_norm: float) -> list:
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    return [g * scale for g in grads]


def make_sr_pixel_step(model, tx: Optimizer, pixel_weight: float, criterion: Callable,
                       warmup_steps: int = 0, warmup_start: int = 0,
                       reverse_grad_clip: Optional[float] = None, reducer=None, mesh=None):
    """G pass 2: the reverse at eps_std 0 and an HR pixel loss (HCFlow_SR_model.py:207-218).

    ``warmup_steps`` ramps the pixel weight linearly from 0 over that many iterations
    after ``warmup_start``; ``reverse_grad_clip`` clips the global norm of the
    gradient before the optimizer sees it (the JAX package's config-gated
    stabilisers, off by default).  ``step(state, hr, lr, generator=None,
    eps_list=None) -> (state, metrics)``: ``generator`` draws the (zero-temperature)
    latents, or ``eps_list`` gives them whitened.  metrics: ``l_g_pix_hr`` and
    ``grads`` (after ``reverse_grad_clip``)."""

    def step(state: TrainState, hr, lr, generator=None, eps_list=None):
        ramp = 1.0
        if warmup_steps:
            ramp = min(max((state.step - warmup_start) / float(warmup_steps), 0.0), 1.0)
        with nets.exact_f32():
            fake_h = model.reverse(state.params, lr, 0.0, generator=generator,
                                   eps_list=eps_list, grad=True, mesh=mesh)
            loss = pixel_weight * ramp * criterion(fake_h, hr)
            grads = _grads(loss, state.params, reducer)
            if reverse_grad_clip:
                grads = _clip_global_norm(grads, reverse_grad_clip)
            state = _apply(tx, state, grads, advance_step=False)
        return state, {"l_g_pix_hr": loss.detach(), "grads": grads}

    return step


def _whole(mesh, *xs):
    """xs as whole images: gathered over the spatial group of a spatial ``mesh``."""
    return [mesh.gather_rows(x) for x in xs] if halo.sharded(mesh) else list(xs)


def _adversarial(gan_type: str, d_apply, d_params, fake_h, hr, mean=torch.mean, mesh=None):
    """The generator's adversarial loss on fake_h; ragan against the detached real
    logits (HCFlow_SR_model.py:236-249), with the batch means ``mean`` takes.  ``mesh``:
    on the spatial group's gathered images."""
    fake_h, hr = _whole(mesh, fake_h, hr)
    pred_fake = d_apply(d_params, fake_h)
    if gan_type == "ragan":
        with torch.no_grad():
            pred_real = d_apply(d_params, hr)
        return (gan_loss("ragan", pred_real - mean(pred_fake), False)
                + gan_loss("ragan", pred_fake - mean(pred_real), True)) / 2.0
    return gan_loss(gan_type, pred_fake, True)


def _feature(f_apply, f_params, fea_criterion, fake_h, hr, mesh=None):
    """The perceptual loss: fake_h's features against HR's (detached); ``mesh``: on this
    rank's band."""
    if halo.sharded(mesh):
        f_apply = functools.partial(f_apply, mesh=mesh)
    with torch.no_grad():
        real_fea = f_apply(f_params, hr)
    return fea_criterion(f_apply(f_params, fake_h), real_fea)


def make_sr_feagan_step(model, tx: Optimizer, eps_std_reverse: float, gan_type: str = "gan",
                        gan_weight: float = 0.0, fea_weight: float = 0.0,
                        fea_criterion: Optional[Callable] = None,
                        d_apply: Optional[Callable] = None, f_apply: Optional[Callable] = None,
                        reverse_grad_clip: Optional[float] = None, reducer=None,
                        mesh=None):
    """G pass 3: the reverse at eps_std_reverse, perceptual and adversarial losses
    (HCFlow_SR_model.py:223-254).

    ``step(state, hr, lr, d_params, f_params, generator=None, eps_list=None) ->
    (state, fake_h, metrics)``: the latents drawn from ``generator``, or the whitened
    ``eps_list`` (already at the temperature); fake_h (detached) feeds the D step.
    metrics: ``l_g_fea`` and ``l_g_gan`` where on, and ``grads``."""

    def step(state: TrainState, hr, lr, d_params, f_params, generator=None, eps_list=None):
        with nets.exact_f32():
            fake_h = model.reverse(state.params, lr, eps_std_reverse, generator=generator,
                                   eps_list=eps_list, grad=True, mesh=mesh)
            total, metrics = 0.0, {}
            if fea_weight and f_apply is not None:
                metrics["l_g_fea"] = fea_weight * _feature(f_apply, f_params, fea_criterion,
                                                           fake_h, hr, mesh)
                total = total + metrics["l_g_fea"]
            if gan_weight and d_apply is not None:
                metrics["l_g_gan"] = gan_weight * _adversarial(gan_type, d_apply, d_params,
                                                               fake_h, hr, _mean(reducer), mesh)
                total = total + metrics["l_g_gan"]
            grads = _grads(total, state.params, reducer)
            if reverse_grad_clip:
                grads = _clip_global_norm(grads, reverse_grad_clip)
            state = _apply(tx, state, grads, advance_step=False)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, fake_h.detach(), {**metrics, "grads": grads}

    return step


def make_d_step(d_apply, d_tx: Optimizer, gan_type: str = "gan", reducer=None, mesh=None):
    """D pass: the discriminator's update on real and fake HR (HCFlow_SR_model.py:256-287).

    ``step(d_state, hr, fake_h) -> (d_state, metrics)``; advances ``d_state.step``.
    metrics: ``l_d_real``, ``l_d_fake``, ``D_real``, ``D_fake`` and ``grads``.  ``mesh``:
    hr and fake_h are this rank's bands; D sees the spatial group's gathered images."""

    mean = _mean(reducer)

    def step(d_state: TrainState, hr, fake_h):
        hr, fake_h = _whole(mesh, hr, fake_h.detach())
        with nets.exact_f32():
            pred_real = d_apply(d_state.params, hr)
            pred_fake = d_apply(d_state.params, fake_h)
            if gan_type == "ragan":
                l_real = gan_loss("ragan", pred_real - mean(pred_fake), True)
                l_fake = gan_loss("ragan", pred_fake - mean(pred_real), False)
                total = (l_real + l_fake) / 2.0
            else:
                l_real = gan_loss(gan_type, pred_real, True)
                l_fake = gan_loss(gan_type, pred_fake, False)
                total = l_real + l_fake
            grads = _grads(total, d_state.params, reducer)
            d_state = _apply(d_tx, d_state, grads, advance_step=True)
        metrics = {"l_d_real": l_real, "l_d_fake": l_fake, "D_real": pred_real.mean(),
                   "D_fake": pred_fake.mean()}
        return d_state, {**{k: v.detach() for k, v in metrics.items()}, "grads": grads}

    return step


# ---------------------------------------------------------------- rescaling step
def latent_shapes(model, lr_shape) -> list:
    """The whitened latents' shapes per level for an LR batch of ``lr_shape`` (NHWC):
    level i at the LR size times 2^(L-1-i), with the level's split-off channels."""
    B, H, W, _ = lr_shape
    L = model.flow.L
    return [(B, H * 2 ** (L - 1 - lv.level), W * 2 ** (L - 1 - lv.level),
             lv.cond_spec.a_channels) for lv in model.flow.levels]


def sample_latents(model, lr_shape, eps_std, generator, device, deepest_first: bool = True) -> list:
    """Whitened latents at temperature eps_std for an LR batch of ``lr_shape``, one per
    level (``latent_shapes``), drawn from ``generator`` in the order the model draws
    them: the SR reverse deepest level first, the rescaling step level 0 first."""
    shapes = latent_shapes(model, lr_shape)
    order = reversed(range(len(shapes))) if deepest_first else range(len(shapes))
    eps = [None] * len(shapes)
    for i in order:
        eps[i] = eps_std * torch.randn(shapes[i], generator=generator, device=device)
    return eps


def _finite(x):
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def make_rescaling_step(model, tx: Optimizer, weight_lr: float, weight_z: float,
                        weight_hr: float, eps_std_reverse: float = 1.0,
                        lr_criterion: Optional[Callable] = None,
                        hr_criterion: Optional[Callable] = None, gan_type: str = "gan",
                        gan_weight: float = 0.0, fea_weight: float = 0.0,
                        fea_criterion: Optional[Callable] = None,
                        d_apply: Optional[Callable] = None, f_apply: Optional[Callable] = None,
                        reducer=None, mesh=None, *, quantize: Callable = quantize_ste):
    """The joint forward and inverse update through the straight-through quantizer
    (HCFlow_Rescaling_model.py:204-264):

        loss = w_lr * L2(fake_LR, LR) + w_z * mean(z^2) + w_hr * L1(reverse(quant(fake_LR)), HR)

    each term finite-guarded on its own (a non-finite term counts 0, the reference's
    torch.isfinite gates).  The reverse leg's activations are recomputed
    in the backward pass (the JAX package's ``jax.checkpoint``); its latents are drawn
    before that region, so the recomputation sees the same ones.

    Optional fea/GAN heads add their terms to the same backward, on the joint pass's
    fake HR.  With either head on: ``step(state, hr, lr, d_params, f_params,
    generator=None, eps_list=None) -> (state, fake_hr, metrics)``; otherwise
    ``step(state, hr, lr, generator=None, eps_list=None) -> (state, metrics)``.  The
    latents are drawn from ``generator`` at ``eps_std_reverse``, or given whitened as
    ``eps_list`` (already at the temperature).  metrics: ``l_g_lr``, ``l_g_z``,
    ``l_g_hr`` (``l_g_fea``, ``l_g_gan``) and ``grads``.  Advances the step.

    ``quantize``: the straight-through quantizer (``parallel.dryrun.HeldCodes`` holds
    another pass's codes there, to compare a sharded step with one process's)."""
    lr_criterion = lr_criterion or l2
    hr_criterion = hr_criterion or l1
    has_heads = bool((fea_weight and f_apply is not None) or (gan_weight and d_apply is not None))

    def joint(state, hr, lr, d_params, f_params, generator, eps_list):
        p = state.params
        with nets.exact_f32():
            fake_lr, fake_zs = model.forward(p, hr, grad=True, mesh=mesh)
            l_lr = weight_lr * lr_criterion(fake_lr, lr)
            z_flat = torch.cat([z.reshape(z.shape[0], -1) for z in fake_zs], 1)
            l_z = weight_z * (z_flat ** 2).mean()
            fake_lr_q = quantize(fake_lr)
            if eps_list is None:
                shape = fake_lr_q.shape if mesh is None else mesh.global_shape(fake_lr_q.shape)
                eps_list = sample_latents(model, shape, eps_std_reverse, generator, hr.device,
                                          deepest_first=False)

            def reverse(z):
                return model.reverse(p, z, eps_std_reverse, eps_list=eps_list, grad=True,
                                     mesh=mesh)

            fake_hr = checkpoint(reverse, fake_lr_q, use_reentrant=False)
            l_hr = weight_hr * hr_criterion(fake_hr, hr)
            total = _finite(l_lr) + _finite(l_z) + _finite(l_hr)
            metrics = {"l_g_lr": l_lr, "l_g_z": l_z, "l_g_hr": l_hr}
            if fea_weight and f_apply is not None:
                metrics["l_g_fea"] = fea_weight * _feature(f_apply, f_params, fea_criterion,
                                                           fake_hr, hr, mesh)
                total = total + _finite(metrics["l_g_fea"])
            if gan_weight and d_apply is not None:
                metrics["l_g_gan"] = gan_weight * _adversarial(gan_type, d_apply, d_params,
                                                               fake_hr, hr, _mean(reducer), mesh)
                total = total + _finite(metrics["l_g_gan"])
            grads = _grads(total, p, reducer)
            state = _apply(tx, state, grads, advance_step=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return state, fake_hr.detach(), {**metrics, "grads": grads}

    if not has_heads:
        def step(state: TrainState, hr, lr, generator=None, eps_list=None):
            state, _, metrics = joint(state, hr, lr, None, None, generator, eps_list)
            return state, metrics

        return step

    def step_heads(state: TrainState, hr, lr, d_params, f_params, generator=None,
                   eps_list=None):
        return joint(state, hr, lr, d_params, f_params, generator, eps_list)

    return step_heads
