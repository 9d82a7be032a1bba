"""SR train steps, as ``hcflow_tpu/train/trainer.py``: the reference's separate G
updates per iteration, each its own step.

1. NLL step: the forward flow's NLL, one update; it alone advances ``TrainState.step``.
2. Pixel step (HCFlow+): the reverse at eps_std 0 against HR with a pixel loss, one
   update, the step not advanced.

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
from typing import Any, Callable, Optional

import torch

from ..ops import nets


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
        leaves = tree_leaves(params)
        return {"count": 0, "mu": [torch.zeros_like(p) for p in leaves],
                "nu": [torch.zeros_like(p) for p in leaves], "notfinite_count": 0,
                "total_notfinite": 0}

    @torch.no_grad()
    def update(self, grads: list, opt_state: dict, params, step: int) -> bool:
        """Apply one update from ``grads`` (one per leaf of ``params``, in
        :func:`tree_leaves` order) at iteration ``step``; returns whether it was
        applied (False: a gradient was not finite, nothing changed but the counters)."""
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all().item()
        if not finite:
            opt_state["notfinite_count"] += 1
            opt_state["total_notfinite"] += 1
            return False
        opt_state["notfinite_count"] = 0
        leaves = tree_leaves(params)
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
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    return TrainState(step=0, params=params, opt_state=tx.init(params))


def _grads(loss: torch.Tensor, params) -> list:
    """d loss / d leaf for every leaf (zeros for a leaf the loss does not reach)."""
    leaves = tree_leaves(params)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, gs)]


def _apply(tx: Optimizer, state: TrainState, grads: list, advance_step: bool) -> TrainState:
    tx.update(grads, state.opt_state, state.params, state.step)
    return dataclasses.replace(state, step=state.step + (1 if advance_step else 0))


# ---------------------------------------------------------------------- SR steps
def make_sr_nll_step(model, tx: Optimizer, nll_weight: float = 1.0):
    """G pass 1: the forward flow's NLL (HCFlow_SR_model.py:195-203).

    ``step(state, hr, lr, generator=None, noise=None) -> (state, metrics)``: the
    dequantization noise is ``noise`` or drawn from ``generator``.  metrics: ``nll``,
    ``grad_norm`` (of the unclipped gradient) and ``grads`` (one per leaf of
    ``state.params``, in ``tree_leaves`` order, unclipped)."""

    def step(state: TrainState, hr, lr, generator=None, noise=None):
        with nets.exact_f32():
            _, nll = model.forward(state.params, hr, lr, generator=generator, noise=noise)
            grads = _grads(nll_weight * nll, state.params)
            gnorm = global_norm(grads)
            state = _apply(tx, state, grads, advance_step=True)
        return state, {"nll": nll.detach(), "grad_norm": gnorm, "grads": grads}

    return step


def _clip_global_norm(grads: list, max_norm: float) -> list:
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-12), max=1.0)
    return [g * scale for g in grads]


def make_sr_pixel_step(model, tx: Optimizer, pixel_weight: float, criterion: Callable,
                       warmup_steps: int = 0, warmup_start: int = 0,
                       reverse_grad_clip: Optional[float] = None):
    """G pass 2: the reverse at eps_std 0 and an HR pixel loss (HCFlow_SR_model.py:207-218).

    ``warmup_steps`` ramps the pixel weight linearly from 0 over that many iterations
    after ``warmup_start``; ``reverse_grad_clip`` clips the global norm of the
    gradient before the optimizer sees it (the JAX package's config-gated
    stabilisers, off by default).  ``step(state, hr, lr, generator=None) ->
    (state, metrics)``: ``generator`` draws the (zero-temperature) latents.  metrics:
    ``l_g_pix_hr`` and ``grads`` (after ``reverse_grad_clip``)."""

    def step(state: TrainState, hr, lr, generator=None):
        ramp = 1.0
        if warmup_steps:
            ramp = min(max((state.step - warmup_start) / float(warmup_steps), 0.0), 1.0)
        with nets.exact_f32():
            fake_h = model.reverse(state.params, lr, 0.0, generator=generator, grad=True)
            loss = pixel_weight * ramp * criterion(fake_h, hr)
            grads = _grads(loss, state.params)
            if reverse_grad_clip:
                grads = _clip_global_norm(grads, reverse_grad_clip)
            state = _apply(tx, state, grads, advance_step=False)
        return state, {"l_g_pix_hr": loss.detach(), "grads": grads}

    return step
