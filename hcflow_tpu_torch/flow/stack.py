"""Sequences of K homogeneous flow steps, held as a list of per-step param dicts.

The JAX package stacks the steps' params and runs ``lax.scan``; here a Python loop
runs the list.  The forward runs the steps from k = 0 up, the inverse from k = K-1
down to 0.  With ``remat`` and grad enabled each step's activations are recomputed
in the backward pass (``torch.utils.checkpoint``), the counterpart of the JAX
package's ``_maybe_remat``, which checkpoints the scan body: the recomputation runs
under the TF32 settings of the first forward (``nets.exact_f32`` sets them globally,
and the backward pass may run outside it).  Under a spatial mesh a chain of steps runs
on this rank's band plus the rows of halo that its nets read (:func:`on_band`), or, in a
forward that sums a logdet, on the band alone with the ``mesh`` passed to every step
(its nets exchange a row before each 3x3 conv), so that each pixel's log-determinant
counts once.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from ..ops import invconv, nets
from ..parallel import halo
from .flowstep import FlowStepSpec


def init_stack(spec: FlowStepSpec, generator: torch.Generator, n_steps: int) -> list:
    return [spec.init(generator) for _ in range(n_steps)]


def precompute_invconv(steps: list) -> list:
    """Attach every step's invconv inverse (out of the serving hot path); a step
    without an invconv is left as it is."""
    return [{**p, "invconv": invconv.precompute(p["invconv"])} if "invconv" in p else p
            for p in steps]


def run_step(fn, *args, remat: bool = False):
    """``fn(*args)``; with ``remat`` and grad enabled, its activations are recomputed
    in the backward pass under the TF32 flags this forward ran with."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    flags = nets.tf32_flags()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,  # draws none
                      context_fn=lambda: (contextlib.nullcontext(), nets.tf32(flags)))


def forward_stack(spec: FlowStepSpec, steps: list, z: torch.Tensor, u=None, logdet=None,
                  remat: bool = False, mesh=None):
    for p in steps:
        z, logdet = run_step(spec.forward, p, z, u, logdet, mesh, remat=remat)
    return z, logdet


def calibrate_stack(spec: FlowStepSpec, steps: list, z: torch.Tensor, u=None, logdet=None):
    """Data-dependent init across the steps in order; returns (steps, z, logdet)."""
    new = []
    for p in steps:
        p, z, logdet = spec.calibrate(p, z, u, logdet)
        new.append(p)
    return new, z, logdet


def inverse_stack(spec: FlowStepSpec, steps: list, z: torch.Tensor, u=None, logdet=None,
                  remat: bool = False):
    for p in reversed(steps):
        z, logdet = run_step(spec.inverse, p, z, u, logdet, remat=remat)
    return z, logdet


def compute_u_contribs(spec: FlowStepSpec, steps: list, u: torch.Tensor,
                       mesh=None) -> torch.Tensor:
    """All K steps' conv1 cond contributions as ONE wide conv.

    conv1 is linear and bias-free, and u is the same for every step, so the K cond
    slices of its weight concatenate into one conv.  Returns NHWC (B, H, W, K*hidden):
    channels ``k*hidden : (k+1)*hidden`` are step k's term, the layout the chain
    kernel reads.
    """
    cond = spec.cond_channels
    w_u = torch.cat([p["coupling"]["f"]["conv1"]["w"][:, -cond:] for p in steps], 0)
    return nets.conv2d(u, w_u, compute_dtype=spec.compute_dtype, mesh=mesh)


def on_band(run, z, u, rows: int, mesh, hoist=None):
    """``run(z, c)`` for a chain of steps that reads ``rows`` rows each side of an output
    row (``nets.halo_rows`` of its steps), c the cond input u, or ``hoist(u)`` where
    given (:class:`Hoist`, which reads ``hoist.rows`` more).  Without
    a spatial axis that is all; with one, run takes this rank's band of z plus its halo
    and u's rows beside them, and its output is cut back to the band."""
    if not halo.sharded(mesh):
        return run(z, u if hoist is None else hoist(u))
    ze, have = halo.exchange(z, rows, mesh, "chain")
    c = None
    if u is not None:
        ue, hu = halo.exchange(u, rows + (0 if hoist is None else hoist.rows), mesh, "cond")
        c = halo.crop(ue if hoist is None else hoist(ue), hu, have)
    return halo.crop(run(ze, c), have)


class Hoist:
    """:func:`compute_u_contribs` of a chain as :func:`on_band` takes it: callable on u,
    with the rows of halo it reads each side (conv1's radius)."""

    def __init__(self, spec: FlowStepSpec, steps: list):
        self.spec, self.steps = spec, steps
        self.rows = nets.halo_rows(steps[0]["coupling"]["f"]["conv1"]["w"])

    def __call__(self, u):
        return compute_u_contribs(self.spec, self.steps, u)


def forward_stack_hoisted(spec: FlowStepSpec, steps: list, z, u, logdet=None,
                          remat: bool = False, mesh=None):
    """Forward with every step's cond term precomputed by :func:`compute_u_contribs`."""
    return forward_stack_uc(spec, steps, z, compute_u_contribs(spec, steps, u, mesh), logdet,
                            remat, mesh)


def forward_stack_uc(spec: FlowStepSpec, steps: list, z, uc, logdet=None, remat: bool = False,
                     mesh=None):
    """Forward with the steps' cond terms ``uc`` (:func:`compute_u_contribs`) given."""
    hid = spec.hidden_channels
    for k in range(len(steps)):
        z, logdet = run_step(spec.forward_hoisted, steps[k], z,
                             uc[..., k * hid : (k + 1) * hid], logdet, mesh, remat=remat)
    return z, logdet


def inverse_stack_hoisted(spec: FlowStepSpec, steps: list, z, u, logdet=None,
                          remat: bool = False):
    """Inverse with every step's cond term precomputed by :func:`compute_u_contribs`."""
    return inverse_stack_uc(spec, steps, z, compute_u_contribs(spec, steps, u), logdet, remat)


def inverse_stack_uc(spec: FlowStepSpec, steps: list, z, uc, logdet=None, remat: bool = False):
    """Inverse with the steps' cond terms ``uc`` (:func:`compute_u_contribs`) given."""
    hid = spec.hidden_channels
    for k in reversed(range(len(steps))):
        z, logdet = run_step(spec.inverse_hoisted, steps[k], z,
                             uc[..., k * hid : (k + 1) * hid], logdet, remat=remat)
    return z, logdet
