"""Break down the rescaling joint step's gradient error on a ('data', 'spatial') mesh by
leaf: the step of chip_smoke.py phase 13 (d) (default_x4 at full width, GT ``--hr``,
batch 2, params perturbed with seed 12, the same latents) on a (1, 2) mesh, its
quantizer holding the one-process forward's 8-bit codes (``dryrun.HeldCodes``).

    python3 tools/probe_rescaling_mesh.py [--hr 160] [--cpu] [--cudnn default|deterministic|off]
                                          [--smooth]

Two ranks (``parallel.dryrun.launch``: a card each over NCCL where there are 2, else
both on the one card over gloo; ``--cpu``: on the CPU).  Rank 0 also runs the
one-process step twice and once with its own codes held, and prints, each against the
first one-process step, the worst leaves (error over the leaf's max |g|, at least 1e-6 of
the largest leaf's, as ``dryrun._leaf_err``): the sharded step's, the second
one-process step's (the run-to-run spread) and the held-codes step's; and the flips of
every rank's fake LR and of the one-process step's against the held codes.  Two
controls that differ from the one-process step by float32 rounding alone, on the same
held codes: the one-process step with cuDNN switched (on the card: off for on, on for
off) and the one-process step on the HR times 1 + 2^-24 N(0, 1).
``--cudnn``: cuDNN as PyTorch sets it by default, ``deterministic`` (only
deterministic algorithms), or ``off`` (PyTorch's own convolutions).  ``--smooth``: every
side runs a model whose kinks are smoothed (ReLU as softplus, leaky ReLU as 0.2 x + 0.8
softplus(x), both at beta SMOOTH_BETA; the HR loss sqrt(d^2 + 1e-6) in place of |d|),
to show whether the sides of a kink decide the error.  Prints one JSON line last, with
the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from hcflow_tpu_torch.parallel import dryrun, mesh  # noqa: E402

WORST = 8  # leaves listed a comparison
SMOOTH_BETA = 20.0


def _names(tree, prefix=""):
    """The leaves' paths in ``param_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _names(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _names(v, f"{prefix}[{i}]")]
    return [prefix] if tree.is_floating_point() else []


def _worst(names, grads, ref):
    top = max(float(r.abs().max()) for r in ref)
    rows = []
    for n, g, r in zip(names, grads, ref):
        scale = max(float(r.abs().max()), dryrun.LEAF_FLOOR * top)
        err = float((g - r).abs().max())
        rows.append({"rel": err / scale, "max_abs_err": err, "max_abs_grad": float(r.abs().max()),
                     "leaf": n})
    return sorted(rows, key=lambda r: -r["rel"])[:WORST]


def _smooth(nets):
    """Smooth the kinks of this process's nets (ReLU, leaky ReLU); returns the HR loss."""
    softplus = torch.nn.functional.softplus
    nets.lrelu = lambda x: 0.2 * x + 0.8 * softplus(x, beta=SMOOTH_BETA)
    torch.relu = lambda x: softplus(x, beta=SMOOTH_BETA)
    return lambda a, b: torch.sqrt((a - b) ** 2 + 1e-6).mean()


def _rank(hr_hw, cpu, cudnn, smooth):
    from hcflow_tpu_torch.models import HCFlowRescalingSpec
    from hcflow_tpu_torch.ops import nets
    from hcflow_tpu_torch.train.schedules import schedule_from_opt
    from hcflow_tpu_torch.train.trainer import (detached, init_state, make_optimizer,
                                                make_rescaling_step, sample_latents)

    hr_criterion = _smooth(nets) if smooth else None
    torch.backends.cudnn.deterministic = cudnn == "deterministic"
    torch.backends.cudnn.enabled = cudnn != "off"
    m = mesh.make_mesh(mesh_shape=(1, 2))
    dev = mesh.rank_device(cpu)
    g = torch.Generator().manual_seed(1)
    B = 2
    hr = torch.rand(B, hr_hw, hr_hw, 3, generator=g).to(dev)
    lr = hr.reshape(B, hr_hw // 4, 4, hr_hw // 4, 4, 3).mean((2, 4))
    model = HCFlowRescalingSpec.default_x4()
    topt = {"lr_G": 2e-4, "max_grad_clip": 5, "max_grad_norm": 100, "beta1": 0.9,
            "beta2": 0.99, "lr_steps": [100]}
    tx = make_optimizer(topt, schedule_from_opt(topt))
    state = init_state(mesh.replicate(dryrun.perturb(model.init(0, device=dev), 12)), tx)
    eps = sample_latents(model, lr.shape, 1.0, torch.Generator(dev).manual_seed(4), dev,
                         deepest_first=False)
    with nets.exact_f32():
        one_lr = model.forward(state.params, hr, grad=True)[0].detach()

    def step(quantize=None, sharded=False, x=hr):
        kw = {} if quantize is None else {"quantize": quantize}
        if sharded:
            kw.update(reducer=mesh.DataParallel(2), mesh=m)
        fn = make_rescaling_step(model, tx, 5e-2, 1e-5, 1.0, hr_criterion=hr_criterion, **kw)
        args = (m.shard(x), m.shard(lr)) if sharded else (x, lr)
        return fn(init_state(detached(state.params), tx), *args, None, eps)[-1]["grads"]

    held = dryrun.HeldCodes(m.shard(one_lr))
    out = {"flips": None, "device": str(dev)}
    sharded = step(held, sharded=True)
    out["flips"] = held.flips[0]
    if m.rank == 0:
        names = _names(state.params)
        ref = step()
        own = dryrun.HeldCodes(one_lr)
        out.update(sharded=_worst(names, sharded, ref), again=_worst(names, step(), ref),
                   held=_worst(names, step(own), ref), one_process_flips=own.flips[0])
        if not cpu:
            torch.backends.cudnn.enabled = not torch.backends.cudnn.enabled
            out["cudnn_switched"] = _worst(names, step(dryrun.HeldCodes(one_lr)), ref)
            torch.backends.cudnn.enabled = not torch.backends.cudnn.enabled
        nudge = torch.randn(hr.shape, generator=torch.Generator().manual_seed(7)).to(dev)
        out["nudged"] = _worst(names, step(dryrun.HeldCodes(one_lr),
                                           x=hr * (1 + 2.0 ** -24 * nudge)), ref)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hr", type=int, default=160)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--cudnn", choices=("default", "deterministic", "off"), default="default")
    ap.add_argument("--smooth", action="store_true", help="smooth the model's kinks")
    a = ap.parse_args()
    if not a.cpu and not torch.cuda.is_available():
        sys.exit("probe_rescaling_mesh: no CUDA device (--cpu runs on the CPU)")
    res = dryrun.launch(2, _rank, (a.hr, a.cpu, a.cudnn, a.smooth), cpu=a.cpu)
    r0 = res[0]
    print(f"rescaling step, GT {a.hr}, batch 2, (1, 2) mesh, cuDNN {a.cudnn}, "
          f"{'kinks smoothed, ' if a.smooth else ''}{r0['device']}")
    print(f"flips against the held codes: ranks {[r['flips']['flips'] for r in res]}, "
          f"one-process step {r0['one_process_flips']['flips']}")
    for key, what in (("sharded", "sharded step"), ("again", "one-process step run again"),
                      ("held", "one-process step on its own codes held"),
                      ("cudnn_switched", "one-process step, cuDNN switched, codes held"),
                      ("nudged", "one-process step on HR x (1 + 2^-24 N(0, 1)), codes held")):
        if key not in r0:
            continue
        print(f"{what} vs the one-process step, worst leaves:")
        for row in r0[key]:
            print(f"  {row['rel']:.3e} x  abs {row['max_abs_err']:.3e}  max |g| "
                  f"{row['max_abs_grad']:.3e}  {row['leaf']}")
    cards = None
    if not a.cpu:
        cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               timeout=60, check=True).stdout.strip().splitlines()
    print(json.dumps({"hr": a.hr, "cudnn": a.cudnn, "smooth": a.smooth, "cards": cards,
                      "ranks": res}))


if __name__ == "__main__":
    main()
