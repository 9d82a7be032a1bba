"""A dry run of data-parallel training over several processes: the counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip`` (1-D data parallelism only; the
JAX package's spatial sharding of image height needs a halo exchange the port does not
have).

``dryrun_multigpu(world)`` starts ``world`` processes (``launch``), which join one
process group and take the passes of every trainer family on a fixed global batch
made from a seed, each rank its rows of it, as ``cli/train.py`` runs them:

1. two SR NLL steps;
2. one full HCFlow++ iteration: NLL, pixel, fea/GAN (random VGG19 features, a VGG
   discriminator of input 32 with BatchNorm over the global batch, the relativistic
   GAN loss), D.  The discriminator runs in float64: in float32 its gradient moves by
   up to 1e-2 x max |g| when a sum is taken in another order (a leaky-ReLU input near
   0 changes side, and BatchNorm over a few values spreads it), as between the two
   frameworks (``tests/test_torch_port_heads.py``); in float64 the ranks' BatchNorm
   gradient is within 1e-13 of one process's;
3. one rescaling joint step.

Before each pass rank 0 also computes the one-process pass on the global batch with
the same params, latents and noise; the pass's all-reduced gradient must lie within
``tol`` x max |g| of it, and the D loss (averaged over the ranks) within 1e-5 of it,
relative.  Every rank records a digest of its params after each pass; they must be
equal.  The ActNorm calibration on the gathered global batch must equal rank 0's
calibration on the global batch bit for bit.  Returns rank 0's report.

    python -m hcflow_tpu_torch.parallel.dryrun [--world N] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import multiprocessing as mp
import os
import socket
import tempfile
import traceback

import torch

from . import mesh

D_LOSS_RTOL = 1e-5


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(rank, world, local_rank, port, backend, cpu, threads, fn, args, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(threads)
    try:
        mesh.init_distributed(backend, cpu=cpu)
        result = fn(*args)
        torch.save({"ok": True, "result": result}, out)
    except BaseException:
        torch.save({"ok": False, "error": traceback.format_exc()}, out)
        raise
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def launch(world: int, fn, args=(), cpu: bool = True):
    """``fn(*args)`` in ``world`` new processes (``spawn``) that form one process group,
    as the launcher's would: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (rank modulo the
    cards; every rank on the CPU with ``cpu``) and a free local port; gloo on the CPU or
    where the cards are fewer than the ranks, else NCCL.  Each process takes this
    process's torch thread count.  Returns every rank's result (``fn`` returns what
    ``torch.save`` takes); raises if a rank fails or takes more than 15 minutes."""
    cards = 1 if cpu else torch.cuda.device_count()
    backend = "gloo" if cpu or world > cards else "nccl"
    port, threads = free_port(), torch.get_num_threads()
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pt") for r in range(world)]
        procs = [ctx.Process(target=_child, args=(r, world, r % cards, port, backend, cpu,
                                                   threads, fn, args, outs[r]))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(900)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r, (p, out) in enumerate(zip(procs, outs)):
            got = torch.load(out, weights_only=False) if os.path.exists(out) else None
            if got is None or not got["ok"] or p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {world} failed (exit code {p.exitcode}):\n"
                                   + (got["error"] if got else "no result"))
            results.append(got["result"])
    return results


# ---------------------------------------------------------------------- the dry run
def digest(params) -> str:
    """sha256 of every leaf's bytes, in ``tree_leaves`` order: equal params, equal digest."""
    from ..train.trainer import tree_leaves

    h = hashlib.sha256()
    for t in tree_leaves(params):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _cpu(tree):
    from ..train.trainer import tree_map

    return tree_map(lambda t: t.detach().cpu(), tree)


def _rank(tol: float, cpu: bool) -> dict:
    from ..models import HCFlowRescalingSpec, HCFlowSRSpec, vgg
    from ..models.discriminators import VGGDiscriminatorSpec
    from ..train.losses import l1
    from ..train.schedules import schedule_from_opt
    from ..train.trainer import (detached, init_state, make_d_optimizer,
                                 make_d_step, make_optimizer, make_rescaling_step,
                                 make_sr_feagan_step, make_sr_nll_step, make_sr_pixel_step,
                                 sample_latents, tree_map)

    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    main = rank == 0
    dev = mesh.rank_device(cpu)
    reducer = mesh.DataParallel(world)
    B = 2 * world  # the global batch
    g = torch.Generator().manual_seed(1)
    hr, hr_r = (torch.rand(B, 32, 32, 3, generator=g).to(dev),
                torch.rand(B, 16, 16, 3, generator=g).to(dev))
    lr, lr_r = hr.reshape(B, 8, 4, 8, 4, 3).mean((2, 4)), hr_r.reshape(B, 4, 4, 4, 4, 3).mean((2, 4))
    noise = [torch.rand(hr.shape, generator=g).to(dev) for _ in range(3)]

    def mine(x):
        return mesh.shard_batch(x, rank, world)

    report = {"passes": {}, "digests": []}

    def check(name, step, state, args, ref_step, ref_args, ref_state_of=None):
        """Run the data-parallel pass; on rank 0 also its one-process reference on the
        global batch from the same params, and compare the gradients."""
        ref = None
        if main:
            rs = init_state(detached(state.params), ref_state_of or tx)
            ref = ref_step(dataclasses.replace(rs, step=state.step), *ref_args)
        out = step(state, *args)
        grads = out[-1]["grads"]
        report["digests"].append((name, digest(out[0].params)))
        if main:
            r_grads = ref[-1]["grads"]
            scale = max(float(t.abs().max()) for t in r_grads)
            err = max(float((a - b).abs().max()) for a, b in zip(grads, r_grads))
            report["passes"][name] = {"max_abs_err": err, "max_abs_grad": scale,
                                      "rel": err / scale}
            if not err <= tol * scale:
                raise AssertionError(f"{name}: the all-reduced gradient is {err:.3e} from "
                                     f"the one-process gradient (tol {tol:g} x {scale:.3e})")
        return out, ref

    # 1. SR NLL steps, the HCFlow recipe
    topt = {"lr_G": 2.5e-4, "max_grad_clip": 5, "max_grad_norm": 100, "beta1": 0.9,
            "beta2": 0.99, "lr_steps": [100]}
    model = HCFlowSRSpec.for_scale(4, rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4, K=(3, 3),
                                   after_splitoff=(1, 1), hidden_channels=8,
                                   so_hidden_channels=8)
    tx = make_optimizer(topt, schedule_from_opt(topt))
    params = mesh.replicate(model.init(0, device=dev))
    calibrated = model.calibrate(params, mesh.gather_batch(mine(hr)), noise=noise[0])
    if main:
        report["calibrate_equal"] = digest(calibrated) == digest(
            model.calibrate(params, hr, noise=noise[0]))
        report["nll"] = {"params": _cpu(params), "hr": hr.cpu(), "lr": lr.cpu(),
                         "noise": noise[1].cpu()}
    state = init_state(params, tx)
    nll = make_sr_nll_step(model, tx, reducer=reducer)
    nll_ref = make_sr_nll_step(model, tx)
    for i in (1, 2):
        (state, m), ref = check(f"nll{i}", nll, state, (mine(hr), mine(lr), None, mine(noise[i])),
                                nll_ref, (hr, lr, None, noise[i]))
        if main and i == 1:
            report["nll"]["grads"] = _cpu(m["grads"])
    if state.step != 2:
        raise AssertionError(f"G step {state.step} after two NLL steps")

    # 2. one HCFlow++ iteration: NLL, pixel, fea/GAN, D
    model = HCFlowSRSpec.for_scale(4, rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4, K=(2, 2),
                                   after_splitoff=(1, 1), hidden_channels=8,
                                   so_hidden_channels=8)
    d_specs = VGGDiscriminatorSpec(input_size=32, sync_bn=True), VGGDiscriminatorSpec(input_size=32)

    def d64(spec):  # the discriminator in float64 on float32 images
        return lambda p, x: spec.apply(p, x.double()).float()

    d_sync, d_plain = (d64(s) for s in d_specs)
    dtx = make_d_optimizer({}, schedule_from_opt({"lr_G": 5e-5}))
    f_params = vgg.random_features(seed=0, device=dev)
    f_apply = vgg.VGG19FeatureSpec().apply
    state = init_state(mesh.replicate(model.init(1, device=dev)), tx)
    d_state = init_state(mesh.replicate(tree_map(torch.Tensor.double,
                                                 d_specs[1].init(5, device=dev))), dtx)
    eps_pix = sample_latents(model, lr.shape, 0.0, torch.Generator(dev).manual_seed(2), dev)
    eps_fg = sample_latents(model, lr.shape, 0.9, torch.Generator(dev).manual_seed(3), dev)
    (state, _), _ = check("plusplus_nll", make_sr_nll_step(model, tx, reducer=reducer), state,
                          (mine(hr), mine(lr), None, mine(noise[0])), make_sr_nll_step(model, tx),
                          (hr, lr, None, noise[0]))
    (state, _), _ = check(
        "pixel", make_sr_pixel_step(model, tx, 1.0, l1, reducer=reducer), state,
        (mine(hr), mine(lr), None, [mine(e) for e in eps_pix]),
        make_sr_pixel_step(model, tx, 1.0, l1), (hr, lr, None, eps_pix))
    fg = dict(gan_type="ragan", gan_weight=0.5, fea_weight=0.05, fea_criterion=l1,
              f_apply=f_apply)
    (state, fake_h, _), ref = check(
        "feagan", make_sr_feagan_step(model, tx, 0.9, d_apply=d_sync, reducer=reducer, **fg),
        state, (mine(hr), mine(lr), d_state.params, f_params, None, [mine(e) for e in eps_fg]),
        make_sr_feagan_step(model, tx, 0.9, d_apply=d_plain, **fg),
        (hr, lr, d_state.params, f_params, None, eps_fg))
    fake_all = mesh.gather_batch(fake_h)
    (d_state, dm), ref = check("D", make_d_step(d_sync, dtx, reducer=reducer), d_state,
                               (mine(hr), fake_h), make_d_step(d_plain, dtx),
                               (hr, fake_all), dtx)
    d_loss = reducer.average([dm["l_d_real"] + dm["l_d_fake"]])[0].item()
    if main:
        d_ref = (ref[-1]["l_d_real"] + ref[-1]["l_d_fake"]).item()
        report["d_loss"] = {"ranks": d_loss, "one_process": d_ref,
                            "rel": abs(d_loss - d_ref) / abs(d_ref)}
        if not abs(d_loss - d_ref) <= D_LOSS_RTOL * abs(d_ref):
            raise AssertionError(f"D loss {d_loss} against {d_ref} in one process")
    if state.step != 1 or d_state.step != 1:
        raise AssertionError(f"G step {state.step}, D step {d_state.step} after an iteration")

    # 3. the rescaling joint step
    rmodel = HCFlowRescalingSpec.default_x4(rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4, K=(2, 2),
                                            after_splitoff=(1, 1), hidden_channels=8,
                                            so_hidden_channels=8)
    rtopt = dict(topt, lr_G=2e-4)
    rtx = make_optimizer(rtopt, schedule_from_opt(rtopt))
    rstate = init_state(mesh.replicate(rmodel.init(0, device=dev)), rtx)
    eps_r = sample_latents(rmodel, lr_r.shape, 1.0, torch.Generator(dev).manual_seed(4), dev,
                           deepest_first=False)
    check("rescaling", make_rescaling_step(rmodel, rtx, 5e-2, 1e-5, 1.0, reducer=reducer), rstate,
          (mine(hr_r), mine(lr_r), None, [mine(e) for e in eps_r]),
          make_rescaling_step(rmodel, rtx, 5e-2, 1e-5, 1.0), (hr_r, lr_r, None, eps_r), rtx)
    return report


def dryrun_multigpu(world: int, cpu: bool = False, tol: float = 1e-4) -> dict:
    """The dry run over ``world`` processes (one card each while the cards last, else
    several on one card over gloo; with ``cpu`` on the CPU); returns rank 0's report:
    each pass's gradient error against the one-process pass (``passes``), the D loss's,
    ``calibrate_equal``, the first NLL pass's params, batch, noise and all-reduced
    gradient (``nll``) and ``digests_equal`` (the ranks' params after every pass)."""
    results = launch(world, _rank, (tol, cpu), cpu=cpu)
    report = results[0]
    report["digests_equal"] = all(r["digests"] == report["digests"] for r in results)
    if not report["digests_equal"]:
        raise AssertionError("the ranks' params differ after a pass")
    if not report["calibrate_equal"]:
        raise AssertionError("calibration on the gathered batch differs from one process's")
    return report


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    rep = dryrun_multigpu(a.world, cpu=a.cpu)
    for name, r in rep["passes"].items():
        print(f"{name}: all-reduced gradient within {r['rel']:.3e} x max |g| of one process")
    print(f"D loss within {rep['d_loss']['rel']:.3e} relative; params equal on every rank; "
          "calibration on the gathered batch bit for bit")
