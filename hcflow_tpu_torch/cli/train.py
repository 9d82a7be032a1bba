"""Training CLI: ``python -m hcflow_tpu_torch.cli.train --opt <yml> [--cpu] [--max_steps N]``;
on N cards of a node ``python -m torch.distributed.run --nproc_per_node N -m
hcflow_tpu_torch.cli.train --opt <yml>``.

The counterpart of the JAX package's ``hcflow_tpu/cli/train.py`` (the reference's
train_HCFlow.py with HCFlow_SR_model.py / HCFlow_Rescaling_model.py), the same loop:

- the ActNorm data-dependent re-initialisation every iteration below
  ``act_norm_start_step`` when training NLL only (a calibration pass before the step);
- the G passes in order, NLL -> pixel -> fea/GAN for SR, or the rescaling model's
  joint step, gated by ``D_update_ratio`` / ``D_init_iters``, then the D pass;
- ``clear_state`` restarts: the optimizer moments reset, the schedule runs on;
- checkpoints every ``save_checkpoint_freq`` with keep-2 + every-5000 retention
  (``logger.checkpoint_keep`` / ``checkpoint_keep_period``) and ``resume_state: auto``;
  ``<iter>_G.ckpt`` / ``latest_G.ckpt`` in the JAX package's format, ``<iter>.state``
  in this package's (``utils/checkpoint.py``), as pickle files or, with
  ``path.checkpoint_backend: orbax``, as orbax directories that the JAX package reads;
- validation every ``val_freq`` with the full eval metric grid (``cli/evaluate.py``);
- on SIGTERM / SIGINT the current iteration ends, the state is saved, the loop stops;
- on a CUDA launch or context error (``utils/backend_guard.py``) the state of the last
  finished iteration is saved and the process exits 75 (EX_TEMPFAIL).

It runs on the card unless ``--cpu`` is given; without a card and without ``--cpu``
it raises.  A ``path.checkpoint_backend`` other than ``pickle`` (the default) or
``orbax`` raises before training starts.  The
steps run the plain path (no kernel has a backward pass); validation on the card
serves ``precompute_inference(params, fused=True)``, the kernels, as ``cli/test.py``
does.  Randomness: one generator per (seed, iteration, pass) on the device, which
draws the dequantization noise and latents of the global batch, so an iteration run
again from a restored state draws what it drew before, whatever the world size.

Data parallelism (``parallel/mesh.py``; the JAX package splits the batch over a
device mesh): under the launcher each process takes one card (``cuda:LOCAL_RANK``;
NCCL, or gloo with ``--cpu`` or ``--dist_backend gloo``) and ``batch_size / world``
rows of the global batch, which the world size must divide; the params start from
rank 0's, every pass averages its gradients over the ranks, the ActNorm calibration
runs on the gathered global batch on every rank and the discriminators' BatchNorm on
the global batch's statistics, so a step equals the one-process step on the global
batch up to the order of its sums.  Logging to file, checkpoints, validation and the
emergency save happen on rank 0 while the others wait at a barrier; every rank resumes
from the same ``.state``.  A stop request and a device failure are agreed over the
ranks at the end of each iteration; a rank whose card fails before its gradient
all-reduce leaves the others' collective to fail, and the launcher stops them.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import signal
import threading
import time

import numpy as np
import torch

from ..data import create_dataloader, create_dataset
from ..data.loader import EnlargedSampler
from ..models import vgg
from ..models.discriminators import PatchGANDiscriminatorSpec, VGGDiscriminatorSpec
from ..models.hcflow_sr import device_for
from ..parallel import mesh
from ..train.losses import pixel_criterion
from ..train.schedules import restart_steps, schedule_from_opt
from ..train.trainer import (
    TrainState,
    detached,
    init_state,
    make_d_optimizer,
    make_d_step,
    make_optimizer,
    make_rescaling_step,
    make_sr_feagan_step,
    make_sr_nll_step,
    make_sr_pixel_step,
    replace_params,
    sample_latents,
)
from ..utils import config as config_mod
from ..utils.backend_guard import is_device_failure
from ..utils.checkpoint import (
    latest_checkpoint,
    load_any,
    load_training_state,
    prune_checkpoints,
    save_model,
    save_training_state,
    wait_for_saves,
)
from ..utils.logging import TBWriter, setup_logger
from ..utils.profiling import ThroughputMeter
from .evaluate import Evaluator

opt_get = config_mod.opt_get

# the passes of an iteration, each with its own generator
NLL, PIXEL, FEAGAN, CALIBRATE = range(4)


def step_generator(device, seed: int, step: int, sub: int) -> torch.Generator:
    """The generator of pass ``sub`` of iteration ``step``, on ``device``."""
    s = int(np.random.SeedSequence([seed + 1, step, sub]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s & (2 ** 63 - 1))


def build_loaders(opt, seed, num_replicas=1, rank=0):
    """(train loader, val loader): the train loader gives this rank's
    ``batch_size / num_replicas`` rows of each global batch."""
    train_loader = val_loader = None
    for phase, dataset_opt in (opt.get("datasets") or {}).items():
        dataset_opt = dict(dataset_opt, seed=seed)
        if phase == "train":
            ds = create_dataset(dataset_opt)
            sampler = EnlargedSampler(len(ds), ratio=200, num_replicas=num_replicas, rank=rank,
                                      seed=seed)
            train_loader = create_dataloader(ds, dataset_opt, sampler=sampler,
                                             num_replicas=num_replicas)
        elif phase == "val":
            ds = create_dataset(dict(dataset_opt, phase="val"))
            val_loader = create_dataloader(ds, dict(dataset_opt, phase="val"))
    return train_loader, val_loader


def _discriminator(opt, sync_bn=False):
    """The D spec of network_D (the reference's networks.py)."""
    if opt_get(opt, ["network_D", "which_model_D"], "") == "PatchGANDiscriminator":
        return PatchGANDiscriminatorSpec(in_nc=opt_get(opt, ["network_D", "in_nc"], 3),
                                         ndf=opt_get(opt, ["network_D", "ndf"], 64),
                                         n_layers=opt_get(opt, ["network_D", "n_layers"], 5),
                                         sync_bn=sync_bn)
    return VGGDiscriminatorSpec(input_size=opt_get(opt, ["datasets", "train", "GT_size"], 160),
                                sync_bn=sync_bn)


CHECKPOINT_BACKENDS = ("pickle", "orbax")


def check_checkpoint_backend(opt) -> str:
    """``path.checkpoint_backend`` (``pickle`` when unset); any other value raises."""
    backend = opt_get(opt, ["path", "checkpoint_backend"], "pickle") or "pickle"
    if backend not in CHECKPOINT_BACKENDS:
        raise NotImplementedError(
            f"path.checkpoint_backend = {backend!r} is not implemented in the port (one of "
            f"{', '.join(CHECKPOINT_BACKENDS)})")
    return backend


def main(argv=None):
    """Train as the option file says; returns the final ``TrainState``."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--opt", required=True)
    parser.add_argument("--cpu", action="store_true", help="train on the CPU")
    parser.add_argument("--max_steps", type=int, default=None, help="override niter")
    parser.add_argument("--dist_backend", choices=("nccl", "gloo"), default=None,
                        help="under the launcher: the process group's backend (default "
                        "nccl on the card, gloo with --cpu)")
    args = parser.parse_args(argv)
    device = device_for(mesh.rank_device(args.cpu))
    opt = config_mod.parse(args.opt, is_train=True)
    ckpt_backend = check_checkpoint_backend(opt)

    own_group = not torch.distributed.is_initialized()
    rank, world = mesh.init_distributed(args.dist_backend, cpu=args.cpu)
    try:
        return _train(args, opt, device, rank, world, ckpt_backend)
    finally:
        if own_group and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, opt, device, rank, world, ckpt_backend):
    main_rank = mesh.is_main_process()
    if device.type == "cuda":
        torch.cuda.set_device(device)
    train_opt = opt["train"]
    seed = train_opt.get("manual_seed", 0) or 0
    paths = opt["path"]
    for d in (paths["experiments_root"], paths["models"], paths["training_state"]):
        os.makedirs(d, exist_ok=True)
    logger = setup_logger("base", paths["log"], level=logging.INFO if main_rank else logging.WARNING,
                          to_file=main_rank)
    tb = TBWriter(os.path.join(paths["root"], "tb_logger", opt.get("name", "exp"))
                  if opt.get("use_tb_logger") and main_rank else None)
    batch_size = opt_get(opt, ["datasets", "train", "batch_size"], 16)
    if batch_size % world:
        raise ValueError(f"datasets.train.batch_size {batch_size} is not a multiple of the "
                         f"world size {world}")
    reducer = mesh.DataParallel(world) if torch.distributed.is_initialized() else None
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"device: {name}; rank {rank} of {world}, {batch_size // world} of the "
                f"{batch_size} rows of a batch each")

    # ------------------------------------------------------------------ model
    model_spec = config_mod.model_spec_from_opt(opt)
    if model_spec.flow.compute_dtype is not None:
        logger.warning(
            "training with compute_dtype=%s: bf16 gradients destabilize flow NLL training "
            "(diverges in practice) - use float32 couplings for training and bf16 for serving "
            "unless you know what you are doing", model_spec.flow.compute_dtype)
    model_spec = dataclasses.replace(model_spec, flow=dataclasses.replace(
        model_spec.flow, remat_steps=bool(opt_get(opt, ["train", "remat_steps"], False)),
        remat_trunks=bool(opt_get(opt, ["train", "remat_trunks"], True))))
    is_rescaling = "rescaling" in (opt.get("model") or "").lower()
    params = model_spec.init(seed, device=device)

    pretrain = opt_get(opt, ["path", "pretrain_model_G"])
    if pretrain and os.path.exists(pretrain):
        logger.info(f"loading pretrained G from {pretrain}")
        params = load_any(pretrain, model_spec.flow, device=device)
    params = mesh.replicate(params)

    # --------------------------------------------------------------- trainers
    niter = args.max_steps or int(train_opt.get("niter", 100000))
    schedule = schedule_from_opt(train_opt)
    clear_at = restart_steps(train_opt)  # clear_state: reset Adam moments at restarts
    tx = make_optimizer(train_opt, schedule)
    state = init_state(params, tx)

    nll_weight = train_opt.get("nll_weight", 1 if not is_rescaling else 0) or 0
    pixel_weight_hr = train_opt.get("pixel_weight_hr", 0) or 0
    fea_weight = train_opt.get("feature_weight", 0) or 0
    gan_weight = train_opt.get("gan_weight", 0) or 0
    eps_std_reverse = train_opt.get("eps_std_reverse", 0.9)
    d_update_ratio = train_opt.get("D_update_ratio", 1) or 1
    d_init_iters = train_opt.get("D_init_iters", 0) or 0
    act_norm_start = opt_get(opt, ["network_G", "act_norm_start_step"], 0) or 0

    d_spec = d_state = d_step = d_tx = None
    f_params = f_apply = None
    if gan_weight:
        d_spec = _discriminator(opt, sync_bn=world > 1)
        d_tx = make_d_optimizer(train_opt, schedule_from_opt(
            {**train_opt, "lr_G": train_opt.get("lr_D", 1e-4)}))
        d_state = init_state(mesh.replicate(d_spec.init(seed, device=device)), d_tx)
        d_step = make_d_step(d_spec.apply, d_tx, train_opt.get("gan_type", "gan"), reducer)
    if fea_weight:
        vgg_path = opt_get(opt, ["path", "vgg19_npz"], "weights/vgg19_features.npz")
        f_params = vgg.load_npz(vgg_path, device=device)
        if f_params is None:
            if opt_get(opt, ["train", "feature_fallback"], "off") == "random":
                logger.warning(
                    f"no pretrained VGG weights at {vgg_path}; using DETERMINISTIC RANDOM "
                    "He-init VGG features as the perceptual loss (opt-in substitute via "
                    "train.feature_fallback: random - see models/vgg.py:random_features; NOT "
                    "comparable to pretrained VGG)")
                f_params = vgg.random_features(seed=0, device=device)
            else:
                logger.warning(f"feature_weight={fea_weight} but no VGG weights at {vgg_path} "
                               "and feature_fallback=off; perceptual loss DISABLED")
                fea_weight = 0
        if fea_weight:
            f_apply = vgg.VGG19FeatureSpec().apply
    fea_criterion = pixel_criterion(train_opt.get("feature_criterion", "l1"))

    if is_rescaling:
        # optional fea/GAN heads ride the same single G backward on the joint pass's
        # fake HR (HCFlow_Rescaling_model.py:237-262), unlike SR's separate third pass
        rescaling_heads = bool((fea_weight and f_apply is not None)
                               or (gan_weight and d_spec is not None))
        eps_std_reverse = train_opt.get("eps_std_reverse", 1.0)
        joint_step = make_rescaling_step(
            model_spec, tx, train_opt.get("pixel_weight_lr", 5e-2),
            train_opt.get("weight_z", 1e-5), pixel_weight_hr or 1.0,
            eps_std_reverse=eps_std_reverse,
            lr_criterion=pixel_criterion(train_opt.get("pixel_criterion_lr", "l2")),
            hr_criterion=pixel_criterion(train_opt.get("pixel_criterion_hr", "l1")),
            gan_type=train_opt.get("gan_type", "gan"), gan_weight=gan_weight,
            fea_weight=fea_weight, fea_criterion=fea_criterion,
            d_apply=d_spec.apply if d_spec else None, f_apply=f_apply, reducer=reducer)
    else:
        nll_step = make_sr_nll_step(model_spec, tx, nll_weight, reducer)
        pix_step = fg_step = None  # built after resume (the warmup ramp anchors there)

    # ----------------------------------------------------------------- resume
    start_step = 0
    if opt_get(opt, ["path", "resume_state"]) == "auto":
        latest = latest_checkpoint(paths["training_state"], ".state")
        if latest:
            logger.info(f"auto-resuming from {latest}")
            saved = load_training_state(latest, device=device)
            state = TrainState(step=int(saved["step"]), params=saved["params"],
                               opt_state=saved["opt_state"])
            if d_state is not None and saved.get("d_params") is not None:
                d_state = dataclasses.replace(d_state, params=saved["d_params"],
                                              opt_state=saved["d_opt_state"])
            start_step = int(saved["step"])

    if not is_rescaling:
        rev_clip = train_opt.get("reverse_grad_clip")
        if pixel_weight_hr:
            pix_step = make_sr_pixel_step(
                model_spec, tx, pixel_weight_hr,
                pixel_criterion(train_opt.get("pixel_criterion_hr", "l1")),
                warmup_steps=int(train_opt.get("pixel_warmup_hr") or 0), warmup_start=start_step,
                reverse_grad_clip=rev_clip, reducer=reducer)
        if gan_weight or fea_weight:
            fg_step = make_sr_feagan_step(
                model_spec, tx, eps_std_reverse, gan_type=train_opt.get("gan_type", "gan"),
                gan_weight=gan_weight, fea_weight=fea_weight, fea_criterion=fea_criterion,
                d_apply=d_spec.apply if d_spec else None, f_apply=f_apply,
                reverse_grad_clip=rev_clip, reducer=reducer)

    # ------------------------------------------------------------------- data
    train_loader, val_loader = build_loaders(opt, seed, world, rank)
    assert train_loader is not None, "no train dataset configured"

    print_freq = opt_get(opt, ["logger", "print_freq"], 200)
    save_freq = int(opt_get(opt, ["logger", "save_checkpoint_freq"], 5000))
    val_freq = int(opt_get(opt, ["train", "val_freq"], 5000))
    heats = opt_get(opt, ["val", "heats"], [0.0])
    n_sample = opt_get(opt, ["val", "n_sample"], 1)

    # graceful preemption: on SIGTERM/SIGINT, finish the current iteration, save, stop
    stop_requested = {"flag": False}

    def _request_stop(signum, frame):
        logger.warning(f"signal {signum} received - saving state and stopping")
        stop_requested["flag"] = True

    prev_handlers = (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT))
    signal.signal(signal.SIGTERM, _request_stop)
    signal.signal(signal.SIGINT, _request_stop)
    try:

        def save_all(tag_step):
            save_model(os.path.join(paths["models"], f"{tag_step}_G.ckpt"), state.params,
                       model_spec, tag_step, backend=ckpt_backend)
            save_training_state(
                os.path.join(paths["training_state"], f"{tag_step}.state"), tag_step,
                state.params, state.opt_state,
                d_params=d_state.params if d_state else None,
                d_opt_state=d_state.opt_state if d_state else None, epoch=epoch,
                backend=ckpt_backend)
            # the reference keeps the 2 newest and every 5000th (base_model.py:82-94)
            keep = int(opt_get(opt, ["logger", "checkpoint_keep"], 2) or 2)
            period = int(opt_get(opt, ["logger", "checkpoint_keep_period"], 5000) or 0)
            prune_checkpoints(paths["models"], "_G.ckpt", keep=keep, keep_period=period)
            prune_checkpoints(paths["training_state"], ".state", keep=keep, keep_period=period)

        def save_on_main(tag_step):
            if main_rank:
                save_all(tag_step)
            mesh.barrier()

        def emergency_save(tag_step):
            """Best-effort save after a device failure, on rank 0: copying off a failed
            card may hang, so it runs in a daemon thread with a deadline; a failed or
            timed-out save is logged and skipped (the periodic checkpoints bound the
            loss, and every write is atomic, so a partial save cannot corrupt
            auto-resume)."""
            if not main_rank:
                return
            done = threading.Event()

            def _try():
                try:
                    save_all(tag_step)
                except Exception as se:  # noqa: BLE001 - best effort by design
                    logger.warning(f"emergency save failed: {type(se).__name__}: {se}")
                finally:
                    done.set()

            threading.Thread(target=_try, daemon=True).start()
            if done.wait(180.0):
                logger.info(f"emergency checkpoint written at step {tag_step}")
            else:
                logger.warning("emergency save timed out; relying on the last periodic "
                               "checkpoint")

        meter = ThroughputMeter(window=max(int(print_freq), 10))
        logger.info(f"training from step {start_step} to {niter}")
        step = start_step
        epoch = 0
        t_last = time.time()
        nll_only = not (pixel_weight_hr or gan_weight or fea_weight) and not is_rescaling

        while step < niter:
            train_loader.set_epoch(epoch)
            for batch in train_loader:
                if step >= niter:
                    break
                step += 1
                if step in clear_at:
                    # the reference's clear_state (lr_scheduler.py:23-24): drop the
                    # optimizer moments at a restart, keep the params; the schedule is
                    # driven by state.step and runs on
                    logger.info(f"clear_state: resetting optimizer state at step {step}")
                    state = dataclasses.replace(state, opt_state=tx.init(state.params))
                hr = torch.from_numpy(batch["GT"]).to(device)
                lr = torch.from_numpy(batch["LQ"]).to(device)
                metrics = {}
                # this rank's rows of what a pass draws for the global batch
                global_lr = (world * lr.shape[0], *lr.shape[1:])

                def gen(sub):
                    return step_generator(device, seed, step, sub)

                def noise(sub):
                    g = torch.rand((world * hr.shape[0], *hr.shape[1:]), generator=gen(sub),
                                   device=device)
                    return mesh.shard_batch(g, rank, world)

                def latents(sub, eps_std, deepest_first=True):
                    eps = sample_latents(model_spec, global_lr, eps_std, gen(sub), device,
                                         deepest_first)
                    return [mesh.shard_batch(e, rank, world) for e in eps]

                failed = False
                try:
                    g_turn = (step % d_update_ratio == 0 and step > d_init_iters) or not gan_weight
                    fake_h = None
                    if is_rescaling:
                        # G gated as in SR (HCFlow_Rescaling_model.py:211); when G is
                        # skipped D trains on a no-grad reverse from the true LR (:275-277)
                        if g_turn:
                            eps = latents(NLL, eps_std_reverse, deepest_first=False)
                            if rescaling_heads:
                                state, fake_h, m = joint_step(
                                    state, hr, lr, d_state.params if d_state else None,
                                    f_params, eps_list=eps)
                            else:
                                state, m = joint_step(state, hr, lr, eps_list=eps)
                            metrics.update(m)
                    else:
                        # the ActNorm re-initialisation window (NLL-only pretraining)
                        if step < act_norm_start and nll_only:
                            # on the gathered global batch, the same on every rank
                            hr_all = mesh.gather_batch(hr)
                            state = replace_params(state, model_spec.calibrate(
                                detached(state.params), hr_all,
                                noise=torch.rand(hr_all.shape, generator=gen(CALIBRATE),
                                                 device=device)))
                        if g_turn:
                            state, m = nll_step(state, hr, lr, noise=noise(NLL))
                            metrics.update(m)
                            if pix_step is not None:
                                state, m = pix_step(state, hr, lr, eps_list=latents(PIXEL, 0.0))
                                metrics.update(m)
                            if fg_step is not None:
                                state, fake_h, m = fg_step(
                                    state, hr, lr, d_state.params if d_state else None,
                                    f_params, eps_list=latents(FEAGAN, eps_std_reverse))
                                metrics.update(m)
                    if gan_weight:
                        if fake_h is None:
                            fake_h = model_spec.reverse(detached(state.params), lr,
                                                        eps_std_reverse,
                                                        eps_list=latents(FEAGAN, eps_std_reverse))
                        d_state, m = d_step(d_state, hr, fake_h)
                        metrics.update(m)
                except Exception as e:  # noqa: BLE001 - device failures only; others re-raise
                    if not is_device_failure(e):
                        raise
                    failed = True
                    logger.error(
                        f"device failure at step {step} on rank {rank} ({type(e).__name__}: "
                        f"{str(e)[:300]}) - restart will auto-resume from the newest checkpoint")
                stop, failed = mesh.any_rank((stop_requested["flag"], failed), device)
                if failed:
                    # save what can be saved within a deadline and exit EX_TEMPFAIL so
                    # that a supervisor restarts; resume_state auto picks up the newest
                    emergency_save(step - 1)
                    tb.close()
                    raise SystemExit(75)
                metrics.pop("grads", None)

                n_global = world * hr.shape[0]
                meter.tick(n_items=n_global, n_pixels=n_global * hr.shape[1] * hr.shape[2])
                if step % print_freq == 0:
                    if reducer is not None:  # the global batch's means
                        metrics = dict(zip(metrics, reducer.average(list(metrics.values()))))
                    dt = (time.time() - t_last) / print_freq
                    t_last = time.time()
                    msg = ", ".join(f"{k_}: {float(v):.4e}" for k_, v in metrics.items())
                    logger.info(
                        f"<epoch:{epoch:3d}, iter:{step:8,d}, lr:{float(schedule(step)):.3e}, "
                        f"{dt:.3f}s/it, {meter.items_per_sec:.1f} img/s, "
                        f"{meter.megapixels_per_sec:.2f} MP/s> {msg}")
                    for k_, v in metrics.items():
                        tb.add_scalar(k_, float(v), step)
                    tb.add_scalar("perf/img_per_sec", meter.items_per_sec, step)

                if stop:
                    save_on_main(step)
                    logger.info(f"stopped by signal at step {step}")
                    tb.close()
                    return state

                if step % save_freq == 0:
                    logger.info(f"saving models and training states at step {step}")
                    save_on_main(step)

                if val_loader is not None and step % val_freq == 0 and main_rank:
                    with torch.no_grad():
                        served = model_spec.flow.precompute_inference(
                            detached(state.params), fused=device.type == "cuda")
                    evaluator = Evaluator(
                        model_spec, served, heats, n_sample=n_sample,
                        scale=opt.get("scale", 4), logger=logger, rescaling=is_rescaling,
                        save_dir=os.path.join(paths.get("val_images", paths["log"]),
                                              f"iter_{step}"),
                        device=device)
                    results = evaluator.run(val_loader, step_generator(device, seed, niter + step,
                                                                       NLL))
                    for k_, v in results.items():
                        if isinstance(v, float):
                            tb.add_scalar(f"val/{k_}", v, step)
                if val_loader is not None and step % val_freq == 0:
                    mesh.barrier()
            epoch += 1

        logger.info("saving the final model")
        if main_rank:
            save_model(os.path.join(paths["models"], "latest_G.ckpt"), state.params, model_spec,
                       step, backend=ckpt_backend)
            wait_for_saves()
        mesh.barrier()
        tb.close()
        logger.info("end of training")
        return state
    finally:
        # main() also runs in-process (tests, notebooks): restore the handlers, or later
        # children would ignore terminate() (SIGTERM would only set a dead flag)
        signal.signal(signal.SIGTERM, prev_handlers[0])
        signal.signal(signal.SIGINT, prev_handlers[1])


if __name__ == "__main__":
    main()
