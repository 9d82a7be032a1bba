"""A dry run of training on a ('data', 'spatial') mesh of processes, the counterpart of
the JAX package's ``__graft_entry__.dryrun_multichip`` and
``tests/test_sharding.py::test_full_plusplus_iteration_sharded``, and spatially sharded
serving (:func:`serve_spatial`).

``dryrun_multigpu(world, mesh_shape=None)`` starts ``world`` processes (``launch``),
which join one process group and lay themselves out on a ('data', 'spatial') mesh as
``dryrun_multichip`` lays its devices out (spatial 2 where the world is even, data the
rest; or ``mesh_shape``: (world, 1) is plain data parallelism).  On a fixed global batch
made from a seed, each rank takes its part (``Mesh.shard``: its batch rows and a band of
their image rows) and the passes of every trainer family, as :class:`TrainPlan` sizes
them (by default ``dryrun_multichip``'s tiny topologies; the params perturbed from a seed
so that every net does work, :func:`perturb`):

1. two SR NLL steps, then one with ``remat_steps`` (and ``remat_trunks``, the default);
2. one full HCFlow++ iteration: NLL, pixel, fea/GAN (random VGG19 features on the band,
   a VGG discriminator on the spatial group's gathered images with BatchNorm over the
   global batch, the relativistic GAN loss), D.  The discriminator runs in float64: in
   float32 its gradient moves by up to 1e-2 x max |g| when a sum is taken in another
   order (a leaky-ReLU input near 0 changes side, and BatchNorm over a few values
   spreads it), as between the two frameworks (``tests/test_torch_port_heads.py``); in
   float64 the ranks' BatchNorm gradient is within 1e-13 of one process's;
3. one rescaling joint step.

Before each pass rank 0 also computes the one-process pass on the global batch with
the same params, latents and noise; the pass's all-reduced gradient must lie within
``tol`` x max |g| of it in every leaf, max |g| the leaf's own (``bf16_tol`` for a model
with bf16 nets; :func:`_leaf_err`), and the D loss
(averaged over the ranks) within 1e-5 of it, relative.  The rescaling step's
straight-through quantizer upscales, on every rank, the 8-bit codes of the one-process
forward's LR (:class:`HeldCodes`), so that a fake LR value within float32 rounding of a
code boundary cannot move the reverse leg's input; the flips that this hides are
counted.  On a spatial axis the ++ iteration's NLL pass and the rescaling pass are also
run with every halo one row short (``Mesh.halo_cut``), controls whose gradients must
break their limits.  Every rank records a digest of its params
after each pass, and its halo exchanges (forward and ``"<unit>.grad"``), bytes, ms and
peak memory per pass; the digests must be equal.  The ActNorm calibration on the mesh
(on the gathered global batch) must equal rank 0's calibration on the global batch bit
for bit.  Returns rank 0's report with every rank's records.

``serve_spatial(world, cases)`` serves requests (:class:`ServeCase`: the x4 or x8 SR
reverse, or the rescaling downscale -> quantize -> upscale) on a ('data', 'spatial')
mesh of ``world`` ranks, each rank its band of the image's rows, and returns each
rank's band, the gathered image, the kernel launches and halo exchanges of a pass, ms
per pass and peak memory; :func:`serve` is one rank's request, or with no mesh the
unsharded one.  A rescaling case may upscale given 8-bit codes (``ServeCase.codes``,
:func:`lr_codes`), the unsharded pass's, so that both sides upscale the same LR;
:func:`code_flips` counts where two LRs quantize apart.

    python -m hcflow_tpu_torch.parallel.dryrun [--world N] [--mesh-shape D,S] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import math
import multiprocessing as mp
import os
import socket
import statistics
import tempfile
import traceback

import torch

from . import halo, mesh

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


def launch(world: int, fn, args=(), cpu: bool = False):
    """``fn(*args)`` in ``world`` new processes (``spawn``) that form one process group,
    as the launcher's would: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` (rank modulo the
    cards; every rank on the CPU with ``cpu``) and a free local port; gloo on the CPU or
    where the cards are fewer than the ranks, else NCCL.  Each process takes this
    process's torch thread count.  Returns every rank's result (``fn`` returns what
    ``torch.save`` takes); raises if a rank fails or takes more than 15 minutes, and
    without a card unless ``cpu``."""
    if not cpu and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: pass cpu=True to run the ranks on the CPU")
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


# ------------------------------------------------------------------ the 8-bit LR codes
def lr_codes(lr: torch.Tensor) -> torch.Tensor:
    """The rescaling LR's 8-bit codes round(clamp(lr, 0, 1) x 255), as uint8: what the
    quantizer keeps of it (``from_codes(lr_codes(lr))`` is ``quantize(lr)`` bit for bit)."""
    return torch.round(lr.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


def from_codes(codes: torch.Tensor) -> torch.Tensor:
    """The quantized LR of 8-bit codes: codes / 255 in float32."""
    return codes.to(torch.float32) / 255.0


def code_flips(lr: torch.Tensor, ref: torch.Tensor) -> dict:
    """Where ``lr`` and ``ref`` (the same shape) quantize to different codes, a *flip*:
    ``flips`` (their count), ``steps`` (the most codes apart), ``lr_diff`` (the largest
    |lr - ref| at a flip; 0 without one) and ``values`` (lr's count).  Two LRs closer than
    1/255 flip by one code at most, and one within float32 rounding of ref flips only
    where ref lies that close to a boundary (k + 1/2) / 255."""
    a, b = lr_codes(lr).int(), lr_codes(ref).int()
    at = a != b
    n = int(at.sum())
    return {"flips": n, "steps": int((a - b).abs().max()) if n else 0,
            "lr_diff": float((lr - ref).abs()[at].max()) if n else 0.0, "values": lr.numel()}


def add_flips(parts) -> dict:
    """:func:`code_flips` of a whole LR from those of its parts (the ranks' bands)."""
    return {"flips": sum(p["flips"] for p in parts), "steps": max(p["steps"] for p in parts),
            "lr_diff": max(p["lr_diff"] for p in parts), "values": sum(p["values"] for p in parts)}


class _Held(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q):
        return q.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


class HeldCodes:
    """A straight-through quantizer for ``make_rescaling_step(quantize=...)`` that holds
    the codes of a reference LR ``ref`` (detached): its forward value is
    ``from_codes(lr_codes(ref))`` whatever its input, its backward the identity, as
    ``quantize_ste``'s.  Each call appends its input's :func:`code_flips` against ref to
    ``flips``.  Where the input's codes are ref's, the step is the default one bit for
    bit."""

    def __init__(self, ref: torch.Tensor):
        self.ref = ref.detach()
        self.q = from_codes(lr_codes(self.ref))
        self.flips = []

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        self.flips.append(code_flips(x.detach(), self.ref))
        return _Held.apply(x, self.q)


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


TINY = dict(rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4, after_splitoff=(1, 1), hidden_channels=8,
            so_hidden_channels=8)  # dryrun_multichip's topologies, with K below


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    """The models and sizes of :func:`dryrun_multigpu`'s passes.  ``nll``: the kwargs of
    ``HCFlowSRSpec.for_scale(4, ...)`` for the NLL steps and the calibration (None: no
    such passes); ``plusplus``: the ++ iteration's; ``rescaling``: those of
    ``HCFlowRescalingSpec.default_x4(...)``; ``hr`` / ``rs_hr``: the HR size of the SR /
    rescaling passes (the discriminator's input size is ``hr``); ``rows``: the batch rows
    a data rank holds; ``reps``: timed passes after each counted one (on the card);
    ``keep``: report the first NLL pass's and the pixel pass's inputs and gradients."""

    nll: dict = dataclasses.field(default_factory=lambda: dict(TINY, K=(3, 3)))
    plusplus: dict = dataclasses.field(default_factory=lambda: dict(TINY, K=(2, 2)))
    rescaling: dict = dataclasses.field(default_factory=lambda: dict(TINY, K=(2, 2)))
    hr: int = 32
    rs_hr: int = 16
    rows: int = 2
    reps: int = 0
    keep: bool = True


def perturb(tree, seed: int, scale: float = 0.1):
    """The params plus noise from a CPU generator seeded ``seed`` (the same on every
    machine): a conv weight scale / sqrt(fan_in) x N(0, 1), any other float leaf 0.02 x
    N(0, 1), as chip_smoke.py's, so that the zero-initialised layers (the couplings'
    last convs, the prior heads) do work and a check sees every net's halo."""
    from ..train.trainer import tree_map

    g = torch.Generator().manual_seed(seed)

    def go(t):
        if not t.is_floating_point():  # a permutation's indices
            return t
        std = scale / math.sqrt(t[0].numel()) if t.ndim == 4 else 0.02
        return t + std * torch.randn(t.shape, generator=g).to(t.device)

    return tree_map(go, tree)


def _measured(first, again, reps: int, dev, barrier: bool):
    """first() with the halo counters at 0, then ``reps`` timed calls of again() (CUDA
    events; after a barrier with ``barrier``); returns (first()'s result, {exchanges,
    bytes, times_ms, ms, peak_bytes (on the card: the most allocated from first() on)})."""
    cuda = dev.type == "cuda"
    if reps and not cuda:
        raise ValueError("timed passes need the card (CUDA events)")
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    out = first()
    rec = {"exchanges": dict(halo.exchanges_by), "bytes": dict(halo.bytes_by), "times_ms": []}
    if reps and barrier:
        mesh.barrier()
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        again()
        end.record()
        torch.cuda.synchronize(dev)
        rec["times_ms"].append(start.elapsed_time(end))
    rec["ms"] = statistics.median(rec["times_ms"]) if rec["times_ms"] else None
    if cuda:
        torch.cuda.synchronize(dev)
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    return out, rec


LEAF_FLOOR = 1e-6  # of the largest leaf's max |g|: the least scale a leaf is held to


def _leaf_err(grads, ref) -> tuple:
    """The worst leaf of a gradient against the reference: (max |g - ref| / its scale, max
    abs error, scale, the whole gradient's max abs error / its max |ref|), a leaf's scale
    its max |ref|, at least LEAF_FLOOR x the whole gradient's.  (Under the NLL's narrow LR
    Gaussian the flow's ActNorms and invconvs take gradients ~10^4 x the nets': against
    the whole gradient's max, a check would not see a net's halo.)"""
    top = max(float(r.abs().max()) for r in ref)
    worst, whole = (0.0, 0.0, top), 0.0
    for g, r in zip(grads, ref):
        sc = max(float(r.abs().max()), LEAF_FLOOR * top)
        e = float((g - r).abs().max())
        whole = max(whole, e / top)
        if e > worst[0] * sc:
            worst = (e / sc, e, sc)
    return (*worst, whole)


def _bf16(model) -> bool:
    f = model.flow
    return "bfloat16" in (f.compute_dtype, f.encoder_dtype)


def train_rank(tol: float, bf16_tol: float, cpu: bool, mesh_shape, plan: TrainPlan) -> dict:
    """What each rank of :func:`dryrun_multigpu` runs; returns its report."""
    from ..models import HCFlowRescalingSpec, HCFlowSRSpec, vgg
    from ..models.discriminators import VGGDiscriminatorSpec
    from ..ops import nets
    from ..train.losses import l1
    from ..train.schedules import schedule_from_opt
    from ..train.trainer import (detached, init_state, make_d_optimizer,
                                 make_d_step, make_optimizer, make_rescaling_step,
                                 make_sr_feagan_step, make_sr_nll_step, make_sr_pixel_step,
                                 sample_latents, tree_map)

    world = torch.distributed.get_world_size()
    m = mesh.make_mesh(mesh_shape=mesh_shape)
    main = m.rank == 0
    dev = mesh.rank_device(cpu)
    reducer = mesh.DataParallel(world)
    B, hw, rhw = plan.rows * m.data, plan.hr, plan.rs_hr  # the global batch
    g = torch.Generator().manual_seed(1)
    hr, hr_r = (torch.rand(B, hw, hw, 3, generator=g).to(dev),
                torch.rand(B, rhw, rhw, 3, generator=g).to(dev))
    lr = hr.reshape(B, hw // 4, 4, hw // 4, 4, 3).mean((2, 4))
    lr_r = hr_r.reshape(B, rhw // 4, 4, rhw // 4, 4, 3).mean((2, 4))
    noise = [torch.rand(hr.shape, generator=g).to(dev) for _ in range(3)]
    mine = m.shard
    report = {"passes": {}, "digests": [], "records": {}, "controls": {}}

    def snapshot(params):  # a copy on the CPU, kept where the report keeps tensors
        return tree_map(lambda t: t.detach().cpu().clone(), params) if main and plan.keep else None

    def keep(name, params, grads, **inputs):
        if main and plan.keep:
            report[name] = {"params": params, "grads": _cpu(grads),
                            **{k: v.cpu() if isinstance(v, torch.Tensor) else _cpu(v)
                               for k, v in inputs.items()}}

    def check(name, step, state, args, ref_step, ref_args, tx, model=None, control=None):
        """Run the pass on the mesh; on rank 0 first its one-process reference on the
        global batch from the same params (and ``control``, the pass with every halo one
        row short), and compare the gradients."""
        lim = bf16_tol if model is not None and _bf16(model) else tol
        ref = cut = None

        def fresh():
            return dataclasses.replace(init_state(detached(state.params), tx), step=state.step)

        if control is not None:
            cut = control(fresh(), *args)[-1]["grads"]
        if main:
            rs, ts = fresh(), fresh() if plan.reps else None
            ref, rrec = _measured(lambda: ref_step(rs, *ref_args), lambda: ref_step(ts, *ref_args),
                                  plan.reps, dev, barrier=False)
        ts = fresh() if plan.reps else None
        out, rec = _measured(lambda: step(state, *args), lambda: step(ts, *args), plan.reps, dev,
                             barrier=True)
        report["digests"].append((name, digest(out[0].params)))
        report["records"][name] = rec
        if main:
            e, ae, sc, whole = _leaf_err(out[-1]["grads"], ref[-1]["grads"])
            report["passes"][name] = {"rel": e, "max_abs_err": ae, "max_abs_grad": sc, "tol": lim,
                                      "whole": whole, "ref": rrec}
            if not e <= lim:
                raise AssertionError(f"{name}: the all-reduced gradient is {ae:.3e} from the "
                                     f"one-process gradient in a leaf of max |g| {sc:.3e} "
                                     f"(tol {lim:g})")
            if cut is not None:
                e, ae, sc, whole = _leaf_err(cut, ref[-1]["grads"])
                report["controls"][name] = {"rel": e, "max_abs_err": ae, "max_abs_grad": sc,
                                            "tol": lim, "whole": whole}
                if e <= lim:
                    raise AssertionError(f"{name} with every halo one row short: the gradient "
                                         f"stays within {lim:g} x max |g| of every leaf ({e:.3e})")
        return out, ref

    topt = {"lr_G": 2.5e-4, "max_grad_clip": 5, "max_grad_norm": 100, "beta1": 0.9,
            "beta2": 0.99, "lr_steps": [100]}
    tx = make_optimizer(topt, schedule_from_opt(topt))

    # 1. SR NLL steps, the HCFlow recipe: two, then one with remat_steps and remat_trunks
    if plan.nll is not None:
        model = HCFlowSRSpec.for_scale(4, **plan.nll)
        params = mesh.replicate(perturb(model.init(0, device=dev), 10))
        calibrated = model.calibrate(params, mine(hr), noise=mine(noise[0]), mesh=m)
        if main:
            report["calibrate_equal"] = digest(calibrated) == digest(
                model.calibrate(params, hr, noise=noise[0]))
        state = init_state(params, tx)
        for i in (1, 2):
            before = snapshot(state.params)
            (state, mt), _ = check(f"nll{i}", make_sr_nll_step(model, tx, reducer=reducer, mesh=m),
                                   state, (mine(hr), mine(lr), None, mine(noise[i])),
                                   make_sr_nll_step(model, tx), (hr, lr, None, noise[i]), tx,
                                   model)
            if i == 1:
                keep("nll", before, mt["grads"], hr=hr, lr=lr, noise=noise[1])
        if state.step != 2:
            raise AssertionError(f"G step {state.step} after two NLL steps")
        rm = dataclasses.replace(model, flow=dataclasses.replace(model.flow, remat_steps=True,
                                                                 remat_trunks=True))
        (state, _), _ = check("nll_remat", make_sr_nll_step(rm, tx, reducer=reducer, mesh=m),
                              state, (mine(hr), mine(lr), None, mine(noise[0])),
                              make_sr_nll_step(rm, tx), (hr, lr, None, noise[0]), tx, rm)

    # 2. one HCFlow++ iteration: NLL, pixel, fea/GAN, D
    model = HCFlowSRSpec.for_scale(4, **plan.plusplus)
    d_specs = (VGGDiscriminatorSpec(input_size=hw, sync_bn=True),
               VGGDiscriminatorSpec(input_size=hw))

    def d64(spec):  # the discriminator in float64 on float32 images
        return lambda p, x: spec.apply(p, x.double()).float()

    d_sync, d_plain = (d64(s) for s in d_specs)
    dtx = make_d_optimizer({}, schedule_from_opt({"lr_G": 5e-5}))
    f_params = vgg.random_features(seed=0, device=dev)
    f_apply = vgg.VGG19FeatureSpec().apply
    state = init_state(mesh.replicate(perturb(model.init(1, device=dev), 11)), tx)
    d_state = init_state(mesh.replicate(tree_map(torch.Tensor.double,
                                                 d_specs[1].init(5, device=dev))), dtx)
    eps_pix = sample_latents(model, lr.shape, 0.0, torch.Generator(dev).manual_seed(2), dev)
    eps_fg = sample_latents(model, lr.shape, 0.9, torch.Generator(dev).manual_seed(3), dev)
    cut = dataclasses.replace(m, halo_cut=1)
    (state, _), _ = check(
        "plusplus_nll", make_sr_nll_step(model, tx, reducer=reducer, mesh=m), state,
        (mine(hr), mine(lr), None, mine(noise[0])), make_sr_nll_step(model, tx),
        (hr, lr, None, noise[0]), tx, model,
        control=make_sr_nll_step(model, tx, reducer=reducer, mesh=cut) if m.spatial > 1 else None)
    before = snapshot(state.params)
    (state, mt), _ = check(
        "pixel", make_sr_pixel_step(model, tx, 1.0, l1, reducer=reducer, mesh=m), state,
        (mine(hr), mine(lr), None, eps_pix), make_sr_pixel_step(model, tx, 1.0, l1),
        (hr, lr, None, eps_pix), tx, model)
    keep("pixel", before, mt["grads"], hr=hr, lr=lr)
    fg = dict(gan_type="ragan", gan_weight=0.5, fea_weight=0.05, fea_criterion=l1,
              f_apply=f_apply)
    (state, fake_h, _), _ = check(
        "feagan", make_sr_feagan_step(model, tx, 0.9, d_apply=d_sync, reducer=reducer, mesh=m,
                                      **fg),
        state, (mine(hr), mine(lr), d_state.params, f_params, None, eps_fg),
        make_sr_feagan_step(model, tx, 0.9, d_apply=d_plain, **fg),
        (hr, lr, d_state.params, f_params, None, eps_fg), tx, model)
    fake_all = m.gather(fake_h)
    (d_state, dm), ref = check("D", make_d_step(d_sync, dtx, reducer=reducer, mesh=m), d_state,
                               (mine(hr), fake_h), make_d_step(d_plain, dtx), (hr, fake_all), dtx)
    d_loss = reducer.average([dm["l_d_real"] + dm["l_d_fake"]])[0].item()
    if main:
        d_ref = (ref[-1]["l_d_real"] + ref[-1]["l_d_fake"]).item()
        report["d_loss"] = {"ranks": d_loss, "one_process": d_ref,
                            "rel": abs(d_loss - d_ref) / abs(d_ref)}
        if not abs(d_loss - d_ref) <= D_LOSS_RTOL * abs(d_ref):
            raise AssertionError(f"D loss {d_loss} against {d_ref} in one process")
    if state.step != 1 or d_state.step != 1:
        raise AssertionError(f"G step {state.step}, D step {d_state.step} after an iteration")

    # 3. the rescaling joint step, its quantizer holding the one-process forward's codes
    # (computed on every rank, as the one-process step computes it)
    rmodel = HCFlowRescalingSpec.default_x4(**plan.rescaling)
    rtopt = dict(topt, lr_G=2e-4)
    rtx = make_optimizer(rtopt, schedule_from_opt(rtopt))
    rstate = init_state(mesh.replicate(perturb(rmodel.init(0, device=dev), 12)), rtx)
    eps_r = sample_latents(rmodel, lr_r.shape, 1.0, torch.Generator(dev).manual_seed(4), dev,
                           deepest_first=False)
    with nets.exact_f32():
        one_lr = mine(rmodel.forward(rstate.params, hr_r, grad=True)[0].detach())
    held, held_cut = HeldCodes(one_lr), HeldCodes(one_lr)

    def rescaling_step(mesh_, quantize):
        return make_rescaling_step(rmodel, rtx, 5e-2, 1e-5, 1.0, reducer=reducer, mesh=mesh_,
                                   quantize=quantize)

    check("rescaling", rescaling_step(m, held), rstate, (mine(hr_r), mine(lr_r), None, eps_r),
          make_rescaling_step(rmodel, rtx, 5e-2, 1e-5, 1.0), (hr_r, lr_r, None, eps_r), rtx,
          rmodel, control=rescaling_step(cut, held_cut) if m.spatial > 1 else None)
    # the counted pass's (check's first call; its timed passes start from moved params)
    report["records"]["rescaling"]["flips"] = held.flips[0]
    report["mesh"] = {"shape": m.shape, "rank": m.rank}
    return report


def dryrun_multigpu(world: int, cpu: bool = False, tol: float = 1e-4, mesh_shape=None,
                    plan: TrainPlan = None, bf16_tol: float = 1e-2, rank_fn=train_rank) -> dict:
    """The dry run over ``world`` processes (one card each while the cards last, else
    several on one card over gloo; with ``cpu`` on the CPU) on a mesh of ``mesh_shape``
    (default: spatial 2 where the world is even) and the passes of ``plan`` (default:
    :class:`TrainPlan`'s); returns rank 0's report: each pass's gradient error against
    the one-process pass and the reference's record (``passes``; the rescaling pass's
    also ``flips``: :func:`code_flips` of the ranks' fake LRs against the one-process
    forward's, over the ranks), the halo controls by pass (``controls``), the D loss's
    error, ``calibrate_equal`` (with an NLL family), the first
    NLL pass's and the pixel pass's params, batch, noise and all-reduced gradient
    (``nll``, ``pixel``; with ``plan.keep``), ``digests_equal`` (the ranks' params after
    every pass) and ``ranks``: every rank's records by pass (exchanges, bytes, ms, peak).
    ``rank_fn(tol, bf16_tol, cpu, mesh shape, plan)``: what a rank runs, a function that
    returns :func:`train_rank`'s report (with what else it adds)."""
    plan = plan or TrainPlan()
    layout = mesh.rank_layout(world, mesh.AXES, mesh_shape)
    shape = (len(layout), len(layout[0]))
    results = launch(world, rank_fn, (tol, bf16_tol, cpu, shape, plan), cpu=cpu)
    report = results[0]
    report["ranks"] = [r["records"] for r in results]
    if "rescaling" in report["passes"]:
        report["passes"]["rescaling"]["flips"] = add_flips(
            [r["rescaling"]["flips"] for r in report["ranks"]])
    report["digests_equal"] = all(r["digests"] == report["digests"] for r in results)
    if not report["digests_equal"]:
        raise AssertionError("the ranks' params differ after a pass")
    if not report.get("calibrate_equal", True):
        raise AssertionError("calibration on the mesh differs from one process's")
    return report


# -------------------------------------------------------------- spatial serving
@dataclasses.dataclass
class ServeCase:
    """One serving request on fixed inputs, for :func:`serve` and :func:`serve_spatial`.

    ``model``: an ``HCFlowSRSpec`` (the reverse maps ``image``, the global LR, to HR) or
    an ``HCFlowRescalingSpec`` (the forward downscales ``image``, the global HR; the LR
    is quantized and the reverse upscales it); ``params`` on the CPU, packed on the
    device by ``precompute_inference(params, fused, resident_trunk=resident)``; the
    latents at temperature ``heat`` drawn from a generator on the device seeded
    ``seed``, or the global whitened latents ``eps_list``; ``codes``: the global 8-bit LR
    codes (:func:`lr_codes`) that a rescaling request upscales instead of its own quantized
    LR (None: its own), on a mesh each rank its part; :func:`serve_spatial` serves it on a
    mesh of ``mesh_shape`` (data, spatial) with ``halo_cut`` rows withheld from every
    exchange (a control); ``reps`` passes are timed after the counted one."""

    model: object
    params: dict
    image: torch.Tensor
    heat: float
    fused: bool = True
    resident: bool = False
    seed: int = 0
    eps_list: list = None
    codes: torch.Tensor = None
    mesh_shape: tuple = (1, 2)
    halo_cut: int = 0
    reps: int = 0


def kernel_launches() -> dict:
    """The kernels' launch counters since the last :func:`reset_counters`, by kernel and
    variant."""
    from ..ops import chain, chain3s, conv, rrdb

    return {"chain": dict(chain.launches_by), "rrdb": dict(rrdb.launches_by),
            "rrdb_trunk": dict(rrdb.trunk_launches_by), "chain3s": dict(chain3s.launches_by),
            "conv3x3": conv.launches}


def reset_counters() -> None:
    """Set every kernel's launch counter and the halo exchange counters to 0."""
    from ..ops import chain, chain3s, conv, rrdb

    for counts in (chain.launches_by, rrdb.launches_by, rrdb.trunk_launches_by,
                   chain3s.launches_by, halo.exchanges_by, halo.bytes_by):
        counts.clear()
    conv.launches = 0


def serve(case: ServeCase, m=None, device="cuda") -> dict:
    """One request of ``case`` on ``device``: without a mesh ``m`` the unsharded pass,
    with one this rank's part of it (its band of ``case.image``).  After a warm-up
    request, one request with the counters at 0, then ``case.reps`` timed ones (CUDA
    events, after a barrier under a process group).  Returns ``out`` (the HR) and ``lr``
    (the rescaling LR, else None) on the device, the kernel ``launches``, halo
    ``exchanges`` and ``bytes`` of the counted request, ``times_ms`` and their median
    ``ms`` (None without reps), and ``peak_bytes`` (on the card: the most memory
    allocated from the counted request on).  A rescaling request with ``case.codes``
    still runs its own forward and returns its LR, and upscales the given codes."""
    from ..models import HCFlowRescalingSpec, quantize
    from ..models.hcflow_sr import to_device

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    model = case.model
    params = model.flow.precompute_inference(to_device(case.params, dev), fused=case.fused,
                                             resident_trunk=case.resident)
    image = case.image.to(dev)
    held = None if case.codes is None else from_codes(case.codes.to(dev))
    if m is not None:
        image = m.shard(image)
        held = None if held is None else m.shard(held).contiguous()
    eps = None if case.eps_list is None else [e.to(dev) for e in case.eps_list]

    def request():
        g = None if eps is not None else torch.Generator(dev).manual_seed(case.seed)
        if isinstance(model, HCFlowRescalingSpec):
            lr = model.forward(params, image, mesh=m)[0]
            q = quantize(lr) if held is None else held
            return lr, model.reverse(params, q, case.heat, g, eps, mesh=m)
        return None, model.reverse(params, image, case.heat, g, eps, mesh=m)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    request()  # warm-up: cuDNN's plans, the kernels' libraries
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    reset_counters()
    lr, out = request()
    sync()
    rec = {"out": out, "lr": lr, "launches": kernel_launches(),
           "exchanges": dict(halo.exchanges_by), "bytes": dict(halo.bytes_by), "times_ms": []}
    if case.reps and not cuda:
        raise ValueError("timed passes need the card (CUDA events)")
    if case.reps:
        mesh.barrier()
    for _ in range(case.reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        request()
        end.record()
        torch.cuda.synchronize(dev)
        rec["times_ms"].append(start.elapsed_time(end))
    rec["ms"] = statistics.median(rec["times_ms"]) if rec["times_ms"] else None
    rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) if cuda else None
    return rec


def serve_ranks(path: str, cpu: bool) -> list:
    """What each rank of :func:`serve_spatial` runs: the cases saved at ``path``, each on
    a mesh of its ``mesh_shape`` (one mesh a shape, made by every rank in the same
    order).  Returns per case this rank's record of :func:`serve` with the tensors on
    the CPU and its ``out`` / ``lr`` band, and on rank 0 ``image`` / ``lr_image``, the
    gathered ones."""
    cases = torch.load(path, weights_only=False)
    dev = mesh.rank_device(cpu)
    meshes, results = {}, []
    for case in cases:
        shape = tuple(case.mesh_shape)
        if shape not in meshes:
            meshes[shape] = mesh.make_mesh(mesh_shape=shape)
        m = dataclasses.replace(meshes[shape], halo_cut=case.halo_cut)
        rec = serve(case, m, dev)
        rec["image"] = m.gather(rec["out"])
        rec["lr_image"] = None if rec["lr"] is None else m.gather(rec["lr"])
        if m.rank != 0:
            rec["image"] = rec["lr_image"] = None
        results.append({k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in rec.items()})
    return results


def serve_spatial(world: int, cases: list, cpu: bool = False, rank_fn=serve_ranks,
                  args=()) -> list:
    """Serve each of ``cases`` (:class:`ServeCase`) on a mesh of ``world`` ranks started
    by :func:`launch` (gloo where the ranks share a card or run on the CPU); returns each
    rank's ``rank_fn(path of the saved cases, cpu, *args)``, by default
    :func:`serve_ranks`'s records, ``results[rank][case]``."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cases.pt")
        torch.save(cases, path)
        return launch(world, rank_fn, (path, cpu, *args), cpu=cpu)


STEP_HALO = {"FCN": 2, "DenseBlock": 5}  # an FCN's 3x3, 1x1, 3x3; a DenseBlock's five 3x3
RRDB_HALO = 15  # three dense blocks of five 3x3 convs


def expected_exchanges(flow, lr_band: tuple, spatial: int, resident: bool = False,
                       forward: bool = False) -> tuple:
    """The halo exchanges a rank makes in one reverse pass of ``flow`` (a FlowNetSpec;
    with ``forward`` also the rescaling forward, which runs the same units), counted
    from the model's structure, independently of the counters: per level conv_first,
    trunk_conv1 and the prior head (unit "conv", one row each), each RRDB ("rrdb", 15
    rows) or with ``resident`` each trunk ("trunk", 15 nb), the split-off chain's cond
    features ("cond": 2K + 1 rows for hoisted FCN steps, else its nets' sum) and z
    ("chain"), the main chain's z ("chain").  An exchange sends the band's top and
    bottom min(rows, h) rows of float32.  ``lr_band``: (B, h, W) of the rank's LR band.
    Returns ({unit: count}, {unit: bytes})."""
    counts, nbytes = {}, {}
    B, h, W = lr_band

    def add(unit, rows, f, c):
        if rows and spatial > 1:
            n = 2 if forward else 1
            counts[unit] = counts.get(unit, 0) + n
            nbytes[unit] = nbytes.get(unit, 0) + n * 2 * min(rows, h * f) * B * W * f * c * 4

    for lv in flow.levels:
        f, cs = 2 ** (flow.L - 1 - lv.level), lv.cond_spec
        add("conv", 1, f, cs.conv_first_in)
        for nb in cs.rrdb_nb:
            if resident:
                add("trunk", RRDB_HALO * nb, f, cs.rrdb_nf)
            for _ in range(0 if resident else nb):
                add("rrdb", RRDB_HALO, f, cs.rrdb_nf)
        add("conv", 1, f, cs.rrdb_nf)
        add("conv", 1, f, cs.cond_channels)
        rows = cs.n_flow_step * STEP_HALO[cs.nn_module]
        add("cond", rows + (1 if cs.hoists else 0) if rows else 0, f, cs.cond_channels)
        add("chain", rows, f, cs.a_channels)
        add("chain", lv.n_main * STEP_HALO[flow.nn_module], f, lv.channels)
    return counts, nbytes


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--mesh-shape", type=lambda t: tuple(int(v) for v in t.split(",")),
                    help="the ('data', 'spatial') mesh, e.g. 2,2 (default: spatial 2 where the "
                    "world is even, data the rest)")
    ap.add_argument("--cpu", action="store_true")
    a = ap.parse_args()
    rep = dryrun_multigpu(a.world, cpu=a.cpu, mesh_shape=a.mesh_shape)
    print(f"mesh (data, spatial) {rep['mesh']['shape']}")
    for name, r in rep["passes"].items():
        print(f"{name}: all-reduced gradient within {r['rel']:.3e} x each leaf's max |g| of one "
              f"process (tol {r['tol']:g})")
    for name, c in rep["controls"].items():
        print(f"{name} with every halo one row short: {c['rel']:.3e} x a leaf's max |g| (breaks "
              "the limit)")
    f = rep["passes"]["rescaling"]["flips"]
    print(f"rescaling: {f['flips']} of {f['values']} fake LR values flip a code against the "
          "one-process forward's (the quantizer holds its codes)")
    print(f"D loss within {rep['d_loss']['rel']:.3e} relative; params equal on every rank; "
          "calibration on the mesh bit for bit")
