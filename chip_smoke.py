"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.  Phases:

1. print the card's name and power limit and whether PyYAML, OpenCV and Pillow import;
   build the five CUDA kernels from hcflow_tpu_torch/csrc with nvcc (sm_90a, in
   parallel) and print their ptxas register, spill and wgmma lines and the build time;
2. hold each kernel against its plain PyTorch version on the card, at every shape of
   the main paths, with bf16 weights perturbed from a seed, and time both: the x4 SR
   path's RRDB (gc 32) at 40x40 and 80x80 and its four 13-step chains; the rescaling
   path's chain3s main chains (K 8, c 24 at 40x40 and c 12 at 80x80), RRDB at gc 16
   at both sizes and 6-step split-off chains; the x8 SR path's resident trunk (nb 5,
   gc 32) at 20x20, 40x40 and 80x80, also against the per-RRDB kernel (bit-identical
   expected) and timed beside it, and its six 13-step chains; the standalone conv3x3
   (on no path, as in the JAX package) at the model's library 3x3 shapes, timed
   beside cuDNN's bf16 conv (its library time, never called by the port); the RRDB,
   trunk and chain rows are timed beside the same function as a sequence of library
   calls in the bf16 recipe (nets.apply_rrdb / apply_rrdb_trunk: cuDNN bf16 convs and
   concats; the chain's and chain3s's step loops, FlowStepSpec.inverse_hoisted /
   inverse), since no
   single call computes one, timed on the device as one CUDA graph (the host takes
   longer to issue the sequence than the card to run it); each chain row prints the
   kernel's tile plan;
3. the flagship x4 SR model at full width (for_scale(4): nb 7, K 26, nf 64, gc 32,
   hidden 64) in the bf16 serving recipe at batch 16, 40x40 -> 160x160, heat 0.9, as
   a few requests with different generator seeds; check the output, the kernel path
   against the plain path under the same explicit latents, that heat 0 is
   deterministic and the exact launch count of each kernel; time the pass;
4. the x4 rescaling model at full width (default_x4: K 14 with 6 split-off steps,
   Haar squeeze, Affine3shift/DenseBlock main chains of growth 32, RRDB nb (2, 1),
   nf 64, gc 16) in the bf16 serving recipe: an HR batch (16, 160, 160, 3) is
   downscaled by the forward, quantized to 8 bits and upscaled by the reverse at heat
   1.0, as a few requests with different generator seeds; check the outputs, the
   exact launch counts, the kernel path against the plain path, heat 0, and the round
   trip HR -> (LR, latents) -> HR; time the downscale and the upscale;
5. the x8 SR model (the CelebA-8X topology, for_scale(8): L 3, K 26 with 13 split-off
   steps a level, nb 5, nf 64, gc 32, hidden 64) at full width in the bf16 serving
   recipe with resident trunks, batch 16, 20x20 -> 160x160, heat 0.8, as phase 3
   checks x4, and also against the per-RRDB kernel path; time the pass on all three
   paths;
6. x4 SR training at full width in the HCFlow+ recipe (for_scale(4,
   encoder_dtype="bfloat16"): bf16 encoders, float32 couplings, quant 64) with the
   hyperparameters of configs/train_SR_DF2K_4X_HCFlow+.yml (batch 16, GT 160, lr 5e-5,
   beta 0.9 / 0.99, clip at value 5 and global norm 100, NLL weight 0.002, L1 pixel
   weight 1) on synthetic images (smooth random HR, LR by 4x4 average pooling on the
   card): calibrate on the first batch, then 3 iterations of the NLL step and the
   pixel step; check the NLL and gradients finite, the params moved and TF32 off in
   every backward conv of the first iteration; time each step kind (CUDA events, after
   the first iteration) and record the peak memory.  Then serve the trained params
   fused: the float32 chain kernel (hid 64) and the RRDB kernel, with exact launch
   counts, the kernel path against the plain path under the same latents, encode ->
   reverse on the kernel path giving HR back, and the NLL on the fused params (RRDB
   kernel in the forward) against the plain params;
7. the tiny trained checkpoint weights/ref_trained/tiny_x4_400_G.pth (hidden 32, RRDB
   nf 32 / gc 16), loaded with params_from_state_dict at the explicit spec of
   tiny_x4_parity.yml and served fused in the bf16 and the float32 recipe (the chain
   kernel at hid 32 in bf16 and in float32, the RRDB kernel at nf 32 / gc 16 in bf16 and
   in float32), each held against the plain path, with exact launch counts;
8. the float32 serving recipe (no compute_dtype, as the shipped test configs set none)
   at full width and depth: the x4 SR model of phase 3, the x4 rescaling model of phase
   4 and the x8 SR model of phase 5 (resident trunks), each as its bf16 phase checks
   it, the kernel path within 1e-4 x max |plain| of the plain path: the float32 RRDB,
   resident-trunk and chain3s kernels (3xTF32 products) and the float32 chain kernel;
9. the serving entry points at full width in the float32 recipe (the shipped test
   configs set no compute_dtype), on synthetic PNG datasets written to a temp directory:
   cli.test.main on configs/test_SR_DF2K_4X_HCFlow.yml (4 GT/LQ pairs of HR 1024x768
   and an LQ-only LR of 127x93), configs/test_SR_CelebA_8X_HCFlow.yml (8 pairs of HR
   160x160 and an LQ-only LR of 24x20) and configs/test_Rescaling_DF2K_4X_HCFlow.yml
   (the x4 pairs), random init (no released weights are in the repo), and on the tiny
   trained checkpoint (weights/ref_trained/tiny_x4_parity.yml + tiny_x4_400_G.pth): each
   option file a copy with only the dataroots (and the LQ-only set), path.root and
   pretrain_model_G changed; every average finite, the saved file names, the exact
   launches of the float32 RRDB, chain and chain3s kernels; the seconds per image per
   heat and the device's busy share (torch.profiler).  Then the x4 Evaluator at heat 0
   on perturbed weights on the kernel path against the plain path (SR images within
   1e-4 x max |plain|, PSNR within 0.05 dB), and Predictor("general") on an LR of
   510x339, tiled at max_tile 128 (shape, range, launches, ms per image);
10. the training entry point at full width (cli.train.main, on the card), on
   synthetic data made by the port's prepare_data in a temp directory (LRHR_PKL crops
   of GT 160 at x4 and x8, GT/LQ .npy pairs, 2 validation pairs of HR 256x256), on
   copies of the shipped training configs with only the dataroots, path.root,
   pretrain_model_G, logger.save_checkpoint_freq (2), train.val_freq (4) and
   logger.print_freq (1) changed, each change printed: HCFlow (NLL, the ActNorm
   calibration window), HCFlow+ from its latest_G.ckpt and again with --max_steps 6
   (auto-resume from 4.state), HCFlow++ from that (train.feature_fallback random,
   D_init_iters 1), rescaling and x8, 4 iterations each; every loss finite, the params
   moved, the G step, the checkpoints and their retention, the written latest_G.ckpt
   equal to the trained params through load_any, each validation through the bf16 RRDB
   and the float32 chain (and chain3s) kernels with exact launches and finite averages,
   the kernel path's validation against the plain path's (HCFlow+ params; 2e-3 x max
   |plain|, 5e-4 x mean |plain|, PSNR within 2e-4 dB), and a control that must break
   each of those limits (one level's two trunk packs exchanged); ms per pass
   kind (CUDA events, after the first), s per validation, peak memory per run;
11. print the kernels' JSON line, the card line, then the JSON status line last.

Phase 2 also holds the float32 kernels at phase 9's shapes (batch 1 at each image's
levels, the ragged LQ-only images, the Predictor's batch of 8 tiles; calls_per_pass 0,
so the kernels line's units do not change), and the variants against their plain
version: the chain kernel's float32 one at hid 64 at the shapes of phase 6's serving,
bf16 and float32 at hid 32 at phase 7's; the float32 RRDB kernel at phases 3, 4 and
7's shapes, the float32 resident trunk at phase 5's and chain3s in float32 at phase
4's (1e-5 x max |plain|), each timed beside its float32 library sequence (cuDNN with
TF32 off) as one CUDA graph. A float32 row's bound_ms is at the 3xTF32 tensor-core
rate, the rate its kernel's products run at; bound_cuda_core_ms gives the same work at
the CUDA-core float32 rate.

Any failed check raises, and the script exits non-zero without the status line.
Weights are random, perturbed so that the zero-initialised layers (coupling conv3s
and conv5s, the prior heads) do work, except phase 6's, which start from the model's
init as training does, and phase 7's, which are trained.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import statistics
import subprocess
import sys
import time

BATCH, LR_HW, SCALE, HEAT = 16, 40, 4, 0.9
RS_HEAT = 1.0  # the rescaling test config's heat (configs/test_Rescaling_DF2K_4X_HCFlow.yml)
# x8: 20x20 LR -> 160x160 HR, the CelebA-8X test config's heat 0.8
# (configs/test_SR_CelebA_8X_HCFlow.yml)
X8_LR_HW, X8_SCALE, X8_HEAT = 20, 8, 0.8
X8_NB = 5
DEV = "cuda"
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # float32 outside the tensor cores
PEAK_3XTF32 = 495e12 / 3  # float32 products as three TF32 tensor-core products (3xTF32)
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
# Kernel vs its plain version on the card: both take the same bf16 operands and sum in
# float32, in another order; a feature rounded to bf16 can then land one bf16 step
# (2^-8 relative) apart and carry, damped, through the following convs or steps.
KERNEL_RTOL = 1e-3  # max |kernel - plain| / max |plain|
# Kernel path vs plain path of the whole model, before the clamp to [0, 1]: the plain
# path also rounds each net conv's OUTPUT through bf16 (as the JAX recipe does) and
# the kernels do not, about 2^-9 relative per conv, carried through 52 steps.
MODEL_MAX_RTOL, MODEL_MEAN_RTOL = 5e-2, 1e-2  # of max |plain| and of mean |plain|
# Rescaling round trip HR -> (LR, latents) -> HR, HR in [0, 1], before the clamp and the
# quantization.  Plain path: forward and reverse run the same nets on inputs equal to
# float32 rounding, so only an input landing across a bf16 rounding boundary moves a
# net's output, by one bf16 step (2^-8 relative of a shift below ~0.5), at a few
# pixels: 2e-3 max abs.  Kernel path: the reverse's kernels also do not round the net
# outputs through bf16 as the forward's plain nets do, 2^-9 relative of every shift
# and scale, mostly cancelling over the steps: 5e-3 max abs, 5e-4 mean abs.  (Measured
# on an H100: 3.6e-4 plain; 6.0e-4 max and 8.5e-5 mean on the kernel path.)
RT_PLAIN_MAX = 2e-3
RT_KERNEL_MAX, RT_KERNEL_MEAN = 5e-3, 5e-4
# The float32 chain kernel against its plain version (both float32 with no TF32, summed
# in another order): 1e-5 x max |plain|; a whole float32-recipe path, kernel against
# plain, over its 16 or 52 steps: 1e-4 x max |plain|.
F32_RTOL, F32_PATH_RTOL = 1e-5, 1e-4
# The trained HCFlow+ model (phase 6): encode -> reverse on the kernel path, HR in
# [0, 1], before the clamp.  Both directions see the same RRDB-kernel cond features, so
# the float32 couplings set the error, as on phase 4's plain round trip: 2e-3 max abs,
# 2e-4 mean abs.  The NLL on the fused params (RRDB kernel in the forward's encoders)
# against the plain params: 1e-3 relative.
RT_TRAIN_MAX, RT_TRAIN_MEAN, NLL_RTOL = 2e-3, 2e-4, 1e-3
# configs/train_SR_DF2K_4X_HCFlow+.yml's train section (what the steps read of it)
TRAIN_OPT = {"lr_G": 5e-5, "lr_scheme": "MultiStepLR", "lr_steps": [20000, 40000],
             "lr_gamma": 0.5, "weight_decay_G": 0, "max_grad_clip": 5, "max_grad_norm": 100,
             "beta1": 0.9, "beta2": 0.99, "nll_weight": 0.002, "pixel_weight_hr": 1.0,
             "pixel_criterion_hr": "l1"}
TRAIN_ITERS = 3
# weights/ref_trained/tiny_x4_parity.yml: x4 SR, K 8 with 4 split-off steps a level,
# coupling width 32, RRDB nb 2, nf 32, gc 16
TINY_CKPT = dict(K=(8, 8), after_splitoff=(4, 4), rrdb_nb=(2, 2), rrdb_nf=32, rrdb_gc=16,
                 hidden_channels=32, so_hidden_channels=32)
# phase 9: synthetic datasets for the serving entry points, image sizes as (H, W).  4
# GT/LQ pairs of HR 768x1024 for the x4 SR and x4 rescaling test configs, 8 of HR
# 160x160 for the x8 one (the CelebA-8X test images' size), one LQ-only image on each SR
# config at a ragged size; the Predictor on a DIV2K-sized LR (about 510x339), which it
# tiles at max_tile 128.
SERVE_X4_HR, SERVE_X4_PAIRS = (768, 1024), 4
SERVE_X8_HR, SERVE_X8_PAIRS = (160, 160), 8
SERVE_REAL_X4, SERVE_REAL_X8 = (93, 127), (20, 24)
PREDICT_LR, PREDICT_TILE = (339, 510), 128
# the kernel path's Evaluator against the plain path's at heat 0: PSNR within 0.05 dB
SERVE_PSNR_TOL = 0.05
# phase 10: the training entry point on copies of the shipped training configs, 4
# iterations a run (HCFlow+ resumed to 6), a checkpoint every 2, validation at the last;
# LRHR_PKL crops of GT 160 from 4 synthetic 320x320 images (8 crops each, x4 and x8 LRs),
# GT/LQ .npy pairs of the same size for rescaling, 2 validation pairs of HR 256x256
TRAIN_STEPS, TRAIN_RESUME_STEPS, TRAIN_SAVE_FREQ = 4, 6, 2
TRAIN_SRC_IMAGES, TRAIN_SRC_HW, TRAIN_CROPS, TRAIN_GT = 4, (320, 320), 8, 160
TRAIN_VAL_PAIRS, TRAIN_VAL_HR = 2, (256, 256)
# The HCFlow+ validation (bf16 encoders, float32 couplings), SR images in [0, 1]: the
# kernel path against the plain path.  The bf16 RRDB kernel sums in float32 in another
# order than the plain trunks; an encoder feature lands one bf16 step apart at a few
# pixels and the float32 couplings carry it, damped.  Measured on an H100 80GB HBM3 at
# 700 W in five runs: max abs 4.1e-4 - 6.5e-4 (max |plain| 1.0), mean abs 5.6e-5 (mean
# |plain| 0.475), PSNR 2.0e-5 - 6.2e-5 dB apart.  A control, the kernel path with
# trunk0's and trunk1's packs exchanged in one level, read 6.9e-3 - 7.0e-3, 9.7e-4 -
# 9.8e-4 and 7.2e-4 - 7.9e-4 dB: on 8 iterations from a random init the encoder moves
# the SR image little.  Each limit sits 3-4x above the sound readings and 3.5-4x below
# the control's, and the control must break every one of them.
TRAIN_VAL_MAX_RTOL, TRAIN_VAL_MEAN_RTOL, TRAIN_VAL_PSNR_TOL = 2e-3, 5e-4, 2e-4
# the step factories of cli/train.py and the pass each one's steps make
TRAIN_PASSES = {"make_sr_nll_step": "nll", "make_sr_pixel_step": "pixel",
                "make_sr_feagan_step": "feagan", "make_d_step": "D",
                "make_rescaling_step": "rescaling"}


def log(msg):
    print(msg, flush=True)


def _io_modules():
    """Whether the readers the serving entry points use import: PyYAML (option files),
    OpenCV (PNG) and Pillow."""
    import importlib

    found = []
    for name in ("yaml", "cv2", "PIL"):
        try:
            found.append(f"{name} {importlib.import_module(name).__version__}")
        except ImportError:
            found.append(f"{name} not installed")
    return ", ".join(found)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def perturb(tree, generator, scale=0.1):
    """Noise on every weight: a conv weight gets scale/sqrt(fan_in) * N(0,1), any other
    tensor 0.02 * N(0,1).  The relative size keeps the 4 x 7 RRDBs from blowing up."""
    import torch

    if isinstance(tree, dict):
        return {k: perturb(v, generator, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturb(v, generator, scale) for v in tree]
    std = scale / math.sqrt(tree[0].numel()) if tree.ndim == 4 else 0.02
    noise = torch.randn(tree.shape, generator=generator, device=generator.device)
    return tree + std * noise.to(tree.device)


def cuda_time(fn, reps, warmup=2):
    """Mean ms per call over reps calls, with CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_time(fn, reps):
    """Mean ms per replay of fn's calls captured as one CUDA graph: the device's time
    for a sequence of library calls, without the host's time to issue them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture: cuDNN plans, allocations
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_time(graph.replay, reps)


def check_rel(name, got, ref, rtol):
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite kernel output")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    ok = err <= rtol * scale
    log(f"  {name}: max_abs_err {err:.3e} (max |plain| {scale:.3e}, tolerance "
        f"{rtol:g} x max |plain|) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err


# ------------------------------------------------------------------ shapes and bounds
def rrdb_work(B, H, W, nf, gc, es=2):
    """(FLOP, bytes) that one RRDB must do and move: the input read once, the output
    written once, the weights (es bytes each: bf16 2, float32 4) and f32 biases read
    once."""
    px = B * H * W
    macs = sum(9 * (nf + i * gc) * (gc if i < 4 else nf) for i in range(5))  # per block
    weights, biases = 3 * macs, 3 * (4 * gc + nf)  # one weight per MAC of a pixel
    return 2 * 3 * macs * px, 2 * px * nf * 4 + es * weights + 4 * biases


def trunk_work(B, H, W, nf, gc, nb, es=2):
    """(FLOP, bytes) of a trunk of nb RRDBs: the input read once, the output written
    once, every RRDB's weights and biases read once."""
    flops, nbytes = rrdb_work(B, H, W, nf, gc, es)
    io = 2 * B * H * W * nf * 4
    return nb * flops, io + nb * (nbytes - io)


def conv_work(B, H, W, C, N):
    """(bf16 FLOP, bytes) of a 3x3 conv: float32 x read and float32 out written once,
    the float32 HWIO weights and bias read once."""
    px = B * H * W
    return 2 * px * 9 * C * N, px * (C + N) * 4 + (9 * C * N + N) * 4


def chain_work(B, H, W, c, hid, K, cond, f32=False):
    """(bf16 FLOP, f32 FLOP, bytes) of one K-step inverse chain: z in and out once,
    the cond terms once, the packed weights once.  The bf16 recipe's convs are bf16
    products; the float32 recipe's (``f32``) are float32 ones, on weights and cond
    terms of 4 bytes."""
    px = B * H * W
    c1, c2 = c // 2, c - c // 2
    convs = 2 * px * K * (9 * c1 * hid + hid * hid + 9 * hid * 2 * c2)
    tail = 2 * px * K * c * c
    es = 4 if f32 else 2  # bytes of a net weight and of a cond term
    weights = K * (es * (9 * c1 * hid + hid * hid + 9 * hid * 2 * c2)
                   + 4 * (4 * hid + 4 * c2 + c * c + c))
    nbytes = 2 * px * c * 4 + (px * K * hid * es if cond else 0) + weights
    return (0, convs + tail, nbytes) if f32 else (convs, tail, nbytes)


def chain3s_work(B, H, W, c, gc, K, f32=False):
    """(bf16 FLOP, f32 FLOP, bytes) of one K-step rescaling main chain at its real
    (unpadded) widths: z in and out once, the weights once (the float32 recipe's,
    ``f32``: float32 products on weights of 4 bytes)."""
    px = B * H * W
    macs = 0
    for k in range(K):
        cin, fout = (3, 2 * (c - 3)) if k % 2 == 0 else (c - 3, 3)
        macs += sum(9 * (cin + i * gc) * (gc if i < 4 else fout) for i in range(5))
    tail = 4 * px * K * c  # the coupling update and the ActNorm inverse, ~4 FLOP a value
    es = 4 if f32 else 2
    weights = es * macs + 4 * K * (4 * gc + 2 * c)  # one weight per MAC; biases, ActNorm
    nbytes = 2 * px * c * 4 + weights
    return (0, 2 * px * macs + tail, nbytes) if f32 else (2 * px * macs, tail, nbytes)


def bound(ops_s, nbytes):
    mem_s = nbytes / PEAK_BYTES
    return (max(ops_s, mem_s) * 1e3, "operations" if ops_s >= mem_s else "bytes")


# --------------------------------------------------------------------------- phases
def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _row(rows, name, label, fn, plain_fn, work, reps, path, calls, library_fn=None,
         library_seq=False, rtol=KERNEL_RTOL, **extra):
    """Check one kernel call against its plain version and time both (and the one
    library call computing the same function, where there is one).  library_seq: the
    library_fn is a sequence of library calls, timed on the device as one CUDA graph
    (library_ms) and also as the host issues it (library_eager_ms).  work = (bf16
    FLOP, float32 FLOP, bytes) of the function.  Returns the kernel's output."""
    import torch

    def first(r):
        return r[0] if isinstance(r, tuple) else r  # chain3s also returns its logdet

    got, ref = first(fn()), first(plain_fn())
    torch.cuda.synchronize()
    err = check_rel(label, got, ref, rtol)
    ms = cuda_time(fn, reps=reps)
    plain_ms = cuda_time(plain_fn, reps=max(2, reps // 4))
    library_ms = None if library_fn is None else cuda_time(library_fn, reps=reps)
    lib = "" if library_ms is None else f", library {library_ms:.4f} ms"
    if library_seq:
        extra["library_eager_ms"] = library_ms
        library_ms = graph_time(library_fn, reps=reps)
        lib = f", library {library_ms:.4f} ms as a graph ({extra['library_eager_ms']:.4f} eager)"
    bf, f32, nbytes = work
    tflops = (bf + f32) / ms / 1e9
    if bf:  # a bf16 row: bf16 tensor-core products, a float32 tail on the CUDA cores
        b_ms, b_by = bound(bf / PEAK_BF16 + f32 / PEAK_F32, nbytes)
        rate = f"{tflops:.1f} TFLOP/s"
    else:  # a float32 row: float32-accurate products as 3xTF32 on the tensor cores
        b_ms, b_by = bound(f32 / PEAK_3XTF32, nbytes)
        extra["bound_cuda_core_ms"] = bound(f32 / PEAK_F32, nbytes)[0]
        rate = (f"{tflops:.1f} TFLOP/s of float32 work; bound at the CUDA-core float32 rate "
                f"{extra['bound_cuda_core_ms']:.4f} ms")
    log(f"    {ms:.4f} ms/call (plain {plain_ms:.4f} ms{lib}, bound {b_ms:.4f} ms by {b_by}, "
        f"{rate}), {calls} calls per {path} unit")
    rows[name].append(dict(path=path, label=label, calls_per_pass=calls, err=err, ms=ms,
                           plain_ms=plain_ms, library_ms=library_ms, bound_ms=b_ms,
                           bound_by=b_by, tflops=tflops, **extra))
    return got


def _bhw(hw):
    """(B, H, W) of a row: a side (square, at batch BATCH) or (B, H, W) itself."""
    return (BATCH, hw, hw) if isinstance(hw, int) else hw


def _library_trunk(torch, trunk, cd="bfloat16"):
    """A trunk's params on the card, for the library yardstick: nets.apply_rrdb(_trunk)
    in the recipe cd (bf16: cuDNN bf16 convs, the conv weights cast to bf16; None:
    cuDNN float32 convs with TF32 off, nets.exact_f32), float32 bias, leaky ReLU,
    concats and residuals, a sequence of library calls, since no single call computes
    an RRDB; the port never runs it on the kernel path."""
    def cast(t):
        return t.to(DEV, torch.bfloat16) if t.ndim == 4 and cd else t.to(DEV)

    return [{r: {c: {k: cast(v) for k, v in conv.items()} for c, conv in rdb.items()}
             for r, rdb in p.items()} for p in trunk]


def _rrdb_rows(torch, gen, rows, gc, shapes, path, nf=64, cd="bfloat16", key="rrdb"):
    """The per-RRDB kernel in the recipe cd (bf16, or float32 for None) against its
    plain version, beside nets.apply_rrdb in the same recipe as one CUDA graph."""
    from hcflow_tpu_torch.ops import nets, rrdb

    trunk = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(11), 1, nf, gc), gen)
    packed = _to(rrdb.pack_rrdb(trunk[0], cd), DEV)
    lib = _library_trunk(torch, trunk, cd)[0]
    for hw, calls in shapes:
        B, H, W = _bhw(hw)
        x = torch.randn(B, H, W, nf, device=DEV, generator=gen)
        flops, nbytes = rrdb_work(B, H, W, nf, gc, 2 if cd else 4)
        _row(rows, key, f"{key} nf {nf} gc {gc} {B}x{H}x{W}x{nf}",
             lambda: rrdb.rrdb_apply(packed, x), lambda: rrdb.rrdb_apply_plain(packed, x),
             (flops, 0, nbytes) if cd else (0, flops, nbytes), 10, path, calls,
             library_fn=lambda: nets.apply_rrdb(lib, x, cd), library_seq=True,
             rtol=KERNEL_RTOL if cd else F32_RTOL, shape=[B, H, W, nf], gc=gc)


def _trunk_rows(torch, gen, rows, shapes, path, cd="bfloat16", key="rrdb_trunk"):
    """The resident trunk (nb 5, gc 32) in the recipe cd against its plain version and
    against the per-RRDB kernel run nb times (bit-identical expected), timed beside it."""
    from hcflow_tpu_torch.ops import nets, rrdb

    nf, gc = 64, 32
    trunk = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(14), X8_NB, nf, gc), gen)
    lib = _library_trunk(torch, trunk, cd)
    trunk = _to(trunk, DEV)
    res = rrdb.pack_rrdb_trunk(trunk, cd, resident=True)
    per = rrdb.pack_rrdb_trunk(trunk, cd)
    for hw, calls in shapes:
        x = torch.randn(BATCH, hw, hw, nf, device=DEV, generator=gen)
        label = f"{key} nb {X8_NB} gc {gc} {BATCH}x{hw}x{hw}x{nf}"
        flops, nbytes = trunk_work(BATCH, hw, hw, nf, gc, X8_NB, 2 if cd else 4)
        got = _row(rows, key, label, lambda: rrdb.trunk_apply(res, x),
                   lambda: rrdb.trunk_apply_resident_plain(res, x),
                   (flops, 0, nbytes) if cd else (0, flops, nbytes), 10, path, calls,
                   library_fn=lambda: nets.apply_rrdb_trunk(lib, x, cd), library_seq=True,
                   rtol=KERNEL_RTOL if cd else F32_RTOL, shape=[BATCH, hw, hw, nf], gc=gc,
                   nb=X8_NB)
        ref = rrdb.trunk_apply(per, x)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        err = 0.0 if same else check_rel(f"{label} vs per-RRDB kernel", got, ref,
                                         KERNEL_RTOL if cd else F32_RTOL)
        per_ms = cuda_time(lambda: rrdb.trunk_apply(per, x), reps=10)
        log(f"    vs the per-RRDB kernel ({X8_NB} x {rrdb.LAUNCHES_PER_RRDB} launches, "
            f"{per_ms:.4f} ms/trunk): {'bit-identical' if same else f'max abs {err:.3e}'}")
        rows[key][-1].update(per_rrdb_ms=per_ms, identical_to_per_rrdb=same,
                             per_rrdb_max_abs=err)


def _conv_rows(torch, gen, rows, shapes, path):
    """conv3x3 against its plain version, and cuDNN's bf16 conv on the same operands
    (its library time)."""
    from hcflow_tpu_torch.ops import conv

    F = torch.nn.functional
    for hw, C, N, relu in shapes:
        x = torch.randn(BATCH, hw, hw, C, device=DEV, generator=gen)
        w = torch.randn(3, 3, C, N, device=DEV, generator=gen) / math.sqrt(9 * C)
        b = 0.1 * torch.randn(N, device=DEV, generator=gen)
        # the library call: NCHW views of channels-last bf16 operands, OIHW weight
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bb = b.to(torch.bfloat16)
        act = ", bias + lrelu" if relu else ", bias"
        flops, nbytes = conv_work(BATCH, hw, hw, C, N)
        _row(rows, "conv3x3", f"conv3x3 {C}->{N}{act} {BATCH}x{hw}x{hw}",
             lambda: conv.conv3x3(x, w, b, relu=relu),
             lambda: conv.conv3x3_plain(x, w, b, relu=relu), (flops, 0, nbytes), 10, path, 1,
             library_fn=lambda: F.conv2d(xb, wb, bb, padding=1), shape=[BATCH, hw, hw, C], N=N,
             relu=relu)


def _chain_rows(torch, gen, rows, K, cond_ch, chains, path, hid=64, cd="bfloat16", key="chain",
                calls=1):
    """The chain kernel at coupling width hid in the recipe cd (bf16, or float32 for
    None) against its plain version, each row with the kernel's tile plan and the
    recipe's step loop (FlowStepSpec.inverse_hoisted / inverse over the K steps: cuDNN
    convs, bf16 conv1 and conv2 in the bf16 recipe, float32 without TF32 otherwise; the
    float32 tail) as the library sequence, timed as one CUDA graph and eagerly; the port
    never runs it.  Rows go under ``key``."""
    from hcflow_tpu_torch.flow import stack
    from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
    from hcflow_tpu_torch.ops import chain, nets

    f32 = cd is None
    for name, cond, c, hw in chains:
        spec = FlowStepSpec(in_channels=c, cond_channels=cond_ch if cond else None,
                            hidden_channels=hid, compute_dtype=cd)
        steps = stack.init_stack(spec, torch.Generator().manual_seed(12), K)
        steps = _to(stack.precompute_invconv(perturb(steps, gen)), DEV)
        pk = chain.pack_inverse_chain(steps, cd, padded=True)
        B, H, W = _bhw(hw)
        z = torch.randn(B, H, W, c, device=DEV, generator=gen)
        uc = ucf = None
        if cond:
            u = torch.randn(B, H, W, cond_ch, device=DEV, generator=gen)
            ucf = stack.compute_u_contribs(spec, steps, u)
            uc = ucf.to(pk["w1"].dtype).contiguous()

        def library(z=z, ucf=ucf, steps=steps, spec=spec):
            with nets.exact_f32():
                for k in reversed(range(K)):
                    z = (spec.inverse_hoisted(steps[k], z, ucf[..., k * hid:(k + 1) * hid])
                         if ucf is not None else spec.inverse(steps[k], z))[0]
            return z

        plan = chain.plan(B, H, W, c, hid=hid, f32=f32)
        log(f"  {key} {name}: {plan['th']}x{plan['tw']} tiles, {plan['blocks']} blocks, "
            f"{plan['blocks_per_sm']} per SM, {plan['smem']} bytes of shared memory a block")
        _row(rows, key, f"{key} {name} {B}x{H}x{W}x{c} K={K}",
             lambda: chain.inverse_chain(pk, z, uc), lambda: chain.inverse_chain_plain(pk, z, uc),
             chain_work(B, H, W, c, hid, K, cond, f32), 20, path, calls, library_fn=library,
             library_seq=True, rtol=F32_RTOL if f32 else KERNEL_RTOL, shape=[B, H, W, c],
             chain=name, K=K, hid=hid, plan=plan)


def _chain3s_rows(torch, gen, rows, K, chains, path, cd="bfloat16", key="chain3s", calls=1):
    """chain3s in the recipe cd against its plain version, beside its step loop
    (FlowStepSpec.inverse over the K steps in the same recipe; float32 with TF32 off)
    as one CUDA graph."""
    from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
    from hcflow_tpu_torch.ops import chain3s, nets

    gc = 32
    for name, c, hw in chains:
        specs = [FlowStepSpec(in_channels=c, hidden_channels=gc, compute_dtype=cd,
                              flow_permutation="none", flow_coupling="Affine3shift",
                              nn_module="DenseBlock", lr_vs_others=(k % 2 == 0))
                 for k in range(K)]
        g = torch.Generator().manual_seed(13)
        steps = _to(perturb([s.init(g) for s in specs], gen), DEV)
        pk = chain3s.pack_inverse_chain3s(steps, cd)
        B, H, W = _bhw(hw)
        z = torch.randn(B, H, W, c, device=DEV, generator=gen)

        def library(z=z, steps=steps, specs=specs):
            with nets.exact_f32() if cd is None else contextlib.nullcontext():
                for k in reversed(range(K)):
                    z = specs[k].inverse(steps[k], z)[0]
            return z

        _row(rows, key, f"{key} {name} {B}x{H}x{W}x{c} K={K}",
             lambda: chain3s.inverse_chain(pk, z), lambda: chain3s.inverse_chain3s_plain(pk, z),
             chain3s_work(B, H, W, c, gc, K, f32=cd is None), 10, path, calls,
             library_fn=library, library_seq=True, rtol=KERNEL_RTOL if cd else F32_RTOL,
             shape=[B, H, W, c], chain=name, K=K)


def phase_kernels(torch, gen):
    """Every kernel against its plain version at every shape of the main paths.
    calls_per_pass counts a row's calls per SR reverse pass or per rescaling request
    (downscale + upscale); conv3x3, on no path, counts one call at each shape."""
    rows = {k: [] for k in KERNELS}
    log("phase 2: kernels against their plain versions on the card")
    log("  SR path (x4, nb 7, gc 32, K 13, hidden 64)")
    _rrdb_rows(torch, gen, rows, 32, ((LR_HW, 14), (2 * LR_HW, 14)), "sr")  # trunk0+1 x 7
    _chain_rows(torch, gen, rows, 13, 128, [("L1 cond", True, 21, LR_HW),
                                            ("L0 cond", True, 6, 2 * LR_HW),
                                            ("L1 main", False, 24, LR_HW),
                                            ("L0 main", False, 12, 2 * LR_HW)], "sr")
    log("  rescaling path (x4, nb (2, 1), gc 16, main K 8 growth 32, split-off K 6)")
    _chain3s_rows(torch, gen, rows, 8, [("L1 main", 24, LR_HW), ("L0 main", 12, 2 * LR_HW)],
                  "rescaling")
    # 3 RRDBs a level, run by the downscale and again by the upscale
    _rrdb_rows(torch, gen, rows, 16, ((LR_HW, 6), (2 * LR_HW, 6)), "rescaling")
    _chain_rows(torch, gen, rows, 6, 64, [("L1 cond", True, 21, LR_HW),
                                          ("L0 cond", True, 6, 2 * LR_HW)], "rescaling")
    log(f"  x8 SR path (resident trunks nb {X8_NB}, gc 32; K 13, hidden 64)")
    hw = X8_LR_HW
    _trunk_rows(torch, gen, rows, ((hw, 2), (2 * hw, 2), (4 * hw, 2)), "sr8")  # trunk0 + 1
    _chain_rows(torch, gen, rows, 13, 128, [("L2 cond", True, 45, hw),
                                            ("L1 cond", True, 12, 2 * hw),
                                            ("L0 cond", True, 6, 4 * hw),
                                            ("L2 main", False, 48, hw),
                                            ("L1 main", False, 24, 2 * hw),
                                            ("L0 main", False, 12, 4 * hw)], "sr8")
    log("  conv3x3 (on no path): the x8 model's library 3x3 conv shapes")
    _conv_rows(torch, gen, rows, ((4 * hw, 262, 64, False), (2 * hw, 140, 64, False),
                                  (hw, 3, 64, False), (4 * hw, 64, 64, True)), "standalone")
    x4_chains = [("L1 cond", True, 21, LR_HW), ("L0 cond", True, 6, 2 * LR_HW),
                 ("L1 main", False, 24, LR_HW), ("L0 main", False, 12, 2 * LR_HW)]
    log("  trained x4 model, HCFlow+ recipe (phase 6): float32 chains, hidden 64, K 13")
    _chain_rows(torch, gen, rows, 13, 128, x4_chains, "train", cd=None, key="chain_f32")
    log("  tiny trained checkpoint (phase 7): chains at hidden 32, K 4, bf16 and float32")
    _chain_rows(torch, gen, rows, 4, 64, x4_chains, "tiny", hid=32, key="chain_hid32")
    _chain_rows(torch, gen, rows, 4, 64, x4_chains, "tiny", hid=32, cd=None,
                key="chain_hid32_f32")
    log("  float32 recipe (phase 8; phase 7's float32 trunks): the RRDB, trunk and chain3s "
        "kernels in 3xTF32")
    _rrdb_rows(torch, gen, rows, 32, ((LR_HW, 14), (2 * LR_HW, 14)), "sr_f32", cd=None,
               key="rrdb_f32")
    _rrdb_rows(torch, gen, rows, 16, ((LR_HW, 6), (2 * LR_HW, 6)), "rescaling_f32", cd=None,
               key="rrdb_f32")
    # the tiny checkpoint: trunk0 and trunk1 of nb 2 a level
    _rrdb_rows(torch, gen, rows, 16, ((LR_HW, 4), (2 * LR_HW, 4)), "tiny_f32", nf=32, cd=None,
               key="rrdb_f32")
    _trunk_rows(torch, gen, rows, ((hw, 2), (2 * hw, 2), (4 * hw, 2)), "sr8_f32", cd=None,
                key="rrdb_trunk_f32")
    _chain3s_rows(torch, gen, rows, 8, [("L1 main", 24, LR_HW), ("L0 main", 12, 2 * LR_HW)],
                  "rescaling_f32", cd=None, key="chain3s_f32")
    log("  serving entry points (phase 9, float32 recipe): the shapes the CLIs give the "
        "kernels (batch 1 at each image's size, the tiled batch of 8), checked, not in the "
        "units above")
    _serving_rows(torch, gen, rows)
    log("  training entry point (phase 10): the validations' shapes (bf16 RRDBs, float32 "
        "chains and chain3s), checked, not in the units above")
    _train_cli_rows(torch, gen, rows)
    return rows


def _serving_rows(torch, gen, rows):
    """The float32 kernels at phase 9's shapes, calls_per_pass 0: an x4 image's levels
    (LR 192x256 and its double), the ragged LQ-only image (LR 93x127), the Predictor's
    tiles (8 x 128x128 LR), the x8 LQ-only image (LR 20x24) and the tiny checkpoint's
    hid-32 chains."""
    h, w = SERVE_X4_HR[0] // SCALE, SERVE_X4_HR[1] // SCALE
    lv1, lv0 = (1, h, w), (1, 2 * h, 2 * w)
    odd1, odd0 = (1, *SERVE_REAL_X4), (1, 2 * SERVE_REAL_X4[0], 2 * SERVE_REAL_X4[1])
    tile1, tile0 = (8, 128, 128), (8, 256, 256)
    x8_2, x8_0 = (1, *SERVE_REAL_X8), (1, 4 * SERVE_REAL_X8[0], 4 * SERVE_REAL_X8[1])
    shapes = [(s, 0) for s in (lv1, lv0, odd1, odd0, tile1, tile0, x8_2, x8_0)]
    _rrdb_rows(torch, gen, rows, 32, shapes, "serve", cd=None, key="rrdb_f32")
    _rrdb_rows(torch, gen, rows, 16, [(lv1, 0), (lv0, 0)], "serve", cd=None, key="rrdb_f32")
    _rrdb_rows(torch, gen, rows, 16, [(lv1, 0), (lv0, 0)], "serve", nf=32, cd=None,
               key="rrdb_f32")
    _chain_rows(torch, gen, rows, 13, 128, [("L1 cond", True, 21, lv1), ("L0 cond", True, 6, lv0),
                                            ("L1 main", False, 24, lv1),
                                            ("L0 main", False, 12, lv0),
                                            ("L1 cond", True, 21, odd1),
                                            ("L0 main", False, 12, odd0),
                                            ("L1 main", False, 24, tile1),
                                            ("L0 cond", True, 6, tile0),
                                            ("L2 cond", True, 45, x8_2),
                                            ("L0 main", False, 12, x8_0)],
                "serve", cd=None, key="chain_f32", calls=0)
    _chain_rows(torch, gen, rows, 6, 64, [("L1 cond", True, 21, lv1), ("L0 cond", True, 6, lv0)],
                "serve", cd=None, key="chain_f32", calls=0)
    _chain_rows(torch, gen, rows, 4, 64, [("L1 cond", True, 21, lv1), ("L0 main", False, 12, lv0)],
                "serve", hid=32, cd=None, key="chain_hid32_f32", calls=0)
    _chain3s_rows(torch, gen, rows, 8, [("L1 main", 24, lv1), ("L0 main", 12, lv0)], "serve",
                  cd=None, key="chain3s_f32", calls=0)


def _train_cli_rows(torch, gen, rows):
    """The kernels at phase 10's validation shapes, calls_per_pass 0: HR 256x256 at x4
    (LR 64: the forward at batch 1, the reverse at n_sample 3) and x8 (LR 32), bf16
    RRDBs (the training configs' bf16 encoders), float32 chains and chain3s."""
    lr4, lr8 = TRAIN_VAL_HR[0] // SCALE, TRAIN_VAL_HR[0] // X8_SCALE
    sizes = sorted({lr4, 2 * lr4, lr8, 2 * lr8, 4 * lr8})
    _rrdb_rows(torch, gen, rows, 32, [((b, h, h), 0) for h in sizes for b in (1, 3)], "train_cli")
    _rrdb_rows(torch, gen, rows, 16, [((1, h, h), 0) for h in (lr4, 2 * lr4)], "train_cli")
    _chain_rows(torch, gen, rows, 13, 128, [("L1 cond", True, 21, (3, lr4, lr4)),
                                            ("L0 cond", True, 6, (3, 2 * lr4, 2 * lr4)),
                                            ("L1 main", False, 24, (3, lr4, lr4)),
                                            ("L0 main", False, 12, (3, 2 * lr4, 2 * lr4)),
                                            ("L2 cond", True, 45, (3, lr8, lr8)),
                                            ("L2 main", False, 48, (3, lr8, lr8))],
                "train_cli", cd=None, key="chain_f32", calls=0)
    _chain_rows(torch, gen, rows, 6, 64, [("L1 cond", True, 21, (1, lr4, lr4)),
                                          ("L0 cond", True, 6, (1, 2 * lr4, 2 * lr4))],
                "train_cli", cd=None, key="chain_f32", calls=0)
    _chain3s_rows(torch, gen, rows, 8, [("L1 main", 24, (1, lr4, lr4)),
                                        ("L0 main", 12, (1, 2 * lr4, 2 * lr4))], "train_cli",
                  cd=None, key="chain3s_f32", calls=0)


def _counts():
    """Launches of every KERNELS entry since the last reset, by variant: the chain
    kernel's (bf16 at hid 64; float32 at hid 64; bf16 and float32 at hid 32), the RRDB,
    trunk and chain3s kernels' (bf16, float32)."""
    from hcflow_tpu_torch.ops import chain, chain3s, conv, rrdb

    by = chain.launches_by
    return {"rrdb": rrdb.launches_by.get("bf16", 0),
            "rrdb_trunk": rrdb.trunk_launches_by.get("bf16", 0),
            "chain": by.get("bf16 hid 64", 0), "chain3s": chain3s.launches_by.get("bf16", 0),
            "conv3x3": conv.launches, "chain_f32": by.get("f32 hid 64", 0),
            "chain_hid32": by.get("bf16 hid 32", 0), "chain_hid32_f32": by.get("f32 hid 32", 0),
            "rrdb_f32": rrdb.launches_by.get("f32", 0),
            "rrdb_trunk_f32": rrdb.trunk_launches_by.get("f32", 0),
            "chain3s_f32": chain3s.launches_by.get("f32", 0)}


def _reset_counts():
    from hcflow_tpu_torch.ops import chain, chain3s, conv, rrdb

    for counts in (chain.launches_by, rrdb.launches_by, rrdb.trunk_launches_by,
                   chain3s.launches_by):
        counts.clear()
    conv.launches = 0


def _per_request(**counts):
    """Launches per request of every kernel: the given ones, 0 for the others."""
    return {k: counts.get(k, 0) for k in KERNELS}


def _check_counts(path, launches, per_unit, n):
    log(f"  {n} requests: launches {launches}")
    for k, per in per_unit.items():
        if launches[k] != per * n:
            raise AssertionError(f"{path}: {k} made {launches[k]} launches, expected {per} "
                                 f"per request")


def _compare_paths(name, a, b, f32=False):
    """Kernel path a against plain path b, before the clamp; a float32 path (``f32``)
    within F32_PATH_RTOL x max |plain|."""
    if f32:
        return (check_rel(f"{name}, kernel path vs plain path", a, b, F32_PATH_RTOL),
                (a - b).abs().mean().item())
    d = (a - b).abs()
    max_abs, mean_abs = d.max().item(), d.mean().item()
    max_ref, mean_ref = b.abs().max().item(), b.abs().mean().item()
    log(f"  {name}, kernel path vs plain path: max abs {max_abs:.3e} of max |plain| "
        f"{max_ref:.3e} (tol {MODEL_MAX_RTOL:g} x), mean abs {mean_abs:.3e} of mean |plain| "
        f"{mean_ref:.3e} (tol {MODEL_MEAN_RTOL:g} x)")
    if not (max_abs <= MODEL_MAX_RTOL * max_ref and mean_abs <= MODEL_MEAN_RTOL * mean_ref):
        raise AssertionError(f"{name}: the kernel path disagrees with the plain path")
    return max_abs, mean_abs


def _median_ms(fn, n=7):
    """Median ms of n calls, each timed alone with CUDA events (after warm-up)."""
    import torch

    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def phase_sr(torch, gen, scale, lr_hw, heat, per_request, resident=False, cd="bfloat16"):
    """An SR model at full width in the serving recipe cd (bf16, or float32 for None),
    batch 16: requests with launch counts (per_request: launches of each kernel per
    request), outputs, heat 0, the kernel path against the plain path (and, with
    resident trunks, against the per-RRDB kernel path) under the same explicit latents,
    and the time per pass."""
    from hcflow_tpu_torch.models import HCFlowSRSpec
    from hcflow_tpu_torch.ops import nets

    model = HCFlowSRSpec.for_scale(scale, compute_dtype=cd)
    L = model.flow.L
    t0 = time.perf_counter()
    params = perturb(model.init(0, device=DEV), gen)
    fused = model.flow.precompute_inference(params, fused=True, resident_trunk=resident)
    plain = model.flow.precompute_inference(params, fused=False)
    per_rrdb = model.flow.precompute_inference(params, fused=True) if resident else None
    torch.cuda.synchronize()
    log(f"  init + perturb + pack: {time.perf_counter() - t0:.1f} s")

    # the prior head and the invertible tail are float32 without TF32
    with nets.exact_f32():
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    head = params[f"level{L - 1}"]["cond"]["f"]
    cond = torch.randn(2, lr_hw, lr_hw, head["w"].shape[1], device=DEV, generator=gen)
    got = nets.apply_conv_zeros(head, cond)
    h64 = {k: v.double().cpu() for k, v in head.items()}
    ref = torch.nn.functional.conv2d(cond.double().cpu().permute(0, 3, 1, 2), h64["w"], h64["b"],
                                     padding=1).permute(0, 2, 3, 1) * torch.exp(3 * h64["logs"])
    head_err = ((got.double().cpu() - ref).abs().max() / ref.abs().max()).item()
    log(f"  prior head conv, float32 on the card vs float64: rel err {head_err:.2e} "
        "(TF32 would give ~1e-3; tolerance 1e-5)")
    if not head_err < 1e-5:
        raise AssertionError("the float32 prior head conv ran with reduced precision")

    lr = torch.rand(BATCH, lr_hw, lr_hw, 3, device=DEV, generator=gen)
    hr_shape = (BATCH, lr_hw * scale, lr_hw * scale, 3)

    def request(seed, heat=heat, p=fused):
        g = torch.Generator(device=DEV).manual_seed(seed)
        return model.reverse(p, lr, heat, generator=g)

    request(0)  # warm-up: cuDNN plans, kernel libraries loaded
    torch.cuda.synchronize()

    # the main path: a few requests, counted
    seeds = (1, 2, 3)
    _reset_counts()
    outs = [request(s) for s in seeds]
    torch.cuda.synchronize()
    launches = _counts()
    _check_counts(f"x{scale} SR", launches, per_request, len(seeds))
    for s, out in zip(seeds, outs):
        if tuple(out.shape) != hr_shape or not torch.isfinite(out).all():
            raise AssertionError(f"request {s}: bad output {tuple(out.shape)}")
        if out.min() < 0 or out.max() > 1:
            raise AssertionError(f"request {s}: output outside [0, 1]")
    inside = ((outs[0] > 0) & (outs[0] < 1)).float().mean().item()
    log(f"  outputs {hr_shape}, finite, in [0, 1]; {inside:.3f} of values inside (0, 1)")
    if torch.equal(outs[0], outs[1]):
        raise AssertionError(f"heat {heat}: two seeds gave the same image")
    if not torch.equal(request(1, 0.0), request(2, 0.0)):
        raise AssertionError("heat 0 is not deterministic across seeds")
    log(f"  heat 0 deterministic across seeds; heat {heat} differs by seed")

    # kernel path vs plain path under the same explicit latents, one whitened latent a
    # level: (B, lr_hw 2^(L-1-i), ..., a_channels) at level i
    eps = [torch.randn(BATCH, lr_hw * 2 ** (L - 1 - lv.level), lr_hw * 2 ** (L - 1 - lv.level),
                       lv.cond_spec.a_channels, device=DEV, generator=gen)
           for lv in model.flow.levels]
    out = dict(launches=launches, head_rel_err=head_err)
    with torch.no_grad():
        got = model.flow.reverse_flow(fused, lr, heat, eps_list=eps)
        out["path_max_abs"], out["path_mean_abs"] = _compare_paths(
            f"x{scale} SR reverse (same eps_list)", got,
            model.flow.reverse_flow(plain, lr, heat, eps_list=eps), f32=cd is None)
        if resident:
            ref = model.flow.reverse_flow(per_rrdb, lr, heat, eps_list=eps)
            torch.cuda.synchronize()
            same = torch.equal(got, ref)
            err = 0.0 if same else check_rel("resident-trunk path vs per-RRDB kernel path", got,
                                             ref, KERNEL_RTOL if cd else F32_PATH_RTOL)
            log(f"  resident-trunk path vs per-RRDB kernel path (same eps_list): "
                f"{'bit-identical' if same else f'max abs {err:.3e}'}")
            out.update(per_rrdb_identical=same, per_rrdb_max_abs=err)

    # time per pass, CUDA events, after warm-up
    hr_mp = BATCH * (lr_hw * scale) ** 2 / 1e6
    ms, times = _median_ms(lambda: request(100))
    plain_ms = cuda_time(lambda: request(200, p=plain), reps=2, warmup=1)
    out.update(pass_ms=ms, pass_times_ms=times, mp_per_s=hr_mp / ms * 1e3, plain_pass_ms=plain_ms)
    log(f"  reverse pass: median {ms:.3f} ms over {len(times)} passes "
        f"({', '.join(f'{t:.3f}' for t in times)}) = {out['mp_per_s']:.3f} HR MP/s; plain path "
        f"{plain_ms:.3f} ms/pass")
    if resident:
        per_ms, per_times = _median_ms(lambda: request(300, p=per_rrdb))
        out.update(per_rrdb_pass_ms=per_ms, per_rrdb_pass_times_ms=per_times)
        log(f"  per-RRDB kernel path: median {per_ms:.3f} ms over {len(per_times)} passes "
            f"({', '.join(f'{t:.3f}' for t in per_times)}) = {hr_mp / per_ms * 1e3:.3f} HR MP/s")
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    return out


def phase_rescaling(torch, gen, per_request, cd="bfloat16"):
    """The x4 rescaling model at full width in the serving recipe cd (bf16, or float32
    for None): downscale -> quantize -> upscale requests with launch counts
    (per_request), outputs, heat 0, the kernel path against the plain path, the round
    trip, and the time of each direction."""
    from hcflow_tpu_torch.models import HCFlowRescalingSpec, quantize

    f32 = cd is None
    model = HCFlowRescalingSpec.default_x4(compute_dtype=cd)
    params = perturb(model.init(0, device=DEV), gen)
    fused = model.flow.precompute_inference(params, fused=True)
    plain = model.flow.precompute_inference(params, fused=False)
    hr = torch.rand(BATCH, LR_HW * SCALE, LR_HW * SCALE, 3, device=DEV, generator=gen)
    lr_shape = (BATCH, LR_HW, LR_HW, 3)

    def request(seed, heat=RS_HEAT, p=fused):
        lr, _ = model.forward(p, hr)
        g = torch.Generator(device=DEV).manual_seed(seed)
        return lr, model.reverse(p, quantize(lr), heat, generator=g)

    request(0)  # warm-up
    torch.cuda.synchronize()

    # the main path: a few requests (downscale, quantize, upscale), counted
    seeds = (1, 2, 3)
    _reset_counts()
    outs = [request(s) for s in seeds]
    torch.cuda.synchronize()
    launches = _counts()
    _check_counts("rescaling", launches, per_request, len(seeds))
    for s, (lr, out) in zip(seeds, outs):
        if tuple(lr.shape) != lr_shape or tuple(out.shape) != tuple(hr.shape):
            raise AssertionError(f"request {s}: bad shapes {tuple(lr.shape)} {tuple(out.shape)}")
        for t in (lr, out):
            if not torch.isfinite(t).all() or t.min() < 0 or t.max() > 1:
                raise AssertionError(f"request {s}: output not finite in [0, 1]")
    inside = ((outs[0][1] > 0) & (outs[0][1] < 1)).float().mean().item()
    log(f"  LR {lr_shape} and HR {tuple(hr.shape)}, finite, in [0, 1]; {inside:.3f} of HR "
        "values inside (0, 1)")
    if torch.equal(outs[0][1], outs[1][1]):
        raise AssertionError("heat 1.0: two seeds gave the same image")
    if not torch.equal(request(1, 0.0)[1], request(2, 0.0)[1]):
        raise AssertionError("heat 0 is not deterministic across seeds")
    log("  heat 0 deterministic across seeds; heat 1.0 differs by seed")

    with torch.no_grad():
        # the downscale: its LR does not pass the encoders and is the same on both
        # paths; its latents do, through the RRDB kernel (fused) or the plain encoders
        z_f, zs_f = model.flow.normal_flow(fused, hr)
        z_p, zs_p = model.flow.normal_flow(plain, hr)
        if not torch.equal(z_f, z_p):
            raise AssertionError("the downscale's LR differs between the two paths")
        fwd_err = [_compare_paths(f"downscale latent, level {i}", a, b, f32)
                   for i, (a, b) in enumerate(zip(zs_f, zs_p))]
        # the upscale under the same explicit latents, before the clamp
        eps = [torch.randn(BATCH, 2 * LR_HW, 2 * LR_HW, 6, device=DEV, generator=gen),
               torch.randn(BATCH, LR_HW, LR_HW, 21, device=DEV, generator=gen)]
        lq = quantize(z_p.clamp(0, 1))
        rev_err = _compare_paths("upscale (same eps_list)",
                                 model.flow.reverse_flow(fused, lq, RS_HEAT, eps_list=eps),
                                 model.flow.reverse_flow(plain, lq, RS_HEAT, eps_list=eps), f32)
        # the round trip: the unquantized LR and its own latents give HR back
        rt_plain = (model.flow.reverse_flow(plain, z_p, RS_HEAT, eps_list=zs_p) - hr).abs()
        rt_kernel = (model.flow.reverse_flow(fused, z_f, RS_HEAT, eps_list=zs_f) - hr).abs()
    rt = dict(plain_max=rt_plain.max().item(), kernel_max=rt_kernel.max().item(),
              kernel_mean=rt_kernel.mean().item())
    log(f"  round trip HR -> (LR, latents) -> HR: plain path max abs {rt['plain_max']:.3e} "
        f"(tol {RT_PLAIN_MAX:g}); kernel path max abs {rt['kernel_max']:.3e} (tol "
        f"{RT_KERNEL_MAX:g}), mean abs {rt['kernel_mean']:.3e} (tol {RT_KERNEL_MEAN:g})")
    if not (rt["plain_max"] <= RT_PLAIN_MAX and rt["kernel_max"] <= RT_KERNEL_MAX
            and rt["kernel_mean"] <= RT_KERNEL_MEAN):
        raise AssertionError("the round trip does not reproduce HR")

    # time the downscale and the upscale, CUDA events, after warm-up
    lq = quantize(model.forward(fused, hr)[0])
    g = torch.Generator(device=DEV).manual_seed(100)
    down_ms, down_times = _median_ms(lambda: model.forward(fused, hr))
    up_ms, up_times = _median_ms(lambda: model.reverse(fused, lq, RS_HEAT, generator=g))
    down_plain = cuda_time(lambda: model.forward(plain, hr), reps=2, warmup=1)
    up_plain = cuda_time(lambda: model.reverse(plain, lq, RS_HEAT, generator=g), reps=2,
                         warmup=1)
    hr_mp = BATCH * (LR_HW * SCALE) ** 2 / 1e6
    out = dict(launches=launches, up_ms=up_ms, up_times_ms=up_times,
               up_mp_per_s=hr_mp / up_ms * 1e3, up_plain_ms=up_plain, down_ms=down_ms,
               down_times_ms=down_times, down_mp_per_s=hr_mp / down_ms * 1e3, down_plain_ms=down_plain,
               down_path_err=fwd_err, up_path_err=rev_err, round_trip=rt,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
    for name in ("up", "down"):
        log(f"  {'upscale' if name == 'up' else 'downscale'}: median {out[name + '_ms']:.3f} ms "
            f"over 7 passes ({', '.join(f'{t:.3f}' for t in out[name + '_times_ms'])}) = "
            f"{out[name + '_mp_per_s']:.3f} HR MP/s; plain path {out[name + '_plain_ms']:.3f} ms")
    return out


def _smooth_batch(torch, gen, hw):
    """A synthetic (HR, LR) batch on the card: HR a smooth random image (noise at 1/8
    of the size, upsampled bilinearly, plus fine noise) in [0, 1], NHWC; LR its 4x4
    average (the HR images of a dataset are smooth at this scale, and no dataset is in
    the repo)."""
    F = torch.nn.functional
    lo = torch.rand(BATCH, 3, hw // 8, hw // 8, device=DEV, generator=gen)
    hr = F.interpolate(lo, size=(hw, hw), mode="bilinear", align_corners=False)
    hr = (hr + 0.02 * torch.randn(hr.shape, device=DEV, generator=gen)).clamp(0, 1)
    lr = F.avg_pool2d(hr, SCALE)
    return hr.permute(0, 2, 3, 1).contiguous(), lr.permute(0, 2, 3, 1).contiguous()


def _tf32_probe(torch, nets):
    """Wrap nets.conv2d so that the backward of every conv records the TF32 flags it
    runs under; returns (the records, a function that removes the wrapper)."""
    seen, conv2d = [], nets.conv2d

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return g

    nets.conv2d = lambda *a, **k: Probe.apply(conv2d(*a, **k))

    def undo():
        nets.conv2d = conv2d

    return seen, undo


def phase_train(torch, gen):
    """x4 SR training at full width, HCFlow+ recipe, then the trained params served."""
    from hcflow_tpu_torch.models import HCFlowSRSpec
    from hcflow_tpu_torch.ops import nets
    from hcflow_tpu_torch.train import losses, schedules, trainer

    log("phase 6: x4 SR training at full width, HCFlow+ recipe (bf16 encoders, float32 "
        "couplings), batch 16, GT 160")
    model = HCFlowSRSpec.for_scale(SCALE, encoder_dtype="bfloat16")
    hw = LR_HW * SCALE
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, device=DEV)  # as training starts: zero coupling conv3s and prior heads
    hr, lr = _smooth_batch(torch, gen, hw)
    params = model.calibrate(params, hr, lr, generator=gen)
    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    state = trainer.init_state(params, tx)
    nll_step = trainer.make_sr_nll_step(model, tx, TRAIN_OPT["nll_weight"])
    pix_step = trainer.make_sr_pixel_step(model, tx, TRAIN_OPT["pixel_weight_hr"],
                                          losses.pixel_criterion(TRAIN_OPT["pixel_criterion_hr"]))
    leaves = trainer.tree_leaves(state.params)
    before = [t.detach().clone() for t in leaves]
    torch.cuda.synchronize()
    log(f"  init + calibrate on the first batch: {time.perf_counter() - t0:.1f} s; "
        f"{len(leaves)} param tensors, {sum(t.numel() for t in leaves) / 1e6:.2f} M values")
    times = {"nll": [], "pixel": []}
    out = {"nll": [], "pixel_loss": [], "grad_norm": []}
    for it in range(TRAIN_ITERS):
        if it:
            hr, lr = _smooth_batch(torch, gen, hw)
        else:  # the first iteration: TF32 allowed outside the steps, probed inside
            prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
            seen, undo = _tf32_probe(torch, nets)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        state, m = nll_step(state, hr, lr, generator=gen)
        ev[1].record()
        state, mp = pix_step(state, hr, lr, generator=gen)
        ev[2].record()
        torch.cuda.synchronize()
        if not it:
            undo()
            flags_after = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
            log(f"  TF32 flags in the {len(seen)} conv backward passes of the first iteration: "
                f"{sorted(set(seen))} (both False expected); after the steps {flags_after}")
            if len(seen) < 100 or any(a or b for a, b in seen) or flags_after != (True, True):
                raise AssertionError("a training step ran a backward conv with TF32 allowed")
        nll, gnorm, pix = m["nll"].item(), m["grad_norm"].item(), mp["l_g_pix_hr"].item()
        pgnorm = trainer.global_norm(mp["grads"]).item()
        log(f"  iteration {it + 1}: NLL {nll:.4f} bits/dim, grad norm {gnorm:.4e}; pixel L1 "
            f"{pix:.5f}, grad norm {pgnorm:.4e}; NLL step {ev[0].elapsed_time(ev[1]):.1f} ms, "
            f"pixel step {ev[1].elapsed_time(ev[2]):.1f} ms")
        if not all(math.isfinite(v) for v in (nll, gnorm, pix, pgnorm)):
            raise AssertionError(f"iteration {it + 1}: non-finite NLL, loss or gradient")
        out["nll"].append(nll)
        out["pixel_loss"].append(pix)
        out["grad_norm"].append([gnorm, pgnorm])
        if it:
            times["nll"].append(ev[0].elapsed_time(ev[1]))
            times["pixel"].append(ev[1].elapsed_time(ev[2]))
    if state.step != TRAIN_ITERS or state.opt_state["count"] != 2 * TRAIN_ITERS:
        raise AssertionError(f"{state.opt_state['count']} updates applied at step {state.step}, "
                             f"expected {2 * TRAIN_ITERS} at step {TRAIN_ITERS}")
    moved = sum(not torch.equal(a, b) for a, b in zip(before, leaves)) / len(leaves)
    if moved < 0.9:
        raise AssertionError(f"only {moved:.3f} of the param tensors moved")
    peak = torch.cuda.max_memory_allocated() / 1e9
    out.update(nll_step_ms=times["nll"], pixel_step_ms=times["pixel"], moved=moved,
               peak_mem_gb=peak)
    log(f"  {TRAIN_ITERS} iterations: NLL step {statistics.mean(times['nll']):.1f} ms, pixel "
        f"step {statistics.mean(times['pixel']):.1f} ms (mean after the first iteration); "
        f"{moved:.3f} of the param tensors moved; peak memory {peak:.2f} GB "
        f"(torch.cuda.max_memory_allocated)")

    # serve the trained params on the card: float32 chain packs, bf16 trunk packs
    log("  serving the trained params (precompute_inference(fused=True))")
    trained = trainer.tree_map(lambda t: t.detach(), state.params)
    fused = model.flow.precompute_inference(trained, fused=True)
    plain = model.flow.precompute_inference(trained)
    for lv in model.flow.levels:
        lp = fused[f"level{lv.level}"]
        if (lp["main_fused"]["w1"].dtype != torch.float32 or "trunk0_fused" not in lp["cond"]
                or lp["cond"]["steps_fused"]["w1"].dtype != torch.float32):
            raise AssertionError("the HCFlow+ recipe's packs: float32 chains, bf16 trunks")

    def request(seed, p=fused):
        return model.reverse(p, lr, HEAT, generator=torch.Generator(device=DEV).manual_seed(seed))

    request(0)
    torch.cuda.synchronize()
    _reset_counts()
    outs = [request(s) for s in (1, 2)]
    torch.cuda.synchronize()
    launches = _counts()
    _check_counts("trained x4 SR", launches, _per_request(rrdb=28 * 16, chain_f32=4 * 13), 2)
    for o in outs:
        if tuple(o.shape) != tuple(hr.shape) or not torch.isfinite(o).all():
            raise AssertionError(f"trained model: bad output {tuple(o.shape)}")
    L = model.flow.L
    eps = [torch.randn(BATCH, LR_HW * 2 ** (L - 1 - lv.level), LR_HW * 2 ** (L - 1 - lv.level),
                       lv.cond_spec.a_channels, device=DEV, generator=gen)
           for lv in model.flow.levels]
    with torch.no_grad():
        out["path_max_abs"], out["path_mean_abs"] = _compare_paths(
            "trained x4 SR reverse (same eps_list)",
            model.flow.reverse_flow(fused, lr, HEAT, eps_list=eps),
            model.flow.reverse_flow(plain, lr, HEAT, eps_list=eps))
        z, eps_hr = model.flow.encode(fused, hr)
        d = (model.flow.reverse_flow(fused, z, HEAT, eps_list=eps_hr) - hr).abs()
        rt_max, rt_mean = d.max().item(), d.mean().item()
        noise = torch.rand(hr.shape, device=DEV, generator=gen)
        _reset_counts()
        nll_f = model.forward(fused, hr, lr, noise=noise)[1].item()
        _check_counts("trained x4 SR forward (NLL)", _counts(), _per_request(rrdb=28 * 16), 1)
        nll_p = model.forward(plain, hr, lr, noise=noise)[1].item()
    nll_rel = abs(nll_f - nll_p) / abs(nll_p)
    log(f"  encode -> reverse on the kernel path: max abs {rt_max:.3e} (tol {RT_TRAIN_MAX:g}), "
        f"mean abs {rt_mean:.3e} (tol {RT_TRAIN_MEAN:g}); NLL fused {nll_f:.6f} vs plain "
        f"{nll_p:.6f} bits/dim, rel {nll_rel:.3e} (tol {NLL_RTOL:g})")
    if not (rt_max <= RT_TRAIN_MAX and rt_mean <= RT_TRAIN_MEAN):
        raise AssertionError("the trained model's encode -> reverse does not give HR back")
    if not nll_rel <= NLL_RTOL:
        raise AssertionError("the NLL on the fused params disagrees with the plain params")
    ms, ts = _median_ms(lambda: request(100), n=5)
    log(f"  trained model's reverse pass (float32 couplings): median {ms:.3f} ms over 5 passes "
        f"({', '.join(f'{t:.3f}' for t in ts)})")
    out.update(launches=launches, round_trip_max=rt_max, round_trip_mean=rt_mean, nll_fused=nll_f,
               nll_plain=nll_p, nll_rel=nll_rel, pass_ms=ms, pass_times_ms=ts)
    return out


def phase_tiny(torch, gen):
    """The tiny trained checkpoint served fused in both recipes, against the plain path."""
    from pathlib import Path

    from hcflow_tpu_torch.convert import params_from_state_dict
    from hcflow_tpu_torch.models import HCFlowSRSpec

    log("phase 7: the tiny trained checkpoint (weights/ref_trained/tiny_x4_400_G.pth, hidden "
        "32, RRDB nf 32 / gc 16), served fused")
    pth = Path(__file__).resolve().parent / "weights" / "ref_trained" / "tiny_x4_400_G.pth"
    sd = torch.load(pth, map_location="cpu")
    _, lr = _smooth_batch(torch, gen, LR_HW * SCALE)
    out = {}
    for cd in ("bfloat16", None):
        recipe = cd or "float32"
        model = HCFlowSRSpec.for_scale(SCALE, compute_dtype=cd, **TINY_CKPT)
        params = params_from_state_dict(sd, model, device=DEV)
        fused = model.flow.precompute_inference(params, fused=True)
        plain = model.flow.precompute_inference(params)

        def request(seed, p=fused, model=model):
            g = torch.Generator(device=DEV).manual_seed(seed)
            return model.reverse(p, lr, HEAT, generator=g)

        request(0)
        torch.cuda.synchronize()
        _reset_counts()
        outs = [request(s) for s in (1, 2)]
        torch.cuda.synchronize()
        launches = _counts()
        per = (_per_request(rrdb=2 * 2 * 2 * 16, chain_hid32=4 * 4) if cd else
               _per_request(rrdb_f32=2 * 2 * 2 * 16, chain_hid32_f32=4 * 4))
        _check_counts(f"tiny checkpoint, {recipe} recipe", launches, per, 2)
        for o in outs:
            if tuple(o.shape) != (BATCH, LR_HW * SCALE, LR_HW * SCALE, 3) or not torch.isfinite(o).all():
                raise AssertionError(f"tiny checkpoint: bad output {tuple(o.shape)}")
        eps = [torch.randn(BATCH, LR_HW * 2 ** (1 - lv.level), LR_HW * 2 ** (1 - lv.level),
                           lv.cond_spec.a_channels, device=DEV, generator=gen)
               for lv in model.flow.levels]
        with torch.no_grad():
            got = model.flow.reverse_flow(fused, lr, HEAT, eps_list=eps)
            ref = model.flow.reverse_flow(plain, lr, HEAT, eps_list=eps)
        if cd:
            err = _compare_paths(f"tiny checkpoint, {recipe} recipe (same eps_list)", got, ref)
        else:
            err = (check_rel(f"tiny checkpoint, {recipe} recipe, kernel path vs plain path "
                             "(same eps_list)", got, ref, F32_PATH_RTOL),)
        ms, ts = _median_ms(lambda: request(100), n=5)
        log(f"  {recipe} recipe: reverse pass median {ms:.3f} ms over 5 passes")
        out[recipe] = dict(launches=launches, path_err=err, pass_ms=ms, pass_times_ms=ts)
    return out


def _write_pairs(np, root, n, hr_hw, scale, rng):
    """n smooth synthetic GT/LQ PNG pairs under root/HR and root/LR (LR by the port's
    MATLAB bicubic); returns their names."""
    from hcflow_tpu_torch.data.imresize import imresize
    from hcflow_tpu_torch.data.util import save_img

    for d in ("HR", "LR"):
        (root / d).mkdir(parents=True)
    names = []
    for i in range(n):
        hr = _smooth_image(np, rng, *hr_hw)
        save_img(str(root / "HR" / f"{i:02d}.png"), hr)
        save_img(str(root / "LR" / f"{i:02d}.png"), np.clip(imresize(hr, 1 / scale), 0, 1))
        names.append(f"{i:02d}")
    return names


def _smooth_image(np, rng, h, w):
    """A smooth random image in [0, 1] (8x8 blocks of random colours, smoothed by a
    bicubic round trip, plus fine noise), float32 HWC."""
    from hcflow_tpu_torch.data.imresize import imresize

    lo = rng.uniform(0.05, 0.95, (-(-h // 8), -(-w // 8), 3))
    img = imresize(lo, 8.0)[:h, :w]
    return np.clip(img + 0.02 * rng.standard_normal(img.shape), 0, 1).astype(np.float32)


def _serve_option_file(path, src, root, datasets, ckpt=None, **changes):
    """An option file from src with its datasets' dataroots (and any LQ-only set),
    path.root and pretrain_model_G changed; nothing else of src."""
    import yaml

    with open(src) as f:
        opt = yaml.safe_load(f)
    opt["datasets"] = datasets
    opt["path"] = {**(opt.get("path") or {}), "root": str(root), "pretrain_model_G": ckpt}
    opt.update(changes)
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return str(path)


def _serve(torch, name, opt_path, expected, files):
    """cli.test.main on opt_path on the card, the launches counted from 0: every
    average finite, the saved files (dataset -> names), the exact launches
    (expected); the Evaluator's seconds per image per heat and the device's busy
    share of them (torch.profiler)."""
    import os

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hcflow_tpu_torch.cli import evaluate, test
    from hcflow_tpu_torch.utils.config import parse

    runs, run = [], evaluate.Evaluator.run

    def timed(self, loader, generator, real_image=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run(self, loader, generator, real_image)
        torch.cuda.synchronize()
        runs.append(dict(s=time.perf_counter() - t0, images=out["n_images"],
                         heats=len(self.heats), real=real_image))
        return out

    evaluate.Evaluator.run = timed
    try:
        _reset_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = test.main(["--opt", opt_path])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _counts()
    finally:
        evaluate.Evaluator.run = run
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e6
    if not busy:
        raise AssertionError(f"{name}: the profiler saw no device time")
    eval_s = sum(r["s"] for r in runs)
    log(f"  {name}: cli.test.main {wall:.2f} s, of which the Evaluator {eval_s:.2f} s; device "
        f"busy {busy:.3f} s = {busy / eval_s:.4f} of the Evaluator's time")
    for (ds, avg), r in zip(res.items(), runs):  # main runs the datasets in this order
        per = r["s"] / (r["images"] * r["heats"])
        r.update(dataset=ds, s_per_image_heat=per)
        log(f"    [{ds}] {r['images']} images x {r['heats']} heats: {per:.3f} s per image per "
            f"heat{' (LQ only: the reverse, no metrics)' if r['real'] else ''}; averages "
            + ", ".join(f"{k} {v:.4f}" for k, v in sorted(avg.items())))
        bad = [k for k, v in avg.items() if not math.isfinite(v)]
        if bad:
            raise AssertionError(f"{name} [{ds}]: non-finite averages {bad}")
    results_root = parse(opt_path, is_train=False)["path"]["results_root"]
    for ds, want in files.items():
        got = sorted(os.listdir(os.path.join(results_root, ds)))
        if got != sorted(want):
            raise AssertionError(f"{name} [{ds}]: saved {got}, expected {sorted(want)}")
    log(f"    saved images as expected ({sum(len(v) for v in files.values())} files)")
    _expect_launches(name, launches, expected)
    return dict(results=res, runs=runs, wall_s=wall, eval_s=eval_s, busy_s=busy,
                busy_share=busy / eval_s, launches=launches)


def _expect_launches(name, launches, expected):
    log(f"    launches {launches}")
    want = _per_request(**expected)
    if launches != want:
        raise AssertionError(f"{name}: launches {launches}, expected {want}")


def _sr_files(names, heats, n_sample=1):
    return [f"SR_{n}_{h:.1f}_{s}.png" for n in names for h in heats for s in range(n_sample)]


def _host_breakdown(np, root):
    """ms on the host of what the Evaluator does for one x4 GT image outside the model,
    each once, on the first pair under root and a stand-in SR: decoding the pair, the
    LR metrics (once an image), and a heat's HR metrics, bicubic downscales (bicHR), their
    metrics and the PNG write."""
    from hcflow_tpu_torch.data.imresize import imresize
    from hcflow_tpu_torch.data.util import read_img, save_img
    from hcflow_tpu_torch.utils.metrics import calculate_psnr_ssim

    ms = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return out

    gt, lr = timed("decode the GT and LQ PNGs", lambda: (read_img(str(root / "HR/00.png")),
                                                          read_img(str(root / "LR/00.png"))))
    sr = np.clip(gt + 0.05 * np.random.default_rng(0).standard_normal(gt.shape), 0, 1)
    timed("LR metrics", lambda: calculate_psnr_ssim(lr, np.clip(lr + 0.01, 0, 1), 0))
    timed("HR metrics (PSNR, SSIM, +Y)", lambda: calculate_psnr_ssim(gt, sr, SCALE))
    bic = timed("bicHR: 2 bicubic downscales", lambda: (imresize(gt, 1 / SCALE),
                                                         imresize(sr, 1 / SCALE)))
    timed("bicHR metrics", lambda: calculate_psnr_ssim(*bic, 0))
    timed("save the SR PNG", lambda: save_img(str(root / "host.png"), sr))
    per_heat = sum(v for k, v in ms.items() if k not in ("decode the GT and LQ PNGs",
                                                         "LR metrics"))
    log(f"  host work of an x4 image outside the model ({gt.shape[1]}x{gt.shape[0]}): "
        + "; ".join(f"{k} {v:.1f} ms" for k, v in ms.items())
        + f"; a heat's share {per_heat:.1f} ms")
    return dict(ms, per_heat=per_heat)


def phase_serving(torch, gen):
    """The serving entry points on the card at full width, float32 recipe: cli.test.main
    on the shipped x4 SR, x8 SR and x4 rescaling test configs and on the tiny trained
    checkpoint, the kernel path's Evaluator against the plain path's, the tiled
    Predictor."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from hcflow_tpu_torch.cli.evaluate import Evaluator
    from hcflow_tpu_torch.cli.predict import Predictor
    from hcflow_tpu_torch.data import DataLoader, create_dataset
    from hcflow_tpu_torch.data.util import read_img, save_img
    from hcflow_tpu_torch.utils import config

    repo = Path(__file__).resolve().parent
    rng = np.random.default_rng(9)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        x4 = _write_pairs(np, tmp / "x4", SERVE_X4_PAIRS, SERVE_X4_HR, SCALE, rng)
        x8 = _write_pairs(np, tmp / "x8", SERVE_X8_PAIRS, SERVE_X8_HR, X8_SCALE, rng)
        for d, hw in (("real_x4", SERVE_REAL_X4), ("real_x8", SERVE_REAL_X8)):
            (tmp / d).mkdir()
            save_img(str(tmp / d / "odd.png"), _smooth_image(np, rng, *hw))
        log(f"  datasets written in {time.perf_counter() - t0:.1f} s: {SERVE_X4_PAIRS} pairs of "
            f"HR {SERVE_X4_HR[1]}x{SERVE_X4_HR[0]}, {SERVE_X8_PAIRS} of HR {SERVE_X8_HR[1]}x"
            f"{SERVE_X8_HR[0]}, LQ-only {SERVE_REAL_X4[1]}x{SERVE_REAL_X4[0]} and "
            f"{SERVE_REAL_X8[1]}x{SERVE_REAL_X8[0]} (W x H)")

        def pairs(name, d):
            return {"name": name, "mode": "GTLQ", "dataroot_GT": str(tmp / d / "HR"),
                    "dataroot_LQ": str(tmp / d / "LR")}

        def real(d):
            return {"name": d, "mode": "LQ", "dataroot_LQ": str(tmp / d)}

        # x4 SR: per GT image the forward and a reverse a heat, per LQ image a reverse a
        # heat; a pass: 28 RRDBs of 16 launches, 4 chains of 13 steps
        heats = [0.0, 0.9]
        opt = _serve_option_file(tmp / "x4.yml", repo / "configs/test_SR_DF2K_4X_HCFlow.yml", tmp,
                                 {"test_1": pairs("x4", "x4"), "test_2": real("real_x4")})
        n, r = len(x4), 1
        log("  x4 SR, configs/test_SR_DF2K_4X_HCFlow.yml (random init: no released weights)")
        out["x4"] = _serve(torch, "x4 SR", opt, dict(
            rrdb_f32=28 * 16 * (n * (1 + len(heats)) + r * len(heats)),
            chain_f32=4 * 13 * len(heats) * (n + r)),
            {"x4": _sr_files(x4, heats), "real_x4": _sr_files(["odd"], heats)})

        out["x4_host_ms"] = _host_breakdown(np, tmp / "x4")

        # x8 SR (per-RRDB kernels, as test.main packs): 30 RRDBs, 6 chains of 13 steps
        heats = [0.0, 0.8]
        opt = _serve_option_file(tmp / "x8.yml", repo / "configs/test_SR_CelebA_8X_HCFlow.yml",
                                 tmp, {"test_1": pairs("x8", "x8"), "test_2": real("real_x8")})
        n = len(x8)
        log("  x8 SR, configs/test_SR_CelebA_8X_HCFlow.yml (random init)")
        out["x8"] = _serve(torch, "x8 SR", opt, dict(
            rrdb_f32=30 * 16 * (n * (1 + len(heats)) + r * len(heats)),
            chain_f32=6 * 13 * len(heats) * (n + r)),
            {"x8": _sr_files(x8, heats), "real_x8": _sr_files(["odd"], heats)})

        # x4 rescaling: per image the downscale (6 RRDBs) and the upscale (6 RRDBs, 2
        # split-off chains of 6 steps, 2 main chains of 1 + 5 x 8 launches), heat 1.0
        opt = _serve_option_file(tmp / "rs.yml", repo / "configs/test_Rescaling_DF2K_4X_HCFlow.yml",
                                 tmp, {"test_1": pairs("rs", "x4")})
        n = len(x4)
        log("  x4 rescaling, configs/test_Rescaling_DF2K_4X_HCFlow.yml (random init)")
        out["rescaling"] = _serve(torch, "x4 rescaling", opt, dict(
            rrdb_f32=2 * 6 * 16 * n, chain_f32=2 * 6 * n, chain3s_f32=2 * 41 * n),
            {"rs": _sr_files(x4, [1.0])})

        # the tiny trained checkpoint: 8 RRDBs a pass, 4 chains of 4 steps at hid 32
        opt = _serve_option_file(tmp / "tiny.yml", repo / "weights/ref_trained/tiny_x4_parity.yml",
                                 tmp, {"test_1": pairs("tiny", "x4")},
                                 ckpt=str(repo / "weights/ref_trained/tiny_x4_400_G.pth"))
        log("  the tiny trained checkpoint, weights/ref_trained/tiny_x4_parity.yml + "
            "tiny_x4_400_G.pth")
        out["tiny"] = _serve(torch, "tiny checkpoint", opt, dict(
            rrdb_f32=8 * 16 * 2 * n, chain_hid32_f32=4 * 4 * n), {"tiny": _sr_files(x4, [0.0])})

        # the kernel path's Evaluator against the plain path's, perturbed full-width x4
        log("  x4 SR Evaluator at heat 0, perturbed weights: kernel path against plain path")
        x4_opt = config.parse(str(repo / "configs/test_SR_DF2K_4X_HCFlow.yml"), is_train=False)
        model = config.model_spec_from_opt(x4_opt)
        params = perturb(model.init(0, device=DEV), gen)

        class Capture(Evaluator):
            def sample(self, *args):
                srs = super().sample(*args)
                self.srs.append(srs)
                return srs

        evs = {}
        for path, fused in (("kernel", True), ("plain", False)):
            ev = Capture(model, model.flow.precompute_inference(params, fused=fused), [0.0])
            ev.srs = []
            t0 = time.perf_counter()
            avg = ev.run(DataLoader(create_dataset({**pairs("x4", "x4"), "phase": "test",
                                                     "scale": SCALE, "n_max": 2})),
                         torch.Generator(device=DEV).manual_seed(1))
            torch.cuda.synchronize()
            evs[path] = (avg, ev.srs, time.perf_counter() - t0)
        errs = [check_rel(f"image {i} SR, kernel path vs plain path", torch.from_numpy(a),
                          torch.from_numpy(b), F32_PATH_RTOL)
                for i, (a, b) in enumerate(zip(evs["kernel"][1], evs["plain"][1]))]
        d_psnr = {k: abs(evs["kernel"][0][k] - evs["plain"][0][k])
                  for k in ("psnr@0.0", "psnr_y@0.0", "bic_psnr@0.0")}
        log(f"  PSNR kernel path {evs['kernel'][0]['psnr@0.0']:.4f} dB, plain "
            f"{evs['plain'][0]['psnr@0.0']:.4f}; |difference| {d_psnr} (tolerance "
            f"{SERVE_PSNR_TOL} dB); Evaluator {evs['kernel'][2]:.2f} s (kernel path) and "
            f"{evs['plain'][2]:.2f} s (plain path) for 2 images")
        if max(d_psnr.values()) > SERVE_PSNR_TOL:
            raise AssertionError("the kernel path's PSNR disagrees with the plain path's")
        out["paths"] = dict(max_abs=errs, d_psnr=d_psnr, kernel_s=evs["kernel"][2],
                            plain_s=evs["plain"][2])

        # the Predictor ('general': the x4 test config, random init) on a DIV2K-sized LR
        log(f"  Predictor('general') on an LR of {PREDICT_LR[1]}x{PREDICT_LR[0]}, max_tile "
            f"{PREDICT_TILE}")

        class Recording(Predictor):
            def reverse(self, params, lr, heat, generator):
                sr = super().reverse(params, lr, heat, generator)
                self.seen.append((lr.shape, sr.shape, float(sr.min()), float(sr.max()),
                                  bool(np.isfinite(sr).all())))
                return sr

        pred = Recording("general")
        pred.seen = []
        save_img(str(tmp / "div2k.png"), _smooth_image(np, rng, *PREDICT_LR))
        pred.predict(str(tmp / "div2k.png"), str(tmp / "warm.png"), max_tile=PREDICT_TILE)
        ph, pw = PREDICT_LR[0] + PREDICT_LR[0] % 2, PREDICT_LR[1] + PREDICT_LR[1] % 2
        stride = PREDICT_TILE - 16
        tiles = math.ceil((ph - 16) / stride) * math.ceil((pw - 16) / stride)
        batches = math.ceil(tiles / 8)
        pred.seen, times = [], []
        _reset_counts()
        for i in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = pred.predict(str(tmp / "div2k.png"), str(tmp / f"sr{i}.png"),
                                max_tile=PREDICT_TILE)
            times.append((time.perf_counter() - t0) * 1e3)
        launches = _counts()
        sr = read_img(path)
        want = (PREDICT_LR[0] * SCALE, PREDICT_LR[1] * SCALE, 3)
        log(f"    {tiles} tiles in {batches} batches of 8 a request; output {sr.shape}; "
            f"reverse outputs {pred.seen[0][:2]}, min {min(s[2] for s in pred.seen):.4f}, "
            f"max {max(s[3] for s in pred.seen):.4f}; ms per image {statistics.median(times):.1f} "
            f"(median of 3: {', '.join(f'{t:.1f}' for t in times)})")
        if sr.shape != want:
            raise AssertionError(f"Predictor: output {sr.shape}, expected {want}")
        if len(pred.seen) != 3 * batches or not all(
                s[1] == (8, PREDICT_TILE * SCALE, PREDICT_TILE * SCALE, 3) and s[4]
                and 0 <= s[2] and s[3] <= 1 for s in pred.seen):
            raise AssertionError(f"Predictor: reverse outputs {pred.seen}")
        _expect_launches("Predictor", launches, dict(rrdb_f32=28 * 16 * batches * 3,
                                                     chain_f32=4 * 13 * batches * 3))
        out["predict"] = dict(ms=times, tiles=tiles, batches=batches, launches=launches)
    return out


# ------------------------------------------------------------ phase 10: training
def _train_data(np, root, rng):
    """Phase 10's datasets under root, made by the port's prepare_data from smooth
    synthetic PNGs (LR by the port's MATLAB bicubic): LRHR_PKL crops of GT 160 with x4
    and x8 LRs (pkl/), GT/LQ .npy pairs of HR 320 x 320 (npy/, the rescaling config's
    GTLQnpy mode) and 2-pair GT/LQ validation sets of HR 256 x 256 at x4 and x8."""
    from hcflow_tpu_torch.cli import prepare_data
    from hcflow_tpu_torch.data.imresize import imresize
    from hcflow_tpu_torch.data.util import save_img

    for d in ("src", "png/HR", "png/LR"):
        (root / d).mkdir(parents=True)
    for i in range(TRAIN_SRC_IMAGES):
        save_img(str(root / "src" / f"{i}.png"), _smooth_image(np, rng, *TRAIN_SRC_HW))
        hr = _smooth_image(np, rng, *TRAIN_SRC_HW)
        save_img(str(root / "png/HR" / f"{i}.png"), hr)
        save_img(str(root / "png/LR" / f"{i}.png"), np.clip(imresize(hr, 1 / SCALE), 0, 1))
    crops = prepare_data.prepare_pkl(str(root / "src"), str(root / "pkl"),
                                     crops_per_image=TRAIN_CROPS, crop_size=TRAIN_GT,
                                     scales=(SCALE, X8_SCALE))
    for d in ("HR", "LR"):
        prepare_data.png2npy(str(root / "png" / d), str(root / "npy" / d))
    for scale in (SCALE, X8_SCALE):
        _write_pairs(np, root / f"val_x{scale}", TRAIN_VAL_PAIRS, TRAIN_VAL_HR, scale, rng)
    return crops


def _train_option_file(path, src, root, changes):
    """A copy of the shipped training config src with the keys of ``changes`` (dotted
    paths) set, printing each one changed; nothing else of src changes."""
    import yaml

    with open(src) as f:
        opt = yaml.safe_load(f)
    for key, value in changes.items():
        *parents, leaf = key.split(".")
        d = opt
        for k in parents:
            d = d.setdefault(k, {})
        log(f"    {key}: {d.get(leaf)!r} -> {value!r}")
        d[leaf] = value
    with open(path, "w") as f:
        yaml.safe_dump(opt, f)
    return str(path)


def _train_run(torch, name, opt_path, max_steps, val_launches, start_params=None):
    """cli.train.main on opt_path on the card, its steps, calibration and validation
    wrapped to time them (CUDA events) and check their losses finite, and the launches
    of each validation held to val_launches.  Returns the final state and the records."""
    from hcflow_tpu_torch.cli import train
    from hcflow_tpu_torch.models.hcflow_sr import HCFlowSRSpec
    from hcflow_tpu_torch.train.trainer import tree_leaves

    passes = []  # (kind, start event, end event)
    vals = []
    saved = {k: getattr(train, k) for k in (*TRAIN_PASSES, "Evaluator")}
    calibrate = HCFlowSRSpec.calibrate

    def timed(kind, fn):
        def step(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            passes.append((kind, ev))
            metrics = out[-1] if isinstance(out, tuple) else {}
            for key, v in metrics.items():
                if key != "grads" and not torch.isfinite(v).all():
                    raise AssertionError(f"{name}: {kind} pass gave a non-finite {key}")
            return out

        return step

    for factory, kind in TRAIN_PASSES.items():
        setattr(train, factory, lambda *a, _f=saved[factory], _k=kind, **k: timed(_k, _f(*a, **k)))

    class Evaluator(saved["Evaluator"]):
        def run(self, *a, **k):
            before = _counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = super().run(*a, **k)
            torch.cuda.synchronize()
            s = time.perf_counter() - t0
            launches = {k_: v - before[k_] for k_, v in _counts().items()}
            bad = [k_ for k_, v in out.items() if not math.isfinite(v)]
            log(f"    validation: {s:.2f} s for {out['n_images']} images; launches {launches}; "
                + ", ".join(f"{k_} {v:.4f}" for k_, v in sorted(out.items())))
            if bad:
                raise AssertionError(f"{name}: non-finite validation averages {bad}")
            _expect_launches(f"{name} validation", launches, val_launches)
            vals.append(dict(s=s, averages=out, launches=launches))
            return out

    train.Evaluator = Evaluator
    HCFlowSRSpec.calibrate = timed("calibrate", calibrate)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        state = train.main(["--opt", opt_path, "--max_steps", str(max_steps)])
        torch.cuda.synchronize()
    finally:
        for k, v in saved.items():
            setattr(train, k, v)
        HCFlowSRSpec.calibrate = calibrate
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    by_kind = {}
    for i, (kind, ev) in enumerate(passes):
        by_kind.setdefault(kind, []).append(ev[0].elapsed_time(ev[1]))
    # ms per pass kind after its first call (the first one builds cuDNN's plans)
    ms = {k: statistics.mean(v[1:]) if len(v) > 1 else None for k, v in by_kind.items()}
    leaves = [t.detach() for t in tree_leaves(state.params)]
    if not all(torch.isfinite(t).all() for t in leaves):
        raise AssertionError(f"{name}: non-finite params after training")
    moved = None
    if start_params is not None:
        moved = sum(not torch.equal(a, b) for a, b in zip(tree_leaves(start_params), leaves)
                    ) / len(leaves)
        if moved < 0.9:
            raise AssertionError(f"{name}: only {moved:.3f} of the param tensors moved")
    log(f"  {name}: {wall:.1f} s of main; ms per pass after the first: "
        + ", ".join(f"{k} {v:.1f}" if v is not None else f"{k} (once)" for k, v in ms.items())
        + f" (calls {', '.join(f'{k} {len(v)}' for k, v in by_kind.items())}); "
        f"G step {state.step}; peak memory {peak:.2f} GB"
        + ("" if moved is None else f"; {moved:.3f} of the param tensors moved"))
    return state, dict(wall_s=wall, pass_ms=ms, pass_times_ms=by_kind, peak_mem_gb=peak,
                       validations=vals, g_step=state.step, moved=moved)


def _expect_files(name, exp, models, states):
    import os

    got = (sorted(os.listdir(exp / "models")), sorted(os.listdir(exp / "training_state")))
    if got != (sorted(models), sorted(states)):
        raise AssertionError(f"{name}: checkpoints {got}, expected {models} and {states}")
    log(f"    checkpoints: {got[0]} and {got[1]}, as the options ask")


def phase_train_cli(torch, gen):
    """The training entry point at full width on the shipped training configs: the
    HCFlow -> HCFlow+ (and an auto-resume) -> HCFlow++ chain, rescaling, x8."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from hcflow_tpu_torch.cli.evaluate import Evaluator
    from hcflow_tpu_torch.data import create_dataloader, create_dataset
    from hcflow_tpu_torch.train import trainer
    from hcflow_tpu_torch.utils import checkpoint, config

    repo = Path(__file__).resolve().parent
    out = {}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        crops = _train_data(np, tmp / "data", np.random.default_rng(10))
        log(f"  datasets written in {time.perf_counter() - t0:.1f} s: {crops}; GT/LQ .npy "
            f"pairs of HR {TRAIN_SRC_HW[1]}x{TRAIN_SRC_HW[0]}; validation {TRAIN_VAL_PAIRS} "
            f"pairs of HR {TRAIN_VAL_HR[1]}x{TRAIN_VAL_HR[0]} at x{SCALE} and x{X8_SCALE}")
        data = tmp / "data"
        root = tmp / "runs"

        def changes(scale, pretrain=None, mode="pkl", **more):
            val = data / f"val_x{scale}"
            train_roots = ({"datasets.train.dataroot_GT": str(data / "pkl/tr.pklv4"),
                            "datasets.train.dataroot_LQ": str(data / f"pkl/tr_X{scale}.pklv4")}
                           if mode == "pkl" else
                           {"datasets.train.dataroot_GT": str(data / "npy/HR"),
                            "datasets.train.dataroot_LQ": str(data / "npy/LR")})
            return {**train_roots, "datasets.val.dataroot_GT": str(val / "HR"),
                    "datasets.val.dataroot_LQ": str(val / "LR"), "path.root": str(root),
                    "path.pretrain_model_G": pretrain,
                    "logger.save_checkpoint_freq": TRAIN_SAVE_FREQ,
                    "train.val_freq": TRAIN_STEPS, "logger.print_freq": 1, **more}

        def opt_file(tag, src, ch):
            log(f"  {tag}: configs/{src}, changed keys:")
            return _train_option_file(tmp / f"{tag}.yml", repo / "configs" / src, root, ch)

        def exp_dir(opt_path):
            return Path(config.parse(opt_path)["path"]["experiments_root"])

        n_val, n_sample = TRAIN_VAL_PAIRS, 3
        heats = 2
        # a validation: per image the forward and n_sample reverses a heat; x4 SR: 28 RRDBs
        # of 16 launches (bf16 encoders) and 4 float32 chains of 13 steps a reverse
        sr_val = dict(rrdb=28 * 16 * n_val * (1 + heats), chain_f32=4 * 13 * n_val * heats)
        x8_val = dict(rrdb=30 * 16 * n_val * (1 + heats), chain_f32=6 * 13 * n_val * heats)
        # rescaling (n_sample 1): the downscale 6 RRDBs, the upscale 6 RRDBs, 2 split-off
        # chains of 6 steps, 2 main chains of 1 + 5 x 8 launches
        rs_val = dict(rrdb=6 * 16 * n_val * (1 + heats), chain_f32=2 * 6 * n_val * heats,
                      chain3s_f32=2 * 41 * n_val * heats)
        _reset_counts()

        # 1. HCFlow (NLL only; act_norm_start_step 100: calibration every iteration)
        log("  run 1: HCFlow, NLL only, from the init (ActNorm calibration window active)")
        opt1 = opt_file("hcflow", "train_SR_DF2K_4X_HCFlow.yml", changes(SCALE))
        spec = config.model_spec_from_opt(config.parse(opt1))
        state, out["hcflow"] = _train_run(torch, "HCFlow", opt1, TRAIN_STEPS, sr_val,
                                          spec.init(0, device=DEV))
        exp1 = exp_dir(opt1)
        _expect_files("HCFlow", exp1, ["2_G.ckpt", "4_G.ckpt", "latest_G.ckpt"],
                      ["2.state", "4.state"])
        if state.step != TRAIN_STEPS or len(out["hcflow"]["pass_times_ms"]["calibrate"]) != 4:
            raise AssertionError(f"HCFlow: G step {state.step}, expected {TRAIN_STEPS}, and "
                                 "a calibration every iteration")

        # 2. HCFlow+ from run 1's latest_G.ckpt, then resumed to step 6
        log("  run 2: HCFlow+ from run 1's latest_G.ckpt")
        pre2 = str(exp1 / "models/latest_G.ckpt")
        opt2 = opt_file("hcflow_plus", "train_SR_DF2K_4X_HCFlow+.yml", changes(SCALE, pre2))
        state, out["hcflow_plus"] = _train_run(torch, "HCFlow+", opt2, TRAIN_STEPS, sr_val,
                                               checkpoint.load_any(pre2, spec.flow, device=DEV))
        log("  run 2b: HCFlow+ again with --max_steps 6: resume_state auto from 4.state")
        state, out["hcflow_plus_resumed"] = _train_run(torch, "HCFlow+ resumed", opt2,
                                                       TRAIN_RESUME_STEPS, sr_val)
        exp2 = exp_dir(opt2)
        # retention keeps the newest 2 of the *_G.ckpt names, latest_G.ckpt among them,
        # as the JAX package's loop does once a run has ended
        _expect_files("HCFlow+ resumed", exp2, ["6_G.ckpt", "latest_G.ckpt"],
                      ["4.state", "6.state"])
        passes = out["hcflow_plus_resumed"]["pass_times_ms"]
        if state.step != TRAIN_RESUME_STEPS or len(passes["nll"]) != 2:
            raise AssertionError(f"HCFlow+ resumed: G step {state.step} after "
                                 f"{len(passes['nll'])} NLL passes, expected 6 after 2")
        served = checkpoint.load_any(str(exp2 / "models/latest_G.ckpt"), spec.flow, device=DEV)
        same = all(torch.equal(a, b.detach()) for a, b in zip(trainer.tree_leaves(served),
                                                               trainer.tree_leaves(state.params)))
        log(f"    latest_G.ckpt through load_any equals the trained params exactly: {same}")
        if not same:
            raise AssertionError("HCFlow+: the written latest_G.ckpt differs from the params")
        trained_plus = trainer.detached(state.params)

        # 3. HCFlow++ from run 2's latest_G.ckpt
        log("  run 3: HCFlow++ from run 2's latest_G.ckpt (random-feature perceptual loss, "
            "D_init_iters 1)")
        opt3 = opt_file("hcflow_plusplus", "train_SR_DF2K_4X_HCFlow++.yml",
                        changes(SCALE, str(exp2 / "models/latest_G.ckpt"),
                                **{"train.feature_fallback": "random", "train.D_init_iters": 1}))
        state, out["hcflow_plusplus"] = _train_run(torch, "HCFlow++", opt3, TRAIN_STEPS, sr_val,
                                                   served)
        passes = out["hcflow_plusplus"]["pass_times_ms"]
        if (state.step != TRAIN_STEPS - 1 or len(passes["D"]) != TRAIN_STEPS
                or len(passes["feagan"]) != TRAIN_STEPS - 1):
            raise AssertionError(f"HCFlow++: G step {state.step}, passes "
                                 f"{ {k: len(v) for k, v in passes.items()} }")
        _expect_files("HCFlow++", exp_dir(opt3), ["2_G.ckpt", "4_G.ckpt", "latest_G.ckpt"],
                      ["2.state", "4.state"])

        # 4. rescaling, from the init
        log("  run 4: rescaling, from the init")
        opt4 = opt_file("rescaling", "train_Rescaling_DF2K_4X_HCFlow.yml",
                        changes(SCALE, mode="npy"))
        rspec = config.model_spec_from_opt(config.parse(opt4))
        state, out["rescaling"] = _train_run(torch, "rescaling", opt4, TRAIN_STEPS, rs_val,
                                             rspec.init(0, device=DEV))
        if state.step != TRAIN_STEPS:
            raise AssertionError(f"rescaling: G step {state.step}")

        # 5. x8 (CelebA-8X), from the init
        log("  run 5: x8 SR (CelebA-8X), from the init")
        opt5 = opt_file("x8", "train_SR_CelebA_8X_HCFlow.yml", changes(X8_SCALE))
        x8spec = config.model_spec_from_opt(config.parse(opt5))
        state, out["x8"] = _train_run(torch, "x8 SR", opt5, TRAIN_STEPS, x8_val,
                                      x8spec.init(0, device=DEV))
        if state.step != TRAIN_STEPS:
            raise AssertionError(f"x8 SR: G step {state.step}")
        torch.cuda.synchronize()
        launches = _counts()
        log(f"  launches in phase 10 (every validation): {launches}")

        # the kernel path's validation against the plain path's: the HCFlow+ params
        log("  HCFlow+ trained params: the Evaluator on the kernel path against the plain "
            "path, heat 0")
        vopt = config.parse(opt2)["datasets"]["val"]

        class Capture(Evaluator):
            def sample(self, *args):
                srs = super().sample(*args)
                self.srs.append(srs)
                return srs

        def validate(p):
            ev = Capture(spec, p, [0.0], device=DEV)
            ev.srs = []
            avg = ev.run(create_dataloader(create_dataset({**vopt, "phase": "val"}),
                                           {**vopt, "phase": "val"}),
                         torch.Generator(device=DEV).manual_seed(1))
            return avg["psnr@0.0"], ev.srs

        with torch.no_grad():
            packed = spec.flow.precompute_inference(trained_plus, fused=True)
            plain = spec.flow.precompute_inference(trained_plus, fused=False)
            # the control: one level's two trunk packs exchanged, as a packing fault would
            wrong = dict(packed, level1=dict(packed["level1"]))
            cond = wrong["level1"]["cond"] = dict(packed["level1"]["cond"])
            cond["trunk0_fused"], cond["trunk1_fused"] = cond["trunk1_fused"], cond["trunk0_fused"]
        (psnr_k, srs_k), (psnr_p, srs_p), (psnr_w, srs_w) = (validate(p)
                                                             for p in (packed, plain, wrong))
        paths = {}
        for name, srs, psnr in (("kernel path", srs_k, psnr_k), ("control", srs_w, psnr_w)):
            a, b = np.stack(srs), np.stack(srs_p)
            d = np.abs(a - b)
            r = dict(max_abs=float(d.max()), mean_abs=float(d.mean()),
                     max_ref=float(np.abs(b).max()), mean_ref=float(np.abs(b).mean()),
                     d_psnr=abs(psnr - psnr_p))
            r["within"] = dict(max=r["max_abs"] <= TRAIN_VAL_MAX_RTOL * r["max_ref"],
                               mean=r["mean_abs"] <= TRAIN_VAL_MEAN_RTOL * r["mean_ref"],
                               psnr=r["d_psnr"] <= TRAIN_VAL_PSNR_TOL)
            log(f"    {name} vs plain path, {len(srs)} images: max abs {r['max_abs']:.3e} of "
                f"max |plain| {r['max_ref']:.3e} (tol {TRAIN_VAL_MAX_RTOL:g} x), mean abs "
                f"{r['mean_abs']:.3e} of mean |plain| {r['mean_ref']:.3e} (tol "
                f"{TRAIN_VAL_MEAN_RTOL:g} x), PSNR {psnr:.5f} dB against {psnr_p:.5f}, "
                f"|difference| {r['d_psnr']:.2e} dB (tol {TRAIN_VAL_PSNR_TOL:g}); "
                f"within: {r['within']}")
            paths[name.split()[0]] = r
        if not all(paths["kernel"]["within"].values()):
            raise AssertionError("the kernel path's validation disagrees with the plain path's")
        if any(paths["control"]["within"].values()):
            raise AssertionError("the control (trunk packs exchanged) passed a validation "
                                 "limit: that limit cannot see a packing fault")
        out["paths"] = paths
    wall = time.perf_counter() - t_phase
    log(f"  phase 10 took {wall:.1f} s")
    out.update(launches=launches, wall_s=wall)
    return out


# name: (source, the Pallas call it replaces, what one unit of ms is, the CUDA kernels
# (__global__ functions) its launches run, by the names the profiler shows).  The
# wgmma tile conv's feature_kernel (conv3x3.cuh) is shared by rrdb and chain3s;
# tools/profile_port.py groups device time by these.
KERNELS = {
    "rrdb": ("hcflow_tpu_torch/csrc/rrdb.cu", "hcflow_tpu/ops/pallas_rdb.py:547",
             "x4 SR reverse pass + rescaling request (downscale + upscale)",
             ("to_dense_kernel", "feature_kernel", "residual_kernel")),
    "rrdb_trunk": ("hcflow_tpu_torch/csrc/rrdb_trunk.cu", "hcflow_tpu/ops/pallas_rdb.py:476",
                   "x8 SR reverse pass", ("trunk_kernel",)),
    "chain": ("hcflow_tpu_torch/csrc/chain.cu", "hcflow_tpu/ops/pallas_chain.py:360",
              "x4 SR reverse pass + rescaling request + x8 SR reverse pass",
              ("chain_step_mma_kernel",)),
    "chain3s": ("hcflow_tpu_torch/csrc/chain3s.cu", "hcflow_tpu/ops/pallas_chain3s.py:305",
                "rescaling request", ("prologue_kernel", "feature_kernel", "coupling_kernel")),
    "conv3x3": ("hcflow_tpu_torch/csrc/conv.cu", "hcflow_tpu/ops/pallas_conv.py:92",
                "one call at each of the x8 model's library 3x3 conv shapes (on no path)",
                ("pack_kernel", "conv_kernel")),
    # the chain kernel's variants beside its bf16 hid-64 one: float32 (CUDA-core fmaf)
    # at hid 64 and the bf16 and float32 ones at hid 32
    "chain_f32": ("hcflow_tpu_torch/csrc/chain.cu", "hcflow_tpu/ops/pallas_chain.py:360",
                  "x4 SR reverse pass of the trained HCFlow+ model (float32 couplings)",
                  ("chain_step_f32_kernel",)),
    "chain_hid32": ("hcflow_tpu_torch/csrc/chain.cu", "hcflow_tpu/ops/pallas_chain.py:360",
                    "x4 SR reverse pass of the tiny trained checkpoint, bf16 recipe",
                    ("chain_step_mma_kernel",)),
    "chain_hid32_f32": ("hcflow_tpu_torch/csrc/chain.cu", "hcflow_tpu/ops/pallas_chain.py:360",
                        "x4 SR reverse pass of the tiny trained checkpoint, float32 recipe",
                        ("chain_step_f32_kernel",)),
    # the float32 recipe's variants of the tile-conv kernels (3xTF32 products)
    "rrdb_f32": ("hcflow_tpu_torch/csrc/rrdb.cu", "hcflow_tpu/ops/pallas_rdb.py:547",
                 "x4 SR float32 pass + rescaling float32 request + tiny checkpoint float32 pass",
                 ("to_dense_kernel", "feature_kernel", "residual_kernel")),
    "rrdb_trunk_f32": ("hcflow_tpu_torch/csrc/rrdb_trunk.cu", "hcflow_tpu/ops/pallas_rdb.py:476",
                       "x8 SR float32 pass", ("trunk_kernel",)),
    "chain3s_f32": ("hcflow_tpu_torch/csrc/chain3s.cu", "hcflow_tpu/ops/pallas_chain3s.py:305",
                    "rescaling float32 request",
                    ("prologue_kernel", "feature_kernel", "coupling_kernel")),
}


def kernel_lines(rows, launches):
    """One entry a kernel; ms, plain_ms, bound_ms, bound_cuda_core_ms (float32 kernels,
    else None) and library_ms summed over the unit its "per" names."""
    out = []
    for name, (source, replaces, per, _) in KERNELS.items():
        rs = rows[name]
        tot = {k: sum(r[k] * r["calls_per_pass"] for r in rs)
               for k in ("ms", "plain_ms", "bound_ms")}
        share = {b: sum(r["bound_ms"] * r["calls_per_pass"] for r in rs if r["bound_by"] == b)
                 for b in ("bytes", "operations")}
        by = max(share, key=share.get)  # what bounds most of the least time
        library = [r["library_ms"] * r["calls_per_pass"] for r in rs if r["library_ms"] is not None]
        cuda_core = [r["bound_cuda_core_ms"] * r["calls_per_pass"] for r in rs
                     if "bound_cuda_core_ms" in r]
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(n[name] for n in launches.values()),
            "max_abs_err": max(r["err"] for r in rs),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": by, "library_ms": sum(library) if library else None,
            "bound_cuda_core_ms": sum(cuda_core) if cuda_core else None, "per": per,
            "launches_by_path": {p: n[name] for p, n in launches.items()}, "shapes": rs,
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write every result to this file")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from hcflow_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})", file=sys.stderr)
        return 1

    card = card_line()
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"{_io_modules()}")
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, text in reports.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line or "Compiling entry" in line:
                log(f"  {name}: {line.strip()}")
        # ptxas's wgmma notes: C7519 (a fence it added before a wgmma) and any warning
        # that it serialised the wgmma pipeline
        notes = [ln.strip() for ln in text.splitlines() if "C75" in ln or "erformance" in ln]
        log(f"  {name}: {sum('C7519' in ln for ln in notes)} ptxas C7519 notes (a fence it "
            "added before a wgmma)")
        for ln in notes:
            if "C7519" not in ln:
                log(f"  {name}: {ln}")
    log(f"  kernels built in {build_s:.1f} s: {', '.join(_build.KERNELS)}")

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = phase_kernels(torch, gen)
    log("phase 3: flagship x4 SR model, full width, bf16 serving recipe")
    sr = phase_sr(torch, gen, SCALE, LR_HW, HEAT, _per_request(rrdb=28 * 16, chain=4 * 13))
    log("phase 4: x4 rescaling model, full width, bf16 serving recipe")
    # per request: 6 RRDBs x 16 launches in each direction; 2 split-off chains of 6
    # steps; 2 main chains of 1 + 5 x 8 launches
    rs = phase_rescaling(torch, gen, _per_request(rrdb=2 * 6 * 16, chain=2 * 6, chain3s=2 * 41))
    log("phase 5: x8 SR model (CelebA-8X topology), full width, bf16 serving recipe, "
        "resident trunks")
    # per request: 2 trunks a level, one launch each; 2 chains of 13 steps a level
    sr8 = phase_sr(torch, gen, X8_SCALE, X8_LR_HW, X8_HEAT,
                   _per_request(rrdb_trunk=6, chain=6 * 13), resident=True)
    train = phase_train(torch, gen)
    tiny = phase_tiny(torch, gen)
    log("phase 8: the float32 serving recipe (no compute_dtype, as the shipped test configs "
        "configs/test_*.yml), full width: the RRDB, trunk and chain3s kernels in 3xTF32")
    log("  x4 SR (configs/test_SR_DF2K_4X_HCFlow.yml's topology)")
    sr_f32 = phase_sr(torch, gen, SCALE, LR_HW, HEAT,
                      _per_request(rrdb_f32=28 * 16, chain_f32=4 * 13), cd=None)
    log("  x4 rescaling (configs/test_Rescaling_DF2K_4X_HCFlow.yml's topology)")
    rs_f32 = phase_rescaling(torch, gen, _per_request(rrdb_f32=2 * 6 * 16, chain_f32=2 * 6,
                                                      chain3s_f32=2 * 41), cd=None)
    log("  x8 SR (configs/test_SR_CelebA_8X_HCFlow.yml's topology), resident trunks")
    sr8_f32 = phase_sr(torch, gen, X8_SCALE, X8_LR_HW, X8_HEAT,
                       _per_request(rrdb_trunk_f32=6, chain_f32=6 * 13), resident=True, cd=None)
    log("phase 9: the serving entry points (cli.test.main, the Evaluator, the tiled Predictor) "
        "at full width, float32 recipe")
    serve = phase_serving(torch, gen)
    log("phase 10: the training entry point (cli.train.main) at full width on the shipped "
        "training configs")
    train_cli = phase_train_cli(torch, gen)
    kernels = kernel_lines(rows, {"sr": sr["launches"], "rescaling": rs["launches"],
                                  "sr8": sr8["launches"], "train": train["launches"],
                                  "tiny_bf16": tiny["bfloat16"]["launches"],
                                  "tiny_f32": tiny["float32"]["launches"],
                                  "sr_f32": sr_f32["launches"],
                                  "rescaling_f32": rs_f32["launches"],
                                  "sr8_f32": sr8_f32["launches"],
                                  **{f"serve_{k}": serve[k]["launches"]
                                     for k in ("x4", "x8", "rescaling", "tiny", "predict")},
                                  "train_cli": train_cli["launches"]})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "build_s": build_s, "kernels": kernels, "model": sr,
                       "rescaling": rs, "sr8": sr8, "train": train, "tiny": tiny,
                       "sr_f32": sr_f32, "rescaling_f32": rs_f32, "sr8_f32": sr8_f32,
                       "serve": serve, "train_cli": train_cli}, f, indent=1, default=str)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shapes"}
                                  for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
