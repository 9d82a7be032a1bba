"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.  Phases:

1. print the card's name and power limit and whether PyYAML, OpenCV and Pillow import;
   build the five CUDA kernels from hcflow_tpu_torch/csrc with nvcc (sm_90a) and the
   zstd decoder with the host's C++ compiler, in parallel, and print the kernels' ptxas
   register, spill and wgmma lines and the build time;
2. hold each kernel against its plain PyTorch version on the card, at every shape of
   the main paths, with bf16 weights perturbed from a seed, and time both: the x4 SR
   path's RRDB (gc 32) at 40x40 and 80x80 and its four 13-step chains; the rescaling
   path's chain3s main chains (K 8, c 24 at 40x40 and c 12 at 80x80; and K 4, c 12
   at 2x37x53, where neither side is a multiple of the tiles or of 8), RRDB at gc 16
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
   longer to issue the sequence than the card to run it); each chain and bf16 chain3s
   row prints the kernel's tile plan, each chain3s row its device time (one call as a
   CUDA graph) beside the host-issued one;
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
11. data-parallel training, train.remat_steps and the flow-op inventory at full width:
   (a) a copy of phase 10's HCFlow+ config (from the init) trained for 4 iterations as
   one process and as world 1 on NCCL under torch.distributed.run, side by side, each a
   subprocess of this script (``--train-rank``) under
   torch.use_deterministic_algorithms: the params after every pass, the written
   latest_G.ckpt and 4.state equal bit for bit (an op without a deterministic CUDA
   version would be named, and the pair then held within 2 lr iterations); (b) the
   same config as 2 ranks on the one card over gloo (RANK 0 / 1, LOCAL_RANK 0, a global
   batch of 16, 8 a rank): the ranks' params bit-identical after every pass, only rank
   0 writing checkpoints and validating, ms per pass and peak memory per rank; then
   dryrun_multigpu(2, mesh_shape=(2, 1)) (two SR NLL steps, one with remat_steps, an
   HCFlow++ iteration, a rescaling step: each pass's all-reduced gradient within 1e-4 x
   max |g| of the one-process pass on the global batch in every leaf, the D loss within
   1e-5); (c) the x4 NLL step at full width with and
   without remat_steps: gradients within 1e-5 x max |g|, TF32 off in every conv's
   backward and in the recomputed convs, both peak memories; (d) the x4 SR model with
   flow_permutation shuffle and a reverse split-off permutation in the bf16 recipe,
   served fused: 28 RRDBs (448 launches) a pass through the RRDB kernel and no chain
   kernel launch (a permuted chain serves on the plain path), the kernel path within
   phase 3's limits of the plain path, the NLL forward finite; the validations' and
   (d)'s launches count in the kernels line;
12. spatially sharded serving at full width and batch 1 on a ('data', 'spatial') mesh of
   (1, 2): one parallel.dryrun.serve_spatial launch of 2 ranks on the one card over gloo,
   each serving its band of the image's rows with the halo exchange of parallel/halo.py,
   against the unsharded pass computed in this process first: (a) x4 SR in the bf16
   serving recipe, LR 512x512 -> HR 2048x2048 at heat 0.9, latents from one seeded
   generator (phase 3's limits, 5e-2 x max and 1e-2 x mean |unsharded|); (b) the same in
   the float32 recipe (1e-4 x max); (c) x8 SR bf16 with resident trunks, LR 256x256 -> HR
   2048x2048 at heat 0.8; (d) x4 rescaling bf16, HR 2048x2048 -> downscale -> quantize ->
   upscale at heat 1.0, LR and HR, and the LR's code flips against the unsharded LR's;
   (e) (a) with every halo one row short, which must break (a)'s limits; the shipped
   float32 recipes at (c)'s and (d)'s sizes: (f) x4 rescaling, the ranks upscaling the
   unsharded pass's 8-bit codes (ServeCase.codes), held in three parts: the LR before
   quantization (1e-4 x max), its code flips (reported), the HR from the same codes
   (1e-4 x max); beside it the round as served, each side from its own codes (max abs
   and the pixels past 1e-4 x max, held to it only where no LR value flips); (g) x8 SR
   with resident trunks (1e-4 x max); (h) (f) with every halo one row short, which must
   break (f)'s HR limit.  Each rank's kernel launches equal the unsharded pass's, its
   halo exchanges and bytes the count from the model's structure
   (dryrun.expected_exchanges); ms a pass (median of 3, CUDA events in the rank after a
   barrier) and peak memory a rank beside the unsharded pass's;
13. training on a ('data', 'spatial') mesh of (1, 2) at full width: one
   parallel.dryrun.dryrun_multigpu launch of 2 ranks on the one card over gloo, each
   holding a band of the images' rows (80 of GT 160), batch 2 (the configs' 16 cut for
   time over gloo), weights perturbed from a seed: (a) the x4 NLL step of
   HCFlowSRSpec.for_scale(4) in the shipped training recipe (bf16 encoders, float32
   couplings); (b) the pixel step; (c) the fea/GAN step and the D step
   (discriminator_vgg_160 in float64 on the gathered images, random VGG19 features on the
   bands); (d) the rescaling joint step, default_x4 at GT 160, its straight-through
   quantizer upscaling the one-process forward's 8-bit codes on every rank
   (dryrun.HeldCodes; the ranks' flips against them reported); (e) (a) and (f) (d) with
   every halo one row short.  Each pass's all-reduced gradient is held against the
   one-process pass on the global batch (computed in rank 0's process first, same
   params, noise and latents) in every leaf: ST_BF16_TOL x the leaf's max |g| for the
   bf16-encoder passes, ST_TOL for the float32 ones; (e) must break ST_BF16_TOL, (f)
   ST_TOL; the ranks' param digests equal after every pass.  Each rank's forward and
   backward halo exchanges and bytes, ms a pass (median of ST_REPS, CUDA events) and
   peak memory, beside the unsharded pass's, with the card's name and power limit;
14. the orbax checkpoint backend (utils/orbax.py, utils/ocdbt.py and the zstd decoder
   csrc/zstd_decode.cpp, built in phase 1 with the host's C++ compiler) at full width:
   (a) cli.train.main on a copy of configs/train_faces_x4_nll_onchip.yml, which keeps
   path.checkpoint_backend orbax and resume_state auto, on phase 10's synthetic
   LRHR_PKL data with only the dataroots, path.root, the save frequency (2), val_freq
   (4) and print_freq changed: 2 iterations with a save at 2, then --max_steps 4, which
   resumes from 2.state: the resumed params and Adam moments equal the saved ones bit for
   bit, list_checkpoints shows the directories retention keeps, one validation through
   the bf16 RRDB and float32 chain kernels; (b) 4_G.ckpt through load_any (equal to the
   trained params) and its pickle copy served on the kernel path at phase 3's shapes
   under the same latents: identical SR batches, exact launches; (c) cli.test.main on a
   copy of configs/test_faces_x4_onchip.yml serving that directory on 2 synthetic pairs;
   (d) three zstd frames tensorstore wrote (TS_FRAMES: Huffman literals, FSE sequences,
   more than one block) decoded to their pinned SHA-256; the seconds and MB/s of saving
   and loading the x4 _G.ckpt and .state through each backend, in turns;
15. widths the kernels hold no instance for, which the port packs zero-padded up to the
   next one (chain: coupling width up to 32 or 64; chain3s: growth 16, 32 or 64; RRDB:
   nf and gc 16, 32 or 64), at batch 16 from an LR of 40x40: configs/smoke_train.yml's
   model (float32, coupling width 8), x4 rescaling at growth 24 and x4 SR at coupling
   width 48 (bf16, full width and depth), the 3-level rescaling model (bf16; its level-2
   main chain, c 48, past chain3s's widths, serves on the plain step loop) and x4 SR cut
   to K 8 with trunks at nf 24 / gc 8 (float32) and gc 24 (bf16, resident): each
   model's launches held to those counted from its structure and the packs the card
   takes, its kernel path against its plain path (phase 3's limits, phase 8's in
   float32); the padded kernels' rows (calls_per_pass 0), each with its bound at the
   true widths (bound_ms) and at the padded ones (bound_padded_ms); cli.train.main on a
   copy of configs/smoke_train.yml (only the dataroots and path.root changed) on
   synthetic faces for its 10 iterations, through its one validation on the kernel
   path (the float32 chain kernel at coupling width 8, packed at 32);
16. print the kernels' JSON line, the card line, then the JSON status line last.

Phase 2 also holds the float32 kernels at phase 9's shapes (batch 1 at each image's
levels, the ragged LQ-only images, the Predictor's batch of 8 tiles; calls_per_pass 0,
so the kernels line's units do not change), every kernel of phase 12 at a rank's band
plus halo (calls_per_pass 0), and the variants against their plain
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
CHAIN3S_BORDER = (2, 37, 53)  # phase 2's ragged chain3s shape (B, H, W)
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
# phase 11: what torch.use_deterministic_algorithms(True, warn_only=True) says of an op
# without a deterministic CUDA version
PAR_NONDET = "does not have a deterministic implementation"
# the step factories of cli/train.py and the pass each one's steps make
TRAIN_PASSES = {"make_sr_nll_step": "nll", "make_sr_pixel_step": "pixel",
                "make_sr_feagan_step": "feagan", "make_d_step": "D",
                "make_rescaling_step": "rescaling"}
# phase 12: spatially sharded serving at batch 1 on a (1, 2) mesh, 2 ranks on the one card
# over gloo: x4 SR LR 512x512 -> HR 2048x2048 at heat 0.9 (bf16 and float32 recipes), x8
# SR LR 256x256 -> HR 2048x2048 at heat 0.8 (resident trunks), x4 rescaling HR 2048x2048
# -> LR 512x512 -> HR at heat 1.0 (x8 and rescaling in both recipes); the median of
# SP_REPS timed passes.  Sharded against unsharded: the bf16 paths within phase 3's
# kernel-vs-plain limits (MODEL_MAX_RTOL, MODEL_MEAN_RTOL), the float32 paths within
# F32_PATH_RTOL x max.  A float32 rescaling LR value within float32 rounding of a code
# boundary (k + 1/2) / 255 flips a code between the two passes (the LRs' difference d
# gives about 510 d flips a value), and the upscale moves near it by far more than
# F32_PATH_RTOL: so the float32 HR is held where both sides upscale the same codes.
SP_WORLD, SP_X4_LR, SP_X8_LR, SP_RS_HR, SP_REPS = 2, 512, 256, 2048, 3
# phase 13: training on a (1, 2) mesh, 2 ranks on the one card over gloo, GT 160 (bands of
# 80 HR rows, 20 LR rows), batch 2, the median of ST_REPS timed passes.  Each gradient
# leaf within ST_BF16_TOL (bf16 encoders) or ST_TOL (float32 models) x its own max |g| of
# the one-process pass; the halo controls (e) and (f) must break ST_BF16_TOL and ST_TOL.
# Measured on an H100 80GB HBM3 at 700 W (worst leaf): (a) 5.8e-3, (b) 5.8e-3, (c)
# fea/GAN 1.05e-2 - 1.16e-2 (bf16 encoders: cuDNN sums a band's convs in another order,
# and a bf16 rounding moves), D 1.2e-14 - 1.4e-14 (float64); the controls 9.3e-2 (e) and
# 5.9e-1 (f).  (d), float32, reads 3.08e-3 with or without its quantizer holding the
# one-process codes, and 0 fake LR values flip: not the quantizer.  Nor a halo: a
# one-process step that differs only by its convolutions' rounding (cuDNN off) reads the
# same worst leaves to four digits (1.41e-2 on tools/probe_rescaling_mesh.py's batch),
# and with the model's kinks smoothed (ReLU, leaky ReLU, L1) both read 4e-5 - 6e-5:
# float32 rounding decides which side of a kink a few activations take, as it decides a
# quantizer code.  So ST_TOL is 1e-2, 3x above (d) and 59x below (f); ST_BF16_TOL 3x
# below (e).  The whole gradient's max error over its max is also printed: the flow's
# ActNorm and invconv leaves dominate it, and it cannot see a halo.
ST_HR, ST_ROWS, ST_REPS = 160, 2, 3
ST_TOL, ST_BF16_TOL = 1e-2, 3e-2


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
    float tensor 0.02 * N(0,1).  The relative size keeps the 4 x 7 RRDBs from blowing
    up."""
    import torch

    if isinstance(tree, dict):
        return {k: perturb(v, generator, scale) for k, v in tree.items()}
    if isinstance(tree, list):
        return [perturb(v, generator, scale) for v in tree]
    if not tree.is_floating_point():  # a permutation's indices
        return tree
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
         library_seq=False, rtol=KERNEL_RTOL, padded_work=None, **extra):
    """Check one kernel call against its plain version and time both (and the one
    library call computing the same function, where there is one).  library_seq: the
    library_fn is a sequence of library calls, timed on the device as one CUDA graph
    (library_ms) and also as the host issues it (library_eager_ms).  work = (bf16
    FLOP, float32 FLOP, bytes) of the function; padded_work the same at the widths a
    padded pack runs it at (bound_padded_ms beside bound_ms, the function's).  Returns
    the kernel's output."""
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

    def least(bf, f32, nbytes):
        if bf:  # a bf16 row: bf16 tensor-core products, a float32 tail on the CUDA cores
            return bound(bf / PEAK_BF16 + f32 / PEAK_F32, nbytes)
        return bound(f32 / PEAK_3XTF32, nbytes)  # float32-accurate products as 3xTF32

    b_ms, b_by = least(*work)
    if bf:
        rate = f"{tflops:.1f} TFLOP/s"
    else:
        extra["bound_cuda_core_ms"] = bound(f32 / PEAK_F32, nbytes)[0]
        rate = (f"{tflops:.1f} TFLOP/s of float32 work; bound at the CUDA-core float32 rate "
                f"{extra['bound_cuda_core_ms']:.4f} ms")
    if padded_work is not None:
        extra["bound_padded_ms"], extra["bound_padded_by"] = least(*padded_work)
        rate += (f"; bound at the padded widths {extra['bound_padded_ms']:.4f} ms by "
                 f"{extra['bound_padded_by']}")
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
        es = 2 if cd else 4
        flops, nbytes = rrdb_work(B, H, W, nf, gc, es)
        nfp, gcp = rrdb.padded_widths(nf, gc)
        padded = None if (nfp, gcp) == (nf, gc) else rrdb_work(B, H, W, nfp, gcp, es)
        # the input of a pack at padded widths: x and zero channels
        xp = x if nfp == nf else torch.nn.functional.pad(x, (0, nfp - nf))
        _row(rows, key, f"{key} nf {nf} gc {gc} {B}x{H}x{W}x{nf}"
             + ("" if padded is None else f" (packed at nf {nfp} gc {gcp})"),
             lambda: rrdb.rrdb_apply(packed, xp), lambda: rrdb.rrdb_apply_plain(packed, xp),
             (flops, 0, nbytes) if cd else (0, flops, nbytes), 10, path, calls,
             library_fn=lambda: nets.apply_rrdb(lib, x, cd), library_seq=True,
             rtol=KERNEL_RTOL if cd else F32_RTOL, shape=[B, H, W, nf], gc=gc,
             padded_work=None if padded is None else ((padded[0], 0, padded[1]) if cd else
                                                      (0, padded[0], padded[1])),
             packed_widths=[nfp, gcp])


def _trunk_rows(torch, gen, rows, shapes, path, cd="bfloat16", key="rrdb_trunk", nf=64, gc=32,
                nb=X8_NB):
    """The resident trunk (by default nb 5, nf 64, gc 32) in the recipe cd against its
    plain version and against the per-RRDB kernel run nb times (bit-identical
    expected), timed beside it; at widths packed padded, through trunk_apply (its input
    padded once, its output cut once), with the bound at the padded widths beside."""
    from hcflow_tpu_torch.ops import nets, rrdb

    trunk = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(14), nb, nf, gc), gen)
    lib = _library_trunk(torch, trunk, cd)
    trunk = _to(trunk, DEV)
    res = rrdb.pack_rrdb_trunk(trunk, cd, resident=True)
    per = rrdb.pack_rrdb_trunk(trunk, cd)
    es = 2 if cd else 4
    nfp, gcp = rrdb.padded_widths(nf, gc)
    for hw, calls in shapes:
        B, H, W = _bhw(hw)
        x = torch.randn(B, H, W, nf, device=DEV, generator=gen)
        # the input of a pack at padded widths: x and zero channels
        xp = x if nfp == nf else torch.nn.functional.pad(x, (0, nfp - nf))
        label = (f"{key} nb {nb} gc {gc} {B}x{H}x{W}x{nf}"
                 + ("" if (nfp, gcp) == (nf, gc) else f" (packed at nf {nfp} gc {gcp})"))
        flops, nbytes = trunk_work(B, H, W, nf, gc, nb, es)
        padded = None
        if (nfp, gcp) != (nf, gc):
            pf, pb = trunk_work(B, H, W, nfp, gcp, nb, es)
            padded = (pf, 0, pb) if cd else (0, pf, pb)
        got = _row(rows, key, label, lambda: rrdb.trunk_apply(res, x),
                   lambda: rrdb.trunk_apply_resident_plain(res, xp)[..., :nf],
                   (flops, 0, nbytes) if cd else (0, flops, nbytes), 10, path, calls,
                   library_fn=lambda: nets.apply_rrdb_trunk(lib, x, cd), library_seq=True,
                   rtol=KERNEL_RTOL if cd else F32_RTOL, shape=[B, H, W, nf], gc=gc,
                   nb=nb, padded_work=padded, packed_widths=[nfp, gcp])
        ref = rrdb.trunk_apply(per, x)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        err = 0.0 if same else check_rel(f"{label} vs per-RRDB kernel", got, ref,
                                         KERNEL_RTOL if cd else F32_RTOL)
        per_ms = cuda_time(lambda: rrdb.trunk_apply(per, x), reps=10)
        log(f"    vs the per-RRDB kernel ({nb} x {rrdb.LAUNCHES_PER_RRDB} launches, "
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
        hp = chain.padded_hid(hid)
        B, H, W = _bhw(hw)
        z = torch.randn(B, H, W, c, device=DEV, generator=gen)
        uc = ucf = None
        if cond:
            u = torch.randn(B, H, W, cond_ch, device=DEV, generator=gen)
            ucf = stack.compute_u_contribs(spec, steps, u)
            uc = chain.pad_uc(pk, ucf)

        def library(z=z, ucf=ucf, steps=steps, spec=spec):
            with nets.exact_f32():
                for k in reversed(range(K)):
                    z = (spec.inverse_hoisted(steps[k], z, ucf[..., k * hid:(k + 1) * hid])
                         if ucf is not None else spec.inverse(steps[k], z))[0]
            return z

        plan = chain.plan(B, H, W, c, hid=hp, f32=f32)
        log(f"  {key} {name}: {plan['th']}x{plan['tw']} tiles, {plan['blocks']} blocks, "
            f"{plan['blocks_per_sm']} per SM, {plan['smem']} bytes of shared memory a block")
        _row(rows, key, f"{key} {name} {B}x{H}x{W}x{c} K={K}"
             + ("" if hp == hid else f" hid {hid} (packed at {hp})"),
             lambda: chain.inverse_chain(pk, z, uc), lambda: chain.inverse_chain_plain(pk, z, uc),
             chain_work(B, H, W, c, hid, K, cond, f32), 20, path, calls, library_fn=library,
             library_seq=True, rtol=F32_RTOL if f32 else KERNEL_RTOL, shape=[B, H, W, c],
             chain=name, K=K, hid=hid, plan=plan, packed_hid=hp,
             padded_work=None if hp == hid else chain_work(B, H, W, c, hp, K, cond, f32))


def _chain3s_rows(torch, gen, rows, K, chains, path, cd="bfloat16", key="chain3s", calls=1,
                  gc=32):
    """chain3s at growth gc in the recipe cd against its plain version, beside its step
    loop (FlowStepSpec.inverse over the K steps in the same recipe; float32 with TF32
    off) as one CUDA graph; each row with its device time (device_ms, one call as a CUDA
    graph) and, in bf16, the kernel's tile plan; at a growth packed padded, the bound
    at the padded growth beside."""
    from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
    from hcflow_tpu_torch.ops import chain3s, nets

    gcp = chain3s.padded_growth(gc)
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

        plan = chain3s.plan(B, H, W, c, gcp) if cd else None
        if plan:
            log(f"  {key} {name}: tiles (even, odd) " + ", ".join(
                f"{p['th']}x{p['tw']} ({p['blocks']} blocks, {p['smem']} bytes)"
                for p in (plan["even"], plan["odd"])))
        run = lambda: chain3s.inverse_chain(pk, z)  # noqa: E731
        _row(rows, key, f"{key} {name} {B}x{H}x{W}x{c} K={K}"
             + ("" if gcp == gc else f" gc {gc} (packed at {gcp})"), run,
             lambda: chain3s.inverse_chain3s_plain(pk, z),
             chain3s_work(B, H, W, c, gc, K, f32=cd is None), 10, path, calls,
             library_fn=library, library_seq=True, rtol=KERNEL_RTOL if cd else F32_RTOL,
             shape=[B, H, W, c], chain=name, K=K, plan=plan, gc=gc, packed_gc=gcp,
             padded_work=None if gcp == gc else chain3s_work(B, H, W, c, gcp, K, f32=cd is None))
        # the device's time of one call (a CUDA graph: without the host's issue)
        rows[key][-1]["device_ms"] = graph_time(run, reps=10)
        log(f"    device {rows[key][-1]['device_ms']:.4f} ms/call")


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
    log("  chain3s at a ragged shape, both recipes: H and W multiples of neither its tiles "
        "nor 8 (the fused halo's zero padding at the border), checked, not in the units")
    for cd, key in (("bfloat16", "chain3s"), (None, "chain3s_f32")):
        _chain3s_rows(torch, gen, rows, 4, [("border", 12, CHAIN3S_BORDER)], "border", cd=cd,
                      key=key, calls=0)
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
    log("  spatially sharded serving (phase 12): a rank's band plus its halo, batch 1, "
        "checked, not in the units above")
    _spatial_rows(torch, gen, rows)
    return rows


def _sp_band(lr_hw, f, halo):
    """(B, H, W) that a rank of phase 12 gives a unit reading ``halo`` rows each side at a
    level of f times the LR size: its band of the rows plus the halo from its one
    neighbour (2 ranks), batch 1."""
    h = lr_hw * f // SP_WORLD
    return (1, h + min(halo, h), lr_hw * f)


def _spatial_rows(torch, gen, rows):
    """The kernels at phase 12's shapes, calls_per_pass 0: the x4 SR path's RRDBs and
    chains in both recipes (LR 512), the x8 path's resident trunks and chains (LR 256)
    and the rescaling path's RRDBs, split-off chains and chain3s (LR 512), each in the
    bf16 recipe and in float32 as (f) and (g) serve them (their data from a generator of
    their own, so that the later phases draw what they drew before)."""
    from hcflow_tpu_torch.parallel.dryrun import RRDB_HALO, STEP_HALO

    fcn, dense = STEP_HALO["FCN"], STEP_HALO["DenseBlock"]
    x4, x8, rs = SP_X4_LR, SP_X8_LR, SP_RS_HR // SCALE
    k13 = 13 * fcn
    for cd, rk, ck in (("bfloat16", "rrdb", "chain"), (None, "rrdb_f32", "chain_f32")):
        _rrdb_rows(torch, gen, rows, 32, [(_sp_band(x4, f, RRDB_HALO), 0) for f in (1, 2)],
                   "spatial", cd=cd, key=rk)
        _chain_rows(torch, gen, rows, 13, 128, [("L1 cond", True, 21, _sp_band(x4, 1, k13)),
                                                ("L0 cond", True, 6, _sp_band(x4, 2, k13)),
                                                ("L1 main", False, 24, _sp_band(x4, 1, k13)),
                                                ("L0 main", False, 12, _sp_band(x4, 2, k13))],
                    "spatial", cd=cd, key=ck, calls=0)
    f32_gen = torch.Generator(device=DEV).manual_seed(1200)
    for cd, sfx, g in (("bfloat16", "", gen), (None, "_f32", f32_gen)):
        _trunk_rows(torch, g, rows, [(_sp_band(x8, f, X8_NB * RRDB_HALO), 0) for f in (1, 2, 4)],
                    "spatial", cd=cd, key="rrdb_trunk" + sfx)
        _chain_rows(torch, g, rows, 13, 128, [("L2 cond", True, 45, _sp_band(x8, 1, k13)),
                                              ("L1 cond", True, 12, _sp_band(x8, 2, k13)),
                                              ("L0 cond", True, 6, _sp_band(x8, 4, k13)),
                                              ("L2 main", False, 48, _sp_band(x8, 1, k13)),
                                              ("L1 main", False, 24, _sp_band(x8, 2, k13)),
                                              ("L0 main", False, 12, _sp_band(x8, 4, k13))],
                    "spatial", cd=cd, key="chain" + sfx, calls=0)
        _rrdb_rows(torch, g, rows, 16, [(_sp_band(rs, f, RRDB_HALO), 0) for f in (1, 2)],
                   "spatial", cd=cd, key="rrdb" + sfx)
        _chain_rows(torch, g, rows, 6, 64, [("L1 cond", True, 21, _sp_band(rs, 1, 6 * fcn)),
                                            ("L0 cond", True, 6, _sp_band(rs, 2, 6 * fcn))],
                    "spatial", cd=cd, key="chain" + sfx, calls=0)
        _chain3s_rows(torch, g, rows, 8, [("L1 main", 24, _sp_band(rs, 1, 8 * dense)),
                                          ("L0 main", 12, _sp_band(rs, 2, 8 * dense))],
                      "spatial", cd=cd, key="chain3s" + sfx, calls=0)


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


def _named(raw):
    """``dryrun.kernel_launches()``'s counts by KERNELS entry: the chain kernel's variants
    (bf16 at hid 64; float32 at hid 64; bf16 and float32 at hid 32), the RRDB, trunk and
    chain3s kernels' recipes (bf16, float32)."""
    by = raw["chain"]
    return {"rrdb": raw["rrdb"].get("bf16", 0), "rrdb_trunk": raw["rrdb_trunk"].get("bf16", 0),
            "chain": by.get("bf16 hid 64", 0), "chain3s": raw["chain3s"].get("bf16", 0),
            "conv3x3": raw["conv3x3"], "chain_f32": by.get("f32 hid 64", 0),
            "chain_hid32": by.get("bf16 hid 32", 0), "chain_hid32_f32": by.get("f32 hid 32", 0),
            "rrdb_f32": raw["rrdb"].get("f32", 0),
            "rrdb_trunk_f32": raw["rrdb_trunk"].get("f32", 0),
            "chain3s_f32": raw["chain3s"].get("f32", 0)}


def _counts():
    """Launches of every KERNELS entry since the last reset."""
    from hcflow_tpu_torch.parallel import dryrun

    return _named(dryrun.kernel_launches())


def _reset_counts():
    """Every kernel's launch counter (and the halo exchange counters) to 0."""
    from hcflow_tpu_torch.parallel import dryrun

    dryrun.reset_counters()


def _rs_main(f32=False):
    """chain3s launches of one of the rescaling model's main chains (K 8) in the bf16 or
    the float32 recipe."""
    from hcflow_tpu_torch.ops import chain3s

    return chain3s.launches_per_chain(8, f32)


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
    """Wrap nets.conv2d so that every conv records the TF32 flags its caller runs it
    under (forward, recomputations in the backward pass included) and its backward the
    flags it runs under; returns (the backward records, the forward records, a
    function that removes the wrapper)."""
    seen, fwd, conv2d = [], [], nets.conv2d

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            fwd.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
            return g

    nets.conv2d = lambda *a, **k: Probe.apply(conv2d(*a, **k))

    def undo():
        nets.conv2d = conv2d

    return seen, fwd, undo


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
            seen, _, undo = _tf32_probe(torch, nets)
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
        # split-off chains of 6 steps, 2 main chains of 8 steps), heat 1.0
        opt = _serve_option_file(tmp / "rs.yml", repo / "configs/test_Rescaling_DF2K_4X_HCFlow.yml",
                                 tmp, {"test_1": pairs("rs", "x4")})
        n = len(x4)
        log("  x4 rescaling, configs/test_Rescaling_DF2K_4X_HCFlow.yml (random init)")
        out["rescaling"] = _serve(torch, "x4 rescaling", opt, dict(
            rrdb_f32=2 * 6 * 16 * n, chain_f32=2 * 6 * n, chain3s_f32=2 * _rs_main(True) * n),
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


def _train_changes(data, root, scale, pretrain=None, mode="pkl", **more):
    """The keys phase 10 and 11 change in a shipped training config: the dataroots of
    ``_train_data``'s files (LRHR_PKL crops, or the .npy pairs), path.root, the
    pretrained G, a checkpoint every TRAIN_SAVE_FREQ, validation at TRAIN_STEPS, a
    progress line every iteration, and ``more``."""
    val = data / f"val_x{scale}"
    train_roots = ({"datasets.train.dataroot_GT": str(data / "pkl/tr.pklv4"),
                    "datasets.train.dataroot_LQ": str(data / f"pkl/tr_X{scale}.pklv4")}
                   if mode == "pkl" else
                   {"datasets.train.dataroot_GT": str(data / "npy/HR"),
                    "datasets.train.dataroot_LQ": str(data / "npy/LR")})
    return {**train_roots, "datasets.val.dataroot_GT": str(val / "HR"),
            "datasets.val.dataroot_LQ": str(val / "LR"), "path.root": str(root),
            "path.pretrain_model_G": pretrain, "logger.save_checkpoint_freq": TRAIN_SAVE_FREQ,
            "train.val_freq": TRAIN_STEPS, "logger.print_freq": 1, **more}


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
            return _train_changes(data, root, scale, pretrain, mode, **more)

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
        # chains of 6 steps, 2 main chains of 8 steps
        rs_val = dict(rrdb=6 * 16 * n_val * (1 + heats), chain_f32=2 * 6 * n_val * heats,
                      chain3s_f32=2 * _rs_main(True) * n_val * heats)
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


# -------------------------------------- phase 11: data parallelism, remat, inventory
def _train_rank(out, argv):
    """One process of phase 11's training runs (``chip_smoke.py --train-rank OUT <cli.train
    arguments>``, alone, under the launcher or as one of the ranks phase 11 starts):
    cli.train.main under torch.use_deterministic_algorithms(True, warn_only=True), its
    passes timed (CUDA events) and the params' digest taken after each, its checkpoint
    writes and the kernels' launches recorded; writes them to OUT as JSON."""
    import os
    import warnings

    import torch

    torch.use_deterministic_algorithms(True, warn_only=True)
    from hcflow_tpu_torch.cli import train
    from hcflow_tpu_torch.parallel.dryrun import digest

    rec = {"rank": int(os.environ.get("RANK", 0)), "passes": [], "digests": [], "saves": []}
    saved = {k: getattr(train, k) for k in (*TRAIN_PASSES, "save_model", "save_training_state")}

    def timed(kind, fn):
        def step(*a, **k):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out_ = fn(*a, **k)
            ev[1].record()
            torch.cuda.synchronize()
            rec["passes"].append((kind, ev[0].elapsed_time(ev[1])))
            rec["digests"].append((kind, digest(out_[0].params)))
            return out_

        return step

    def recorded(fn):
        def save(path, *a, **k):
            rec["saves"].append(os.path.basename(path))
            return fn(path, *a, **k)

        return save

    for factory, kind in TRAIN_PASSES.items():
        setattr(train, factory, lambda *a, _f=saved[factory], _k=kind, **k: timed(_k, _f(*a, **k)))
    train.save_model, train.save_training_state = (recorded(saved["save_model"]),
                                                   recorded(saved["save_training_state"]))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.reset_peak_memory_stats()
        state = train.main(argv)
        torch.cuda.synchronize()
    rec.update(step=state.step, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               launches=_counts(), world=int(os.environ.get("WORLD_SIZE", 1)),
               nondeterministic=sorted({str(w.message).split(" does not have")[0]
                                        for w in caught if PAR_NONDET in str(w.message)}))
    with open(out, "w") as f:
        json.dump(rec, f)
    return 0


def _pass_ms(rec):
    """ms per pass kind after its first call."""
    by = {}
    for kind, ms in rec["passes"]:
        by.setdefault(kind, []).append(ms)
    return {k: statistics.mean(v[1:]) if len(v) > 1 else v[0] for k, v in by.items()}


def _launch_ranks(cmds, envs, logs, timeout=600):
    """Start the commands side by side (stdout and stderr to the log files), wait for all,
    raise with a log's tail if one fails; every process ends before this returns."""
    import os

    procs = []
    try:
        for cmd, env, log_path in zip(cmds, envs, logs):
            with open(log_path, "w") as f:
                procs.append(subprocess.Popen(cmd, env={**os.environ, **env}, stdout=f,
                                              stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=timeout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log_path in zip(procs, logs):
        if p.returncode != 0:
            with open(log_path) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"{' '.join(map(str, p.args))} exited {p.returncode}:\n{tail}")


def phase_parallel(torch, gen):
    """Data-parallel training (world 1 on NCCL against one process, 2 ranks on the one card
    over gloo, dryrun_multigpu(2)), train.remat_steps at full width and the flow-op
    inventory's x4 SR model at full width on the kernel path."""
    t_phase = time.perf_counter()
    launches = _per_request()
    out = _ddp(torch, launches)
    out["remat"] = _remat(torch, gen)
    out["inventory"] = _inventory(torch, gen, launches)
    wall = time.perf_counter() - t_phase
    log(f"  phase 11 took {wall:.1f} s; launches {launches}")
    out.update(launches=launches, wall_s=wall)
    return out


def _ddp(torch, launches):
    """Phase 11 (a), (b) and the dry run; adds the runs' kernel launches to launches."""
    import sys
    import tempfile
    from pathlib import Path

    import numpy as np

    from hcflow_tpu_torch.parallel.dryrun import dryrun_multigpu, free_port
    from hcflow_tpu_torch.train import trainer
    from hcflow_tpu_torch.utils import checkpoint, config

    repo = Path(__file__).resolve().parent
    me = str(repo / "chip_smoke.py")
    out = {}
    n_val, heats = TRAIN_VAL_PAIRS, 2
    sr_val = _per_request(rrdb=28 * 16 * n_val * (1 + heats), chain_f32=4 * 13 * n_val * heats)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        _train_data(np, data, np.random.default_rng(11))
        base = {"CUBLAS_WORKSPACE_CONFIG": ":4096:8", "OMP_NUM_THREADS": "1",
                "PYTHONPATH": str(repo)}

        def opt_file(tag):
            log(f"  {tag}: configs/train_SR_DF2K_4X_HCFlow+.yml, changed keys:")
            return _train_option_file(tmp / f"{tag}.yml",
                                      repo / "configs" / "train_SR_DF2K_4X_HCFlow+.yml", None,
                                      _train_changes(data, tmp / tag, SCALE))

        def rank_args(tag, rank=0, *more):
            return ["--train-rank", str(tmp / f"{tag}{rank}.json"), "--opt", str(tmp / f"{tag}.yml"),
                    "--max_steps", str(TRAIN_STEPS), *more]

        def read(tag, rank=0):
            with open(tmp / f"{tag}{rank}.json") as f:
                rec = json.load(f)
            for k in launches:
                launches[k] += rec["launches"][k]
            return rec

        def leaves(path, spec):
            return trainer.tree_leaves(checkpoint.load_any(str(path), spec.flow, device=DEV))

        # (a) world 1 on NCCL under the launcher against one process
        log("  (a) HCFlow+ at full width, one process and world 1 on NCCL under "
            "torch.distributed.run, deterministic algorithms")
        for tag in ("single", "world1"):
            opt_file(tag)
        # side by side on the card: each run's results do not depend on the other, its
        # pass times do (the card and the host are shared)
        t0 = time.perf_counter()
        _launch_ranks([[sys.executable, me, *rank_args("single")],
                       [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", "1",
                        "--master_port", str(free_port()), me, *rank_args("world1")]],
                      [base, base], [tmp / "single.log", tmp / "world1.log"])
        single, world1 = read("single"), read("world1")
        log(f"    both runs side by side {time.perf_counter() - t0:.1f} s, from the start of the "
            "processes")
        spec = config.model_spec_from_opt(config.parse(str(tmp / "single.yml")))

        def exp(tag):
            return Path(config.parse(str(tmp / f"{tag}.yml"))["path"]["experiments_root"])
        nondet = sorted(set(single["nondeterministic"]) | set(world1["nondeterministic"]))
        a, b = (leaves(exp(t) / "models/latest_G.ckpt", spec) for t in ("single", "world1"))
        sa, sb = (trainer.tree_leaves(checkpoint.load_training_state(
            str(exp(t) / f"training_state/{TRAIN_STEPS}.state"), device=DEV)["params"])
            for t in ("single", "world1"))
        diff = max(max((x - y).abs().max().item() for x, y in zip(a, b)),
                   max((x - y).abs().max().item() for x, y in zip(sa, sb)))
        bitwise = diff == 0 and single["digests"] == world1["digests"]
        bound = 2 * TRAIN_OPT["lr_G"] * TRAIN_STEPS
        log(f"    ops without a deterministic CUDA version: {nondet or 'none'}; latest_G.ckpt and "
            f"{TRAIN_STEPS}.state params: max abs difference {diff:.3e}; digests after every "
            f"pass equal: {single['digests'] == world1['digests']}")
        if nondet and not diff <= bound:
            raise AssertionError(f"world 1 differs from one process by {diff} > 2 lr iterations")
        if not nondet and not bitwise:
            raise AssertionError("world 1 on NCCL differs from one process")
        for name, rec in (("one process", single), ("world 1", world1)):
            log(f"    {name}: ms per pass {_pass_ms(rec)}; peak {rec['peak_mem_gb']:.2f} GB; "
                f"saves {rec['saves']}; validation launches {rec['launches']}")
            _expect_launches(f"(a) {name} validation", rec["launches"], sr_val)
        out["world1"] = dict(bitwise=bitwise, max_abs_diff=diff, nondeterministic=nondet,
                             single_ms=_pass_ms(single), world1_ms=_pass_ms(world1),
                             single_peak_gb=single["peak_mem_gb"],
                             world1_peak_gb=world1["peak_mem_gb"])

        # (b) 2 ranks on the one card over gloo
        log("  (b) HCFlow+ at full width, 2 ranks on the one card over gloo (global batch 16, "
            "8 a rank)")
        opt_file("world2")
        port = free_port()
        t0 = time.perf_counter()
        _launch_ranks([[sys.executable, me, *rank_args("world2", r, "--dist_backend", "gloo")]
                       for r in (0, 1)],
                      [{**base, "RANK": str(r), "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                        "MASTER_ADDR": "localhost", "MASTER_PORT": str(port)} for r in (0, 1)],
                      [tmp / f"world2_{r}.log" for r in (0, 1)])
        ranks = [read("world2", r) for r in (0, 1)]
        log(f"    both ranks {time.perf_counter() - t0:.1f} s")
        for rec in ranks:
            log(f"    rank {rec['rank']}: ms per pass {_pass_ms(rec)}; peak "
                f"{rec['peak_mem_gb']:.2f} GB; saves {rec['saves']}; G step {rec['step']}")
        want = ["2_G.ckpt", "2.state", "4_G.ckpt", "4.state", "latest_G.ckpt"]
        if ranks[0]["saves"] != want or ranks[1]["saves"]:
            raise AssertionError(f"checkpoint writes {[r['saves'] for r in ranks]}: rank 0 "
                                 f"should write {want}, rank 1 nothing")
        if ranks[0]["digests"] != ranks[1]["digests"] or len(ranks[0]["digests"]) != 2 * TRAIN_STEPS:
            raise AssertionError("the ranks' params differ after a pass")
        if [r["step"] for r in ranks] != [TRAIN_STEPS] * 2:
            raise AssertionError(f"G steps {[r['step'] for r in ranks]}")
        _expect_launches("(b) rank 0 validation", ranks[0]["launches"], sr_val)
        _expect_launches("(b) rank 1 (no validation)", ranks[1]["launches"], _per_request())
        c = leaves(exp("world2") / "models/latest_G.ckpt", spec)
        drift = max((x - y).abs().max().item() for x, y in zip(a, c))
        log(f"    params bit-identical on both ranks after each of the {2 * TRAIN_STEPS} passes; "
            f"only rank 0 wrote checkpoints and validated; against the one-process run: max abs "
            f"{drift:.3e} (2 lr iterations = {bound:g})")
        out["world2"] = dict(ms=[_pass_ms(r) for r in ranks], peak_gb=[r["peak_mem_gb"] for r in ranks],
                             drift_vs_single=drift)

        # dryrun_multigpu(2): each pass kind's all-reduced gradient against one process
        t0 = time.perf_counter()
        rep = dryrun_multigpu(2, mesh_shape=(2, 1))
        log(f"  dryrun_multigpu(2, mesh_shape=(2, 1)) on the card (gloo, "
            f"{time.perf_counter() - t0:.1f} s): "
            + ", ".join(f"{k} {v['rel']:.2e}" for k, v in rep["passes"].items())
            + f" x max |g| (tol 1e-4); D loss rel {rep['d_loss']['rel']:.2e} (tol 1e-5); "
            f"params equal on both ranks after every pass: {rep['digests_equal']}")
        out["dryrun"] = {k: rep[k] for k in ("passes", "d_loss", "digests_equal", "calibrate_equal")}
    return out


def _remat(torch, gen):
    """Phase 11 (c): train.remat_steps on the x4 NLL step at full width."""
    import dataclasses

    from hcflow_tpu_torch.models import HCFlowSRSpec
    from hcflow_tpu_torch.ops import nets
    from hcflow_tpu_torch.train import schedules, trainer

    log("  (c) remat_steps: the x4 NLL step at full width (bf16 encoders), with and without")
    model = HCFlowSRSpec.for_scale(SCALE, encoder_dtype="bfloat16")
    hr, lr = _smooth_batch(torch, gen, LR_HW * SCALE)
    params = model.calibrate(model.init(0, device=DEV), hr, lr, generator=gen)
    noise = torch.rand(hr.shape, device=DEV, generator=gen)
    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    grads, peaks, remat = {}, {}, {}
    for on in (False, True):
        m = dataclasses.replace(model, flow=dataclasses.replace(model.flow, remat_steps=on))
        state = trainer.init_state(params, tx)
        step = trainer.make_sr_nll_step(m, tx, TRAIN_OPT["nll_weight"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        seen, fwd, undo = _tf32_probe(torch, nets)
        try:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            state, met = step(state, hr, lr, noise=noise)
            ev[1].record()
            torch.cuda.synchronize()
        finally:
            undo()
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev
        grads[on], peaks[on] = met["grads"], torch.cuda.max_memory_allocated() / 1e9
        again = trainer.init_state(params, tx)  # a second call, timed: the first builds plans
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(again, hr, lr, noise=noise)
        torch.cuda.synchronize()
        remat[on] = dict(first_ms=ev[0].elapsed_time(ev[1]),
                         ms=(time.perf_counter() - t0) * 1e3, peak_gb=peaks[on],
                         conv_forwards=len(fwd), conv_backwards=len(seen))
        if any(a_ or b_ for a_, b_ in seen + fwd):
            raise AssertionError(f"remat_steps {on}: a conv ran with TF32 allowed")
    scale = max(g.abs().max().item() for g in grads[False])
    err = max((x - y).abs().max().item() for x, y in zip(grads[True], grads[False]))
    log(f"    gradient with remat against without: max abs {err:.3e} of max |g| {scale:.3e} "
        f"(tol 1e-5 x); peak memory {peaks[False]:.2f} GB without, {peaks[True]:.2f} GB with; "
        f"NLL step {remat[False]['ms']:.1f} / {remat[True]['ms']:.1f} ms (second call each, "
        f"host clock; first {remat[False]['first_ms']:.1f} / {remat[True]['first_ms']:.1f}); "
        f"conv forwards {remat[False]['conv_forwards']} / {remat[True]['conv_forwards']} (the "
        f"recomputed ones), backwards {remat[False]['conv_backwards']} / "
        f"{remat[True]['conv_backwards']}, every one with TF32 off")
    if not err <= 1e-5 * scale:
        raise AssertionError("remat_steps changes the gradient")
    if not remat[True]["conv_forwards"] > remat[False]["conv_forwards"]:
        raise AssertionError("remat_steps recomputed no conv")
    return dict(max_abs_err=err, max_abs_grad=scale, **{str(k): v for k, v in remat.items()})


def _inventory(torch, gen, launches):
    """Phase 11 (d): the flow-op inventory's x4 SR model at full width, served fused;
    adds its launches to launches."""
    from hcflow_tpu_torch.models import HCFlowSRSpec

    log("  (d) x4 SR at full width, bf16 serving recipe, flow_permutation shuffle, splitOff "
        "reverse: served fused")
    model = HCFlowSRSpec.for_scale(SCALE, compute_dtype="bfloat16", flow_permutation="shuffle",
                                   so_flow_permutation="reverse")
    params = perturb(model.init(0, device=DEV), gen)
    fused = model.flow.precompute_inference(params, fused=True)
    plain = model.flow.precompute_inference(params)
    if any("main_fused" in fused[f"level{i}"] or "steps_fused" in fused[f"level{i}"]["cond"]
           for i in range(model.flow.L)):
        raise AssertionError("a permuted chain was packed for the chain kernel")
    L = model.flow.L
    lr = torch.rand(BATCH, LR_HW, LR_HW, 3, device=DEV, generator=gen)
    eps = [torch.randn(BATCH, LR_HW * 2 ** (L - 1 - lv.level), LR_HW * 2 ** (L - 1 - lv.level),
                       lv.cond_spec.a_channels, device=DEV, generator=gen)
           for lv in model.flow.levels]
    with torch.no_grad():
        model.flow.reverse_flow(fused, lr, HEAT, eps_list=eps)  # warm-up
        torch.cuda.synchronize()
        _reset_counts()
        got = model.flow.reverse_flow(fused, lr, HEAT, eps_list=eps)
        torch.cuda.synchronize()
        inv = _counts()
        _check_counts("inventory x4 SR reverse", inv, _per_request(rrdb=28 * 16), 1)
        p_max, p_mean = _compare_paths("inventory x4 SR reverse (same eps_list)", got,
                                       model.flow.reverse_flow(plain, lr, HEAT, eps_list=eps))
        hr, _ = _smooth_batch(torch, gen, LR_HW * SCALE)
        nll = model.forward(fused, hr, lr, noise=torch.rand(hr.shape, device=DEV, generator=gen))[1]
        torch.cuda.synchronize()
    fwd = {k: v - inv[k] for k, v in _counts().items()}
    log(f"    NLL forward on the fused params: {nll.item():.4f} bits/dim; launches {fwd}")
    if not torch.isfinite(nll) or fwd != _per_request(rrdb=28 * 16):
        raise AssertionError("the inventory model's NLL forward")
    ms, ts = _median_ms(lambda: model.flow.reverse_flow(fused, lr, HEAT, eps_list=eps), n=3)
    log(f"    reverse pass: median {ms:.3f} ms over 3 ({', '.join(f'{t:.3f}' for t in ts)}); 28 "
        "RRDBs a pass through the RRDB kernel (16 launches each), chain kernel 0 (the permuted "
        "chains serve on the plain path)")
    for k, v in _counts().items():
        launches[k] += v
    return dict(launches=inv, path_max_abs=p_max, path_mean_abs=p_mean, nll=nll.item(),
                pass_ms=ms, pass_times_ms=ts)


def _sp_check(name, got, ref, f32):
    """(max abs, mean abs, within the limits) of a sharded image against the unsharded
    one: float32 within F32_PATH_RTOL x max |unsharded|, bf16 within MODEL_MAX_RTOL x max
    and MODEL_MEAN_RTOL x mean."""
    import torch

    if tuple(got.shape) != tuple(ref.shape) or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: sharded output {tuple(got.shape)} not finite of shape "
                             f"{tuple(ref.shape)}")
    d = (got - ref).abs()
    max_abs, mean_abs = d.max().item(), d.mean().item()
    max_ref, mean_ref = ref.abs().max().item(), ref.abs().mean().item()
    if f32:
        ok, lim = max_abs <= F32_PATH_RTOL * max_ref, f"{F32_PATH_RTOL:g} x max"
    else:
        ok = max_abs <= MODEL_MAX_RTOL * max_ref and mean_abs <= MODEL_MEAN_RTOL * mean_ref
        lim = f"{MODEL_MAX_RTOL:g} x max, {MODEL_MEAN_RTOL:g} x mean"
    log(f"  {name}, sharded vs unsharded: max abs {max_abs:.3e} of max {max_ref:.3e}, mean abs "
        f"{mean_abs:.3e} of mean {mean_ref:.3e} (limits {lim}): {'within' if ok else 'BROKEN'}")
    return dict(max_abs=max_abs, mean_abs=mean_abs, max_ref=max_ref, mean_ref=mean_ref, ok=ok)


def _ms(x):
    return "not measured" if x is None else f"{x:.3f} ms"


def _gb(nbytes):
    return None if nbytes is None else nbytes / 1e9


def _sp_backend():
    """The backend of phases 12 and 13's ranks (parallel.dryrun.launch's choice)."""
    import torch

    return "nccl" if torch.cuda.device_count() >= SP_WORLD else "gloo"


def _sp_cards():
    if _sp_backend() == "nccl":
        return "a card a rank over NCCL"
    return "the 2 ranks share one card over gloo, so their ms say nothing of the gain across cards"


def _sp_past(name, got, ref):
    """The float32 HR of a rescaling round as served, each side from its own codes: the
    max abs difference and the pixels past F32_PATH_RTOL x max |unsharded|."""
    d = (got - ref).abs()
    lim = F32_PATH_RTOL * ref.abs().max().item()
    out = dict(max_abs=d.max().item(), past=int((d > lim).sum()), limit=lim)
    log(f"  {name}: max abs {out['max_abs']:.3e}, {out['past']} of {d.numel()} values past "
        f"{F32_PATH_RTOL:g} x max ({lim:.3e})")
    return out


def _sp_flips(name, lr, ref):
    """dryrun.code_flips of a sharded LR against the unsharded one, logged."""
    from hcflow_tpu_torch.parallel import dryrun

    f = dryrun.code_flips(lr, ref)
    log(f"  {name}: {f['flips']} of {f['values']} LR values flip a code against the unsharded "
        f"pass's (at most {f['steps']} code apart; largest LR difference at a flip "
        f"{f['lr_diff']:.3e})")
    return f


def phase_spatial(torch, gen):
    """Spatially sharded serving at full width, batch 1, on a (1, 2) mesh: 2 ranks on the
    one card over gloo (dryrun.serve_spatial), each its band of the image's rows, against
    the unsharded pass computed here first; (a) x4 SR bf16, (b) x4 SR float32, (c) x8 SR
    bf16 with resident trunks, (d) x4 rescaling bf16 (LR and HR; its LR's code flips
    reported), (e) (a) with every halo one row short, which must break (a)'s limits, (f)
    x4 rescaling float32 upscaling the unsharded pass's 8-bit codes: the LR, its flips
    against the unsharded LR's codes, and the HR from the same codes; the round as served
    (each side from its own codes) beside it, held only where no LR value flips; (g) x8
    SR float32 with resident trunks; (h) (f) with every halo one row short, which must
    break (f)'s HR limit.  Each rank's kernel launches must equal the unsharded pass's,
    its halo exchanges and bytes dryrun.expected_exchanges'."""
    import dataclasses

    from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
    from hcflow_tpu_torch.parallel import dryrun

    t_phase = time.perf_counter()
    cpu = torch.Generator().manual_seed(12)

    def params(model, g=gen):
        return _to(perturb(model.init(0, device=DEV), g), "cpu")

    # (f) and (g) draw from a generator of their own, so that later phases draw as before
    f32_gen = torch.Generator(device=DEV).manual_seed(1201)

    x4 = {cd: HCFlowSRSpec.for_scale(SCALE, compute_dtype=cd) for cd in ("bfloat16", None)}
    x8 = {cd: HCFlowSRSpec.for_scale(X8_SCALE, compute_dtype=cd) for cd in ("bfloat16", None)}
    rs = {cd: HCFlowRescalingSpec.default_x4(compute_dtype=cd) for cd in ("bfloat16", None)}
    lr4 = torch.rand(1, SP_X4_LR, SP_X4_LR, 3, generator=cpu)
    cases = {
        "a": dryrun.ServeCase(x4["bfloat16"], params(x4["bfloat16"]), lr4, HEAT, seed=1,
                              reps=SP_REPS),
        "b": dryrun.ServeCase(x4[None], params(x4[None]), lr4, HEAT, seed=2, reps=SP_REPS),
        "c": dryrun.ServeCase(x8["bfloat16"], params(x8["bfloat16"]),
                              torch.rand(1, SP_X8_LR, SP_X8_LR, 3, generator=cpu), X8_HEAT,
                              resident=True, seed=3, reps=SP_REPS),
        "d": dryrun.ServeCase(rs["bfloat16"], params(rs["bfloat16"]),
                              torch.rand(1, SP_RS_HR, SP_RS_HR, 3, generator=cpu), RS_HEAT, seed=4,
                              reps=SP_REPS),
    }
    cases["e"] = dataclasses.replace(cases["a"], halo_cut=1, reps=0)
    cases["f"] = dryrun.ServeCase(rs[None], params(rs[None], f32_gen),
                                  torch.rand(1, SP_RS_HR, SP_RS_HR, 3, generator=cpu), RS_HEAT,
                                  seed=5, reps=SP_REPS)
    cases["g"] = dryrun.ServeCase(x8[None], params(x8[None], f32_gen),
                                  torch.rand(1, SP_X8_LR, SP_X8_LR, 3, generator=cpu), X8_HEAT,
                                  resident=True, seed=6, reps=SP_REPS)
    per_request = {"a": _per_request(rrdb=28 * 16, chain=4 * 13),
                   "b": _per_request(rrdb_f32=28 * 16, chain_f32=4 * 13),
                   "c": _per_request(rrdb_trunk=6, chain=6 * 13),
                   "d": _per_request(rrdb=2 * 6 * 16, chain=2 * 6, chain3s=2 * _rs_main()),
                   "f": _per_request(rrdb_f32=2 * 6 * 16, chain_f32=2 * 6,
                                     chain3s_f32=2 * _rs_main(True)),
                   "g": _per_request(rrdb_trunk_f32=6, chain_f32=6 * 13)}
    refs = {}
    for k in "abcdfg":
        rec = dryrun.serve(cases[k], None, DEV)
        refs[k] = {**rec, "out": rec["out"].cpu(), "lr": None if rec["lr"] is None else
                   rec["lr"].cpu(), "launches": _named(rec["launches"])}
        del rec
        _check_counts(f"phase 12 ({k}) unsharded", refs[k]["launches"], per_request[k], 1)
        log(f"  ({k}) unsharded: {_ms(refs[k]['ms'])} a pass (median of {cases[k].reps}), peak "
            f"{_gb(refs[k]['peak_bytes'])} GB")
    # (f) upscales the unsharded pass's codes on the mesh; (f served) its own codes, as a
    # server would
    refs["f served"] = refs["f"]
    cases["f served"] = dataclasses.replace(cases["f"], reps=0)
    cases["f"] = dataclasses.replace(cases["f"], codes=dryrun.lr_codes(refs["f"]["lr"]))
    cases["h"] = dataclasses.replace(cases["f"], halo_cut=1, reps=0)
    order = ["a", "b", "c", "d", "e", "f", "f served", "g", "h"]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = dryrun.serve_spatial(SP_WORLD, [cases[k] for k in order])
    log(f"  {SP_WORLD} ranks (spawn, {_sp_backend()} group, {len(order)} cases): "
        f"{time.perf_counter() - t0:.1f} s")
    got = {k: [rank[i] for rank in ranks] for i, k in enumerate(order)}
    out, launches = {}, _per_request()
    for k in ("a", "b", "c", "d", "f", "f served", "g"):
        case, ref = cases[k], refs[k]
        rescaling = isinstance(case.model, HCFlowRescalingSpec)
        H, W = case.image.shape[1:3]
        f = SCALE if rescaling else 1
        exp_n, exp_b = dryrun.expected_exchanges(case.model.flow, (1, H // f // SP_WORLD, W // f),
                                                 SP_WORLD, resident=case.resident,
                                                 forward=rescaling)
        res = {"ranks": []}
        for r, rec in enumerate(got[k]):
            named = _named(rec["launches"])
            if named != ref["launches"]:
                raise AssertionError(f"({k}) rank {r}: launches {named}, unsharded "
                                     f"{ref['launches']}")
            if rec["exchanges"] != exp_n or rec["bytes"] != exp_b:
                raise AssertionError(f"({k}) rank {r}: exchanges {rec['exchanges']} of "
                                     f"{rec['bytes']} bytes, counted {exp_n} of {exp_b}")
            for n in launches:
                launches[n] += named[n]
            res["ranks"].append(dict(launches=named, exchanges=rec["exchanges"],
                                     bytes=rec["bytes"], ms=rec["ms"], times_ms=rec["times_ms"],
                                     peak_gb=_gb(rec["peak_bytes"])))
            log(f"  ({k}) rank {r}: launches as unsharded; {sum(exp_n.values())} exchanges "
                f"{exp_n}, {sum(exp_b.values()) / 1e6:.3f} MB sent, as counted; "
                f"{_ms(rec['ms'])} a pass ({', '.join(f'{t:.3f}' for t in rec['times_ms'])}) "
                f"against {_ms(ref['ms'])} unsharded; peak {_gb(rec['peak_bytes'])} GB "
                f"against {_gb(ref['peak_bytes'])} GB")
        f32 = case.model.flow.compute_dtype is None
        image, lr = got[k][0]["image"], got[k][0]["lr_image"]
        ok = True
        if rescaling:
            res["lr"] = _sp_check(f"({k}) LR", lr, ref["lr"], f32)
            res["flips"] = _sp_flips(f"({k}) LR", lr, ref["lr"])
            ok = res["lr"]["ok"]
        if k == "f served":  # each side from its own codes: held only without flips
            res["hr"] = _sp_past("(f served) HR, each side from its own codes", image, ref["out"])
            res["hr"]["held"] = res["flips"]["flips"] == 0
            if res["hr"]["held"]:
                res["hr"].update(_sp_check("(f served) HR, no LR value flipped", image,
                                           ref["out"], f32))
                ok = ok and res["hr"]["ok"]
        else:
            what = " from the unsharded pass's codes" if case.codes is not None else ""
            res["hr"] = _sp_check(f"({k}) HR{what}", image, ref["out"], f32)
            ok = ok and res["hr"]["ok"]
        if not ok:
            raise AssertionError(f"({k}): the sharded pass disagrees with the unsharded one")
        res.update(unsharded_ms=ref["ms"], unsharded_times_ms=ref["times_ms"],
                   unsharded_peak_gb=_gb(ref["peak_bytes"]), exchanges=exp_n, bytes=exp_b,
                   launches=ref["launches"])
        out[k] = res
    out["e"] = _sp_check("(e) every halo one row short (a control)", got["e"][0]["image"],
                         refs["a"]["out"], False)
    if out["e"]["ok"]:
        raise AssertionError("(e): a halo one row short stays within (a)'s limits")
    out["h"] = _sp_check("(h) (f) with every halo one row short (a control), HR from the "
                         "unsharded pass's codes", got["h"][0]["image"], refs["f"]["out"], True)
    if out["h"]["ok"]:
        raise AssertionError("(h): a halo one row short stays within (f)'s HR limit")
    wall = time.perf_counter() - t_phase
    log(f"  phase 12 took {wall:.1f} s; {_sp_cards()}; launches {launches}")
    out.update(launches=launches, wall_s=wall)
    return out


def _st_plan():
    """Phase 13's passes: the ++ iteration of the full-width x4 model in the shipped
    training recipe and the full-width rescaling model, at GT ST_HR, ST_ROWS images."""
    from hcflow_tpu_torch.parallel import dryrun

    return dryrun.TrainPlan(nll=None, plusplus=dict(encoder_dtype="bfloat16"), rescaling={},
                            hr=ST_HR, rs_hr=ST_HR, rows=ST_ROWS, reps=ST_REPS, keep=False)


def _fwd_bwd(counts):
    """(forward, backward) totals of a rank's exchange counters."""
    return (sum(v for k, v in counts.items() if not k.endswith(".grad")),
            sum(v for k, v in counts.items() if k.endswith(".grad")))


def phase_spatial_train(torch, card):
    """Training on a (1, 2) mesh at full width: 2 ranks on the one card over gloo
    (dryrun.dryrun_multigpu with _st_plan()), each a band of the images' rows: (a) the x4
    NLL step (bf16 encoders, float32 couplings), (b) the pixel step, (c) the fea/GAN and
    D steps, (d) the rescaling joint step (its quantizer upscaling the one-process
    forward's 8-bit codes; the ranks' flips against them reported), each pass's
    all-reduced gradient against the one-process pass in every leaf; (e) (a) and (f) (d)
    with every halo one row short must break (a)'s and (d)'s limits.  Raises on a failed
    check (dryrun_multigpu raises on its own)."""
    from hcflow_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    rep = dryrun.dryrun_multigpu(SP_WORLD, cpu=DEV == "cpu", tol=ST_TOL, mesh_shape=(1, SP_WORLD),
                                 plan=_st_plan(), bf16_tol=ST_BF16_TOL)
    wall = time.perf_counter() - t0
    labels = {"plusplus_nll": "(a) NLL", "pixel": "(b) pixel", "feagan": "(c) fea/GAN",
              "D": "(c) D", "rescaling": "(d) rescaling joint"}
    out = {"card": card, "wall_s": wall, "mesh": rep["mesh"]["shape"], "passes": {}}
    digests = dict(rep["digests"])
    for name, label in labels.items():
        p, ranks = rep["passes"][name], [r[name] for r in rep["ranks"]]
        log(f"  {label}: worst leaf {p['max_abs_err']:.3e} of max |g| {p['max_abs_grad']:.3e}, "
            f"{p['rel']:.3e} x (limit {p['tol']:g}); over the whole gradient's max "
            f"{p['whole']:.3e} x; digests equal on both ranks "
            f"({digests[name][:12]}); [{card}]")
        ref = p["ref"]
        for r, rec in enumerate(ranks):
            (nf, nb), (bf, bb) = _fwd_bwd(rec["exchanges"]), _fwd_bwd(rec["bytes"])
            log(f"    rank {r}: {nf} forward exchanges ({bf / 1e6:.3f} MB sent), {nb} backward "
                f"({bb / 1e6:.3f} MB) {rec['exchanges']}; {_ms(rec['ms'])} a pass "
                f"({', '.join(f'{t:.3f}' for t in rec['times_ms'])}), peak "
                f"{_gb(rec['peak_bytes'])} GB; unsharded {_ms(ref['ms'])} "
                f"({', '.join(f'{t:.3f}' for t in ref['times_ms'])}), peak "
                f"{_gb(ref['peak_bytes'])} GB [{card}]")
        out["passes"][name] = dict(
            label=label, rel=p["rel"], max_abs_err=p["max_abs_err"], max_abs_grad=p["max_abs_grad"],
            tol=p["tol"], whole=p["whole"], unsharded_ms=ref["ms"], unsharded_times_ms=ref["times_ms"],
            unsharded_peak_gb=_gb(ref["peak_bytes"]),
            ranks=[dict(exchanges=rec["exchanges"], bytes=rec["bytes"], ms=rec["ms"],
                        times_ms=rec["times_ms"], peak_gb=_gb(rec["peak_bytes"]))
                   for rec in ranks])
    fl = rep["passes"]["rescaling"]["flips"]
    log(f"  (d) the quantizer upscales the one-process forward's codes: {fl['flips']} of "
        f"{fl['values']} fake LR values on the ranks flip a code against them (at most "
        f"{fl['steps']} apart; largest LR difference at a flip {fl['lr_diff']:.3e}) [{card}]")
    controls = rep["controls"]
    for name, label in (("plusplus_nll", "(e) (a)"), ("rescaling", "(f) (d)")):
        c = controls[name]
        log(f"  {label} with every halo one row short (a control): worst leaf "
            f"{c['max_abs_err']:.3e} of max |g| {c['max_abs_grad']:.3e}, {c['rel']:.3e} x: "
            f"breaks {label[4:]}'s {c['tol']:g}; over the whole gradient's max {c['whole']:.3e} "
            f"x [{card}]")
    log(f"  D loss on the ranks within {rep['d_loss']['rel']:.3e} of one process's; phase 13 "
        f"took {wall:.1f} s; {_sp_cards()}; no kernel runs in training (the plain path)")
    out["passes"]["rescaling"]["flips"] = fl
    out.update(controls=controls, d_loss=rep["d_loss"], digests_equal=rep["digests_equal"])
    return out


# ------------------------------------------- phase 14: the orbax checkpoint backend
ORBAX_SAVE_AT, ORBAX_STEPS = 2, 4
ORBAX_TURNS = ("orbax", "pickle", "pickle", "orbax")  # the save / load timings' order
# zstd frames that tensorstore's zarr driver wrote as chunks (compressor zstd): (what, decoded
# bytes, SHA-256 of the decoded bytes, the frame as hex)
TS_FRAMES = (
    ("132000 bytes of text, level 3: Huffman literals in 4 streams, FSE sequences, 2 blocks",
     132000, "ebe11e37167f33d17e85d0546fc87b4dc98852b877b53e8505bbbd2f481d6bbf",
     "28b52ffd0040a48f00565c481490650704a21da61f1cbf2695c8ddddf9f4fa971c4300410041009c2e509bf7c9d1"
     "a8242f38299fd61befcd1ca883ed7bc9879ceb651e771eb81707430e14d3233db5277284f80984d62a3e58030757"
     "defdfa6ea6279037ee372703a202b15fa07bb0bc0c064f98d436c78136d093e151ad2def1ad98a5fc28f53f1539c"
     "887c0f1fe007cf1d238337cdbedb1b21fb40d284933f1c750e55d78b346c3ab0347db6dd77d0b73a1c29f50ef0fc"
     "74eaab15395a2f9ef79ee312e3728c171c6063594972243ee9388dd8dbecb3ef4d0959b11c28a4a560f2082d78b9"
     "8b9974e754472235221ecf392a941facf3056943f847ef84889430e7b217ba1dd0d7c5a423670bad16e99c8c8b7b"
     "59d9f9b0a2fda7ce1b8d9fb08a319c996ef64a96094a202f038822a8d4bfff0f280310204004e304478cf9001400"
     "00015e0001fe320454a245200002a02a82403b493f4322a7ec037ffaa35bbf85717ea0c62800fd9e63c58a546dea"
     "ec7da0560f4b7202f0194d5ac116c9f6108364b59242857be456ac859a2726722a8c711350bfaf363b6cd7c537b5"
     "8b7010b4b02ceffce4c025b303c00211e3e66d5553041f1b80fa3b5a6649b468284d23afcdc671599a77a8d7b069"
     "04f1e9deec575a79b27d048e6a445ab5ba86cf08823c6861d6f5da70dc957a2b76ef63f464c32f6de13e9b0bdd83"
     "a0ff034db78aa362826b4d2aac91a458b0a68e64359d5207c3a325e7f16df7fa5dfe613cd91ef976a71ef97a7f7f"
     "0a54ac2040417fc6870002c983e78cadb06befd680e0a42a9be1e95561a5be491f2442024ece685554f09256248c"
     "d48f3d601bac476de291d3eecd2e95d24a29eee948099e3fd90874f3244028b2b537f6f524148288b8c3dae61877"
     "27f732c92b96bc4b815a0c4ba3071f08cc08766a2ba1401061b4e7f47554da6a1d6101d62fa005bb23ea29620735"
     "da755248f4757393de08a9961e4527fc8e533409f9bac1cb7b72db043dc91927801d2584157637317642617b32d4"
     "8a4b64f5b72df43f87d34e3f014f7cbf0a8437dd2f4886c4ca92b8a64e84fd3c20628fc7ad191003680698a8cc99"
     "948bf52d7f7d8d74236ad5aab35f7d6258c0c5c49ebb521658f133066b252afe23d31a14b561ac4241567a8a5bc2"
     "3af57fc24a1d24471130cb81c19c995e0be64b6fbd544b9a26b84887d5c2b499d1514fad950a3f72ae792ab56206"
     "dd1d3e28dd43e51bc1afadec537b49aa5fa74570242ac35f34dfd9ed7c10796e453a7b929f23b7888fbb79547016"
     "25ace43aa74d406603a4d4cb25505f27a6038070f9b19240bf4e8bf83a63dd7db57fc70d91b322dfd0e6775e12b5"
     "a7121e6b509e1b199179ba2cfbcad90c8d610eb9b0ac9e80babe9237de50043a054b5410e0a0424c4d3c96231805"
     "589bde2c0fd09b38956211b768ace367cd3ef43125eee14662e968b524ac0d2829f993700167884e454f51b7a640"
     "4dc931be0aea27bb99d0a7a1e0c9681c8ea05b992672ea85184054a10fe1f49f96025ada86d9f07a23a60a6ea6b5"
     "fd1d50ebfc20491bec7260657afa16df93fb8c5d549f17096ed344ef23a84014654493f9971e06c21292fd00a04d"
     "cf651f3250322bb3ecb7ae72c86400e145d2b35e9af2f268743d1ca5364c402d4dcc16dcbf788902ed24f6c96760"
     "710cf85c82fbefa45abbc3538779aee3cac491b593fd1b920ec4076e91a999a854d18fe3cd5a162f862840ddd7ce"
     "4e944f9311b5a995ea491976d046ac9e96a6a21ee12a5ea835b1d469891c01024acf2e2a37273e7703ad7bb14a21"
     "960c3165a46c3105cd5be9d392d0bfa90e38e815246721cdfa795ab80baab26b356d4d0c21b3147bb1cddb377069"
     "99b20bf1a8a366d948f2f058728cf7a47a6b8267043725d015595a180f63cce484dc2e2786044c5ce3aa5f21e579"
     "8202aaf9029cc280538fe2bb444e37e7a37f3692ebb2d6cd601d49eaf34e5705ba1d1eb08b4b7e1b649640c6bdb5"
     "4be26bc23c5bbb019e972df9f4ab68718fec65a48b0df7bf8d1f789e2795f19ef443df5b564f62c2158067f86145"
     "98d8362d1fa240829ea9cb51fb31e989d22829844ba1f6d2adc5b05c9fb250d1fa96394a070ce01297272f10bad7"
     "c54fab3599bb05054fa9a819abcf142aad880a7fe4916d2ed49d8cfb579c546981491dbc35ad98da4669c94911f2"
     "901b33bacab1e59374155330440701092ac4d4e9450478145073c0a4067abb4e4514ad39671dbcaa6e9bf9fc4565"
     "e3709b8b49f61c576656672fb0087ee58bdaa86b026581c0bd259ff6e3ec33dc5617d617356da5d66b63b27e3080"
     "93de2e522d550ecdd077646215444775e3804c7dfd5357ba9efcf1902de2630f38f545dbf2368bfe91ea7c41af0e"
     "394a69d34fd3c2ece5530672268b3800551127c00149a7126913ab404c0fd0a6977a29551c0e3398b26ca0dbaa07"
     "fdd5a172681fd753459ce62da947baa0bfc96fc9c039c72f0d40d75b572a656e4ee2600ed2dc77f3eeadb9271522"
     "24a689f61677f78f506c685a2ca1d533388ff0d614a677c5c90a53a5a500246cec6af2927274992867b86ef4ec9f"
     "3103d667f3d407e141f0e1b2e766c433162997e44c0184ff65ee518544665c5ba7076cd00702f67a5df2830ee365"
     "90a16b1401d5521e7362a99492c76c04947b789a7bea69cb6454ec223642a9a29ca9afaad43a2d1b9622a5a9c6c8"
     "a17bbb4e45a489314675ec161e9bbb63ca346b6d0c8e23a4a347d3a5048a45e5b467d67a54f1bffe1388cc1d11db"
     "670a15959b96ca875fd82bc1a69caecb8f7a0cbba54a94ff4a13f417cb86b12561fd0e2d6ada126a95393c8b1bb6"
     "da5e22864a37d28d2a912445e1959b2c2ae5a1a67576d65638431c54ead84107870e9815486c93a7c100c8d1cba6"
     "dd8ff39951325241373da54e659321b31a134766767ccbefe15cd026feb78624290878caebb3a77c090b921c943d"
     "b54fd435a3cd55675300fa85b4507f9b9607ad4dfbc4bbebe67dd8d30a22219938a9d98942236cf8910182f68a3a"
     "d26a390cf656ae65887af813284bd006e6a79393dadb7b6aa3275da01f47a88eebaf8162e898c28b34c859284e0b"
     "c551198213ff66072dc0a06904b47c98d62590b146be270fde914a28cf8d7bdc895e9b4d42e16d5cb1598dbdc422"
     "fc155df446cd2ccb02997b4bba76a47d86f3add5e056de54a5fd0a87aff83d5ae00f23fad20730a0a17c0e86cd4c"
     "169c25278af9613321d728d72356059a94d16fcfba40cc087a22484bff0ce9a16b8a086479f80cd32844b77fed8b"
     "9347000b2628b1e27769813a2e61df86ce93668c394790a842d62c251528349927625a3415cf0874709d7a53042e"
     "eaf147bc21bb0b18a747a50fa898e1f3fb52c0207f5807a8cf5f3fbfdc546a374469a9b20a11a82785255258f3fe"
     "e32ae0bcf9b02da04762da15ecbb0bac0813daa6e5431588d03b75296a3f463d411a1d857429b63068028fa56a2c"
     "42c190b7cca37461c02eb11c5481ccbd5d7264bb2dc37181a0e4df0b52f6149eb041e4e169109d4d55e0e93c5f06"
     "349d5a4168f2152afaa36eb84203057b3feecd80d88dde001795358768ee3451e34a6195e6d617217a82f8b0f984"
     "8b7412ab0016bdc5a6164a6043bc0e1aba4779a9c86b2ab79081ea3d526165a58c79af54bc2c84bef97be26fa45b"
     "f24f1da0acb12b68cc852951122f9b9844efc153fbece0106a56e7a897f99ebfb94a74b9747950ae5dd1e8ade821"
     "05e539054dcd161ba428c8595901af5bc45a082fc904dafda9d88013c934b51483fe9114bacbe9570240eb10cbaa"
     "6d7f34fbfff864370b0900626782f03de2212ebddda71a6fd521f1718cacb9457de804f0a9554f532918358122ed"
     "2e5426f88b1837a79f4e0bf7a38bc7ec4c5975ed8be8e287bfde3e5301e9b89c7f87ac8afbcf5eca86783c84398f"
     "3d453fad7a45db5ef222d3371490895e5f9c586b294902a5273a4f8039c0f4e63eda674369696bc554d491a43553"
     "6a8a5d38055cc9153d0960aad5332cab6624142972b6c5f82f6cdc2a974b81a72cb9b652f9f6abb7f7d4447dda36"
     "97831782d33b93468d31454f6490b2a0d9877d8cea2eda363acb82483f4fd0f04993a2b2016c2040cc87e8b5c289"
     "d31a193c472ac90134add4d4484ad216bce7d8a37f5029b7fe142a614184c2caaabd8014305d2955b3e46e37db89"
     "125d04e6d15b335570a82bee3b62b73eb2d24efbf453b490d6f1621d00f840abcd6db4cb86d7d2d6caa828474a6b"
     "86d48c349a82a84415f3042f6caad52a03ed06f509b064a6a58f81b004e4e90114d4db61ad88278679055a16204e"
     "7fc63de5dbc49e9fb340c0388a8551ec566246a4301b826841e9093453f53f78dbcbc599a619e48d8ae5edd47e8f"
     "dfc2c97fea4c1820a2705f4d94c559bf708338617229cf224e63965e130915524f57759f1e3435964e3135156524"
     "52bd8cda110ab2a6168ad1b83d9002b41030bd39554a0908acc63a447fb4eaff45f1e6b83b56dc27b827ee46ba25"
     "f1c401ea1abb82b6dc4f8925494ca8fc3dc8d4fcc4e243a4599cdfe915f6574354e6a304945acec9bc972e06cc12"
     "c9b20590a5b7155244da645009590d5ee5680de00ba994c54fd3227e57f60c64c1602914b9779d043d8c1a984c2e"
     "19abba4cbcbdb1d2c3d0534498b24104905af04c79abccbe260b5534a45ae7a00474d49be3a7ea1f312dae111434"
     "9ba56b4c7d1316043b3c11439f6df4831b135ef5bdb290faa101667aab4aa5f4583a217348d15c48fa069fdd535d"
     "95e53921ea09105ec0c208307ad667fca8c99ce5d65898d55587839fa50d87f03b8d6b04e8c768269e171af88c1a"
     "f242d7a35be02953018e70d10959a403c5ff405b895d7ad421af8c9ebf1a2ff6c4a90d02005184cedbd471420830"
     "0c35e618a4cad88011ca2ef8ef094635ae94ac9e5e5a11ea8aedf5416d48da0121f572a2b51c98986a488def0029"
     "8312d2a3249e013ad61b33d5205bd209d27176e60709d05caea4bf5bd3f7c426ea6d813f63264740f30594385c4d"
     "329321088c9f7ef71af85d7077f588cac5cf1d28c881a90ce02f661638fd3e2db03b1d140fd8d9a1aa3366f10df1"
     "40ffa2130701033faec8acc65e6011fa8a17c5516bf67381d0bd927d8fdacedce9a7fdc636b609c35a7292cf1c42"
     "99135e0b07b3a1b75eaa2152afeae07acb4aff6ea1963a4b42fa71772eaf7fedaab4db0554e44aca88c9d375d98d"
     "cc0d600bb9460933b12a509e8cfe19d6058a46909e06a7dc5b524f7ead54f07d240e02c6bf5d1d6cbc7140b4a8ea"
     "f1f71ff6a78e8a0a8214f697fd78c6018c8c97e4807e7c2ad3a11530388fb4b5c998c625a0f7bd8aa922808f96a0"
     "d78e1cbdb4eb6769e1ccd8d90a34663e0bc755b4660c7240d5dcbc72d332e60231f76a5de28384d90d59e8ad44fe"
     "f32d8531223588a662355a8e8af68828550df5e7bb3d522e4219325610d6d1da969ef1449fa2a5124b244885c2fc"
     "66590072468d9cc1a0f4464e55a4a36d195b878f944bf3db80ca705f39f1e492d64d451e818b544e6d510464bd84"
     "3b9794df7142fc115b2919659bda86bdcda702440f02097e888563035240ccf14c85e9ed2a95924ec9f9ee2855d5"
     "947a1ebfcc6096fe961170e555a1cec0529e21bf70c4867b528911b18570348be79c468d4180a4ab48e1ccb52283"
     "371cb1beede9b240b583ad77cb65e07110e8deeb75d1de2ccc4657ab8b20de268a8cb8bb0c8dab475c2e0ea650a9"
     "49db02f0206da25441f418ee4b271930cc47730eade24a590d7de8fd7505493355f2525f6fee4965c602ed995bcb"
     "e15773b48903b2e6ec959b9afd341049efb632661e397c332cc895302e985f39afc9352d92416504a9ee9d4ead49"
     "62cd9a9c8e3d1e3a0796317310e842d1afeab4641561a6461fb4cc22d6929c10ffa57c328fd1888dce41961642c5"
     "3d02aae8a0dec492a78d1ab925148b6fbb976d621761860e81987bd132604cc2c1341d77e9e9e788a4feadca7319"
     "15148eb86236fdc569a8341eb618e539b4f4bc049ffe27911b5afc04b2a1ed3bf698d90267cfb5a92afcc0502125"
     "a7dcbb42cb98428aab033e6780571662bf3b80446f75a994764b27940ed40e1272468395a9a22a3d7edbd62ddb07"
     "8d1af0046b90501c1fbeb662accd6a417884c4e25b17ba6a417758aac06718dd3cb64323b3465c03f133e39e69c1"
     "d407214010e1fbbd72a893c08b6315a799828441161fc9050fad167e6293a2781b66b51e2ab291acba8fba100ab0"
     "362dff46bab0c6497ffac0f8740c99f8b3eeb35743e7e1dfc0ed2a9569b12414cf01b2c68a8fc3041079b1041ecb"
     "a95f142aba6b23c44fd766bf028a1a4d8a2b37abb0975884bff2457dd499bd2c50b86792e400beb7fd223fd14ac7"
     "31dbfca820468a668fd48ccc1cca5969e577f73e817baab6280c2b3d87f81f01e2f427ccfd776cf2f09fd590f0ff"
     "e5fe37f20fdd000008780700cc8b81ca8a0826cb0e945136016992ac02237183a60aae"),
    ("2048 float32 of 16 values, level 3: a raw block, then FSE sequences",
     8192, "6a3ff7a241155f9902515ea91e7f6af0f0f1f78f300c1b062b9596609899e637",
     "28b52ffd0018e4390014049610033eef98ee3ee6e1ef3f38b97d3fd03f113f1339993f767f9fbf7f4240997d893e"
     "2e818bbf85c1903f7b5477bf44cf7b2f4ca53caeee9b9610033e4dafb2bd8474a8c39fa434ed1b03116060504832"
     "980e8a763f13809120d07cf41cb3fd6d9605f819ccf246101e8f56f37ec0e933439fb78dbb7c08a7ca5b8746cfdb"
     "0f90b7c8aecfd24dec397f3e4ed67b18fc89e7868ffb3fc94ce75ff408b79a27761857892bf6044ff866fe58747e"
     "de1a67940f8487f2ee5c2c69d50359e416d29fd85bbe042bee78c35ff5cbbfa0673879daf86b7c550e13b71985eb"
     "cdf3bb0847ff76d0d18ff3a15fa18d56efd5f44e7599fb105fc6c20c6f7e1f2eabc0d68c376fdf78b9bfe3b9153b"
     "b207fcca4bd7d1597aaa4e45e34be3e2b619f84db3815f25dddb656f5c3fc3d6bcfd0af2181cbc81b5c6573db3bd"
     "3a7a1e94bee05a3008f8876f4f7c99a0a77b07d6f260dee5fe84afb2833dc7176d5d5ccddc5a3ca17d7525fc5ba6"
     "eab63cb21fe9469ecd2e1ed29e0da6cbd6bbe4ebc3e7f9159ce77f16a2e3f033f7cc2ac4b366a0fa81fb3ccf9f31"
     "28c3ff27eb28b73e9bcdc8e55071ff79d66304bb4fe85593d1bc479e9579fe797755f77f4e84fddb26bf6bfd56da"
     "cfab7d47e8eb9bf1ce1e7bfb12e41a7d189ec12988ec6b374626f219e49d7cd66f9e23fd2cfac93f74b6dd57e027"
     "c6ec8178d487dbcc856d6559df74377c7c8fa5d7fb1fb8f990133771c389b788bffc1c2f899d00bac1d96ef43f66"
     "fe18e3c05b6d5d38dec37c964e97f83f1b775bfe837d889fdc1ce0ead840dbd285be03ace3caeef55b873b6df468"
     "d547f9a67ce457683dc80b7d404c0d43fe3dc3f1f9e2a26bfd406a3bb0e134f22166fc47f30e27eda5e191ffd50b"
     "ecfddc8563a01fbb3fa6bff687e0009e9b5eeeb05ef9e6bcdfe3f1fc6167c6f1cbbf6bab769ec5db7429db670dee"
     "4e68f317c8e30f6204fdc6f4327b4277e4d09d46e3b03336998396d7245f6adfd6769c0139439faf103bda5c6eea"
     "f71ad6bcfcce77849dfc125d1b78a72ebb3f2dd43fa640f3a5bf938ceec1ee929a9ffbef9c3ef79fb336cb7f1813"
     "cdac7305ce139fa9ffa0813450d913ec24d8c419b95b8b4bb855806fa77c4c00ceec8a9a8a03f9dcf367793d0ff8"
     "749ced77b6f79fdfa133dcee5b8ca1ede79ea1b9fdaee44938f9d24b74ac7ab8352dbf4bd5effd1ace6b1fe20de5"
     "8bddb093b9666f645a9691473cf01df4772d5842db26deb94798e93cf053df7988ff7dd35dd0364c88ab0376bab1"
     "4636e0166dc0e17376958d19972dfd221679c112bb08dc470eb8dde966d12a78211bb88111fd087ac8430ee64edf"
     "6d14b80ecd4438c0d5e50f9c96763c4769495cb1dbbf23afe1cdea015c87034c5e74dc2ef9b72d576fcc23ea720d"
     "e2edff6ae768bc0d9f9f68ae5c9b87e27f4e3b47649ec5c79ee543f1f2023c7e6be7cc634e87e1d085ff73be71f1"
     "1f83f7cce31d5ee157f5fff89cb9099e786a63f6c0cda016ddebe4999827f0e72cbfe7e4c6e10f7de77d3e004fbc"
     "c147ca4227ba223b66335f24fffafee89aba8f2be6bfcd84beba07710f7dd4f8a2f3f856fbff1a78e437f72817f9"
     "04ea7fc211fb614faed00e5c708cefc636f2e8e8c92ab6e0bffedbeefedc368fdfb7ce4fff20cf34b121cfa7fff6"
     "523b7aa1cfbc51bdce7dfc9ef849cc8b2f7e7bfc5c80bef0e52d69acbc62cf39cd5ef9551fa2f92056a107f611ce"
     "c6c9dbcfc63df1c55321024bb1e18837f430b8fa16daa6a3e6ed33f56cf062d435dde113f57a86c7cfe2c21fd033"
     "fb38c3987b76f3e600de417e3658fed5370af166df7c445df76f7dbfc1c36bf0793223bb5e9bf81cfe2d792dffb2"
     "cf7ea887e53844ebf5dc0f1fee87413c192ffdfc7b3aad7f985ac15eaf858f51cffd9299b6ffde711bbfed337ec1"
     "cdc73773ec1fd6d13a86e5d8c72f74d177f4280e6517a7d966b9c579b1d743dd4f7ad6ade0e5846be4aec1c73843"
     "98b18571c496f8859f17e04abbfd647f836d7eea1f38f361d2fafd9ee2fa6eec431de6fc38e5adf9522e7103c7fc"
     "03dafd171fbf33bf1f993cfea97f7189cd977bbbbc65ce67fd399ea903605eb7e625ff76789099f0ee6ee3d275fe"
     "4a4fabbbe7fc1770f383d5fec1e3119ad9eef3fc09c7efef1ebd2f70cc0e5b351fec92df670037b7dda33d6e76b6"
     "73b738e018ffb3c34fc521b2c440ef7ce635974e7ff6dff1e67d66ee93cedafd8499b3dfa3e565c84ec0b3f9e3c7"
     "7d6bf7f6e7651c53bf07b8bf6c5b05dc9f590489d5266ecf2979e44ff05fd3dfb42703f2bb1fe97aef3de897e17e"
     "d976bb797bae1d5aa3dffbe725d7def393073faf871fccb3e1fc62bd7c6c33fff3594ecce1af26f3b34bb0f1184b"
     "61122e1ebcaa3e76f03687eabc87e7e939e2ff8466c7dc66c2fd89c53abbdfb30db691e347f66179bdedd737763f"
     "ef668eecb67d3fe7a599ed23838c01434ec3faf42dad3af849ee8defa3273ee12fbb9423c5ad69a7c144cffc98de"
     "36250b9e3ac06e8d8733ffe909660383232e7e620e8b9516f3f25fbab039e7533cfdff341d3ff9d00f037f9f426a"
     "a400e1937f1ff629dfcd3186378f4e1acddcecba02010000"),
    ("a 0-d int64, level 1: one raw block (orbax's step/0)",
     8, "03e7fb02cbc33eb45e98ab50b4bcad7fc338e5edfb5eca33ad9eb7d13d4ff106",
     "28b52ffd000041000015cd5b0700000000"),
)


def _tree_bytes(tree) -> int:
    """The bytes of the arrays (numpy or torch) in a tree."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if hasattr(tree, "nbytes"):
        return int(tree.nbytes)
    if hasattr(tree, "element_size"):
        return tree.numel() * tree.element_size()
    return 0


def _orbax_frames():
    """(d) The TS_FRAMES decoded by the port's decoder (built on this host), each held
    to its pinned size and SHA-256."""
    import hashlib

    from hcflow_tpu_torch.utils import zstd

    out = []
    for what, n, digest, hexed in TS_FRAMES:
        frame = bytes.fromhex(hexed)
        t0 = time.perf_counter()
        got = zstd.decompress(frame)
        s = time.perf_counter() - t0
        if len(got) != n or hashlib.sha256(got).hexdigest() != digest:
            raise AssertionError(f"zstd: the frame of {what} decoded to {len(got)} bytes with "
                                 f"SHA-256 {hashlib.sha256(got).hexdigest()}, expected {n} and "
                                 f"{digest}")
        log(f"  (d) {len(frame)}-byte frame of {what}: {n} bytes, SHA-256 as pinned "
            f"({s * 1e3:.3f} ms on the host)")
        out.append(dict(what=what, frame_bytes=len(frame), bytes=n, s=s))
    return out


def _orbax_rates(torch, tmp, spec, state):
    """Seconds and MB/s (the arrays' bytes) of saving and loading the x4 _G.ckpt and
    .state of ``state`` through each backend, in turns."""
    from hcflow_tpu_torch.utils import checkpoint

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    runs = {b: {"save_G": [], "load_G": [], "load_any_G": [], "save_state": [], "load_state": []}
            for b in ("orbax", "pickle")}
    sizes = {}
    for i, backend in enumerate(ORBAX_TURNS):
        g, st = str(tmp / f"r{i}" / "4_G.ckpt"), str(tmp / f"r{i}" / "4.state")
        r = runs[backend]
        r["save_G"].append(timed(lambda: checkpoint.save_model(g, state.params, spec, 4,
                                                               backend=backend))[1])
        tree, s = timed(lambda: checkpoint.load_checkpoint(g))
        r["load_G"].append(s)
        sizes["G"] = _tree_bytes(tree)
        r["load_any_G"].append(timed(lambda: checkpoint.load_any(g, spec.flow, device=DEV))[1])
        r["save_state"].append(timed(lambda: checkpoint.save_training_state(
            st, 4, state.params, state.opt_state, epoch=0, backend=backend))[1])
        loaded, s = timed(lambda: checkpoint.load_training_state(st, device=DEV))
        r["load_state"].append(s)
        sizes["state"] = _tree_bytes({k: loaded[k] for k in ("params", "opt_state")})
    out = {"bytes": sizes}
    for backend, r in runs.items():
        out[backend] = {}
        for k, times in r.items():
            nbytes = sizes["G" if k.endswith("_G") else "state"]
            mb_s = [nbytes / t / 1e6 for t in times]
            out[backend][k] = dict(s=times, mb_s=mb_s)
        log(f"  {backend}: " + "; ".join(
            f"{k} {', '.join(f'{t:.3f}' for t in v['s'])} s = "
            f"{', '.join(f'{m:.1f}' for m in v['mb_s'])} MB/s" for k, v in out[backend].items()))
    log(f"    (_G.ckpt {sizes['G'] / 1e6:.1f} MB, .state {sizes['state'] / 1e6:.1f} MB of "
        "arrays; load_G reads the numpy tree, load_any_G also converts it and moves it to the "
        "card, load_state moves it to the card)")
    return out


def phase_orbax(torch, gen, card):
    """The orbax checkpoint backend on the shipped on-chip recipe at full width:
    (a) train, save, prune and resume with path.checkpoint_backend orbax; (b) serve the
    orbax _G.ckpt and its pickle copy on the kernel path; (c) cli.test.main on the orbax
    _G.ckpt; (d) zstd frames tensorstore wrote; the save and load MB/s."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from hcflow_tpu_torch.cli import train
    from hcflow_tpu_torch.train import trainer
    from hcflow_tpu_torch.utils import checkpoint, config

    repo = Path(__file__).resolve().parent
    t_phase = time.perf_counter()
    out = {"frames": _orbax_frames()}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        _train_data(np, tmp / "data", np.random.default_rng(14))
        data, root = tmp / "data", tmp / "runs"
        log("  (a) configs/train_faces_x4_nll_onchip.yml (path.checkpoint_backend orbax, "
            "resume_state auto), changed keys:")
        opt = _train_option_file(tmp / "nll.yml", repo / "configs/train_faces_x4_nll_onchip.yml",
                                 root, _train_changes(data, root, SCALE,
                                                      **{"train.val_freq": ORBAX_STEPS}))
        parsed = config.parse(opt)
        if parsed["path"]["checkpoint_backend"] != "orbax":
            raise AssertionError("the on-chip config no longer asks for orbax checkpoints")
        spec = config.model_spec_from_opt(parsed)
        exp = Path(parsed["path"]["experiments_root"])
        # a validation: per image the forward and the reverses of 2 heats (the samples of a
        # heat batched); 28 RRDBs of 16 launches (bf16 encoders), 4 float32 chains of 13
        n_val, heats = TRAIN_VAL_PAIRS, len(parsed["val"]["heats"])
        val = dict(rrdb=28 * 16 * n_val * (1 + heats), chain_f32=4 * 13 * n_val * heats)
        _reset_counts()
        state1, out["run1"] = _train_run(torch, "faces x4 NLL, orbax", opt, ORBAX_SAVE_AT, val,
                                         spec.init(0, device=DEV))
        _expect_files("run 1", exp, ["2_G.ckpt", "latest_G.ckpt"], ["2.state"])
        load, resumed = train.load_training_state, {}

        def capture(path, device="cuda"):
            state = load(path, device=device)
            # a copy: the resumed run updates the loaded tensors in place
            resumed.update(path=path, state=trainer.tree_map(
                lambda t: t.detach().clone() if isinstance(t, torch.Tensor) else t,
                {k: state[k] for k in ("params", "opt_state")}))
            return state

        train.load_training_state = capture
        try:
            log(f"  (a) again with --max_steps {ORBAX_STEPS}: resume_state auto")
            state2, out["run2"] = _train_run(torch, "faces x4 NLL, orbax, resumed", opt,
                                             ORBAX_STEPS, val)
        finally:
            train.load_training_state = load
        launches = _counts()
        _expect_files("run 2", exp, ["4_G.ckpt", "latest_G.ckpt"], ["2.state", "4.state"])
        listed = (checkpoint.list_checkpoints(str(exp / "models"), "_G.ckpt"),
                  checkpoint.list_checkpoints(str(exp / "training_state"), ".state"))
        dirs = all((exp / d / f).is_dir() for d, fs in zip(("models", "training_state"), listed)
                   for f in fs)
        if listed != (["4_G.ckpt", "latest_G.ckpt"], ["2.state", "4.state"]) or not dirs:
            raise AssertionError(f"list_checkpoints gave {listed} (directories: {dirs})")
        if not resumed.get("path", "").endswith("2.state") or state2.step != ORBAX_STEPS:
            raise AssertionError(f"run 2 resumed from {resumed.get('path')} to step {state2.step}")
        got = resumed["state"]
        pairs = [("params", state1.params, got["params"]),
                 ("Adam mu", state1.opt_state["mu"], got["opt_state"]["mu"]),
                 ("Adam nu", state1.opt_state["nu"], got["opt_state"]["nu"])]
        for what, a, b in pairs:
            la, lb = trainer.tree_leaves(a), trainer.tree_leaves(b)
            if len(la) != len(lb) or not all(torch.equal(x.detach(), y.detach())
                                             for x, y in zip(la, lb)):
                raise AssertionError(f"the resumed run's {what} at step {ORBAX_SAVE_AT} differ "
                                     "from the saved ones")
        if got["opt_state"]["count"] != state1.opt_state["count"]:
            raise AssertionError("the resumed Adam count differs from the saved one")
        n_leaves = len(trainer.tree_leaves(state1.params))
        log(f"    run 2 resumed from 2.state: params and Adam moments equal run 1's at step "
            f"{ORBAX_SAVE_AT} bit for bit ({n_leaves} leaves each); list_checkpoints: {listed}, "
            "all directories")

        log("  (b) 4_G.ckpt through load_any (orbax) and its pickle copy, served on the kernel "
            f"path (bf16 RRDB, float32 chain), batch {BATCH}, {LR_HW}x{LR_HW}, heat {HEAT}, "
            "the same latents")
        g_orbax = str(exp / "models/4_G.ckpt")
        p_orbax = checkpoint.load_any(g_orbax, spec.flow, device=DEV)
        if not all(torch.equal(a, b.detach()) for a, b in zip(trainer.tree_leaves(p_orbax),
                                                               trainer.tree_leaves(state2.params))):
            raise AssertionError("4_G.ckpt through load_any differs from the trained params")
        g_pickle = str(tmp / "pickle" / "4_G.ckpt")
        checkpoint.save_model(g_pickle, p_orbax, spec, ORBAX_STEPS)
        p_pickle = checkpoint.load_any(g_pickle, spec.flow, device=DEV)
        lr = torch.rand(BATCH, LR_HW, LR_HW, 3, device=DEV, generator=gen)
        L = spec.flow.L
        eps = [torch.randn(BATCH, LR_HW * 2 ** (L - 1 - lv.level), LR_HW * 2 ** (L - 1 - lv.level),
                           lv.cond_spec.a_channels, device=DEV, generator=gen)
               for lv in spec.flow.levels]
        packs = [spec.flow.precompute_inference(p, fused=True) for p in (p_orbax, p_pickle)]
        _reset_counts()
        with torch.no_grad():
            srs = [spec.reverse(p, lr, HEAT, eps_list=eps) for p in packs]
        torch.cuda.synchronize()
        served = _counts()
        _check_counts("orbax and pickle serving", served,
                      _per_request(rrdb=28 * 16, chain_f32=4 * 13), 2)
        shape = (BATCH, LR_HW * SCALE, LR_HW * SCALE, 3)
        if tuple(srs[0].shape) != shape or not torch.isfinite(srs[0]).all():
            raise AssertionError(f"orbax serving: a bad SR batch {tuple(srs[0].shape)}")
        if not torch.equal(srs[0], srs[1]):
            raise AssertionError("the SR batches from the orbax and the pickle _G.ckpt differ")
        log(f"    SR batches {shape} from the orbax and the pickle _G.ckpt identical")

        log("  (c) cli.test.main on configs/test_faces_x4_onchip.yml, pretrain_model_G the orbax "
            "4_G.ckpt, 2 synthetic pairs")
        names = [f"{i:02d}" for i in range(TRAIN_VAL_PAIRS)]
        topt = config.parse(str(repo / "configs/test_faces_x4_onchip.yml"), is_train=False)
        theats, n_sample = topt["val"]["heats"], topt["val"]["n_sample"]
        vdir = data / f"val_x{SCALE}"
        test_opt = _serve_option_file(
            tmp / "test.yml", repo / "configs/test_faces_x4_onchip.yml", tmp,
            {"test_1": {"name": "faces", "mode": "GTLQ", "dataroot_GT": str(vdir / "HR"),
                        "dataroot_LQ": str(vdir / "LR")}}, ckpt=g_orbax)
        out["test"] = _serve(torch, "test_faces_x4_onchip on the orbax 4_G.ckpt", test_opt, dict(
            rrdb=28 * 16 * len(names) * (1 + len(theats)),
            chain_f32=4 * 13 * len(names) * len(theats)),
            {"faces": _sr_files(names, theats, n_sample)})
        log(f"  save and load rates of the x4 _G.ckpt and .state, in turns {ORBAX_TURNS} "
            f"[{card}]")
        out["rates"] = _orbax_rates(torch, tmp / "rates", spec, state2)
    launches = {k: launches[k] + served[k] + out["test"]["launches"][k] for k in launches}
    wall = time.perf_counter() - t_phase
    log(f"  phase 14 took {wall:.1f} s; launches {launches}")
    out.update(launches=launches, wall_s=wall, card=card)
    return out


# -------------------------------------- phase 15: widths the kernels run padded
# a chain's KERNELS entry by (float32 recipe, the padded pack's coupling width)
CHAIN_KEYS = {(False, 64): "chain", (True, 64): "chain_f32", (False, 32): "chain_hid32",
              (True, 32): "chain_hid32_f32"}
SMOKE_TRAIN_IMAGES, SMOKE_TRAIN_HW = 4, (160, 160)  # the faces' HR size


def _width_models():
    """Phase 15's models, (label, model, resident trunks): configs/smoke_train.yml's as it
    is (float32, coupling width 8, RRDB gc 4: the trunks stay plain as in JAX); x4
    rescaling at growth 24 and x4 SR at coupling width 48, both full width and depth
    (bf16); the 3-level rescaling model (bf16), whose level-2 main chain (c 48) chain3s
    does not take; two x4 SR models cut to K 8 and nb 2 for padded trunks: nf 24, gc 8
    (float32, per RRDB) and gc 24 (bf16, resident trunks)."""
    from pathlib import Path

    from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
    from hcflow_tpu_torch.utils import config

    smoke = config.model_spec_from_opt(config.load_yaml(
        str(Path(__file__).resolve().parent / "configs" / "smoke_train.yml")))
    cut = dict(K=(8, 8), after_splitoff=(4, 4), rrdb_nb=(2, 2))
    bf = dict(compute_dtype="bfloat16")
    return [
        ("smoke_train.yml, coupling width 8 (float32)", smoke, False),
        ("x4 rescaling, growth 24 (bf16)", HCFlowRescalingSpec.default_x4(hidden_channels=24, **bf),
         False),
        ("x4 SR, coupling width 48 (bf16)", HCFlowSRSpec.for_scale(SCALE, hidden_channels=48, **bf),
         False),
        ("3-level rescaling, level 2 c 48 (bf16)", HCFlowRescalingSpec.default_x4(
            L=3, K=(4, 4, 4), after_splitoff=(2, 2, 2), rrdb_nb=(1, 1, 1), **bf), False),
        ("x4 SR K 8, RRDB nf 24 gc 8 (float32)",
         HCFlowSRSpec.for_scale(SCALE, rrdb_nf=24, rrdb_gc=8, **cut), False),
        ("x4 SR K 8, RRDB gc 24 (bf16, resident trunks)",
         HCFlowSRSpec.for_scale(SCALE, rrdb_gc=24, **cut, **bf), True),
    ]


def _width_launches(model, resident=False) -> dict:
    """A reverse pass's launches by KERNELS entry, counted from the model's structure and
    the packs the card takes (FlowNetSpec.kernel_packs): a packed chain's K steps under
    its recipe and padded coupling width, chain3s's launches of a main chain, 16 an RRDB
    of a packed trunk or one a resident trunk."""
    from hcflow_tpu_torch.ops import chain, chain3s, rrdb

    flow = model.flow
    out = _per_request()
    for lv, names in zip(flow.levels, flow.kernel_packs(DEV).values()):
        so = lv.cond_spec
        for name, K, hid, cd in (
                ("main_fused", lv.n_main, flow.hidden_channels, flow.compute_dtype),
                ("steps_fused", so.n_flow_step, so.hidden_channels, so.compute_dtype)):
            if name in names:
                out[CHAIN_KEYS[(cd is None, chain.padded_hid(hid))]] += K
        if "main3s_fused" in names:
            f32 = flow.compute_dtype is None
            out["chain3s_f32" if f32 else "chain3s"] += chain3s.launches_per_chain(lv.n_main, f32)
        if "trunk0_fused" in names:
            suffix = "_f32" if so.encoder_compute_dtype is None else ""
            if resident:
                out["rrdb_trunk" + suffix] += 2
            else:
                out["rrdb" + suffix] += (so.rrdb_nb[0] + so.rrdb_nb[1]) * rrdb.LAUNCHES_PER_RRDB
    return out


def _serve_width_model(torch, gen, label, model, resident):
    """One phase-15 model at batch 16 from an LR of 40x40: two counted requests held to
    _width_launches, their outputs checked, the kernel path against the plain path under
    the same latents (phase 3's limits; float32 phase 8's), the pass timed."""
    flow = model.flow
    rescaling = not flow.sr
    heat = RS_HEAT if rescaling else HEAT
    params = perturb(model.init(0, device=DEV), gen)
    fused = flow.precompute_inference(params, fused=True, resident_trunk=resident)
    plain = flow.precompute_inference(params)
    lr = torch.rand(BATCH, LR_HW, LR_HW, 3, device=DEV, generator=gen)

    def request(seed, p=fused):
        return model.reverse(p, lr, heat, generator=torch.Generator(device=DEV).manual_seed(seed))

    request(0)
    torch.cuda.synchronize()
    _reset_counts()
    outs = [request(s) for s in (1, 2)]
    torch.cuda.synchronize()
    launches = _counts()
    per = _width_launches(model, resident)
    log(f"  {label}: packs on the card {flow.kernel_packs(DEV)}")
    _check_counts(label, launches, per, 2)
    hr = (BATCH, LR_HW * 2 ** flow.L, LR_HW * 2 ** flow.L, 3)
    for out in outs:
        if tuple(out.shape) != hr or not torch.isfinite(out).all() or out.min() < 0 or out.max() > 1:
            raise AssertionError(f"{label}: bad output {tuple(out.shape)}")
    eps = [torch.randn(BATCH, LR_HW * 2 ** (flow.L - 1 - lv.level),
                       LR_HW * 2 ** (flow.L - 1 - lv.level), lv.cond_spec.a_channels,
                       device=DEV, generator=gen) for lv in flow.levels]
    with torch.no_grad():
        err = _compare_paths(f"{label} (same eps_list)",
                             flow.reverse_flow(fused, lr, heat, eps_list=eps),
                             flow.reverse_flow(plain, lr, heat, eps_list=eps),
                             f32=flow.compute_dtype is None)
    ms, times = _median_ms(lambda: request(100), n=3)
    log(f"    reverse pass median {ms:.3f} ms over 3 passes; per request {per}")
    return dict(launches=launches, per_request=per, path_err=err, pass_ms=ms, pass_times_ms=times)


def _width_rows(torch, gen, rows, models):
    """The kernels on phase 15's paths at padded widths (calls_per_pass 0), each with its
    bound at the true widths (bound_ms) and at the padded ones (bound_padded_ms)."""
    smoke = models[0][1].flow
    lv1, lv0 = smoke.levels[1], smoke.levels[0]
    _chain_rows(torch, gen, rows, lv1.cond_spec.n_flow_step, lv1.cond_spec.cond_channels,
                [("L1 cond", True, lv1.cond_spec.a_channels, LR_HW)], "widths", hid=8, cd=None,
                key="chain_hid32_f32", calls=0)
    _chain_rows(torch, gen, rows, lv0.n_main, None, [("L0 main", False, lv0.channels, 2 * LR_HW)],
                "widths", hid=8, cd=None, key="chain_hid32_f32", calls=0)
    _chain_rows(torch, gen, rows, 13, None, [("L1 main", False, 24, LR_HW),
                                             ("L0 main", False, 12, 2 * LR_HW)], "widths",
                hid=48, calls=0)
    _chain3s_rows(torch, gen, rows, 8, [("L1 main", 24, LR_HW), ("L0 main", 12, 2 * LR_HW)],
                  "widths", calls=0, gc=24)
    _rrdb_rows(torch, gen, rows, 8, ((LR_HW, 0), (2 * LR_HW, 0)), "widths", nf=24, cd=None,
               key="rrdb_f32")
    _trunk_rows(torch, gen, rows, ((LR_HW, 0), (2 * LR_HW, 0)), "widths", gc=24, nb=2)


def phase_widths(torch, gen, rows):
    """Serving where the kernels run padded packs, at batch 16 and phase 3's shapes
    (_width_models), the padded kernels' rows, and cli.train.main on a copy of
    configs/smoke_train.yml on synthetic faces, through its validation on the kernel
    path (the chain kernel at coupling width 8, packed at 32)."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from hcflow_tpu_torch.data.util import save_img
    from hcflow_tpu_torch.utils import config

    t_phase = time.perf_counter()
    models = _width_models()
    out, launches = {}, _per_request()
    for label, model, resident in models:
        out[label] = _serve_width_model(torch, gen, label, model, resident)
        for k, v in out[label]["launches"].items():
            launches[k] += v
    log(f"  the models took {time.perf_counter() - t_phase:.1f} s")
    _width_rows(torch, gen, rows, models)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        rng = np.random.default_rng(15)
        (tmp / "faces").mkdir()
        for i in range(SMOKE_TRAIN_IMAGES):
            save_img(str(tmp / "faces" / f"{i}.png"), _smooth_image(np, rng, *SMOKE_TRAIN_HW))
        log(f"  configs/smoke_train.yml on {SMOKE_TRAIN_IMAGES} synthetic faces of "
            f"{SMOKE_TRAIN_HW[1]}x{SMOKE_TRAIN_HW[0]}, changed keys:")
        src = Path(__file__).resolve().parent / "configs" / "smoke_train.yml"
        opt = _train_option_file(tmp / "smoke_train.yml", src, tmp, {
            "datasets.train.dataroot_GT": str(tmp / "faces"),
            "datasets.val.dataroot_GT": str(tmp / "faces"), "path.root": str(tmp / "runs")})
        spec = config.model_spec_from_opt(config.parse(opt))
        niter = config.parse(opt)["train"]["niter"]
        # one validation image at one heat: one reverse on the packs
        state, rec = _train_run(torch, "smoke_train.yml", opt, niter, _width_launches(spec))
    if state.step != niter or len(rec["validations"]) != 1:
        raise AssertionError(f"smoke_train.yml: G step {state.step} of {niter}, "
                             f"{len(rec['validations'])} validations, expected one")
    for k, v in rec["validations"][0]["launches"].items():
        launches[k] += v
    log(f"  cli.train.main on smoke_train.yml: {time.perf_counter() - t0:.1f} s")
    wall = time.perf_counter() - t_phase
    log(f"  phase 15 took {wall:.1f} s; launches {launches}")
    out.update(train=rec, launches=launches, wall_s=wall)
    return out


# name: (source, the Pallas call it replaces, what one unit of ms is, the CUDA kernels
# (__global__ functions) its launches run, by the names the profiler shows).  The
# wgmma tile conv's feature_kernel (conv3x3.cuh) is rrdb's; tools/profile_port.py groups
# device time by these.
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
                "rescaling request", ("chain3s_step_kernel",)),
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
                    "rescaling float32 request", ("chain3s_f32_kernel",)),
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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0], allow_abbrev=False)
    ap.add_argument("--json", help="also write every result to this file")
    ap.add_argument("--train-rank", metavar="OUT",
                    help="phase 11's training process: run cli.train.main on the remaining "
                    "arguments, write its records to OUT")
    args, rest = ap.parse_known_args(argv)
    if args.train_rank:
        return _train_rank(args.train_rank, rest)
    if rest:
        ap.error(f"unrecognized arguments: {' '.join(rest)}")

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
    libs = (*_build.KERNELS, *_build.HOST_LIBS)  # the kernels and the zstd decoder
    reports = _build.build(libs)
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
    log(f"  kernels and host libraries built in {build_s:.1f} s: {', '.join(libs)}")

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = phase_kernels(torch, gen)
    log("phase 3: flagship x4 SR model, full width, bf16 serving recipe")
    sr = phase_sr(torch, gen, SCALE, LR_HW, HEAT, _per_request(rrdb=28 * 16, chain=4 * 13))
    log("phase 4: x4 rescaling model, full width, bf16 serving recipe")
    # per request: 6 RRDBs x 16 launches in each direction; 2 split-off chains of 6
    # steps; 2 main chains of 8 steps
    rs = phase_rescaling(torch, gen, _per_request(rrdb=2 * 6 * 16, chain=2 * 6,
                                                    chain3s=2 * _rs_main()))
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
                                                      chain3s_f32=2 * _rs_main(True)), cd=None)
    log("  x8 SR (configs/test_SR_CelebA_8X_HCFlow.yml's topology), resident trunks")
    sr8_f32 = phase_sr(torch, gen, X8_SCALE, X8_LR_HW, X8_HEAT,
                       _per_request(rrdb_trunk_f32=6, chain_f32=6 * 13), resident=True, cd=None)
    log("phase 9: the serving entry points (cli.test.main, the Evaluator, the tiled Predictor) "
        "at full width, float32 recipe")
    serve = phase_serving(torch, gen)
    log("phase 10: the training entry point (cli.train.main) at full width on the shipped "
        "training configs")
    train_cli = phase_train_cli(torch, gen)
    log("phase 11: data-parallel training (world 1 on NCCL, 2 ranks on the card over gloo, "
        "dryrun_multigpu(2)), train.remat_steps and the flow-op inventory at full width")
    par = phase_parallel(torch, gen)
    log("phase 12: spatially sharded serving at full width, batch 1: x4 SR (bf16, float32), "
        "x8 SR and x4 rescaling on a (1, 2) mesh, 2 ranks on the card over gloo")
    spatial = phase_spatial(torch, gen)
    log("phase 13: training on a (1, 2) mesh at full width, GT 160, batch 2: the x4 NLL, pixel, "
        "fea/GAN and D steps (bf16 encoders, float32 couplings) and the rescaling joint step, "
        "2 ranks on the card over gloo")
    spatial_train = phase_spatial_train(torch, card)
    log("phase 14: the orbax checkpoint backend on configs/train_faces_x4_nll_onchip.yml at full "
        "width: train, save, prune and resume; serve the orbax _G.ckpt (load_any, cli.test.main); "
        "zstd frames tensorstore wrote; save and load rates")
    orbax = phase_orbax(torch, gen, card)
    log("phase 15: widths the kernels run padded (zero channels up to their next width), batch "
        "16 from LR 40x40: smoke_train.yml's model, x4 rescaling at growth 24, x4 SR at "
        "coupling width 48, a 3-level rescaling model, trunks at nf 24 / gc 8 and gc 24; "
        "cli.train.main on smoke_train.yml through its validation")
    widths = phase_widths(torch, gen, rows)
    kernels = kernel_lines(rows, {"sr": sr["launches"], "rescaling": rs["launches"],
                                  "sr8": sr8["launches"], "train": train["launches"],
                                  "tiny_bf16": tiny["bfloat16"]["launches"],
                                  "tiny_f32": tiny["float32"]["launches"],
                                  "sr_f32": sr_f32["launches"],
                                  "rescaling_f32": rs_f32["launches"],
                                  "sr8_f32": sr8_f32["launches"],
                                  **{f"serve_{k}": serve[k]["launches"]
                                     for k in ("x4", "x8", "rescaling", "tiny", "predict")},
                                  "train_cli": train_cli["launches"],
                                  "parallel": par["launches"],
                                  "spatial": spatial["launches"],
                                  "orbax": orbax["launches"],
                                  "widths": widths["launches"]})
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "build_s": build_s, "kernels": kernels, "model": sr,
                       "rescaling": rs, "sr8": sr8, "train": train, "tiny": tiny,
                       "sr_f32": sr_f32, "rescaling_f32": rs_f32, "sr8_f32": sr8_f32,
                       "serve": serve, "train_cli": train_cli, "parallel": par,
                       "spatial": spatial, "spatial_train": spatial_train, "orbax": orbax,
                       "widths": widths},
                      f, indent=1, default=str)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shapes"}
                                  for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
