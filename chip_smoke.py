"""Drive the PyTorch port's x4 SR serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--json PATH]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.  Phases:

1. print the card's name and power limit; build both CUDA kernels from
   hcflow_tpu_torch/csrc with nvcc (sm_90a) and print the build time;
2. hold each kernel against its plain PyTorch version on the card, at every shape
   of the main path (RRDB at 40x40 and 80x80; the four inverse chains), with bf16
   weights perturbed from a seed, and time both;
3. run the flagship x4 model at full width (for_scale(4): nb 7, K 26, nf 64, gc 32,
   hidden 64) in the bf16 serving recipe at batch 16, 40x40 -> 160x160, heat 0.9, as
   a few requests with different generator seeds; check the output, the kernel path
   against the plain path under the same explicit latents, that heat 0 is
   deterministic and that both kernels ran; time the pass with CUDA events;
4. print the kernels' JSON line, then the JSON status line last.

Any failed check raises, and the script exits non-zero without the status line.
Weights are random (the checkpoint of the repo is a tiny topology), perturbed so
that the zero-initialised layers (coupling conv3s, the prior head) do work.
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time

BATCH, LR_HW, SCALE, HEAT = 16, 40, 4, 0.9
DEV = "cuda"
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s (NVIDIA data sheet)
PEAK_F32 = 67e12  # float32 outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
# Kernel vs its plain version on the card: both take the same bf16 operands and sum in
# float32, in another order; a feature rounded to bf16 can then land one bf16 step
# (2^-8 relative) apart and carry, damped, through the following convs or steps.
KERNEL_RTOL = 1e-3  # max |kernel - plain| / max |plain|
# Kernel path vs plain path of the whole model, before the clamp to [0, 1]: the plain
# path also rounds each net conv's OUTPUT through bf16 (as the JAX recipe does) and
# the kernels do not, about 2^-9 relative per conv, carried through 52 steps.
MODEL_MAX_RTOL, MODEL_MEAN_RTOL = 5e-2, 1e-2  # of max |plain| and of mean |plain|


def log(msg):
    print(msg, flush=True)


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
def rrdb_work(B, H, W, nf, gc):
    """(bf16 FLOP, bytes) that one RRDB must do and move: the input read once, the
    output written once, the bf16 weights and f32 biases read once."""
    px = B * H * W
    macs = sum(9 * (nf + i * gc) * (gc if i < 4 else nf) for i in range(5))  # per block
    weights, biases = 3 * macs, 3 * (4 * gc + nf)  # one weight per MAC of a pixel
    return 2 * 3 * macs * px, 2 * px * nf * 4 + 2 * weights + 4 * biases


def chain_work(B, H, W, c, hid, K, cond):
    """(bf16 FLOP, f32 FLOP, bytes) of one K-step inverse chain: z in and out once,
    the cond terms once, the packed weights once."""
    px = B * H * W
    c1, c2 = c // 2, c - c // 2
    bf = 2 * px * K * (9 * c1 * hid + hid * hid + 9 * hid * 2 * c2)
    f32 = 2 * px * K * c * c
    weights = K * (2 * (9 * c1 * hid + hid * hid + 9 * hid * 2 * c2)
                   + 4 * (4 * hid + 4 * c2 + c * c + c))
    nbytes = 2 * px * c * 4 + (px * K * hid * 2 if cond else 0) + weights
    return bf, f32, nbytes


def bound(ops_s, nbytes):
    mem_s = nbytes / PEAK_BYTES
    return (max(ops_s, mem_s) * 1e3, "operations" if ops_s >= mem_s else "bytes")


# --------------------------------------------------------------------------- phases
def phase_kernels(torch, gen):
    from hcflow_tpu_torch.flow import stack
    from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
    from hcflow_tpu_torch.ops import chain, nets, rrdb

    dev = DEV
    nf, gc, hid, K, nb = 64, 32, 64, 13, 7
    rows = {"rrdb": [], "chain": []}

    log("phase 2: kernels against their plain versions on the card")
    trunk = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(11), 1, nf, gc), gen)
    packed = rrdb.pack_rrdb(trunk[0], "bfloat16")
    packed = {k: [t.to(dev) for t in v] for k, v in packed.items()}
    for hw, calls in ((LR_HW, 2 * nb), (2 * LR_HW, 2 * nb)):  # trunk0 + trunk1 per level
        x = torch.randn(BATCH, hw, hw, nf, device=dev, generator=gen)
        got = rrdb.rrdb_apply(packed, x)
        ref = rrdb.rrdb_apply_plain(packed, x)
        torch.cuda.synchronize()
        err = check_rel(f"rrdb {BATCH}x{hw}x{hw}x{nf}", got, ref, KERNEL_RTOL)
        ms = cuda_time(lambda: rrdb.rrdb_apply(packed, x), reps=10)
        plain_ms = cuda_time(lambda: rrdb.rrdb_apply_plain(packed, x), reps=3)
        flops, nbytes = rrdb_work(BATCH, hw, hw, nf, gc)
        b_ms, b_by = bound(flops / PEAK_BF16, nbytes)
        log(f"    {ms:.4f} ms/RRDB (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}, "
            f"{flops / ms / 1e9:.1f} TFLOP/s), {calls} calls per pass")
        rows["rrdb"].append(dict(shape=[BATCH, hw, hw, nf], calls_per_pass=calls, err=err,
                                 ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))

    # (level, cond, c, spatial): the cond chains and the main chains of both levels
    chains = [("L1 cond", True, 21, LR_HW), ("L0 cond", True, 6, 2 * LR_HW),
              ("L1 main", False, 24, LR_HW), ("L0 main", False, 12, 2 * LR_HW)]
    for name, cond, c, hw in chains:
        spec = FlowStepSpec(in_channels=c, cond_channels=2 * nf if cond else None,
                            hidden_channels=hid, compute_dtype="bfloat16")
        steps = stack.init_stack(spec, torch.Generator().manual_seed(12), K)
        steps = stack.precompute_invconv(perturb(steps, gen))
        steps = [{k: _to(v, dev) for k, v in s.items()} for s in steps]
        pk = chain.pack_inverse_chain(steps, "bfloat16")
        z = torch.randn(BATCH, hw, hw, c, device=dev, generator=gen)
        uc = None
        if cond:
            u = torch.randn(BATCH, hw, hw, 2 * nf, device=dev, generator=gen)
            uc = stack.compute_u_contribs(spec, steps, u).to(torch.bfloat16).contiguous()
        got = chain.inverse_chain(pk, z, uc)
        ref = chain.inverse_chain_plain(pk, z, uc)
        torch.cuda.synchronize()
        err = check_rel(f"chain {name} {BATCH}x{hw}x{hw}x{c} K={K}", got, ref, KERNEL_RTOL)
        ms = cuda_time(lambda: chain.inverse_chain(pk, z, uc), reps=20)
        plain_ms = cuda_time(lambda: chain.inverse_chain_plain(pk, z, uc), reps=5)
        bf, f32, nbytes = chain_work(BATCH, hw, hw, c, hid, K, cond)
        b_ms, b_by = bound(bf / PEAK_BF16 + f32 / PEAK_F32, nbytes)
        log(f"    {ms:.4f} ms/chain (plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}), "
            f"1 call per pass")
        rows["chain"].append(dict(shape=[BATCH, hw, hw, c], chain=name, K=K, calls_per_pass=1,
                                  err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                  bound_by=b_by))
    return rows


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def phase_model(torch, gen):
    from hcflow_tpu_torch.models import HCFlowSRSpec
    from hcflow_tpu_torch.ops import chain, nets, rrdb

    log("phase 3: flagship x4 model, full width, bf16 serving recipe")
    model = HCFlowSRSpec.for_scale(SCALE, compute_dtype="bfloat16")
    t0 = time.perf_counter()
    params = perturb(model.init(0, device=DEV), gen)
    fused = model.flow.precompute_inference(params, fused=True)
    plain = model.flow.precompute_inference(params, fused=False)
    torch.cuda.synchronize()
    log(f"  init + perturb + pack: {time.perf_counter() - t0:.1f} s")

    # the prior head and the invertible tail are float32 without TF32
    with nets.exact_f32():
        assert not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32
    head = params["level1"]["cond"]["f"]
    cond = torch.randn(2, LR_HW, LR_HW, head["w"].shape[1], device=DEV, generator=gen)
    got = nets.apply_conv_zeros(head, cond)
    h64 = {k: v.double().cpu() for k, v in head.items()}
    ref = torch.nn.functional.conv2d(cond.double().cpu().permute(0, 3, 1, 2), h64["w"], h64["b"],
                                     padding=1).permute(0, 2, 3, 1) * torch.exp(3 * h64["logs"])
    head_err = ((got.double().cpu() - ref).abs().max() / ref.abs().max()).item()
    log(f"  prior head conv, float32 on the card vs float64: rel err {head_err:.2e} "
        "(TF32 would give ~1e-3; tolerance 1e-5)")
    if not head_err < 1e-5:
        raise AssertionError("the float32 prior head conv ran with reduced precision")

    lr = torch.rand(BATCH, LR_HW, LR_HW, 3, device=DEV, generator=gen)
    hr_shape = (BATCH, LR_HW * SCALE, LR_HW * SCALE, 3)

    def request(seed, heat=HEAT, p=fused):
        g = torch.Generator(device=DEV).manual_seed(seed)
        return model.reverse(p, lr, heat, generator=g)

    request(0)  # warm-up: cuDNN plans, kernel libraries loaded
    torch.cuda.synchronize()

    # the main path: a few requests, counted
    seeds = (1, 2, 3)
    rrdb.launches = chain.launches = 0
    outs = [request(s) for s in seeds]
    torch.cuda.synchronize()
    launches = {"rrdb": rrdb.launches, "chain": chain.launches}
    log(f"  {len(seeds)} requests: launches {launches}")
    per_pass = {"rrdb": 28 * rrdb.LAUNCHES_PER_RRDB, "chain": 4 * 13}
    for k, n in per_pass.items():
        if launches[k] != n * len(seeds):
            raise AssertionError(f"{k}: {launches[k]} launches, expected {n} per pass")
    for s, out in zip(seeds, outs):
        if tuple(out.shape) != hr_shape or not torch.isfinite(out).all():
            raise AssertionError(f"request {s}: bad output {tuple(out.shape)}")
        if out.min() < 0 or out.max() > 1:
            raise AssertionError(f"request {s}: output outside [0, 1]")
    inside = ((outs[0] > 0) & (outs[0] < 1)).float().mean().item()
    log(f"  outputs {hr_shape}, finite, in [0, 1]; {inside:.3f} of values inside (0, 1)")
    if torch.equal(outs[0], outs[1]):
        raise AssertionError("heat 0.9: two seeds gave the same image")
    if not torch.equal(request(1, 0.0), request(2, 0.0)):
        raise AssertionError("heat 0 is not deterministic across seeds")
    log("  heat 0 deterministic across seeds; heat 0.9 differs by seed")

    # kernel path vs plain path under the same explicit latents
    eps = [torch.randn(BATCH, 2 * LR_HW, 2 * LR_HW, 6, device=DEV, generator=gen),
           torch.randn(BATCH, LR_HW, LR_HW, 21, device=DEV, generator=gen)]
    with torch.no_grad():
        a = model.flow.reverse_flow(fused, lr, HEAT, eps_list=eps)
        b = model.flow.reverse_flow(plain, lr, HEAT, eps_list=eps)
    d = (a - b).abs()
    max_abs, mean_abs = d.max().item(), d.mean().item()
    max_ref, mean_ref = b.abs().max().item(), b.abs().mean().item()
    log(f"  kernel path vs plain path (same eps_list, before the clamp): max abs "
        f"{max_abs:.3e} of max |plain| {max_ref:.3e} (tol {MODEL_MAX_RTOL:g} x), mean abs "
        f"{mean_abs:.3e} of mean |plain| {mean_ref:.3e} (tol {MODEL_MEAN_RTOL:g} x)")
    if not (max_abs <= MODEL_MAX_RTOL * max_ref and mean_abs <= MODEL_MEAN_RTOL * mean_ref):
        raise AssertionError("the kernel path disagrees with the plain path")

    # time per pass, CUDA events, after warm-up
    times = []
    for i in range(7):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        request(100 + i)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    plain_ms = cuda_time(lambda: request(200, p=plain), reps=2, warmup=1)
    mps = BATCH * (LR_HW * SCALE) ** 2 / 1e6 / (ms / 1e3)
    log(f"  reverse pass: median {ms:.3f} ms over {len(times)} passes "
        f"({', '.join(f'{t:.3f}' for t in times)}) = {mps:.3f} MP/s; plain path "
        f"{plain_ms:.3f} ms/pass")
    return dict(launches=launches, pass_ms=ms, pass_times_ms=times, mp_per_s=mps,
                plain_pass_ms=plain_ms, path_max_abs=max_abs, path_mean_abs=mean_abs,
                head_rel_err=head_err, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def kernel_lines(rows, launches):
    out = []
    meta = {
        "rrdb": ("hcflow_tpu_torch/csrc/rrdb.cu", "hcflow_tpu/ops/pallas_rdb.py:547"),
        "chain": ("hcflow_tpu_torch/csrc/chain.cu", "hcflow_tpu/ops/pallas_chain.py:360"),
    }
    for name, (source, replaces) in meta.items():
        rs = rows[name]
        tot = {k: sum(r[k] * r["calls_per_pass"] for r in rs)
               for k in ("ms", "plain_ms", "bound_ms")}
        share = {b: sum(r["bound_ms"] * r["calls_per_pass"] for r in rs if r["bound_by"] == b)
                 for b in ("bytes", "operations")}
        by = max(share, key=share.get)  # what bounds most of the pass's least time
        out.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["err"] for r in rs),
            "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
            "bound_by": by, "library_ms": None, "per": "reverse pass", "shapes": rs,
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
    log(f"phase 1: card {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t0
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  kernels built in {build_s:.1f} s: {', '.join(_build.KERNELS)}")

    gen = torch.Generator(device=DEV).manual_seed(0)
    rows = phase_kernels(torch, gen)
    model = phase_model(torch, gen)
    kernels = kernel_lines(rows, model["launches"])
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "build_s": build_s, "kernels": kernels, "model": model},
                      f, indent=1)
    print(json.dumps({"kernels": [{k: v for k, v in r.items() if k != "shapes"}
                                  for r in kernels]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
