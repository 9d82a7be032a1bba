"""Profile a serving path of the PyTorch port on one NVIDIA GPU with torch.profiler.

    python3 tools/profile_port.py [--path sr|sr8|upscale|downscale|conv3x3] [--passes 3]
                                  [--trace port_trace.json]

``sr``: the x4 SR reverse pass of chip_smoke.py phase 3 (full width, bf16 serving
recipe, batch 16, 40x40 -> 160x160, heat 0.9, kernel path).  ``sr8``: the x8 SR
reverse pass of phase 5 (the CelebA-8X topology at full width, bf16, resident
trunks, batch 16, 20x20 -> 160x160, heat 0.8).  ``upscale`` and
``downscale``: the x4 rescaling model of phase 4 (full width, bf16, kernel path), its
reverse at heat 1.0 from a quantized 40x40 LR, or its forward from a 160x160 HR.
After two warm-up passes it profiles ``--passes`` passes and prints the device time
by kernel name, the same time grouped by the port's kernels (``chip_smoke.KERNELS``
names the CUDA kernels each one launches; the tile conv's shared kernels count for
every port kernel that runs them), the window's wall time (CUDA events) and the
device's busy share (summed kernel time over wall time; one stream, so kernels do not
overlap).  ``conv3x3``: the standalone conv3x3 kernel (on no path) at chip_smoke.py's
four shapes, ten calls each beside ten of cuDNN's bf16 conv on the same operands,
device time per call by kernel name.  It is the measurement behind PERF.md's
breakdowns; chip_smoke.py does not run it.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def profile_conv3x3(torch, calls=10):
    """Device ms per call of conv3x3's kernels and of cuDNN's, at each shape."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hcflow_tpu_torch.ops import conv

    gen = torch.Generator(device="cuda").manual_seed(0)
    hw = chip_smoke.X8_LR_HW
    for s, C, N, relu in ((4 * hw, 262, 64, False), (2 * hw, 140, 64, False),
                          (hw, 3, 64, False), (4 * hw, 64, 64, True)):
        x = torch.randn(chip_smoke.BATCH, s, s, C, device="cuda", generator=gen)
        w = torch.randn(3, 3, C, N, device="cuda", generator=gen) / (9 * C) ** 0.5
        b = 0.1 * torch.randn(N, device="cuda", generator=gen)
        xb = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wb = w.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bb = b.to(torch.bfloat16)

        def both():
            conv.conv3x3(x, w, b, relu=relu)
            torch.nn.functional.conv2d(xb, wb, bb, padding=1)

        for _ in range(3):
            both()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                both()
            torch.cuda.synchronize()
        print(f"conv3x3 {C}->{N} at {chip_smoke.BATCH}x{s}x{s} (ours and cuDNN's), "
              "device ms/call:")
        rows = [(ev.self_device_time_total / calls / 1e3, ev.key) for ev in prof.key_averages()
                if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        for ms, key in sorted(rows, reverse=True):
            print(f"  {ms:9.4f}  {key[:90]}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("sr", "sr8", "upscale", "downscale", "conv3x3"),
                    default="sr")
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--trace", help="also export the Chrome trace to this file")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec, quantize

    if not torch.cuda.is_available():
        print("profile_port: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    if args.path == "conv3x3":
        return profile_conv3x3(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, hw = chip_smoke.BATCH, chip_smoke.LR_HW
    if args.path == "sr":
        model = HCFlowSRSpec.for_scale(chip_smoke.SCALE, compute_dtype="bfloat16")
        heat = chip_smoke.HEAT
    elif args.path == "sr8":
        model = HCFlowSRSpec.for_scale(chip_smoke.X8_SCALE, compute_dtype="bfloat16")
        heat, hw = chip_smoke.X8_HEAT, chip_smoke.X8_LR_HW
    else:
        model = HCFlowRescalingSpec.default_x4(compute_dtype="bfloat16")
        heat = chip_smoke.RS_HEAT
    params = chip_smoke.perturb(model.init(0), gen)
    params = model.flow.precompute_inference(params, fused=True,
                                             resident_trunk=args.path == "sr8")
    if args.path == "downscale":
        hr = torch.rand(B, hw * chip_smoke.SCALE, hw * chip_smoke.SCALE, 3, device="cuda",
                        generator=gen)

        def run(seed):
            return model.forward(params, hr)
    else:
        lr = torch.rand(B, hw, hw, 3, device="cuda", generator=gen)
        if args.path == "upscale":
            lr = quantize(lr)

        def run(seed):
            g = torch.Generator(device="cuda").manual_seed(seed)
            return model.reverse(params, lr, heat, generator=g)

    for s in range(2):
        run(s)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for s in range(args.passes):
            run(10 + s)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)

    rows = []  # device kernels only: host-side events also carry their kernels' time
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total / 1e3, ev.count, ev.key))
    if not rows:
        raise AssertionError("the profiler saw no device time")
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    print(f"{args.passes} passes: wall {wall_ms:.3f} ms ({wall_ms / args.passes:.3f} ms/pass), "
          f"device busy {busy_ms:.3f} ms = {busy_ms / wall_ms:.4f} of wall")
    print(f"{'device ms/pass':>15} {'share':>7} {'calls/pass':>10}  name")
    for ms, count, key in rows[:25]:
        per = args.passes
        print(f"{ms / per:15.4f} {ms / busy_ms:7.4f} {count / per:10.1f}  {key[:90]}")
    groups = {}
    for ms, count, key in rows:
        owners = [n for n, k in chip_smoke.KERNELS.items() if any(c in key for c in k[3])]
        g = groups.setdefault(" / ".join(owners) or "library and other", [0.0, 0])
        g[0], g[1] = g[0] + ms, g[1] + count
    print(f"{'device ms/pass':>15} {'share':>7} {'calls/pass':>10}  port kernel")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"{ms / args.passes:15.4f} {ms / busy_ms:7.4f} {count / args.passes:10.1f}  {name}")
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
