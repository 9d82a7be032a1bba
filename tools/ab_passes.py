"""Time the serving passes of several checkouts of the port, in turns, on one GPU.

    python3 tools/ab_passes.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one, another commit unpacked with
``git archive`` into a git-ignored directory).  For each ROOT in the order given (list
a pair as A B B A to cancel drift), a fresh process builds that checkout's kernels and
times, as its chip_smoke.py times a pass (``_median_ms``: CUDA events around each of 7
passes after warm-up, the median), the serving passes at full width and batch 16 on
random weights from seed 0, fused with ``precompute_inference(fused=True)``: in the bf16
recipe the x4 SR reverse (40x40 -> 160x160, heat 0.9), the x4 rescaling upscale and
downscale (160x160, heat 1.0) and the x8 SR reverse with resident trunks (20x20 ->
160x160, heat 0.8); in the float32 recipe (no compute_dtype) the x4 SR reverse,
the x4 rescaling upscale and the x8 SR reverse with resident trunks.  Prints one line of ms per ROOT, the passes in that order.
"""

from __future__ import annotations

import subprocess
import sys

PASSES = ("x4 bf16", "upscale bf16", "downscale bf16", "x8 bf16 resident", "x4 f32",
          "upscale f32", "x8 f32 resident")


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from hcflow_tpu_torch import _build
    from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec, quantize

    _build.build()
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)

    def fused(model, **kw):
        params = cs.perturb(model.init(0, device=dev), gen)
        return model.flow.precompute_inference(params, fused=True, **kw)

    def sr(scale, lr_hw, heat, cd, **kw):
        model = HCFlowSRSpec.for_scale(scale, compute_dtype=cd)
        p = fused(model, **kw)
        lr = torch.rand(cs.BATCH, lr_hw, lr_hw, 3, device=dev, generator=gen)
        g = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            model.reverse(p, lr, heat, generator=g)
            return cs._median_ms(lambda: model.reverse(p, lr, heat, generator=g))[0]

    def rescaling(cd):
        model = HCFlowRescalingSpec.default_x4(compute_dtype=cd)
        p = fused(model)
        hr = torch.rand(cs.BATCH, 4 * cs.LR_HW, 4 * cs.LR_HW, 3, device=dev, generator=gen)
        g = torch.Generator(device=dev).manual_seed(1)
        with torch.no_grad():
            lq = quantize(model.forward(p, hr)[0])
            model.reverse(p, lq, 1.0, generator=g)
            up = cs._median_ms(lambda: model.reverse(p, lq, 1.0, generator=g))[0]
            down = cs._median_ms(lambda: model.forward(p, hr))[0]
        return up, down

    times = [sr(4, cs.LR_HW, 0.9, "bfloat16"), *rescaling("bfloat16"),
             sr(8, cs.X8_LR_HW, 0.8, "bfloat16", resident_trunk=True), sr(4, cs.LR_HW, 0.9, None),
             rescaling(None)[0], sr(8, cs.X8_LR_HW, 0.8, None, resident_trunk=True)]
    print(root, " ".join(f"{t:.3f}" for t in times), flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) == 2 and args[0] == "--one":
        run_one(args[1])
        return 0
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print("ms per pass:", ", ".join(PASSES), flush=True)
    rc = 0
    for root in args:
        rc |= subprocess.run([sys.executable, __file__, "--one", root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
