"""Readings below the bf16 recipe, that a bf16 cell's correctness limits are set from.

    python3 tools/probe_bf16_control.py --workload sr_x4_bf16.photos --seeds 1,2,3
        [--seconds 4] [--controls port,carry_bf16,conv_fp8] [--json PATH]

For each control and seed, one run of the cell (``h100_bench/harness.py`` ``run_cell``,
a short window at the cell's own load, on the card) in this one process, with the
program patched while it serves, and the numbers the run compares with the float32
reference:

- ``port``: the program as it is (the bf16 recipe; the lower readings);
- ``carry_bf16``: what the recipe keeps in float32 carried in bf16: the output of every
  RRDB trunk (``ops/rrdb.py`` ``trunk_apply``) and the z of every inverse chain
  (``ops/chain.py`` ``inverse_chain``) rounded to bf16;
- ``conv_fp8``: every library conv's operands (``ops/nets.py`` ``conv2d``: the input
  and the weight) rounded to float8 e4m3, each tensor scaled so that its largest
  magnitude is e4m3's largest (448), the precision below bf16.

For each control, prints one JSON line naming it, then ``h100_bench/control.py``'s lines
for the program ``port`` served with the control in force: one a run and a summary, the
least and the largest of each number over the seeds.  The benchmark's own runs never run
a control.
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

CONTROLS = ("port", "carry_bf16", "conv_fp8")
E4M3_MAX = 448.0


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def round_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 under one scale a tensor (its largest magnitude to 448)."""
    top = t.detach().abs().amax().float()
    scale = torch.where(top > 0, top / E4M3_MAX, torch.ones_like(top))
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


@contextlib.contextmanager
def patched(control: str):
    """The program with control ``control`` in force over the block."""
    from hcflow_tpu_torch.ops import chain, nets, rrdb

    undo = []

    def wrap(mod, name, make):
        orig = getattr(mod, name)
        setattr(mod, name, make(orig))
        undo.append((mod, name, orig))

    if control == "carry_bf16":
        wrap(rrdb, "trunk_apply", lambda f: lambda *a, **k: round_bf16(f(*a, **k)))
        wrap(chain, "inverse_chain", lambda f: lambda *a, **k: round_bf16(f(*a, **k)))
    elif control == "conv_fp8":
        wrap(nets, "conv2d", lambda f: lambda x, w, *a, **k: f(round_e4m3(x), round_e4m3(w),
                                                               *a, **k))
    elif control != "port":
        raise ValueError(f"no control {control!r}: {', '.join(CONTROLS)}")
    try:
        yield
    finally:
        for mod, name, orig in reversed(undo):
            setattr(mod, name, orig)


def main(argv=None) -> int:
    """``h100_bench/control.py``'s readings of its program ``port``, once a control, with
    the control in force; ``--json PATH`` writes each control's to ``PATH.<control>``."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", default="4")
    ap.add_argument("--controls", default=",".join(CONTROLS))
    ap.add_argument("--json", help="also write every reading to PATH.<control>")
    args = ap.parse_args(argv)

    from h100_bench import control

    for c in args.controls.split(","):
        print(json.dumps({"control": c}), flush=True)
        with patched(c):
            rc = control.main(["--workload", args.workload, "--seeds", args.seeds,
                               "--seconds", args.seconds, "--programs", "port"]
                              + (["--json", f"{args.json}.{c}"] if args.json else []))
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
