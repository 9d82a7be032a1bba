"""Time the CUDA kernels of several checkouts of the port, in turns, on one GPU.

    python3 tools/ab_kernels.py [--unchecked] ROOT [ROOT ...]

Each ROOT is the root of a checkout (``.`` for this one; another commit unpacked with
``git archive`` into a git-ignored directory, or a copy whose ``csrc/`` differs).  For
each ROOT, in the order given (list a pair as A B B A to cancel drift), a fresh
process builds that checkout's kernels into its own ``hcflow_tpu_torch/build/`` and
runs its own ``chip_smoke.py`` phase-2 rows: the per-RRDB kernel (gc 32 and 16 at
16x40x40 and 16x80x80), the resident trunk (nb 5 at 20x20, 40x40, 80x80), the inverse
chain (K 13: the x4 SR chains, c 21 / 6 / 24 / 12, then the x8 ones, c 45 / 12 / 6 /
48 / 24 / 12), chain3s (K 8 at 40x40 and 80x80) and conv3x3 (262, 140, 3 and 64
channels in), and where the checkout's chip_smoke.py has them the chain kernel's other
variants at the x4 chain shapes: float32 at hid 64 (K 13), bf16 and float32 at hid 32
(K 4), and the float32 recipe's RRDB (gc 32 at 16x40x40 and 16x80x80), resident-trunk
(nb 5 at 40x40 and 80x80) and chain3s (K 8) kernels.  Each row is checked against its
plain version, as chip_smoke.py checks it.  Prints one line of ms/call per ROOT in that
order, then the library yardsticks' ms of the rows that have one (a checkout's own
chip_smoke.py decides which), then whether each trunk was bit-identical to the per-RRDB
kernel and the latter's ms.  ``--unchecked`` times only the per-RRDB kernel (gc 32 at
16x40x40 and 16x80x80) and checks nothing: for probes, variants that skip part of the
work on purpose to show where the time goes.
"""

from __future__ import annotations

import contextlib
import io
import subprocess
import sys

ROWS = ("rrdb gc32 40 80, rrdb gc16 40 80, trunk 20 40 80, "
        "chain x4 (L1 cond, L0 cond, L1 main, L0 main) x8 (L2 cond, L1 cond, L0 cond, L2 main, "
        "L1 main, L0 main), chain3s 40 80, conv3x3 262 140 3 64, "
        "[chain_f32, chain_hid32, chain_hid32_f32 x4 (L1 cond, L0 cond, L1 main, L0 main)], "
        "[rrdb_f32 gc32 40 80, rrdb_trunk_f32 40 80, chain3s_f32 40 80]")


def run_unchecked(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from hcflow_tpu_torch import _build
    from hcflow_tpu_torch.ops import nets, rrdb

    _build.build(["rrdb"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    trunk = cs.perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(11), 1, 64, 32), gen)
    packed = cs._to(rrdb.pack_rrdb(trunk[0], "bfloat16"), "cuda")
    times = []
    for hw in (cs.LR_HW, 2 * cs.LR_HW):
        x = torch.randn(cs.BATCH, hw, hw, 64, device="cuda", generator=gen)
        times.append(cs.cuda_time(lambda: rrdb.rrdb_apply(packed, x), reps=20))
    print(root, "rrdb gc32 40 80, unchecked", " ".join(f"{t:.4f}" for t in times), flush=True)


def run_one(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from hcflow_tpu_torch import _build

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {k: [] for k in ("rrdb", "rrdb_trunk", "chain", "chain3s", "conv3x3")}
    hw = cs.LR_HW
    with contextlib.redirect_stdout(io.StringIO()):
        cs._rrdb_rows(torch, gen, rows, 32, ((hw, 14), (2 * hw, 14)), "sr")
        cs._rrdb_rows(torch, gen, rows, 16, ((hw, 6), (2 * hw, 6)), "rescaling")
        cs._trunk_rows(torch, gen, rows, ((hw // 2, 2), (hw, 2), (2 * hw, 2)), "sr8")
        cs._chain_rows(torch, gen, rows, 13, 128, [("L1 cond", True, 21, hw),
                                                   ("L0 cond", True, 6, 2 * hw),
                                                   ("L1 main", False, 24, hw),
                                                   ("L0 main", False, 12, 2 * hw)], "sr")
        cs._chain_rows(torch, gen, rows, 13, 128, [("L2 cond", True, 45, hw // 2),
                                                   ("L1 cond", True, 12, hw),
                                                   ("L0 cond", True, 6, 2 * hw),
                                                   ("L2 main", False, 48, hw // 2),
                                                   ("L1 main", False, 24, hw),
                                                   ("L0 main", False, 12, 2 * hw)], "sr8")
        cs._chain3s_rows(torch, gen, rows, 8, [("L1 main", 24, hw), ("L0 main", 12, 2 * hw)],
                         "rescaling")
        cs._conv_rows(torch, gen, rows, ((2 * hw, 262, 64, False), (hw, 140, 64, False),
                                         (hw // 2, 3, 64, False), (2 * hw, 64, 64, True)),
                      "standalone")
        if "chain_f32" in getattr(cs, "KERNELS", {}):  # the chain kernel's other variants
            x4 = [("L1 cond", True, 21, hw), ("L0 cond", True, 6, 2 * hw),
                  ("L1 main", False, 24, hw), ("L0 main", False, 12, 2 * hw)]
            for key, K, cond_ch, hid, cd in (("chain_f32", 13, 128, 64, None),
                                             ("chain_hid32", 4, 64, 32, "bfloat16"),
                                             ("chain_hid32_f32", 4, 64, 32, None)):
                rows[key] = []
                cs._chain_rows(torch, gen, rows, K, cond_ch, x4, "ab", hid=hid, cd=cd, key=key)
        if "rrdb_f32" in getattr(cs, "KERNELS", {}):  # the float32 recipe's tile-conv kernels
            for key in ("rrdb_f32", "rrdb_trunk_f32", "chain3s_f32"):
                rows[key] = []
            cs._rrdb_rows(torch, gen, rows, 32, ((hw, 14), (2 * hw, 14)), "ab", cd=None,
                          key="rrdb_f32")
            cs._trunk_rows(torch, gen, rows, ((hw, 2), (2 * hw, 2)), "ab", cd=None,
                           key="rrdb_trunk_f32")
            cs._chain3s_rows(torch, gen, rows, 8, [("L1 main", 24, hw), ("L0 main", 12, 2 * hw)],
                             "ab", cd=None, key="chain3s_f32")
    flat = [r for k in rows for r in rows[k]]
    print(root, " ".join(f"{r['ms']:.4f}" for r in flat), flush=True)
    print(root, "library", " ".join(f"{r['library_ms']:.4f}" for r in flat
                                    if r["library_ms"] is not None), flush=True)
    print(root, "trunk bit-identical to the per-RRDB kernel, per-RRDB ms",
          " ".join(f"{r['identical_to_per_rrdb']} {r['per_rrdb_ms']:.4f}"
                   for r in rows["rrdb_trunk"]), flush=True)


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) == 2 and args[0] in ("--one", "--one-unchecked"):
        (run_one if args[0] == "--one" else run_unchecked)(args[1])
        return 0
    mode = "--one"
    if args and args[0] == "--unchecked":
        mode, args = "--one-unchecked", args[1:]
    if not args:
        print(__doc__, file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print("rows:", ROWS, flush=True)
    rc = 0
    for root in args:
        rc |= subprocess.run([sys.executable, __file__, mode, root]).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
