"""Readings that the correctness limits are set from, on the card at a cell's own size.

    python3 h100_bench/control.py --workload <name> --seeds 1,2,3 [--seconds 4]
        [--programs port,reference_tf32,port_bf16] [--json PATH]

For each program and seed, one run of the cell (:func:`harness.run_cell`, a short
window at the cell's own load) in this one process, and the numbers it compares with
the reference: ``port`` is the program under test (the lower readings); the controls
put something else in its place, ``reference_tf32`` the reference with TF32 on (the
precision below the configuration's float32 with TF32 off) and ``port_bf16`` the
program's own bf16 recipe of the configuration (the upper readings).  The benchmark's
own runs never run a control.  Prints one JSON line per run and a summary: for each
program and number, the least and the largest reading over the seeds.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--programs", default="port,reference_tf32,port_bf16")
    ap.add_argument("--json", help="also write every reading to this file")
    args = ap.parse_args(argv)

    import torch

    from h100_bench import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = []
    for program in args.programs.split(","):
        for seed in seeds:
            t = time.perf_counter()
            res = harness.run_cell(args.workload, seed, args.seconds, False, program=program)
            rec = {"program": program, "seed": seed, "attempted": res["attempted"],
                   "s": time.perf_counter() - t,
                   "checks": {k: c["value"] for k, c in res["checks"].items()}}
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    summary = {}
    for rec in runs:
        for k, v in rec["checks"].items():
            lo_hi = summary.setdefault(rec["program"], {}).setdefault(k, [v, v])
            lo_hi[0], lo_hi[1] = min(lo_hi[0], v), max(lo_hi[1], v)
    print(json.dumps({"workload": args.workload, "least_largest": summary}), flush=True)
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps({"runs": runs, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
