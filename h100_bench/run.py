"""Run one cell of the benchmark of ``hcflow_tpu_torch`` once, on the card(s) of this
machine, and print its result as the last line of standard output.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a profiled window.  The line is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device`` (with
``--trace 1`` also ``breakdown``) and, last, ``checks``: each number compared with the
reference beside its limit, which the last lines of standard error repeat.  Exits
non-zero, with no result, without enough CUDA cards, without the program, or where the
JAX package or JAX was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power limit not read (nvidia-smi failed)"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from h100_bench import harness, spec

    cell = spec.load_cell(args.workload)
    chips = cell.cell["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run: {args.workload} needs {chips} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    try:
        import hcflow_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run: the program under test (hcflow_tpu_torch) is missing: {e}", file=sys.stderr)
        return 2
    print(f"card: {card_line()}", flush=True)
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run: the process loaded {', '.join(bad)}, which the port must not use",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
