"""Run chip_smoke.py's mesh phases alone: 12 (spatially sharded serving) and 13 (training on
the mesh), with their checks.

    python3 tools/mesh_phases.py [--phases 12,13] [--json PATH]

The phases' 2 ranks (``parallel.dryrun.launch``) take one card each over NCCL where the
machine has 2 or more cards, else share the one card over gloo, as in ``chip_smoke.py``.
Builds the kernels first for phase 12 (one nvcc a source, in parallel).  Prints every
phase's log, the cards' names and power limits and the backend the ranks used; with
``--json`` also writes each phase's record.  Exits non-zero if a check fails or there
is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="12,13", help="a comma-separated subset of 12,13")
    ap.add_argument("--json", help="also write each phase's record to this file")
    a = ap.parse_args()
    phases = a.phases.split(",")
    if not set(phases) <= {"12", "13"}:
        ap.error(f"--phases {a.phases}: only 12 and 13")
    if not torch.cuda.is_available():
        sys.exit("mesh_phases: no CUDA device")
    import chip_smoke as cs
    from hcflow_tpu_torch import _build

    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout
    backend = cs._sp_backend()
    cs.log(f"cards: {'; '.join(cards.strip().splitlines())}; {cs.SP_WORLD} ranks over {backend}")
    t0 = time.perf_counter()
    out = {"cards": cards.strip().splitlines(), "backend": backend}
    if "12" in phases:  # phase 13 trains on the plain path: no kernel
        _build.build()
        cs.log(f"kernels built in {time.perf_counter() - t0:.1f} s")
        cs.log("phase 12: spatially sharded serving")
        out["spatial"] = cs.phase_spatial(torch, torch.Generator(device=cs.DEV).manual_seed(0))
    if "13" in phases:
        cs.log("phase 13: training on the mesh")
        out["spatial_train"] = cs.phase_spatial_train(torch, cs.card_line())
    if a.json:
        with open(a.json, "w") as f:
            json.dump(out, f, indent=1, default=str)
    cs.log(f"mesh_phases: phases {a.phases} passed over {backend} in "
           f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
