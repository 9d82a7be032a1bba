"""Split the time of a spatially sharded pass into its halo exchanges and the rest, on
one GPU.

    python3 tools/probe_halo.py [--world 2] [--f32] [--reps 5] [--lr 512]

``--world`` ranks (``parallel.dryrun.launch``: one card each over NCCL where the machine
has as many cards, else all on the one card over gloo) serve the x4 SR reverse of
``chip_smoke.py`` phase 12 (a): the bf16 serving recipe (``--f32``: the float32 one, (b)),
fused, batch 1, LR lr x lr, heat 0.9, on a (1, world) mesh.  Each rank times, as phase
12 does (CUDA events after a barrier, the median of ``--reps`` passes):

1. ``served``: the pass as served, each exchange one ``all_gather``;
2. ``local``: the pass with every exchange replaced by one that pads the band with as
   many of its own edge rows as the real one adds (no communication; the same shapes,
   launches and kernel work, wrong values): what two ranks' compute on one card costs;
3. ``exchanges``: the pass's exchanges alone, replayed at the shapes the pass gave them
   (a barrier, then each exchange in turn, the device synchronised after the last).

This process first times the unsharded pass on the card (``unsharded``).  Prints one
JSON line with every rank's three medians, the exchanges' count and bytes a pass, the
backend, and the cards' names and power limits.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402


def _params(lr_hw, cd):
    import chip_smoke as cs
    from hcflow_tpu_torch.models import HCFlowSRSpec

    model = HCFlowSRSpec.for_scale(4, compute_dtype=cd)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = cs._to(cs.perturb(model.init(0, device="cuda"), gen), "cpu")
    lr = torch.rand(1, lr_hw, lr_hw, 3, generator=torch.Generator().manual_seed(12))
    return model, params, lr


def _median_ms(fn, reps):
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), times


def _rank(model, params, lr, reps):
    from hcflow_tpu_torch.parallel import halo, mesh

    m = mesh.make_mesh(mesh_shape=(1, torch.distributed.get_world_size()))
    dev = mesh.rank_device()
    pp = model.flow.precompute_inference(_to(params, dev), fused=True)
    band = m.shard(lr.to(dev))
    g = torch.Generator(dev)

    def request():
        g.manual_seed(1)
        return model.reverse(pp, band, 0.9, generator=g, mesh=m)

    real = halo.exchange
    shapes = []

    def recording(x, rows, mesh_, unit):
        shapes.append((tuple(x.shape), rows, unit))
        return real(x, rows, mesh_, unit)

    def local(x, rows, mesh_, unit):  # the real exchange's shapes, no communication
        s, j, h = mesh_.spatial, mesh_.spatial_index, x.shape[1]
        top, bot = min(rows, j * h), min(rows, (s - 1 - j) * h)
        pieces = [x[:, :top].flip(1)] if top else []
        pieces += [x] + ([x[:, h - bot:].flip(1)] if bot else [])
        return torch.cat(pieces, 1), (top, bot)

    halo.exchange = recording
    request()  # warm-up, and the exchanges' shapes
    torch.cuda.synchronize()
    halo.exchange = real
    out = {}
    mesh.barrier()
    out["served"] = _median_ms(request, reps)
    halo.exchange = local
    request()
    torch.cuda.synchronize()
    mesh.barrier()
    out["local"] = _median_ms(request, reps)
    halo.exchange = real
    xs = [(torch.randn(s, device=dev), rows, unit) for s, rows, unit in shapes]
    mesh.barrier()

    def exchanges():
        for x, rows, unit in xs:
            real(x, rows, m, unit)

    exchanges()
    torch.cuda.synchronize()
    mesh.barrier()
    out["exchanges"] = _median_ms(exchanges, reps)
    halo.exchanges_by.clear()
    halo.bytes_by.clear()
    exchanges()
    out["count"], out["bytes"] = sum(halo.exchanges_by.values()), sum(halo.bytes_by.values())
    out["backend"], out["device"] = torch.distributed.get_backend(), str(dev)
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--f32", action="store_true", help="the float32 recipe")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--lr", type=int, default=512)
    a = ap.parse_args()
    from hcflow_tpu_torch import _build
    from hcflow_tpu_torch.parallel import dryrun

    if not torch.cuda.is_available():
        sys.exit("probe_halo: no CUDA device")
    _build.build()
    model, params, lr = _params(a.lr, None if a.f32 else "bfloat16")
    pp = model.flow.precompute_inference(_to(params, "cuda"), fused=True)
    g = torch.Generator("cuda")
    lr_dev = lr.cuda()

    def request():
        g.manual_seed(1)
        return model.reverse(pp, lr_dev, 0.9, generator=g)

    request()
    torch.cuda.synchronize()
    unsharded = _median_ms(request, a.reps)
    del pp
    torch.cuda.empty_cache()
    ranks = dryrun.launch(a.world, _rank, (model, params, lr, a.reps))
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60, check=True).stdout
    print(json.dumps({"cards": cards.strip().splitlines(), "world": a.world, "f32": a.f32,
                      "lr": a.lr, "unsharded_ms": unsharded, "ranks": ranks}))


if __name__ == "__main__":
    main()
