"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up builds the kernels the configuration names (the program's build cache lives in
its package, inside the checkout), draws the weights on the card from the seed, loads
them through the program's loader for released ``.pth`` weights
(``convert.params_from_state_dict``), packs them for the kernels
(``precompute_inference(fused=True)``), makes the pool of input images and serves a few
warm-up requests of the cell's own shapes.  The window is a closed loop that keeps the
mix's requests in flight: when one is done (its output in host memory) the next is
issued, until ``seconds`` have passed since the first; the window then waits for the
last ones.  ``hr_mps`` is the HR megapixels of every request of the window over the time
from the first issue to the last output; ``latency_p95_ms`` the 95th percentile of the
requests' times from issue to output.

Then the peak memory is read, the program's state freed, and the plain reference run on
a sample of the window's requests, drawn from the seed (reservoir sampling, so that the
program's outputs of only that many requests are kept); each number compared is printed
beside its limit.
"""

from __future__ import annotations

import collections
import contextlib
import math
import random
import sys
import time

import numpy as np
import torch

from . import clients, spec, trace, weights
from .reference.hcflow import HCFlowReference, Topology
from .traffic import Traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "hcflow_tpu"}  # the JAX package and JAX itself


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot), compared whole, is
    JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


class Reservoir:
    """A uniform sample of k of the requests offered, drawn from a seed (algorithm R)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.kept = k, random.Random(seed), 0, []

    def offer(self, h):
        """Keep h or not; returns the handle that is not kept (h, or one it evicts)."""
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(h)
            return None
        j = self.rng.randrange(self.seen)
        if j < self.k:
            h, self.kept[j] = self.kept[j], h
        return h


def serve(client, first: int, span, count=None, seconds=None, on_done=None):
    """A closed loop keeping the mix's requests in flight, from request index ``first``:
    ``count`` requests, or issuing until ``seconds`` have passed.  Returns (time of the
    first issue, time of the last output, latencies, requests)."""
    q, r = collections.deque(), first
    t0 = time.perf_counter()

    def more():
        return (r - first < count) if count is not None else time.perf_counter() - t0 < seconds

    def issue():
        nonlocal r
        with span("bench.issue"):
            q.append(client.issue(r))
        r += 1

    while len(q) < client.t.in_flight and more():
        issue()
    lat, t_last = [], t0
    while q:
        h = q.popleft()
        with span("bench.wait"):
            client.complete(h)
        lat.append(h.t_done - h.t_issue)
        t_last = h.t_done
        if on_done is not None:
            on_done(h)
        if more():
            issue()
    return t0, t_last, lat, r - first


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_model(config: dict, recipe=None):
    """The program's model spec from the configuration, through the option-file parser
    (``recipe`` "bfloat16": the program's own bf16 recipe of it)."""
    from hcflow_tpu_torch.utils import config as config_mod

    net = dict(config["network_G"])
    if recipe is not None:
        net["compute_dtype"] = recipe
    opt = {"model": config["model"], "scale": config["scale"], "network_G": net}
    if "quant" in config:
        opt["quant"] = config["quant"]
    return config_mod.model_spec_from_opt(opt)


class ReferenceModel:
    """The reference put in the program's place (the control): the entries' signatures
    on NHWC tensors."""

    def __init__(self, ref):
        self.ref = ref

    def reverse(self, params, lr, eps_std, eps_list=None, **_):
        out = self.ref.reverse(lr.permute(0, 3, 1, 2), [e.permute(0, 3, 1, 2) for e in eps_list])
        return out.permute(0, 2, 3, 1).contiguous()

    def forward(self, params, hr, **_):
        lr, zs = self.ref.forward(hr.permute(0, 3, 1, 2))
        return lr.permute(0, 2, 3, 1), [z.permute(0, 2, 3, 1) for z in zs]


def compare(traffic, pool, ref, kept, dev) -> dict:
    """The numbers compared, {name: value}, over the sampled requests."""
    if traffic.entry == "forward":
        flips, count, lat = 0, 0, 0.0
        for h in kept:
            d = clients.check(traffic, pool, ref, h, dev)
            flips += int((d["codes"] > 0).sum())
            count += d["codes"].numel()
            lat = max([lat] + [float(x.max()) for x in d["latents"]])
        return {"code_flip_share": flips / max(count, 1), "latent_max_rel": lat}
    top, sq, count = 0.0, 0.0, 0
    for h in kept:
        d = clients.check(traffic, pool, ref, h, dev)["hr"].double()
        top = max(top, float(d.max()))
        sq += float((d ** 2).sum())
        count += d.numel()
    return {"hr_max_abs": top, "hr_rms": math.sqrt(sq / max(count, 1))}


def run_cell(name: str, seed: int, seconds: float, traced: bool, device="cuda",
             root=spec.ROOT, t_start=None, program="port"):
    """One run of cell ``name``; returns the result line's dict (its keys,
    ``checks`` last).  ``program``: "port" (the program under test), or a control in
    its place: "port_bf16" (the program's own bf16 recipe) or "reference_tf32" (the
    reference with TF32 on)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = spec.load_cell(name, root)
    cfg, dev = cell.config, torch.device(device)
    torch.set_num_threads(2)
    from hcflow_tpu_torch import _build, convert

    marks = [("imports", time.perf_counter())]
    top = Topology(cfg["network_G"], cell.sr)
    model = build_model(cfg, "bfloat16" if program == "port_bf16" else None)
    if dev.type == "cuda":
        torch.cuda.init()
        marks.append(("CUDA context", time.perf_counter()))
        _build.build(tuple(cfg.get("kernels", ())))
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("kernels built or found", time.perf_counter()))
    sd = weights.state_dict(top, seed, dev)
    if program == "reference_tf32":
        params, model = None, ReferenceModel(HCFlowReference(sd, cfg["network_G"], cell.sr, dev,
                                                             tf32=True))
    else:
        params = convert.params_from_state_dict(sd, model, dev)
        params = model.flow.precompute_inference(params, fused=True)
    marks.append(("weights and packs", time.perf_counter()))
    traffic = Traffic(cell.traffic, top, cfg["scale"], seed, dev)
    calls = trace.Calls(top) if traced else None
    if calls is not None:
        calls.install()
    span = trace.span if traced else (lambda name: contextlib.nullcontext())
    client = clients.Client(traffic, model, params, dev, span)
    pool = client.inputs
    marks.append(("inputs", time.perf_counter()))
    serve(client, 0, span, count=traffic.in_flight + 1, on_done=client.release)  # warm-up
    _sync(dev)
    marks.append(("warm-up requests", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    prev = t_start
    steps = []
    for what, t in marks:
        steps.append(f"{what} {t - prev:.2f}")
        prev = t
    log(f"set-up {setup_s:.2f} s: " + ", ".join(steps))

    sampler = Reservoir(traffic.sample, weights.mix(seed, "sample"))

    def done(h):
        out = sampler.offer(h)
        if out is not None:
            client.release(out)

    if calls is not None:
        client.on_entry = calls.entry
    prof = trace.profiler(dev.type == "cuda") if traced else None
    if prof is not None:
        calls.reset()
        prof.start()
    with span("bench.window"):
        t0, t1, lat, n = serve(client, traffic.in_flight + 1, span, seconds=seconds,
                               on_done=done)
        _sync(dev)
    if prof is not None:
        prof.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    reading = None
    if prof is not None:
        calls.uninstall()
        t_trace = time.perf_counter()
        reading = trace.Reading(trace.chrome_events(prof), calls, n)
        del prof
        log(f"trace: {reading.events} events, {reading.device_ops_seen} device operations "
            f"({reading.unlinked} not linked to a launch), read in "
            f"{time.perf_counter() - t_trace:.1f} s")

    # the program's state freed, then the reference on the sample
    kept = sampler.kept
    del client, params, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = HCFlowReference(sd, cfg["network_G"], cell.sr, dev)
    t_ref = time.perf_counter()
    values = compare(traffic, pool, ref, kept, dev)
    ref_s = time.perf_counter() - t_ref
    limits = cell.cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in values.items()}
    correct = bool(kept) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                 for c in checks.values())
    log(f"{name}: seed {seed}, {n} requests in {t1 - t0:.3f} s, reference {ref_s:.1f} s "
        f"on {len(kept)} of them, program {program}")
    for k, c in checks.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['value'] <= c['limit'] else 'FAIL'}")

    if reading is not None:
        metrics = {}
        for m in cell.metrics:
            v = m.read(reading)
            if v is not None:
                metrics[m.NAME] = {"value": v, "unit": m.UNIT}
    else:
        e2e = {"hr_mps": (n * traffic.hr_mp / (t1 - t0), "MP/s"),
               "latency_p95_ms": (float(np.percentile(lat, 95)) * 1e3 if lat else None, "ms"),
               "setup_s": (setup_s, "s")}
        # a cell may report a quantity under a name of its own, "<quantity>.<suffix>",
        # where its spread differs from the other cells' (the bound is a metric's)
        metrics = {k: {"value": e2e[k.split(".")[0]][0], "unit": e2e[k.split(".")[0]][1]}
                   for k in cell.cell["end_to_end"]}
    if dev.type == "cuda":
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                       "count": cell.cell["chips"], "memory_peak_bytes": peak}
    else:
        device_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": n, "failed": 0, "metrics": metrics,
              "device": device_info}
    if reading is not None:
        device_info.update(busy_s=reading.busy_s, window_s=reading.window_s)
        result["breakdown"] = reading.breakdown()
    result["checks"] = checks
    return result
