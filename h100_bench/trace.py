"""The traced run: the benchmark's own spans around calls into the program, the
profiler's device trace, and its reduction to what the per-layer readers read.

Spans (``torch.profiler.record_function``, in the traced run only) go around:

- the window (``bench.window``), each request's issue (``bench.issue``) and the wait
  for its output (``bench.wait``);
- the entry call (``bench.entry``: ``reverse`` or ``forward`` of the model), and in
  the tiled path the whole ``tiled_reverse`` call (``bench.tiled``) and each of its
  ``reverse_fn`` calls (``bench.reverse_fn``);
- each call to the kernel wrappers' entry functions ``ops/rrdb.py`` ``trunk_apply``
  (``bench.rrdb``), ``ops/chain.py`` ``inverse_chain`` (``bench.chain``) and
  ``ops/chain3s.py`` ``inverse_chain`` (``bench.chain3s``), whose work is counted from
  the call's shapes and the option file's topology (:mod:`work`).

A device operation belongs to the innermost span open on the host when it was launched
(the profiler links each one to its launch by a correlation id), so a kernel's time goes
to the wrapper that launched it whatever the kernel is named.  Busy time is the union of
the device operations' intervals inside the window, so that overlapping launches count
once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile

import torch

from . import work

WRAPPERS = ("rrdb", "chain", "chain3s")
_DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}
_LAUNCH = {"cuda_runtime", "cuda_driver"}


def span(name: str):
    return torch.profiler.record_function(name)


class Calls:
    """The wrapper calls of the window, with their work, and the entry calls' model
    FLOP; :meth:`install` wraps the program's functions (the traced run only)."""

    def __init__(self, top):
        self.top = top
        self.work = {w: [0.0, 0.0, 0.0, 0] for w in WRAPPERS}  # flops, bytes, least s, calls
        self.model_flops = 0.0
        self._trunk = 0
        self._undo = []

    def reset(self):
        for w in WRAPPERS:
            self.work[w] = [0.0, 0.0, 0.0, 0]
        self.model_flops = 0.0

    def _add(self, name, flops, nbytes):
        rec = self.work[name]
        rec[0] += flops
        rec[1] += nbytes
        rec[2] += work.least_s(flops, nbytes)
        rec[3] += 1

    def _level(self, c: int, cond: bool):
        for i, (ci, _, a, _) in enumerate(self.top.levels):
            if (a if cond else ci) == c:
                return i
        raise ValueError(f"no level of the topology has {c} channels")

    def rrdb(self, x):
        nb = self.top.nb[self._trunk % 2]  # every level calls trunk0, then trunk1
        self._trunk += 1
        B, H, W, _ = x.shape
        self._add("rrdb", *work.trunk_work(B, H, W, self.top.nf, self.top.gc, nb))

    def chain(self, z, uc):
        B, H, W, c = z.shape
        cond = uc is not None
        i = self._level(c, cond)
        top = self.top
        K = top.after[i] if cond else top.levels[i][3]
        hid = top.so_hid if cond else top.hid
        _, flops, nbytes = work.chain_work(B, H, W, c, hid, K, cond)
        self._add("chain", flops, nbytes)

    def chain3s(self, z):
        B, H, W, c = z.shape
        _, flops, nbytes = work.chain3s_work(B, H, W, c, self.top.hid,
                                            self.top.levels[self._level(c, False)][3])
        self._add("chain3s", flops, nbytes)

    def entry(self, B, H_hr, W_hr):
        self.model_flops += work.model_flops(self.top, B, H_hr, W_hr)

    def install(self):
        """Wrap the program's kernel entry functions with a span and a work count."""
        from hcflow_tpu_torch.ops import chain, chain3s, rrdb

        def wrap(mod, fn, name, count):
            orig = getattr(mod, fn)

            def wrapped(*args, **kwargs):
                count(*args[1:], **kwargs)
                with span(f"bench.{name}"):
                    return orig(*args, **kwargs)

            setattr(mod, fn, wrapped)
            self._undo.append((mod, fn, orig))

        wrap(rrdb, "trunk_apply", "rrdb", lambda x, mesh=None: self.rrdb(x))
        wrap(chain, "inverse_chain", "chain", lambda z, uc=None: self.chain(z, uc))
        wrap(chain3s, "inverse_chain", "chain3s", lambda z: self.chain3s(z))

    def uninstall(self):
        for mod, fn, orig in reversed(self._undo):
            setattr(mod, fn, orig)
        self._undo.clear()


def profiler(cuda: bool = True):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    return profile(activities=acts)


def chrome_events(prof) -> list:
    """The profiler's events as its Chrome trace writes them (a file in TMPDIR, removed
    once read)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the merged intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


class Spans:
    """The host spans of one name, sorted, for 'which span holds time t'."""

    def __init__(self, spans):
        self.spans = sorted(spans)
        self.starts = [s for s, _ in self.spans]

    def holds(self, t) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]

    def total(self) -> float:
        return sum(e - s for s, e in self.spans)


class Reading:
    """What the per-layer readers read: the traced window reduced (seconds)."""

    def __init__(self, events: list, calls: Calls, requests: int):
        self.calls, self.requests = calls, requests
        ann, launch, device = {}, {}, []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            if cat == "user_annotation" and str(ev.get("name", "")).startswith("bench."):
                ann.setdefault(ev["name"], []).append((ev["ts"], ev["ts"] + ev.get("dur", 0)))
            elif cat in _LAUNCH:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = ev["ts"]
            elif cat in _DEVICE:
                device.append(ev)
        if "bench.window" not in ann:
            raise RuntimeError("the trace holds no bench.window span")
        w0, w1 = ann["bench.window"][0]
        self.window_s = (w1 - w0) / 1e6
        self.spans = {name: Spans(v) for name, v in ann.items()}
        inner = ["bench." + w for w in WRAPPERS] + ["bench.entry", "bench.reverse_fn",
                                                    "bench.tiled", "bench.issue", "bench.wait"]
        self.inner = [n for n in inner if n in self.spans]

        by_label, by_op, busy = {}, {}, []
        self.events, self.device_ops_seen, self.unlinked = len(events), len(device), 0
        for ev in device:
            s, e = max(ev["ts"], w0), min(ev["ts"] + ev.get("dur", 0), w1)
            if e <= s:
                continue
            busy.append((s, e))
            t = launch.get((ev.get("args") or {}).get("correlation"))
            self.unlinked += t is None
            label = self.owner(t) if t is not None else None
            key = {"bench.entry": "library", "bench.rrdb": "rrdb", "bench.chain": "chain",
                   "bench.chain3s": "chain3s"}.get(label, "outside the entry")
            by_label.setdefault(key, []).append((s, e))
            op = key if key in WRAPPERS else f"{key}: {str(ev.get('name', ''))[:72]}"
            by_op[op] = by_op.get(op, 0.0) + (e - s)
        self.busy_s, merged = _union(busy)
        self.busy_s /= 1e6
        self.device_s = {k: _union(v)[0] / 1e6 for k, v in by_label.items()}
        self.device_ops = sorted(([k, v / 1e6] for k, v in by_op.items()), key=lambda kv: -kv[1])
        gaps = {}
        prev = w0
        for s, e in merged + [[w1, w1]]:
            if s > prev:
                owner = self.owner(prev) or "no span"
                gaps[owner] = gaps.get(owner, 0.0) + (s - prev) / 1e6
            prev = max(prev, e)
        self.idle_gaps = sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])

    def owner(self, t):
        """The innermost benchmark span open on the host at time t."""
        for name in self.inner:
            if self.spans[name].holds(t):
                return name
        return None

    def host_s(self, name: str) -> float:
        sp = self.spans.get(name)
        return sp.total() / 1e6 if sp else 0.0

    # ------------------------------------------------------------- for readers
    def roofline_pct(self, wrapper: str):
        """The least time of the wrapper's calls over the device time of what they
        launched, in percent; None where the window made no such call."""
        flops, nbytes, least, n = self.calls.work[wrapper]
        dev = self.device_s.get(wrapper, 0.0)
        if n == 0 or dev <= 0:
            return None
        return 100.0 * least / dev

    def breakdown(self) -> dict:
        return {"device_ops": self.device_ops[:10], "idle_gaps": self.idle_gaps[:10]}
