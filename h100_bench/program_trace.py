"""The program's own spans in the traced run, reduced for the readers of the layers
inside the entry call.

``hcflow_tpu_torch`` opens a span (``torch.profiler.record_function``, on the profiler's
clock) at each layer boundary while a profile records: ``hcflow.reverse`` /
``hcflow.forward`` (the entry), ``hcflow.cond`` (a level's conditional flow) with
``hcflow.encoder`` (its conditioning encoder) inside, ``hcflow.main`` (a level's main
chain), ``hcflow.rrdb``, ``hcflow.chain``, ``hcflow.chain3s`` (the kernel wrappers).
From the window's events this module computes:

- device time by the innermost program span open when each device operation was launched
  (the profiler's correlation id links an operation to its launch; innermost: the open
  span with the latest start), the union of the operations' intervals a span name;
- each program span's host self time: its duration less its child spans' (the
  benchmark's spans count as children, so that their own work is not the program's);
- the owner of each idle gap of the window: the innermost span open, of the benchmark's
  (``bench.*``) and the program's, at the gap's start.

The harness reduces the profiler's events into a ``trace.Reading``, which keeps the
benchmark's spans only.  Importing this module puts its :class:`Reading`, a subclass
that leaves every value of ``trace.Reading`` as it is and keeps the events, in
``trace.Reading``'s place: the readers that use the reduction import this module, and
the harness imports every reader before its run.  The reduction is made when a reader
first asks for it (``Reading.program``), and logged then on standard error with its
agreement with the benchmark's wrapper spans, so that a cell whose readers read no
program span pays nothing for it.  A program without spans gives an empty reduction,
and the readers then return None.
"""

from __future__ import annotations

import bisect
import functools
import sys
import time

from . import trace

ENTRIES = ("hcflow.reverse", "hcflow.forward")


class ProgramTrace:
    """The window's program spans reduced (seconds)."""

    def __init__(self, events: list):
        ann, launch, device = [], {}, []
        window = None
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = str(ev.get("cat", "")).lower()
            name = str(ev.get("name", ""))
            if cat == "user_annotation" and name.startswith(("bench.", "hcflow.")):
                span = (ev["ts"], ev["ts"] + ev.get("dur", 0), name)
                ann.append(span)
                if name == "bench.window" and window is None:
                    window = span[:2]
            elif cat in trace._LAUNCH:
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launch[corr] = ev["ts"]
            elif cat in trace._DEVICE:
                device.append(ev)
        self.has_spans = any(n.startswith("hcflow.") for _, _, n in ann)
        self.device_ops = 0
        self.device_s, self.self_s, self.idle_s = {}, {}, {}
        # outer before inner: by start, the longer first, the benchmark's span before the
        # program's of the same interval (the program's runs inside the benchmark's)
        ann.sort(key=lambda s: (s[0], -s[1], s[2].startswith("hcflow.")))
        self.starts = [s for s, _, _ in ann]
        self.ends = [e for _, e, _ in ann]
        self.names = [n for _, _, n in ann]
        if window is None:
            return
        w0, w1 = window
        self.parent, stack = [], []
        for i, (s, e, _) in enumerate(ann):
            while stack and self.ends[stack[-1]] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        # the nearest program span holding each span, itself included
        self.in_program = []
        for i, n in enumerate(self.names):
            p = self.parent[i]
            self.in_program.append(i if n.startswith("hcflow.")
                                   else (self.in_program[p] if p >= 0 else -1))
        child = [0.0] * len(ann)
        for i, p in enumerate(self.parent):
            if p >= 0:
                child[p] += self.ends[i] - self.starts[i]
        for i, n in enumerate(self.names):
            if n.startswith("hcflow.") and w0 <= self.starts[i] <= w1:
                self.self_s[n] = self.self_s.get(n, 0.0) + (
                    self.ends[i] - self.starts[i] - child[i]) / 1e6

        by_span, busy = {}, []
        for ev in device:
            s, e = max(ev["ts"], w0), min(ev["ts"] + ev.get("dur", 0), w1)
            if e <= s:
                continue
            busy.append((s, e))
            t = launch.get((ev.get("args") or {}).get("correlation"))
            i = self.innermost(t) if t is not None else -1
            p = self.in_program[i] if i >= 0 else -1
            by_span.setdefault(self.names[p] if p >= 0 else None, []).append((s, e))
        self.device_ops = len(busy)
        self.device_s = {k: trace._union(v)[0] / 1e6 for k, v in by_span.items()}
        _, merged = trace._union(busy)
        prev = w0
        for s, e in merged + [[w1, w1]]:
            if s > prev:
                i = self.innermost(prev)
                owner = self.names[i] if i >= 0 else "no span"
                self.idle_s[owner] = self.idle_s.get(owner, 0.0) + (s - prev) / 1e6
            prev = max(prev, e)

    def innermost(self, t) -> int:
        """The index of the innermost span open at time t, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.ends[i] < t:
            i = self.parent[i]
        return i


class Reading(trace.Reading):
    """``trace.Reading``, whose values it leaves as they are, with the reduction of the
    program's spans (``program``), made and logged on standard error when first read."""

    def __init__(self, events: list, calls, requests: int):
        super().__init__(events, calls, requests)
        self._trace_events = events

    @functools.cached_property
    def program(self) -> ProgramTrace:
        t0 = time.perf_counter()
        pt = ProgramTrace(self._trace_events)
        self._trace_events = None
        _log(pt, self, time.perf_counter() - t0)
        return pt


if not issubclass(trace.Reading, Reading):
    trace.Reading = Reading


def per_request_ms(r, seconds):
    return 1e3 * seconds / r.requests if r.requests else None


def _fmt(d: dict, r) -> str:
    return ", ".join(f"{k} {per_request_ms(r, v):.4f}"
                     for k, v in sorted(d.items(), key=lambda kv: -kv[1]))


def _pct(a, b) -> str:
    return f"{100.0 * (a - b) / b:+.3f}%" if b else "n/a"


def _log(pt: ProgramTrace, r, seconds: float):
    """The program spans' reduction and its agreement with the benchmark's own spans, on
    standard error."""
    def log(msg):
        print(f"program spans: {msg}", file=sys.stderr, flush=True)

    if not pt.has_spans or not r.requests:
        log("none in the trace (the program opens no hcflow.* span)" if r.requests
            else "no request in the window")
        return
    log(f"reduced in {seconds:.1f} s")
    dev = {("(no program span)" if k is None else k): v for k, v in pt.device_s.items()}
    log("device ms a request by innermost program span: " + _fmt(dev, r))
    log("host self ms a request: " + _fmt(pt.self_s, r))
    log("idle ms a request by innermost span: " + _fmt(pt.idle_s, r))
    for w in trace.WRAPPERS:
        mine = pt.device_s.get(f"hcflow.{w}", 0.0)
        bench = r.device_s.get(w, 0.0)
        spans, calls = pt.names.count(f"hcflow.{w}"), r.calls.work[w][3]
        if not (mine or bench or spans or calls):
            continue
        log(f"agreement {w}: device ms a request hcflow.{w} {per_request_ms(r, mine):.4f} "
            f"bench.{w} {per_request_ms(r, bench):.4f} ({_pct(mine, bench)}); "
            f"{spans} hcflow.{w} spans, {calls} calls")
    lib = r.device_s.get("library", 0.0)
    parts = {n: pt.device_s.get(n, 0.0) for n in ("hcflow.encoder", "hcflow.cond",
                                                  "hcflow.main")}
    parts["entry self"] = sum(pt.device_s.get(n, 0.0) for n in ENTRIES)
    total = sum(parts.values())
    log("library split: " + " + ".join(f"{k} {per_request_ms(r, v):.4f}" for k, v in
                                       parts.items())
        + f" = {per_request_ms(r, total):.4f} ms a request, library.device_ms "
          f"{per_request_ms(r, lib):.4f} ({_pct(total, lib)})")


# ------------------------------------------------------------------ for readers
def device_ms(r, name: str):
    """Device ms a request launched with program span ``name`` innermost; None where
    the trace holds no such time."""
    pt = getattr(r, "program", None)
    dev = pt.device_s.get(name, 0.0) if pt is not None else 0.0
    return per_request_ms(r, dev) if dev else None


def host_self_ms(r, name: str):
    """Host self ms a request in program span ``name``; None where there is none."""
    pt = getattr(r, "program", None)
    host = pt.self_s.get(name, 0.0) if pt is not None else 0.0
    return per_request_ms(r, host) if host else None


def program_idle_ms(r):
    """Device idle ms a request in gaps that open while a program span is the innermost
    span open; None where the trace holds no device operation or no program span."""
    pt = getattr(r, "program", None)
    if pt is None or not pt.has_spans or not pt.device_ops:
        return None
    return per_request_ms(r, sum(v for k, v in pt.idle_s.items() if k.startswith("hcflow.")))
