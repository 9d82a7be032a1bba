"""Profiling utilities, as the JAX package's ``hcflow_tpu/utils/profiling.py``: a scope
timer that waits for the card's queued work before it reads the clock, a throughput
meter (images and megapixels per second) for training and serving loops, and a thin
wrapper over ``torch.profiler`` that writes a trace viewable in Perfetto / TensorBoard.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


class ScopeTimer:
    """``with ScopeTimer('fwd') as t: ...``; synchronises the card at exit."""

    def __init__(self, name: str = "", logger=None, sync=True):
        self.name = name
        self.logger = logger
        self.sync = sync
        self.elapsed = None

    def __enter__(self):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync and torch.cuda.is_available():
            torch.cuda.synchronize()  # the work queued in the scope has finished
        self.elapsed = time.perf_counter() - self.t0
        msg = f"{self.name}: {self.elapsed * 1e3:.2f} ms"
        (self.logger.info if self.logger else print)(msg)
        return False


class ThroughputMeter:
    """Sliding-window step time, images/s and MP/s for training and serving loops."""

    def __init__(self, window: int = 100):
        self.window = window
        self.times = []
        self.pixels = []
        self.items = []
        self._last = None

    def tick(self, n_items: int = 0, n_pixels: int = 0):
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
            self.items.append(n_items)
            self.pixels.append(n_pixels)
            if len(self.times) > self.window:
                self.times.pop(0)
                self.items.pop(0)
                self.pixels.pop(0)
        self._last = now

    @property
    def step_time(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def items_per_sec(self) -> float:
        t = sum(self.times)
        return sum(self.items) / t if t else 0.0

    @property
    def megapixels_per_sec(self) -> float:
        t = sum(self.times)
        return sum(self.pixels) / 1e6 / t if t else 0.0


@contextlib.contextmanager
def trace(log_dir: Optional[str] = "profiles/torch-trace"):
    """Profile the host and the card over the block; write a trace under ``log_dir``
    (TensorBoard's trace handler) and yield the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
