"""Profiling utilities: the program's spans, a throughput meter (images and megapixels
per second) for training and serving loops, and a thin wrapper over ``torch.profiler``
that writes a trace viewable in Perfetto / TensorBoard.

Spans.  The program opens a span, named ``hcflow.<layer>``, at each layer boundary of a
serving or training pass:

- ``hcflow.reverse`` / ``hcflow.forward``: the models' entry calls
  (``models/hcflow_sr.py``, ``models/hcflow_rescaling.py``);
- ``hcflow.cond``: one level's conditional flow (``flow/conditional.py``
  ``forward``, ``reverse``, ``encode_eps``), and inside it ``hcflow.encoder``, the
  conditioning encoder (``cond_feature``: conv_first, both trunks, trunk_conv1);
- ``hcflow.main``: one level's main chain (``flow/flownet.py`` ``_main_inverse``,
  ``_main_forward``);
- ``hcflow.rrdb``, ``hcflow.chain``, ``hcflow.chain3s``: the kernel wrappers
  (``ops/rrdb.py`` ``trunk_apply``, ``ops/chain.py`` and ``ops/chain3s.py``
  ``inverse_chain``), on the card and on the CPU's plain versions alike;
- ``hcflow.cast``: in the bf16 recipe, each library conv's casts (``ops/nets.py``
  ``conv2d``): one span around the operands' casts to bf16 and one around the output's
  upcast to float32, with the conv between them left to its layer's span; the float32
  recipe opens none.

A span is a ``torch.profiler.record_function`` while a profile with CPU activity
records, and otherwise one shared null context, so that a pass outside a profile pays
one check a span.  Spans and the card's operations are on the profiler's one clock: a
device operation belongs to the spans open on the host when it was launched (the trace
links each to its launch).  To see them, profile a pass with CPU and CUDA activity,
with :func:`trace` or any ``torch.profiler.profile``.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Optional

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A span named ``name`` (``hcflow.<layer>``) while a profile records; otherwise
    one shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorate a function to run inside :func:`span` ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return inner

    return wrap


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
    (TensorBoard's trace handler), which holds the program's spans, and yield the
    profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
