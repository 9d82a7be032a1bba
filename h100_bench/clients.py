"""The entries a request drives, on the program's side and on the reference's.

``reverse`` (LR -> HR: SR sampling, or the rescaling upscale from stored 8-bit codes):
the request's B uint8 LR images (the mix's ``batch``) go to the card in one copy, become
[0, 1] floats and run the model's ``reverse`` as one batch with the request's latents;
the B HR images go back to pinned host memory on a copy stream, so that with two
requests in flight the next one's work overlaps the read back.  ``forward`` (the
rescaling downscale, an image store taking a photo in): the uint8 HR goes to the card,
runs the model's ``forward`` and ``quantize``; its 8-bit LR codes go to host memory, its
latents stay on the card.  ``tiled_reverse``: the predictor's whole-image path
(``cli/tiled.py`` ``tiled_reverse`` as ``Predictor.predict`` calls it), synchronous, each
batch of tiles with its own latents.

A request is done when its output is in host memory.  :meth:`check` runs the reference
on a done request's inputs and returns what is compared.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from .reference import tiles as ref_tiles
from .reference.hcflow import codes as ref_codes


class Handle:
    def __init__(self, r, t_issue):
        self.r, self.t_issue, self.t_done = r, t_issue, None
        self.out = None  # the output in host memory once done
        self.keep = None  # what else the check compares (device tensors)
        self._dev = self._event = None


class Client:
    """Issue and complete requests of one traffic mix against the program."""

    def __init__(self, traffic, model, params, device, span=None):
        self.t, self.model, self.params = traffic, model, params
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.span = span or (lambda name: contextlib.nullcontext())
        self.inputs = traffic.images()
        self.copy_stream = torch.cuda.Stream() if self.cuda else None
        self._free = []
        self.on_entry = None  # called with (B, H, W) of the HR of each entry call
        if traffic.entry == "tiled_reverse":  # the predictor reads float32 HWC numpy
            self._lr_np = [(img.numpy().astype(np.float32) / 255.0) for img in self.inputs]

    # ----------------------------------------------------------------- buffers
    def _buffer(self, shape, dtype):
        for i, b in enumerate(self._free):
            if b.shape == shape and b.dtype == dtype:
                return self._free.pop(i)
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def release(self, h):
        """Give a done request's host buffer back for reuse."""
        if isinstance(h.out, torch.Tensor):
            self._free.append(h.out)
        h.out, h.keep = None, None

    def _to_host(self, h, t: torch.Tensor):
        buf = self._buffer(tuple(t.shape), t.dtype)
        if self.cuda:
            done = torch.cuda.Event()
            done.record()
            with torch.cuda.stream(self.copy_stream):
                self.copy_stream.wait_event(done)
                buf.copy_(t, non_blocking=True)
                h._event = torch.cuda.Event()
                h._event.record()
        else:
            buf.copy_(t)
        h.out, h._dev = buf, t  # the device tensor lives until its copy is done

    def _input(self, r):
        ids = self.t.image_ids(r, len(self.inputs))
        if ids == list(range(ids[0], ids[0] + len(ids))):  # a slice of the pinned pool
            x = self.inputs[ids[0]: ids[0] + len(ids)]
        else:
            x = self.inputs[ids]
        x = x.to(self.device, non_blocking=True)
        return x.float() / 255.0

    # ------------------------------------------------------------------ requests
    def issue(self, r: int) -> Handle:
        h = Handle(r, time.perf_counter())
        entry = self.t.entry
        with torch.no_grad():
            if entry == "tiled_reverse":
                h.out = self._tiled(r)
                h.t_done = time.perf_counter()
                return h
            x = self._input(r)
            if entry == "reverse":
                eps = self.t.eps(r, 0, x.shape[0])
                self._count(x.shape[0], x.shape[1] * self.t.scale, x.shape[2] * self.t.scale)
                with self.span("bench.entry"):
                    hr = self.model.reverse(self.params, x, self.t.heat, eps_list=eps)
                self._to_host(h, hr)
            elif entry == "forward":
                self._count(*x.shape[:3])
                with self.span("bench.entry"):
                    lr, zs = self.model.forward(self.params, x)
                self._to_host(h, torch.round(lr[0].clamp(0.0, 1.0) * 255.0).to(torch.uint8))
                h.keep = zs
            else:
                raise ValueError(f"unknown entry {entry!r}")
        return h

    def _count(self, B, H, W):
        if self.on_entry is not None:
            self.on_entry(B, H, W)

    def complete(self, h: Handle) -> Handle:
        if h.t_done is None:
            if h._event is not None:
                h._event.synchronize()
            h.t_done = time.perf_counter()
            h._dev = h._event = None
        return h

    def _tiled(self, r):
        from hcflow_tpu_torch.cli.tiled import tiled_reverse

        p = self.t.p
        lr = self._lr_np[r % len(self._lr_np)]
        h0, w0 = lr.shape[:2]
        lr = np.pad(lr, ((0, h0 % 2), (0, w0 % 2), (0, 0)), mode="reflect")
        batches = iter(range(1 << 30))

        def reverse_fn(params, lr_batch, heat, generator):  # Predictor.reverse, own latents
            with self.span("bench.reverse_fn"):
                b = next(batches)
                x = torch.from_numpy(np.ascontiguousarray(lr_batch, np.float32)).to(self.device)
                eps = self.t.eps(r, b, x.shape[0], tuple(x.shape[1:3]))
                self._count(x.shape[0], x.shape[1] * self.t.scale, x.shape[2] * self.t.scale)
                with self.span("bench.entry"):
                    hr = self.model.reverse(params, x, heat, eps_list=eps)
                return hr.cpu().numpy()

        with self.span("bench.tiled"):
            sr = tiled_reverse(reverse_fn, self.params, lr, self.t.scale, self.t.heat, None,
                               tile=p["tile"], overlap=p["overlap"], batch=p["tile_batch"])
        return sr[: h0 * self.t.scale, : w0 * self.t.scale]


# ------------------------------------------------------------------ the check
def _nchw(t):
    return t.permute(0, 3, 1, 2)


def check(traffic, pool, ref, h: Handle, device) -> dict:
    """The reference on request h's inputs, against what the program returned: for the
    HR images, the absolute differences (``hr``); for codes and latents, the codes and
    the latents' differences.  ``pool``: the inputs the program was given.  Runs once the
    program's state is freed."""
    dev = torch.device(device)
    entry, r = traffic.entry, h.r
    img = pool[r % len(pool)]
    if entry == "reverse":  # the request's B images and latents, as the program had them
        x = _nchw(pool[traffic.image_ids(r, len(pool))].to(dev).float() / 255.0)
        hr = ref.reverse(x, [_nchw(e) for e in traffic.eps(r, 0, traffic.batch)])
        got = _nchw(torch.as_tensor(h.out).to(dev))
        return {"hr": (got - hr).abs()}
    if entry == "tiled_reverse":
        p = traffic.p
        lr = img.numpy().astype(np.float32) / 255.0

        def run_batch(b, tiles):
            x = torch.from_numpy(tiles).to(dev)
            eps = traffic.eps(r, b, x.shape[0], tuple(x.shape[1:3]))
            return ref.reverse(_nchw(x), [_nchw(e) for e in eps]).permute(0, 2, 3, 1).cpu().numpy()

        want = ref_tiles.tiled(run_batch, lr, traffic.scale, p["tile"], p["overlap"],
                               p["tile_batch"])
        got = np.asarray(h.out)
        if got.shape != want.shape:
            return {"hr": torch.full((1,), float("inf"))}
        return {"hr": torch.from_numpy(np.abs(got - want))}
    x = _nchw(img.to(dev).float()[None] / 255.0)
    lr, latents = ref.forward(x)
    want = ref_codes(lr)[0].permute(1, 2, 0)
    got = torch.as_tensor(h.out).to(dev)
    return {"codes": (got.int() - want.int()).abs(),
            "latents": [(_nchw(z).to(dev) - w).abs() / w.abs().max() for z, w in zip(h.keep,
                                                                                    latents)]}
