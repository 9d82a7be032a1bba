"""Halo exchange between the ranks that hold neighbouring bands of an image's rows.

Under a spatial axis (``mesh.Mesh``) a rank holds a band of h rows of its images.  A
unit of the model that reads rows around each output row (a 3x3 conv reads one each
side, an RRDB 15, a K-step chain 2K) runs on its band plus ``rows`` rows of the bands
above and below (:func:`exchange`), and keeps the band's rows of its output
(:func:`crop`); :func:`banded` does both.  The JAX package has no module for this: XLA's
SPMD partitioner inserts the exchanges (and their transposes) for it.

- At the image's own top and bottom the halo is clipped, not padded, so that a unit's
  own zero padding falls on the real image border, as on the whole image.
- ``rows`` may exceed a band: the rows then come from ranks further away.  Every rank
  of the spatial group sends its top and bottom ``min(rows, h)`` rows in one
  ``all_gather`` (a collective that both NCCL and gloo take for CUDA tensors) and takes
  what it needs of every other rank's.
- The exchange is differentiable: its backward sends each halo row's gradient back to
  the rank that owns the row, which adds it to the gradient of its own row (one
  ``all_gather`` of every rank's halo gradients, ``rows`` rows each side, zeros where
  the halo was clipped), so that a unit's gradient on a band equals the whole image's.
  Every rank runs its backward exchanges in the same order, as it ran the forward ones
  (``torch.utils.checkpoint`` reruns forward exchanges inside the backward pass, on
  every rank alike).
- Each exchange counts under its unit in ``exchanges_by`` and the bytes this rank sent
  in ``bytes_by``, a backward exchange under ``"<unit>.grad"`` (reset with
  ``.clear()``), as the kernels count their launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

exchanges_by = {}  # halo exchanges by unit: "conv", "rrdb", "trunk", "cond", "chain"; "*.grad"
bytes_by = {}  # bytes this rank sent in them, by unit


def sharded(mesh) -> bool:
    """Whether ``mesh`` splits the image height: a mesh whose spatial axis has more than
    one rank (None, the default everywhere, is the unsharded pass)."""
    return mesh is not None and mesh.spatial > 1


def count(unit: str, t: torch.Tensor) -> None:
    """Count one exchange of unit that sent t."""
    exchanges_by[unit] = exchanges_by.get(unit, 0) + 1
    bytes_by[unit] = bytes_by.get(unit, 0) + t.numel() * t.element_size()


def _all_gather(t: torch.Tensor, mesh) -> list:
    parts = [torch.empty_like(t) for _ in range(mesh.spatial)]
    dist.all_gather(parts, t, group=mesh.spatial_group)
    return parts


class _Exchange(torch.autograd.Function):
    """x (B, h, W, C) -> (B, top + h + bot, W, C): the band with ``top`` rows of the bands
    above and ``bot`` of those below; backward as the module's docstring says."""

    @staticmethod
    def forward(ctx, x, rows, top, bot, mesh, unit):
        s, j = mesh.spatial, mesh.spatial_index
        h = x.shape[1]
        m = min(rows, h)
        edges = torch.cat([x[:, :m], x[:, h - m :]], 1).contiguous()
        parts = _all_gather(edges, mesh)
        count(unit, edges)
        ctx.rows, ctx.top, ctx.bot, ctx.mesh, ctx.unit = rows, top, bot, mesh, unit
        pieces = [x]
        if top:  # the bottom rows of the ranks above, nearest last
            pieces.insert(0, torch.cat([p[:, m:] for p in parts[:j]], 1)[:, -top:])
        if bot:  # the top rows of the ranks below, nearest first
            pieces.append(torch.cat([p[:, :m] for p in parts[j + 1 :]], 1)[:, :bot])
        return torch.cat(pieces, 1)

    @staticmethod
    def backward(ctx, g):
        R, top, bot, mesh = ctx.rows, ctx.top, ctx.bot, ctx.mesh
        s, j = mesh.spatial, mesh.spatial_index
        h = g.shape[1] - top - bot
        gx = g[:, top : top + h].clone(memory_format=torch.contiguous_format)
        # this rank's halo gradients, R rows each side; a clipped halo's missing rows
        # (outside the image) are zeros
        send = g.new_zeros(g.shape[0], 2 * R, *g.shape[2:])
        send[:, R - top : R] = g[:, :top]
        send[:, R : R + bot] = g[:, top + h :]
        parts = _all_gather(send, mesh)
        count(f"{ctx.unit}.grad", send)
        # rank k's top halo held image rows [k h - R, k h), its bottom [(k + 1) h, (k + 1) h
        # + R); add what falls in this band, [j h, (j + 1) h)
        for k, p in enumerate(parts):
            if k == j:
                continue
            for lo, off in ((k * h - R, 0), ((k + 1) * h, R)):
                a, b = max(lo, j * h), min(lo + R, (j + 1) * h)
                if a < b:
                    gx[:, a - j * h : b - j * h] += p[:, off + a - lo : off + b - lo]
        return gx, None, None, None, None, None


def exchange(x: torch.Tensor, rows: int, mesh, unit: str):
    """NHWC x (this rank's band) with up to ``rows`` rows of the bands above and below
    it, fewer at the image border (``mesh.halo_cut`` fewer each side); returns (the
    extended tensor, (rows added above, rows added below)).  Every rank of the spatial
    group calls it together, on bands of one height; differentiable."""
    s, j = mesh.spatial, mesh.spatial_index
    h = x.shape[1]
    rows = max(rows - mesh.halo_cut, 0)
    if rows == 0:
        return x, (0, 0)
    top, bot = min(rows, j * h), min(rows, (s - 1 - j) * h)
    return _Exchange.apply(x, rows, top, bot, mesh, unit), (top, bot)


def crop(y: torch.Tensor, have, keep=(0, 0)) -> torch.Tensor:
    """y, computed on a band extended by ``have`` = (rows above, rows below), cut to the
    band extended by ``keep`` rows (at most ``have``), a view."""
    return y[:, have[0] - keep[0] : y.shape[1] - (have[1] - keep[1])]


def banded(fn, x: torch.Tensor, rows: int, mesh, unit: str) -> torch.Tensor:
    """fn(x) for a unit that maps an NHWC tensor to one of the same rows and reads
    ``rows`` rows each side of an output row: without a spatial axis fn(x) itself; with
    one, fn on the band plus its halo, cut back to the band."""
    if not sharded(mesh):
        return fn(x)
    xe, have = exchange(x, rows, mesh, unit)
    return crop(fn(xe), have)
