"""Halo exchange between the ranks that hold neighbouring bands of an image's rows.

Under a spatial axis (``mesh.Mesh``) a rank holds a band of h rows of its images.  A
unit of the model that reads rows around each output row (a 3x3 conv reads one each
side, an RRDB 15, a K-step chain 2K) runs on its band plus ``rows`` rows of the bands
above and below (:func:`exchange`), and keeps the band's rows of its output
(:func:`crop`); :func:`banded` does both.  The JAX package has no module for this: XLA's
SPMD partitioner inserts the exchanges for it.

- At the image's own top and bottom the halo is clipped, not padded, so that a unit's
  own zero padding falls on the real image border, as on the whole image.
- ``rows`` may exceed a band: the rows then come from ranks further away.  Every rank
  of the spatial group sends its top and bottom ``min(rows, h)`` rows in one
  ``all_gather`` (a collective that both NCCL and gloo take for CUDA tensors) and takes
  what it needs of every other rank's.
- Each exchange counts under its unit in ``exchanges_by`` and the bytes this rank sent
  in ``bytes_by`` (reset with ``.clear()``), as the kernels count their launches.
- There is no backward: an input that requires grad raises (spatial training is not
  ported).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

exchanges_by = {}  # halo exchanges by unit: "conv", "rrdb", "trunk", "cond", "chain"
bytes_by = {}  # bytes this rank sent in them, by unit


def sharded(mesh) -> bool:
    """Whether ``mesh`` splits the image height: a mesh whose spatial axis has more than
    one rank (None, the default everywhere, is the unsharded pass)."""
    return mesh is not None and mesh.spatial > 1


def exchange(x: torch.Tensor, rows: int, mesh, unit: str):
    """NHWC x (this rank's band) with up to ``rows`` rows of the bands above and below
    it, fewer at the image border (``mesh.halo_cut`` fewer each side); returns (the
    extended tensor, (rows added above, rows added below)).  Every rank of the spatial
    group calls it together, on bands of one height."""
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError("the halo exchange has no backward pass: spatial training "
                                  "is not ported")
    s, j = mesh.spatial, mesh.spatial_index
    h = x.shape[1]
    rows = max(rows - mesh.halo_cut, 0)
    m = min(rows, h)
    if m == 0:
        return x, (0, 0)
    edges = torch.cat([x[:, :m], x[:, h - m :]], 1).contiguous()
    parts = [torch.empty_like(edges) for _ in range(s)]
    dist.all_gather(parts, edges, group=mesh.spatial_group)
    exchanges_by[unit] = exchanges_by.get(unit, 0) + 1
    bytes_by[unit] = bytes_by.get(unit, 0) + edges.numel() * edges.element_size()
    top, bot = min(rows, j * h), min(rows, (s - 1 - j) * h)
    pieces = [x]
    if top:  # the bottom rows of the ranks above, nearest last
        pieces.insert(0, torch.cat([p[:, m:] for p in parts[:j]], 1)[:, -top:])
    if bot:  # the top rows of the ranks below, nearest first
        pieces.append(torch.cat([p[:, :m] for p in parts[j + 1 :]], 1)[:, :bot])
    return torch.cat(pieces, 1), (top, bot)


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
