"""Data parallelism and spatial sharding over processes, one card each: the counterpart
of the JAX package's ``hcflow_tpu/parallel/mesh.py`` on ``torch.distributed``.

The semantics stay the JAX package's: the global batch is ``datasets.train.batch_size``
per node, split over the ranks, and a step equals the one-process step on that global
batch up to the order of its sums:

- ``init_distributed`` joins the process group that a launcher describes
  (``python -m torch.distributed.run``: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
  ``MASTER_ADDR`` / ``MASTER_PORT``, the counterpart of ``JAX_COORDINATOR_ADDRESS``);
  without that environment it returns (0, 1) and makes no group.  The backend is NCCL
  on the card and gloo on the CPU or where the caller names it; nothing falls back;
- a rank's device is ``cuda:LOCAL_RANK``;
- rank r holds rows r, r + world, ... of the global batch (``shard_batch``), the rows
  the sampler gives it (``data/loader.py`` ``EnlargedSampler``); ``gather_batch`` puts
  the global batch back together in that order;
- ``replicate`` broadcasts params from rank 0; ``DataParallel.average`` averages a
  pass's gradients over the ranks in one flattened all-reduce, so that every rank
  clips and takes the skip decision on the same gradient and the params stay
  bit-identical; ``DataParallel.mean`` and :func:`moments` are differentiable means
  over the global batch (the discriminators' BatchNorm, the relativistic GAN loss);
- ``any_rank`` agrees flags (a stop request, a device failure) over the ranks;
- :func:`make_mesh` lays the ranks out on a 2-D ('data', 'spatial') mesh as the JAX
  package lays devices out (data major, spatial minor), with a process group per data
  row (the ranks that hold bands of the same images) and per spatial column.
  :meth:`Mesh.shard`, the counterpart of ``spatial_sharding``, takes a rank's batch
  rows on the data axis (as ``shard_batch``) and a contiguous band of the image height
  on the spatial axis; :meth:`Mesh.gather` puts the images back together, and
  :meth:`Mesh.draw` draws a global tensor from a generator and keeps this rank's part.
  A band's neighbours' rows reach it through ``parallel/halo.py``, which XLA's SPMD
  partitioner writes for the JAX package;
- training on the mesh: every rank takes the backward pass of its own loss and
  ``DataParallel.average`` divides the gradients' sum by the world size.  The collectives
  on the way (the halo exchange, :meth:`Mesh.spatial_sum`, :meth:`Mesh.gather_rows`,
  the all-reduces of :func:`moments` and ``DataParallel.mean``) are differentiable, each
  backward the transpose of its forward, so the averaged gradient is the gradient of the
  mean of the ranks' losses.  That mean is the global loss when a rank's loss is a mean
  over its band's pixels (bands are equal) or a loss every rank of a spatial group
  computes alike on its whole images (the NLL after ``spatial_sum``, the
  discriminators' losses on ``gather_rows``).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn

from . import halo

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE")


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", 0))


def rank_device(cpu: bool = False) -> torch.device:
    """The device of this process: the CPU, or card ``LOCAL_RANK``."""
    return torch.device("cpu") if cpu else torch.device("cuda", local_rank())


def init_distributed(backend=None, cpu: bool = False) -> tuple:
    """Join the launcher's process group; returns (rank, world).  ``backend``: NCCL
    on the card, gloo with ``cpu``, unless named."""
    if not all(k in os.environ for k in _LAUNCHER_ENV):
        return 0, 1
    if not dist.is_initialized():
        backend = backend or ("gloo" if cpu else "nccl")
        if backend == "nccl":
            torch.cuda.set_device(local_rank())
        dist.init_process_group(backend, init_method="env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def shard_batch(x: torch.Tensor, rank: int, world: int) -> torch.Tensor:
    """This rank's rows of a global batch: rank, rank + world, ..."""
    return x[rank::world]


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """The global batch from every rank's rows (equal on every rank), in the order
    ``shard_batch`` takes them apart."""
    world = world_size()
    if world == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(world)]
    dist.all_gather(parts, x.contiguous())
    return torch.stack(parts, 1).flatten(0, 1)


def _tensor_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensor_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensor_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


@torch.no_grad()
def replicate(tree):
    """Every tensor of a nested dict/list overwritten by rank 0's, in place; returns
    the tree.  NCCL broadcasts only contiguous tensors, so a strided leaf (an invconv
    weight from its QR init) goes through a contiguous copy."""
    if world_size() > 1:
        for t in _tensor_leaves(tree):
            c = t.contiguous()
            dist.broadcast(c, 0)
            if c is not t:
                t.copy_(c)
    return tree


def any_rank(flags, device) -> list:
    """Each of ``flags`` (bools) set on any rank, in one all-reduce (every rank must
    call it)."""
    if world_size() == 1:
        return [bool(f) for f in flags]
    t = torch.tensor([1.0 if f else 0.0 for f in flags], device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return [bool(v) for v in t.tolist()]


def moments(x: torch.Tensor, dims, sync: bool = False):
    """(mean, biased variance) of x over ``dims``; with ``sync`` over the global batch
    (every rank's x of the same shape), differentiable through the all-reduces."""
    if not sync or world_size() == 1:
        return x.mean(dim=dims), x.var(dim=dims, unbiased=False)
    n = world_size()
    for d in dims:
        n *= x.shape[d]
    mean = dist_nn.all_reduce(x.sum(dim=dims)) / n
    var = dist_nn.all_reduce(((x - mean) ** 2).sum(dim=dims)) / n
    return mean, var


class DataParallel:
    """What a train step needs of the process group: the gradient average of a pass
    and means over the global batch.  ``world`` 1 changes nothing."""

    def __init__(self, world: int):
        self.world = world

    @torch.no_grad()
    def average(self, tensors: list) -> list:
        """Each tensor's mean over the ranks (a pass's gradients, the metrics), in one
        all-reduce of the flattened list."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        flat /= self.world
        return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of t over every rank's elements (t of the same shape on each),
        differentiable."""
        if self.world == 1:
            return t.mean()
        return dist_nn.all_reduce(t.sum()) / (t.numel() * self.world)


# ------------------------------------------------------------------ the 2-D mesh
AXES = ("data", "spatial")


def rank_layout(world: int, axis_names=AXES, mesh_shape=None) -> list:
    """The ranks of a mesh as nested lists, ``[data][spatial]``, as the JAX package's
    ``make_mesh`` reshapes its devices: ``mesh_shape`` when given; else one axis for
    ``("data",)``, and for two axes spatial 2 where the world is even (1 where it is
    odd), data the rest."""
    axis_names = tuple(axis_names)
    if axis_names not in (AXES[:1], AXES):
        raise ValueError(f"the port's meshes have the axes ('data',) or {AXES}, not {axis_names}")
    if mesh_shape is not None:
        shape = tuple(mesh_shape)
    elif len(axis_names) == 1:
        shape = (world,)
    else:
        spatial = 2 if world % 2 == 0 else 1
        shape = (world // spatial, spatial)
    if len(shape) != len(axis_names) or math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} over axes {axis_names} does not hold "
                         f"{world} ranks")
    return torch.arange(world).reshape(shape).tolist()


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a ('data', 'spatial') mesh of ``shape`` (data, spatial):
    rank ``d * spatial + s`` holds batch rows d, d + data, ... of the global batch and
    band s of the image height.  ``spatial_group`` is this rank's data row (the ranks
    that exchange halos), ``data_group`` its spatial column; both are None where the
    axis has one rank.  ``halo_cut`` rows are withheld from every halo exchange: 0
    serves; a control sets 1 to show that a check sees a halo one row short."""

    shape: tuple
    rank: int = 0
    spatial_group: object = None
    data_group: object = None
    halo_cut: int = 0

    @property
    def data(self) -> int:
        return self.shape[0]

    @property
    def spatial(self) -> int:
        return self.shape[1]

    @property
    def data_index(self) -> int:
        return self.rank // self.spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.spatial

    def _check(self, B: int, H: int) -> None:
        """The JAX package's device_put refuses a batch or a height its axis does not
        divide; so does the port (no ragged split)."""
        if B % self.data:
            raise ValueError(f"a batch of {B} does not split over {self.data} data ranks")
        if H % self.spatial:
            raise ValueError(f"an image height of {H} rows does not split over {self.spatial} "
                             "spatial ranks")

    def shard(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a global NHWC tensor: its batch rows (as
        :func:`shard_batch`) and its band of rows, a view."""
        B, H = x.shape[:2]
        self._check(B, H)
        h, s = H // self.spatial, self.spatial_index
        return x[self.data_index :: self.data, s * h : (s + 1) * h]

    def global_shape(self, shape) -> tuple:
        """The global shape of which a rank's part has ``shape``."""
        return (shape[0] * self.data, shape[1] * self.spatial, *shape[2:])

    def draw(self, sample, shape, **kw) -> torch.Tensor:
        """This rank's part, of ``shape``, of a global tensor drawn as ``sample(global
        shape, **kw)`` (``torch.rand`` or ``torch.randn`` with a generator): a seed gives
        the same global tensor however the ranks split it."""
        return self.shard(sample(self.global_shape(shape), **kw))

    def spatial_sum(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over this rank's spatial group (every rank of it calls it; equal on
        each), differentiable: the backward sums the group's gradients."""
        if self.spatial == 1:
            return t
        return dist_nn.all_reduce(t, group=self.spatial_group)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole images of this rank's batch rows from the bands of its spatial group
        (every rank of it calls it; equal on each), differentiable: the backward gives a
        band the sum over the group of the gradients of its rows."""
        if self.spatial == 1:
            return x
        return _GatherRows.apply(x, self)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's part (every rank calls it; equal on every
        rank), in the order :meth:`shard` takes it apart."""
        if self.data * self.spatial == 1:
            return x
        parts = [torch.empty_like(x) for _ in range(self.data * self.spatial)]
        dist.all_gather(parts, x.contiguous())
        rows = [torch.cat(parts[d * self.spatial : (d + 1) * self.spatial], 1)
                for d in range(self.data)]
        return torch.stack(rows, 1).flatten(0, 1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        ctx.m = m
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(m.spatial)]
        dist.all_gather(parts, x, group=m.spatial_group)
        halo.count("gather", x)
        return torch.cat(parts, 1)

    @staticmethod
    def backward(ctx, g):
        m = ctx.m
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=m.spatial_group)
        halo.count("gather.grad", g)
        h = g.shape[1] // m.spatial
        return g[:, m.spatial_index * h : (m.spatial_index + 1) * h], None


def make_mesh(world: int = None, axis_names=AXES, mesh_shape=None) -> Mesh:
    """This rank's :class:`Mesh` over the process group's ``world`` ranks (all of them by
    default), laid out by :func:`rank_layout`.  Every rank calls it, in the same order:
    it makes a process group for each data row and each spatial column."""
    world = world_size() if world is None else world
    if world != world_size():
        raise ValueError(f"a mesh of {world} ranks in a process group of {world_size()}")
    layout = rank_layout(world, axis_names, mesh_shape)
    rows = layout if len(layout) and isinstance(layout[0], list) else [[r] for r in layout]
    shape = (len(rows), len(rows[0]))
    if world == 1:
        return Mesh(shape)
    rank = dist.get_rank()
    spatial_group = data_group = None
    for row in rows:  # every rank makes every group
        g = dist.new_group(row) if len(row) > 1 else None
        if rank in row:
            spatial_group = g
    for col in zip(*rows):
        g = dist.new_group(list(col)) if len(col) > 1 else None
        if rank in col:
            data_group = g
    return Mesh(shape, rank, spatial_group, data_group)
