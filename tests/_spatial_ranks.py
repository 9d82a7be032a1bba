"""What the ranks of tests/test_torch_port_spatial.py run, in processes that
``hcflow_tpu_torch.parallel.dryrun.launch`` starts: this module imports no JAX, so a
rank starts in a few seconds."""

import torch
import torch.distributed as dist

from hcflow_tpu_torch.ops import nets
from hcflow_tpu_torch.parallel import dryrun, halo, mesh

STACK_DEPTHS = (1, 2, 5)  # 3x3 convs in a stack; halo = depth, up to 2.5 bands of 2 rows


def _peers(group, rank):
    """The ranks of ``group`` in its order (None for no group)."""
    if group is None:
        return None
    parts = [torch.zeros(1, dtype=torch.long) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, torch.tensor([rank]), group=group)
    return [int(p) for p in parts]


def run(path, cpu, shapes):
    """For each mesh shape in ``shapes``: this rank's place on the mesh and the ranks of
    its two groups; a stack of n random 3x3 convs run on bands of 2 rows with a halo of
    n rows, gathered, against the stack on the whole image (the max abs difference, on
    rank 0).  Then the serving cases saved at ``path`` (``dryrun.serve_ranks``)."""
    rank = dist.get_rank()
    meshes, stacks = {}, {}
    g = torch.Generator().manual_seed(0)
    ws = [0.3 * torch.randn(3, 3, 3, 3, generator=g) for _ in range(max(STACK_DEPTHS))]
    for shape in shapes:
        m = mesh.make_mesh(mesh_shape=shape)
        meshes[shape] = {"rank": m.rank, "shape": m.shape, "data_index": m.data_index,
                         "spatial_index": m.spatial_index,
                         "spatial_peers": _peers(m.spatial_group, rank),
                         "data_peers": _peers(m.data_group, rank)}
        x = torch.randn(2 * m.data, 2 * m.spatial, 5, 3, generator=g)
        for n in STACK_DEPTHS:
            want = got = x
            got, have = halo.exchange(m.shard(x), n, m, "test")
            for w in ws[:n]:
                want, got = nets.conv2d(want, w), nets.conv2d(got, w)
            got = m.gather(halo.crop(got, have))
            stacks[(shape, n)] = (got - want).abs().max().item()
    return {"meshes": meshes, "stacks": stacks, "serve": dryrun.serve_ranks(path, cpu)}
