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
    rank 0), and the gradient of a weighted sum of its output with respect to the input
    and the weights (the input's bands gathered, the weights' summed over the ranks)
    against the whole image's (max abs difference over max |whole|, on rank 0).  Then
    the serving cases saved at ``path`` (``dryrun.serve_ranks``)."""
    rank = dist.get_rank()
    meshes, stacks, grads = {}, {}, {}
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
            grads[(shape, n)] = _stack_grad(m, x, ws[:n], n, g)
    return {"meshes": meshes, "stacks": stacks, "grads": grads,
            "replicate": replicate_strided(), "serve": dryrun.serve_ranks(path, cpu)}


def replicate_strided() -> list:
    """``mesh.replicate`` of a tree with a strided leaf (a transposed weight, as an
    invconv's init gives) and a contiguous one, each holding this rank's values, under a
    broadcast that refuses a non-contiguous tensor as NCCL's does: the leaves after it."""
    real = dist.broadcast

    def strict(t, src, *args, **kw):
        if not t.is_contiguous():
            raise ValueError("Tensors must be contiguous")
        return real(t, src, *args, **kw)

    r = dist.get_rank()
    tree = {"w": (torch.arange(12.0).reshape(3, 4) + 100 * r).t(),
            "b": [torch.full((2,), float(r))]}
    dist.broadcast = strict
    try:
        mesh.replicate(tree)
    finally:
        dist.broadcast = real
    return [tree["w"], tree["b"][0]]


def _stack_grad(m, x, ws, rows, g) -> float:
    """d/d(x, ws) of sum(v * stack(x)) on bands with a halo of ``rows`` (the exchange's
    backward) against the whole image's: max abs difference / max |whole|."""
    v = torch.randn(x.shape, generator=g)
    ws = [w.clone().requires_grad_() for w in ws]
    xw = x.clone().requires_grad_()
    y = xw
    for w in ws:
        y = nets.conv2d(y, w)
    want = torch.autograd.grad((y * v).sum(), [xw, *ws])
    xb = m.shard(x).clone().requires_grad_()
    y, have = halo.exchange(xb, rows, m, "test")
    for w in ws:
        y = nets.conv2d(y, w)
    got = torch.autograd.grad((halo.crop(y, have) * m.shard(v)).sum(), [xb, *ws])
    for t in got[1:]:  # every rank's share of the weights' gradient
        dist.all_reduce(t)
    got = [m.gather(got[0]), *got[1:]]
    return max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(got, want))


def train(tol, bf16_tol, cpu, shape, plan):
    """``dryrun.train_rank`` (tests/test_torch_port_spatial_train.py), then
    :func:`trunk_remat` on the same mesh."""
    report = dryrun.train_rank(tol, bf16_tol, cpu, shape, plan)
    report["trunk_remat"] = trunk_remat(shape)
    return report


def trunk_remat(shape) -> dict:
    """A trunk of 2 RRDBs (nf 8, gc 4) on bands of 4 rows (halo 15: from ranks further
    away), with and without ``remat``: the elements of the tensors its autograd graph
    saves (``saved_tensors_hooks``) beside those of the RRDBs' inputs on band + halo
    (``inputs``, what a checkpoint saves), its halo exchanges, and the
    gradient of a weighted sum of its output (input bands gathered, weights summed over
    the ranks) against the whole image's (max abs difference over max |whole|), and the
    remat gradient against the plain one (max abs difference)."""
    from hcflow_tpu_torch.train.trainer import param_leaves, tree_map

    m = mesh.make_mesh(mesh_shape=shape)
    g = torch.Generator().manual_seed(3)
    params = dryrun.perturb(nets.init_rrdb_trunk(g, 2, nf=8, gc=4), 5)
    x = torch.randn(2 * m.data, 4 * m.spatial, 5, 8, generator=g)
    v = torch.randn(x.shape, generator=g)

    def grads(xin, band):
        ps = tree_map(lambda t: t.clone().requires_grad_(), params)
        xin = xin.clone().requires_grad_()
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t

        dryrun.reset_counters()
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            y = nets.apply_rrdb_trunk(ps, xin, remat=band == "remat", mesh=m if band else None)
        gs = list(torch.autograd.grad((y * (m.shard(v) if band else v)).sum(),
                                      [xin, *param_leaves(ps)]))
        if band:
            for t in gs[1:]:
                dist.all_reduce(t)
            gs[0] = m.gather(gs[0])
        return gs, sum(saved), dict(halo.exchanges_by)

    whole, _, _ = grads(x, None)
    s, j, h = m.spatial, m.spatial_index, 4
    out = {"saved": {}, "exchanges": {},
           "inputs": 2 * m.shard(x).numel() // h * (h + min(15, j * h) + min(15, (s - 1 - j) * h))}
    for band in ("plain", "remat"):
        gs, out["saved"][band], out["exchanges"][band] = grads(m.shard(x), band)
        out[band] = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(gs, whole))
        out.setdefault("gs", {})[band] = gs
    out["remat_vs_plain"] = max((a - b).abs().max().item()
                                for a, b in zip(out["gs"]["remat"], out["gs"]["plain"]))
    del out["gs"]
    return out
