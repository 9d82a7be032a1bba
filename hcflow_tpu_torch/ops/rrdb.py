"""RRDB encoder blocks: the CUDA kernels ``csrc/rrdb.cu`` (one RRDB) and
``csrc/rrdb_trunk.cu`` (a whole trunk), their plain versions and packing.

Replaces ``hcflow_tpu/ops/pallas_rdb.py``: ``rrdb_apply`` / ``_make_kernel`` (one
RRDB a call) and ``_build_call_trunk`` / ``_make_kernel_trunk`` (one call a trunk,
the carries resident), both driven by ``trunk_apply``, which takes the per-RRDB
kernel for a list of packed RRDBs and the resident-trunk kernel for one stacked
dict, as the JAX package's does.  One RRDB is three residual dense blocks; a dense
block with input x runs five 3x3 convs over growing concats,
``x_i = lrelu_0.2(conv_i(cat(x, x_1..x_{i-1})) + b_i)`` for i = 1..4 and
``x <- 0.2 * (conv_5(cat(x, x_1..x_4)) + b_5) + x``; the RRDB returns
``0.2 * x + x_in``.  Operands are bf16, every sum and the residual carries float32.

Bound on the card: operations.  At nf 64 / gc 32 a dense block is 239,616 MAC per
pixel, so the four trunks of the x4 reverse pass are about 2.58 TFLOP at batch 16
(2.6 ms at the card's 989 TFLOP/s bf16 peak) against a few hundred MB of
activations.  The kernel therefore runs every conv on the warpgroup tensor cores
(wgmma bf16, float32 accumulation) as one launch per conv of the shared tile conv
``csrc/conv3x3.cuh`` (16x16 or 8x16-pixel tiles, input channels staged 16 at a time
through a 3-stage cp.async ring: nf and gc of 16, 32 or 64), with the concats free:
each dense block writes its features into channel slices of one NHWC bf16 buffer
and each conv reads a channel prefix of it.  The TPU kernel's
grouping of the convs by source feature existed for the TPU's 128-lane layout and
is not carried over; unlike it, the RRDB input and the carries stay float32.

The resident-trunk kernel runs the same convs for all nb RRDBs of a trunk in one
cooperative launch (a persistent grid with a grid-wide barrier between conv stages,
``csrc/rrdb_trunk.cu``): the carries and dense buffers are allocated once per trunk
and no conversion pass runs between RRDBs; its output is bit-identical to the
per-RRDB kernel's.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import nets

launches = 0  # CUDA kernel launches made by rrdb_apply (16 per RRDB)
LAUNCHES_PER_RRDB = 16  # one bf16 conversion of the input, then 15 convs
trunk_launches = 0  # cooperative launches of the resident-trunk kernel (1 per trunk)
WIDTHS = (16, 32, 64)  # the nf and gc both kernels take

_FN = "hcflow_rrdb_apply"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_TRUNK_FN = "hcflow_rrdb_trunk_apply"
_TRUNK_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def pack_rrdb(rrdb: dict, compute_dtype=None) -> dict:
    """Pack one RRDB's params (rdb1..3, conv1..5 OIHW) for the kernel.

    ``w``: 15 weights (9, cin, cout) in the net dtype, ``[tap][ci][co]`` with tap =
    3 * ky + kx, dense block r's conv i+1 at index 5 r + i; ``b``: the 15 biases, f32.
    """
    nd = nets.net_dtype(compute_dtype)
    ws, bs = [], []
    for r in (1, 2, 3):
        for i in range(1, 6):
            conv = rrdb[f"rdb{r}"][f"conv{i}"]
            cout, cin = conv["w"].shape[:2]
            ws.append(conv["w"].permute(2, 3, 1, 0).reshape(9, cin, cout).to(nd).contiguous())
            bs.append(conv["b"].float().contiguous())
    return {"w": ws, "b": bs}


def pack_rrdb_trunk(trunk: list, compute_dtype=None, resident: bool = False):
    """Pack a trunk (a list of RRDB params): a list of :func:`pack_rrdb` dicts for the
    per-RRDB kernel, or with ``resident`` one stacked dict for the resident-trunk
    kernel (the JAX package's packing under ``HCFLOW_RDB_TRUNK=1``): ``w[i]`` (3 nb,
    9, nf + i gc, cout_i) and ``b[i]`` (3 nb, cout_i) hold conv i+1 of dense block j =
    3 * rrdb + r at row j."""
    packs = [pack_rrdb(p, compute_dtype) for p in trunk]
    if not resident:
        return packs
    return {k: [torch.stack([p[k][5 * r + i] for p in packs for r in range(3)])
                for i in range(5)] for k in ("w", "b")}


def rrdb_slices(packed: dict) -> list:
    """A resident-trunk pack as the per-RRDB packs it stacks."""
    nb = packed["b"][0].shape[0] // 3
    return [{k: [packed[k][i][3 * n + r] for r in range(3) for i in range(5)]
             for k in ("w", "b")} for n in range(nb)]


def rrdb_apply_plain(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the conv operands rounded to the
    packed weights' dtype, float32 sums, float32 carries."""
    wd = packed["w"][0].dtype

    def rnd(t):
        return t.to(wd).float()

    x_in = x = x.float()
    with nets.exact_f32():
        for r in range(3):
            feats = [rnd(x)]
            for i in range(4):
                k = 5 * r + i
                h = nets.conv_taps(torch.cat(feats, -1), packed["w"][k], packed["b"][k])
                feats.append(rnd(nets.lrelu(h)))
            k = 5 * r + 4
            x = nets.conv_taps(torch.cat(feats, -1), packed["w"][k], packed["b"][k]) * 0.2 + x
    return x * 0.2 + x_in


def rrdb_apply(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """One RRDB on NHWC float32 x.  A CPU tensor takes the plain version; a CUDA
    tensor the kernel.  Either raises under autograd when an input requires grad."""
    _build.refuse_grad("RRDB", x, packed)
    if not x.is_cuda:
        return rrdb_apply_plain(packed, x)
    global launches
    B, H, W, nf = x.shape
    gc = packed["w"][0].shape[2]
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    if nf not in WIDTHS or gc not in WIDTHS:
        raise ValueError(f"the RRDB kernel takes nf and gc of 16, 32 or 64, not {nf}, {gc}")
    tensors = packed["w"] + packed["b"]
    if any(w.dtype != torch.bfloat16 for w in packed["w"]):
        raise ValueError("the RRDB kernel takes the bf16 recipe's packed weights")
    for k, w in enumerate(packed["w"]):
        cout = gc if k % 5 < 4 else nf
        if tuple(w.shape) != (9, nf + k % 5 * gc, cout) or packed["b"][k].shape != (cout,):
            raise ValueError(f"packed conv {k} has shape {tuple(w.shape)}")
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("RRDB kernel weights must be contiguous CUDA tensors")
    # the two dense-block buffers: (B, H, W, nf + 4 gc) bf16 each
    dense = [torch.empty((B, H, W, nf + 4 * gc), dtype=torch.bfloat16, device=x.device)
             for _ in range(2)]
    out = torch.empty_like(x)
    lib = _build.load("rrdb", _FN, _ARGTYPES)
    w_ptrs = (ctypes.c_void_p * 15)(*(w.data_ptr() for w in packed["w"]))
    b_ptrs = (ctypes.c_void_p * 15)(*(b.data_ptr() for b in packed["b"]))
    err = lib.hcflow_rrdb_apply(
        x.data_ptr(), out.data_ptr(), dense[0].data_ptr(), dense[1].data_ptr(),
        ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs), B, H, W, nf, gc,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, _FN, err)
    launches += LAUNCHES_PER_RRDB
    return out


def trunk_apply_resident_plain(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """The resident-trunk kernel's arithmetic in plain PyTorch: the per-RRDB plain
    version over the stacked pack's slices."""
    x = x.float()
    for p in rrdb_slices(packed):
        x = rrdb_apply_plain(p, x)
    return x


def trunk_apply_resident(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """A whole trunk, packed by ``pack_rrdb_trunk(..., resident=True)``, on NHWC float32
    x.  A CPU tensor takes the plain version; a CUDA tensor the resident-trunk kernel
    (one cooperative launch), or it raises.  Either raises under autograd when an input
    requires grad."""
    _build.refuse_grad("RRDB trunk", x, packed)
    if not x.is_cuda:
        return trunk_apply_resident_plain(packed, x)
    global trunk_launches
    B, H, W, nf = x.shape
    gc = packed["w"][0].shape[3]
    nb = packed["b"][0].shape[0] // 3
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    if nf not in WIDTHS or gc not in WIDTHS:
        raise ValueError(f"the RRDB trunk kernel takes nf and gc of 16, 32 or 64, not {nf}, {gc}")
    for i in range(5):
        cout = gc if i < 4 else nf
        w, b = packed["w"][i], packed["b"][i]
        if tuple(w.shape) != (3 * nb, 9, nf + i * gc, cout) or tuple(b.shape) != (3 * nb, cout):
            raise ValueError(f"packed conv {i + 1} has shape {tuple(w.shape)}, {tuple(b.shape)}")
        if w.dtype != torch.bfloat16 or b.dtype != torch.float32:
            raise ValueError("the RRDB trunk kernel takes the bf16 recipe's packed weights")
        if not (w.is_cuda and b.is_cuda and w.is_contiguous() and b.is_contiguous()):
            raise ValueError("RRDB trunk kernel weights must be contiguous CUDA tensors")
    out, carry = torch.empty_like(x), torch.empty_like(x)
    dense = [torch.empty((B, H, W, nf + 4 * gc), dtype=torch.bfloat16, device=x.device)
             for _ in range(2)]
    lib = _build.load("rrdb_trunk", _TRUNK_FN, _TRUNK_ARGTYPES)
    w_ptrs = (ctypes.c_void_p * 5)(*(w.data_ptr() for w in packed["w"]))
    b_ptrs = (ctypes.c_void_p * 5)(*(b.data_ptr() for b in packed["b"]))
    err = lib.hcflow_rrdb_trunk_apply(
        x.data_ptr(), out.data_ptr(), carry.data_ptr(), dense[0].data_ptr(),
        dense[1].data_ptr(), ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs), B, H, W, nf,
        gc, nb, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, _TRUNK_FN, err)
    trunk_launches += 1
    return out


def trunk_apply(packed, x: torch.Tensor) -> torch.Tensor:
    """A trunk of RRDBs on NHWC x; float32 out.  ``packed`` from
    :func:`pack_rrdb_trunk`: a list runs the per-RRDB kernel once per RRDB, a stacked
    dict (``resident=True``) the resident-trunk kernel once."""
    x = x.float().contiguous()
    if isinstance(packed, dict):
        return trunk_apply_resident(packed, x)
    for p in packed:
        x = rrdb_apply(p, x)
    return x
