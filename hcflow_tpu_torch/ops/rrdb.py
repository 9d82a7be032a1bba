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
``0.2 * x + x_in``.  In the bf16 recipe the operands are bf16, every sum and the
residual carries float32; in the float32 recipe (a float32 pack, as the JAX package
packs for float32 encoders and runs at ``Precision.HIGHEST``) everything is float32.

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

The float32 recipe runs the same launches on float32 dense buffers, every product in
TF32 on ``wgmma`` with each operand split into two TF32 values (three or four TF32
products a product, an error of float32's order; no single-pass TF32).  A conv of 32 or
64 outputs runs ``csrc/conv3x3.cuh``'s wide tile conv (``conv_tile_f32w``: output
channels x pixels), one of 16 the narrow one (``conv_tile_f32``: pixels x output
channels); :data:`conv_paths_by` counts both, by the rule the library exports
(:func:`conv_paths`).  The weights are split once, at pack time: a float32 pack holds the float32
weights K-major, ``(9, cout, cin)`` ``[tap][co][ci]`` (``nets.pack_taps``, which the
plain version reads; ``nets.taps`` gives either pack's weight as ``(9, cin, cout)``),
and their hi and lo TF32 planes (``nets.pack_tf32``), which the kernels read; the
wrappers raise on a float32 pack without them (:func:`check_pack`).

Widths that are multiples of 8 are packed at the kernels' next widths
(:func:`padded_widths`: 8 -> 16, 24 -> 32, 40 to 56 -> 64) with zero weights and biases
on the padded channels: a padded feature is lrelu(0) = 0, a padded trunk channel stays
0 through ``x + 0.2 * conv5`` and ``0.2 * rdb3 + x_in``, and the real channels' sums
gain only exact zero terms.  :func:`trunk_apply` pads the trunk's input with zero
channels once and cuts its output back once.  A trunk wider than 64 is not packed for
the card (:func:`packs_trunk`) and runs the plain path there.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from ..parallel import halo
from ..utils import profiling
from . import nets

# CUDA kernel launches made by rrdb_apply (16 per RRDB), by recipe: "bf16", "f32"
launches_by = {}
LAUNCHES_PER_RRDB = 16  # the input staged into the dense buffer, then 15 convs
# cooperative launches of the resident-trunk kernel (1 per trunk), by recipe
trunk_launches_by = {}
# float32 convs run by both kernels, by the orientation of their tile conv's implicit
# GEMM: "f32.wide" (output channels x pixels), "f32.narrow" (pixels x output channels)
conv_paths_by = {}
WIDTHS = (16, 32, 64)  # the nf and gc both kernels take

# the C entry points by the packed weights' dtype: the bf16 and the float32 recipe
_FN = {torch.bfloat16: "hcflow_rrdb_apply", torch.float32: "hcflow_rrdb_apply_f32"}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_TRUNK_FN = {torch.bfloat16: "hcflow_rrdb_trunk_apply",
             torch.float32: "hcflow_rrdb_trunk_apply_f32"}
_TRUNK_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_RECIPE = {torch.bfloat16: "bf16", torch.float32: "f32"}  # the launch counters' keys


def takes(nf: int, gc: int) -> bool:
    """Whether the RRDB and resident-trunk kernels run widths nf, gc: the limit that
    :func:`packs_trunk` and the wrappers' checks both apply."""
    return nf in WIDTHS and gc in WIDTHS


def padded_widths(nf: int, gc: int) -> tuple:
    """(nf, gc) of a pack: where both are multiples of 8 (the JAX package's gate), each
    rounded up to 16, 32 or 64; other widths, and widths past 64, as they are."""
    if nf % 8 or gc % 8:
        return nf, gc
    return nets.pad_width(nf, WIDTHS), nets.pad_width(gc, WIDTHS)


def packs_trunk(nf: int, gc: int, device) -> bool:
    """Whether a trunk of widths nf, gc whose params lie on ``device`` is packed for
    serving: where nf and gc are multiples of 8 (the JAX package's gate) and, on the
    card, where the padded widths are ones the kernels take; a wider trunk runs the
    plain path there."""
    if nf % 8 or gc % 8:
        return False
    return torch.device(device).type != "cuda" or takes(*padded_widths(nf, gc))


def pack_rrdb(rrdb: dict, compute_dtype=None) -> dict:
    """Pack one RRDB's params (rdb1..3, conv1..5 OIHW) for the kernel, at the widths
    :func:`padded_widths` gives (zero weights and biases on the padded channels).

    ``w``: 15 weights in the net dtype by ``nets.pack_taps`` (bf16 (9, cin, cout),
    float32 (9, cout, cin)), dense block r's conv i+1 at index 5 r + i; ``b``: the 15
    biases, f32; in float32 also ``tf32``: the 15 weights' TF32 planes by
    ``nets.pack_tf32`` ((2, 9, cin / 4, cout, 4)), which the kernel reads.
    """
    nd = nets.net_dtype(compute_dtype)
    gc, nf = rrdb["rdb1"]["conv1"]["w"].shape[:2]
    nfp, gcp = padded_widths(nf, gc)
    convs = [nets.pad_dense_conv(c["w"], c["b"], [nf] + [gc] * i, [nfp] + [gcp] * i,
                                 gcp if i < 4 else nfp)
             for c, i in ((rrdb[f"rdb{r}"][f"conv{i + 1}"], i) for r in (1, 2, 3)
                          for i in range(5))]
    packed = {"w": [nets.pack_taps(w, nd) for w, _ in convs],
              "b": [b.float().contiguous() for _, b in convs]}
    if nd == torch.float32:
        packed["tf32"] = [nets.pack_tf32(w) for w, _ in convs]
    return packed


def pack_rrdb_trunk(trunk: list, compute_dtype=None, resident: bool = False):
    """Pack a trunk (a list of RRDB params): a list of :func:`pack_rrdb` dicts for the
    per-RRDB kernel, or with ``resident`` one stacked dict for the resident-trunk
    kernel (the JAX package's packing under ``HCFLOW_RDB_TRUNK=1``): ``w[i]`` (3 nb,
    9, nf + i gc, cout_i) (float32: (3 nb, 9, cout_i, nf + i gc)), ``b[i]`` (3 nb,
    cout_i) and, in float32, ``tf32[i]`` (3 nb, 2, 9, (nf + i gc) / 4, cout_i, 4) hold
    conv i+1 of dense block j = 3 * rrdb + r at row j."""
    packs = [pack_rrdb(p, compute_dtype) for p in trunk]
    if not resident:
        return packs
    return {k: [torch.stack([p[k][5 * r + i] for p in packs for r in range(3)])
                for i in range(5)] for k in packs[0]}


def rrdb_slices(packed: dict) -> list:
    """A resident-trunk pack as the per-RRDB packs it stacks."""
    nb = packed["b"][0].shape[0] // 3
    return [{k: [packed[k][i][3 * n + r] for r in range(3) for i in range(5)]
             for k in packed} for n in range(nb)]


def rrdb_apply_plain(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the conv operands rounded to the
    packed weights' dtype (none in float32), float32 sums, float32 carries."""
    wd = packed["w"][0].dtype

    def rnd(t):
        return t.to(wd).float()

    x_in = x = x.float()
    with nets.exact_f32():
        for r in range(3):
            feats = [rnd(x)]
            for i in range(4):
                k = 5 * r + i
                h = nets.conv_taps(torch.cat(feats, -1), nets.taps(packed["w"][k]),
                                   packed["b"][k])
                feats.append(rnd(nets.lrelu(h)))
            k = 5 * r + 4
            x = nets.conv_taps(torch.cat(feats, -1), nets.taps(packed["w"][k]),
                               packed["b"][k]) * 0.2 + x
    return x * 0.2 + x_in


def conv_paths(lib, nf: int, gc: int) -> dict:
    """The float32 convs of one RRDB (nf, gc) by orientation, by the rule the kernel
    library ``lib`` exports (``hcflow_rrdb_f32_wide``): 12 convs of gc outputs, 3 of nf."""
    wide = lib.hcflow_rrdb_f32_wide
    wide.argtypes, wide.restype = [ctypes.c_int], ctypes.c_int
    paths = {"f32.wide": 0, "f32.narrow": 0}
    for cout, n in ((gc, 12), (nf, 3)):
        paths["f32.wide" if wide(cout) else "f32.narrow"] += n
    return paths


def _count_paths(lib, nf: int, gc: int, rrdbs: int) -> None:
    """Add ``rrdbs`` float32 RRDBs' convs (nf, gc) to :data:`conv_paths_by`."""
    for key, n in conv_paths(lib, nf, gc).items():
        conv_paths_by[key] = conv_paths_by.get(key, 0) + rrdbs * n


def _check_tf32(packed: dict, kernel: str, lead: tuple) -> list:
    """The TF32 planes of a float32 pack (``nets.pack_tf32``, rows ``lead`` stacked in
    front), which the float32 kernel reads in place of the float32 weights; raises a
    ValueError where they are missing or do not match the weights."""
    planes = packed.get("tf32")
    if planes is None or len(planes) != len(packed["w"]):
        raise ValueError(f"the float32 {kernel} kernel reads the weights' TF32 planes: pack "
                         "the weights with pack_rrdb / pack_rrdb_trunk (nets.pack_tf32)")
    for w, t in zip(packed["w"], planes):
        cin, cout = nets.taps_shape(w)[-2:]
        if t.dtype != torch.float32 or tuple(t.shape) != (*lead, 2, 9, cin // 4, cout, 4):
            raise ValueError(f"TF32 planes of shape {tuple(t.shape)} for a weight of shape "
                             f"{tuple(w.shape)}")
    return planes


def check_pack(packed: dict, nf: int) -> tuple:
    """The per-RRDB kernel's checks of a pack for an input of nf channels, which need no
    card: one dtype (bf16 or float32), widths the kernel takes, every shape, and a
    float32 pack's TF32 planes.  Returns (dtype, gc, the weights the kernel reads);
    raises a ValueError."""
    wd = nets.pack_dtype(packed["w"], "RRDB")
    gc = nets.taps_shape(packed["w"][0])[2]
    if not takes(nf, gc):
        raise ValueError(f"the RRDB kernel takes nf and gc of 16, 32 or 64, not {nf}, {gc}")
    for k, w in enumerate(packed["w"]):
        cout = gc if k % 5 < 4 else nf
        shape = nets.taps_shape(w)
        if shape != (9, nf + k % 5 * gc, cout) or packed["b"][k].shape != (cout,):
            raise ValueError(f"packed conv {k} has shape {tuple(w.shape)}")
    return wd, gc, _check_tf32(packed, "RRDB", ()) if wd == torch.float32 else packed["w"]


def rrdb_apply(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """One RRDB on NHWC float32 x.  A CPU tensor takes the plain version; a CUDA
    tensor the kernel (bf16 or float32 pack), or it raises (:func:`check_pack`).  Either
    raises under autograd when an input requires grad."""
    _build.refuse_grad("RRDB", x, packed)
    if not x.is_cuda:
        return rrdb_apply_plain(packed, x)
    B, H, W, nf = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    wd, gc, ws = check_pack(packed, nf)
    if not all(t.is_cuda and t.is_contiguous() for t in ws + packed["b"]):
        raise ValueError("RRDB kernel weights must be contiguous CUDA tensors")
    # the two dense-block buffers: (B, H, W, nf + 4 gc) in the weights' dtype each
    dense = [torch.empty((B, H, W, nf + 4 * gc), dtype=wd, device=x.device) for _ in range(2)]
    out = torch.empty_like(x)
    fn = _FN[wd]
    lib = _build.load("rrdb", fn, _ARGTYPES)
    w_ptrs = (ctypes.c_void_p * 15)(*(w.data_ptr() for w in ws))
    b_ptrs = (ctypes.c_void_p * 15)(*(b.data_ptr() for b in packed["b"]))
    err = getattr(lib, fn)(
        x.data_ptr(), out.data_ptr(), dense[0].data_ptr(), dense[1].data_ptr(),
        ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs), B, H, W, nf, gc,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, fn, err)
    key = _RECIPE[wd]
    launches_by[key] = launches_by.get(key, 0) + LAUNCHES_PER_RRDB
    if wd == torch.float32:
        _count_paths(lib, nf, gc, 1)
    return out


def trunk_apply_resident_plain(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """The resident-trunk kernel's arithmetic in plain PyTorch: the per-RRDB plain
    version over the stacked pack's slices."""
    x = x.float()
    for p in rrdb_slices(packed):
        x = rrdb_apply_plain(p, x)
    return x


def check_trunk_pack(packed: dict, nf: int) -> tuple:
    """The resident-trunk kernel's checks of a stacked pack for an input of nf channels,
    which need no card (as :func:`check_pack`).  Returns (dtype, gc, nb, the weights the
    kernel reads); raises a ValueError."""
    wd = nets.pack_dtype(packed["w"], "RRDB trunk")
    gc = nets.taps_shape(packed["w"][0])[3]
    nb = packed["b"][0].shape[0] // 3
    if not takes(nf, gc):
        raise ValueError(f"the RRDB trunk kernel takes nf and gc of 16, 32 or 64, not {nf}, {gc}")
    for i in range(5):
        cout = gc if i < 4 else nf
        w, b = packed["w"][i], packed["b"][i]
        shape = nets.taps_shape(w)
        if shape != (3 * nb, 9, nf + i * gc, cout) or tuple(b.shape) != (3 * nb, cout):
            raise ValueError(f"packed conv {i + 1} has shape {tuple(w.shape)}, {tuple(b.shape)}")
        if b.dtype != torch.float32:
            raise ValueError("the RRDB trunk kernel takes float32 biases")
    ws = _check_tf32(packed, "RRDB trunk", (3 * nb,)) if wd == torch.float32 else packed["w"]
    return wd, gc, nb, ws


def trunk_apply_resident(packed: dict, x: torch.Tensor) -> torch.Tensor:
    """A whole trunk, packed by ``pack_rrdb_trunk(..., resident=True)`` (bf16 or
    float32), on NHWC float32 x.  A CPU tensor takes the plain version; a CUDA tensor the
    resident-trunk kernel (one cooperative launch), or it raises
    (:func:`check_trunk_pack`).  Either raises under autograd when an input requires
    grad."""
    _build.refuse_grad("RRDB trunk", x, packed)
    if not x.is_cuda:
        return trunk_apply_resident_plain(packed, x)
    B, H, W, nf = x.shape
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    wd, gc, nb, ws = check_trunk_pack(packed, nf)
    if not all(t.is_cuda and t.is_contiguous() for t in ws + packed["b"]):
        raise ValueError("RRDB trunk kernel weights must be contiguous CUDA tensors")
    out, carry = torch.empty_like(x), torch.empty_like(x)
    dense = [torch.empty((B, H, W, nf + 4 * gc), dtype=wd, device=x.device) for _ in range(2)]
    fn = _TRUNK_FN[wd]
    lib = _build.load("rrdb_trunk", fn, _TRUNK_ARGTYPES)
    w_ptrs = (ctypes.c_void_p * 5)(*(w.data_ptr() for w in ws))
    b_ptrs = (ctypes.c_void_p * 5)(*(b.data_ptr() for b in packed["b"]))
    err = getattr(lib, fn)(
        x.data_ptr(), out.data_ptr(), carry.data_ptr(), dense[0].data_ptr(),
        dense[1].data_ptr(), ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs), B, H, W, nf,
        gc, nb, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, fn, err)
    key = _RECIPE[wd]
    trunk_launches_by[key] = trunk_launches_by.get(key, 0) + 1
    if wd == torch.float32:
        _count_paths(lib, nf, gc, nb)
    return out


def halo_rows(packed: dict) -> int:
    """Rows of halo each side that a pack's convs read around an output row, one a 3x3
    conv in sequence: 15 for a per-RRDB pack, 15 nb for a resident-trunk pack (its
    weights stack 3 nb dense blocks' convs)."""
    return sum((w.shape[0] if w.ndim == 4 else 1) * ((math.isqrt(w.shape[-3]) - 1) // 2)
               for w in packed["w"])


@profiling.spanned("hcflow.rrdb")
def trunk_apply(packed, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """A trunk of RRDBs on NHWC x; float32 out.  ``packed`` from
    :func:`pack_rrdb_trunk`: a list runs the per-RRDB kernel once per RRDB, a stacked
    dict (``resident=True``) the resident-trunk kernel once.  Where the pack's nf is
    padded past x's channels, x gains zero channels once before the first RRDB and the
    output loses them once after the last.  ``mesh``: each kernel call on this rank's
    band plus the halo it reads (:func:`halo_rows`), exchanged before it; at a padded
    nf only the real channels are exchanged, and each call pads the band and its halo
    and cuts its output back.  Runs in the span ``hcflow.rrdb``."""
    nf = x.shape[-1]
    pad = (packed if isinstance(packed, dict) else packed[0])["b"][4].shape[-1] - nf
    once = not (pad and halo.sharded(mesh))  # the padded channels are 0: exchange none

    def widen(t):
        return torch.nn.functional.pad(t, (0, pad)) if pad else t.contiguous()

    if isinstance(packed, dict):
        calls = [(functools.partial(trunk_apply_resident, packed), halo_rows(packed), "trunk")]
    else:
        calls = [(functools.partial(rrdb_apply, p), halo_rows(p), "rrdb") for p in packed]
    x = x.float()
    if once:
        x = widen(x)
    for fn, rows, unit in calls:
        run = ((lambda t, fn=fn: fn(t.contiguous())) if once
               else (lambda t, fn=fn: fn(widen(t))[..., :nf]))
        x = halo.banded(run, x, rows, mesh, unit)
    return x[..., :nf] if once and pad else x
