"""Inverse rescaling main chain: the CUDA kernel ``csrc/chain3s.cu``, its plain version
and their packing.

Replaces ``hcflow_tpu/ops/pallas_chain3s.py`` (``inverse_chain`` / ``_make_kernel``).
A chain is K flow steps with no permutation and an Affine3shift coupling whose
``lr_vs_others`` alternates (True at even k), each with a 5-conv DenseBlock net, run
from k = K-1 down to 0.  z splits into the 3 LR channels z1 and the c-3 others z2:

- even k: the net on z1 gives [shift | scale]; ``z2 = z2 * exp(-0.318 * atan(2 *
  scale)) - shift``;
- odd k: the net on z2 gives 3 shifts; ``z1 = z1 - shift``;
- every k: the ActNorm inverse ``z = z * exp(-logs) - bias``.

The chain's logdet does not depend on z (the Affine3shift inverse adds nothing, by
the reference's convention, and ActNorm adds ``-sum(logs) * H * W``), so it is
computed at pack time.  In the bf16 recipe the net input and the features x1..x4 are
rounded to bf16 as conv operands and every sum is float32, as in the TPU kernel; z
and the coupling stay float32.  In the float32 recipe (a float32 pack) nothing is
rounded: the kernel's products are 3xTF32 (``csrc/conv3x3.cuh``'s ``conv_tile_f32``,
on the weights' TF32 planes split at pack time), an error of float32's order, as the
JAX kernel runs them at ``Precision.HIGHEST``.

On the card (``csrc/chain3s.cu``), bf16: one launch a flow step, K a chain
(:func:`launches_per_chain`), each block running a step's five dense-block convs on its
tile on ``wgmma`` with the features x1..x4 in shared memory, recomputing a 5-pixel halo;
z alone goes through device memory between steps.  float32: one cooperative launch a
chain, whose blocks run the shared float32 tile conv over two dense buffers in device
memory, a (conv, tile) item at a time, each waiting only for the neighbouring tiles of
the conv before.  Bound: operations (~1.2 MFLOP per pixel for an 8-step chain against
~100 bytes).  :func:`plan` picks each bf16 step parity's tile and shared memory (the
kernel recomputes and checks it).  The pack keeps the plain
version's per-conv weights and, for the kernel, one weight blob and one bias blob
(:func:`pack_inverse_chain3s`), which the wrapper hands over as two pointers: no loop
over the steps.  The net input is zero-padded to a multiple of 16 channels and conv5's
outputs likewise, with zero weights at pack time; the padding never reaches z.  A
growth that is a multiple of 8 is padded up to 16, 32 or 64 (:func:`padded_growth`):
the padded features x1..x4 have zero weights and biases, so they are lrelu(0) = 0, and
carry nothing into the later convs.  A chain past the kernel's widths (:func:`takes`:
a growth over 64, c - 3 over 32) is not packed for the card (:func:`packs`) and serves
on the plain step loop.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _build
from . import nets

launches_by = {}  # chain3s kernel launches (launches_per_chain a chain), by recipe

# the C entry points by the packed weights' dtype: the bf16 and the float32 recipe, and
# their arguments (pointers, ints, then the bf16 plans, and the stream)
_FN = {torch.bfloat16: "hcflow_chain3s_inverse", torch.float32: "hcflow_chain3s_inverse_f32"}
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3
_ARGTYPES_F32 = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

# csrc/chain3s.cu's constants: warpgroups a block, the net input's halo, accumulator
# floats a thread keeps in a pass, the largest tile side, a block's shared memory at most
NWG, HALO, ACC_FLOATS, MAX_MG, MAX_TILE, BLOCK_SMEM = 3, 5, 64, 3, 64, 232448
SMS = 132  # SMs of an H100 SXM: plan() fills them
_SIDES = (8, 10, 12, 14, 16, 20, 24, 28, 32)  # the tile sides plan() weighs


def _rup(n: int, m: int) -> int:
    return -(-n // m) * m


def _rup16(n: int) -> int:
    return _rup(n, 16)


def launches_per_chain(K: int, f32: bool = False) -> int:
    """The kernel launches one K-step chain makes: one a step in bf16, one a chain in
    float32."""
    return 1 if f32 else K


def step_widths(c: int) -> tuple:
    """((cinp, n5) of the even steps, (cinp, n5) of the odd ones): the net input padded
    to 16 channels and conv5's width in the kernel (even: [shift | scale] in blocks of 8,
    2 rup8(c - 3); odd: the 3 shifts padded to 16)."""
    c2 = c - 3
    return (16, 2 * _rup(c2, 8)), (_rup16(c2), 16)


def _offsets(th, tw, cinp, gc, n5, stages) -> list:
    """Where a bf16 step block's five feature arrays start in its shared memory, and where
    the last ends (csrc/chain3s.cu's Geometry): the weight ring, then the net input on the
    tile plus 5 and x1..x4 on the tile plus 4..1, each 128-byte aligned."""
    offs = [_rup(stages * 9 * 16 * max(gc, n5) * 2, 128)]
    for f in range(5):
        h = HALO - f
        offs.append(offs[-1] + _rup((th + 2 * h) * (tw + 2 * h) * (cinp if f == 0 else gc) * 2,
                                    128))
    return offs


def smem_bytes(th, tw, cinp, gc, n5, stages) -> int:
    """A bf16 step block's shared memory (csrc/chain3s.cu's Geometry)."""
    return _offsets(th, tw, cinp, gc, n5, stages)[5]


def _mg(n: int) -> int:
    return min(MAX_MG, max(1, ACC_FLOATS // (n // 2)))


def _runs(th, tw, cinp, gc, n5, stages) -> bool:
    """Whether the bf16 kernel takes the plan (its plan_ok): shared memory within a
    block's, conv5 in one pass and its sums, staged over the ring and the first two
    arrays, within them."""
    offs = _offsets(th, tw, cinp, gc, n5, stages)
    return (offs[5] <= BLOCK_SMEM and -(-th // 8) * -(-tw // 8) <= NWG * _mg(n5)
            and th * tw * n5 * 4 <= offs[2])


def _block_work(th, tw, cinp, gc, n5) -> int:
    """The products of a block's busiest warpgroup (in m64n8k16 units), plus ~30 for each
    ring step and the net input's staging: the unit plan() compares tiles in."""
    work = (th + 2 * HALO) * (tw + 2 * HALO) * 2
    for i in range(5):
        n, h = (gc if i < 4 else n5), HALO - 1 - i
        nmt, per = -(-(tw + 2 * h) // 8) * -(-(th + 2 * h) // 8), NWG * _mg(n)
        chunks = (cinp + i * gc) // 16
        for p0 in range(0, nmt, per):
            busiest = -(-min(per, nmt - p0) // NWG)
            work += chunks * (9 * busiest * (n // 8) + 30)
    return work


def _fused_plan(B, H, W, cinp, gc, n5):
    best = None
    for th in _SIDES:
        for tw in _SIDES:
            for stages in (3, 2):
                if _runs(th, tw, cinp, gc, n5, stages):
                    smem = smem_bytes(th, tw, cinp, gc, n5, stages)
                    break
            else:
                continue
            grid = (-(-W // tw), -(-H // th), B)
            blocks = grid[0] * grid[1] * B
            waves = -(-blocks // SMS)
            key = (waves * _block_work(th, tw, cinp, gc, n5), blocks, th, tw)
            if best is None or key < best[0]:
                regions = [(th + 2 * h, tw + 2 * h) for h in range(HALO, -1, -1)]
                best = (key, {"th": th, "tw": tw, "stages": stages, "smem": smem, "cinp": cinp,
                              "n5": n5, "grid": grid, "blocks": blocks, "waves": waves,
                              "regions": regions})
    return best[1]


GROWTHS = (16, 32, 64)  # the growths the kernels take


def padded_growth(gc: int) -> int:
    """The growth a pack holds: a multiple of 8 rounded up to 16, 32 or 64, any other
    growth (or one past 64) as it is."""
    return nets.pad_width(gc, GROWTHS) if gc % 8 == 0 else gc


def takes(c: int, gc: int) -> bool:
    """Whether the kernels run a chain of c channels at growth gc: the limit that
    :func:`packs` and the wrapper's checks both apply."""
    return gc in GROWTHS and 1 <= c - 3 <= 32


def _check_widths(c: int, gc: int) -> None:
    if takes(c, gc):
        return
    if gc not in GROWTHS:
        raise ValueError(f"the chain3s kernel takes a growth of 16, 32 or 64, not {gc}")
    raise ValueError(f"the chain3s kernel takes 4 to 35 channels, not {c}")


_plans: dict = {}


def plan(B: int, H: int, W: int, c: int, gc: int) -> dict:
    """The bf16 kernel's plan of a chain at (B, H, W, c), growth gc, a pure function of
    its arguments: {"even": ..., "odd": ...}, each step parity's {"th", "tw": the tile;
    "stages" of the weight ring (3 where they fit, else 2); "smem": a block's
    shared-memory bytes; "cinp", "n5": the net input's and conv5's widths; "grid": (tiles
    across, tiles down, B); "blocks"; "waves" of one block an SM on ``SMS`` SMs;
    "regions": (height, width) of the net input, x1..x4 and conv5 (the tile plus 5 .. 0
    pixels)}.  Of the tiles the kernel takes (shared memory within a block's, conv5 in
    one pass), the one with the least work on the busiest SM (waves x the products of a
    block's busiest warpgroup).  Raises a ValueError for widths the kernel does not take.
    (The float32 kernel needs no plan: it runs the shared tile conv's tiles.)"""
    _check_widths(c, gc)
    key = (B, H, W, c, gc)
    if key not in _plans:
        even, odd = (_fused_plan(B, H, W, cinp, gc, n5) for cinp, n5 in step_widths(c))
        _plans[key] = {"even": even, "odd": odd}
    return _plans[key]


def supported(lv, hidden_channels: int) -> bool:
    """The chains the kernel computes (``hcflow_tpu/ops/pallas_chain3s.py``
    ``supported``): a level's alternating main chain of at least two Affine3shift
    steps with DenseBlock nets of a growth that is a multiple of 8, no permutation, no
    cond, more than the 3 LR channels; a chain of other steps serves on the plain path."""
    ms = lv.main_spec
    return (lv.alternate_lrvsothers and lv.n_main >= 2 and ms.flow_permutation == "none"
            and ms.flow_coupling == "Affine3shift" and ms.nn_module == "DenseBlock"
            and ms.cond_channels is None and hidden_channels % 8 == 0 and lv.channels > 3)


def packs(lv, gc: int, device) -> bool:
    """Whether a level's main chain of growth gc whose params lie on ``device`` is packed
    for serving: where the JAX package packs it (:func:`supported`) and, on the card,
    where its padded pack is one the kernels take; a wider chain serves on the plain
    step loop there."""
    return supported(lv, gc) and (torch.device(device).type != "cuda"
                                  or takes(lv.channels, padded_growth(gc)))


def _conv5_order(c2: int, even: bool) -> list:
    """conv5's outputs in the kernel's order, as rows of the [shift | scale] (even) or
    shift (odd) outputs, -1 for a zero row: even steps in blocks of 8, [shift 0..7 |
    scale 0..7 | shift 8..15 | ...] (2 rup8(c2) rows), so that shift j and scale j land in
    one thread's accumulator fragment; odd steps the 3 shifts and 13 zero rows."""
    if not even:
        return [0, 1, 2] + [-1] * 13
    order = []
    for col in range(2 * _rup(c2, 8)):
        j = 8 * (col // 16) + col % 8
        order.append(-1 if j >= c2 else (j if col % 16 < 8 else c2 + j))
    return order


def _pack_net(f: dict, cin: int, fout: int, perm, nd) -> tuple:
    """One dense block's weights by ``nets.pack_taps`` (bf16 [tap][ci][co], float32
    [tap][co][ci]) with the net input padded to 16 channels (zero rows), the growth
    padded by :func:`padded_growth` (zero outputs of conv1-4 and zero rows where each
    later conv reads them) and conv5's outputs permuted by ``perm`` and zero-padded, and
    their biases, for the plain version; and the same convs flattened in the kernel's
    layout for the blobs (bf16 [tap][ci][co]; float32 their TF32 planes,
    ``nets.pack_tf32``, split after the padding, where every input width is a multiple
    of 4, else None), conv5's outputs in :func:`_conv5_order`."""
    gc = f["conv1"]["w"].shape[0]
    gcp = padded_growth(gc)
    ws, bs, blob_w, blob_b = [], [], [], []
    for i in range(1, 6):
        w, b = f[f"conv{i}"]["w"], f[f"conv{i}"]["b"]  # OIHW
        w, b = nets.pad_dense_conv(w, b, [cin] + [gc] * (i - 1),
                                   [_rup16(cin)] + [gcp] * (i - 1), gcp if i < 5 else fout)
        wk, bk = w, b
        if i == 5:
            if perm is not None:
                w, b = w[perm], b[perm]
            order = _conv5_order(fout // 2, perm is not None)
            idx = torch.tensor([fout if r < 0 else r for r in order], device=w.device)
            wk = torch.cat([w, w.new_zeros(1, *w.shape[1:])])[idx]
            bk = torch.cat([b, b.new_zeros(1)])[idx]
            pad_out = _rup16(fout) - fout
            w, b = F.pad(w, (0, 0, 0, 0, 0, 0, 0, pad_out)), F.pad(b, (0, pad_out))
        ws.append(nets.pack_taps(w, nd))
        bs.append(b.float())
        if nd == torch.float32:
            blob_w.append(nets.pack_tf32(wk).flatten() if wk.shape[1] % 4 == 0 else None)
        else:
            blob_w.append(nets.pack_taps(wk, nd).flatten())
        blob_b.append(bk.float())
    return ws, bs, blob_w, blob_b


def pack_inverse_chain3s(main: list, compute_dtype=None) -> dict:
    """Pack an alternating chain's per-step params for the kernel and its plain version.

    Every conv's growth is padded by :func:`padded_growth` (gc below).  For the plain
    version, stacked per parity (``e``: even k, net input z1; ``o``: odd
    k, net input z2), index k // 2: ``w{e,o}{1..5}`` (n, 9, cin_i, cout_i) in the net
    dtype (float32: (n, 9, cout_i, cin_i), K-major) and ``b{e,o}{1..5}`` float32; the
    even conv5's outputs go from the even/odd "cross" split to [shift | scale].  For the
    kernel, ``blob_w``: every step's five convs, step 0 first, flattened in its layout
    (bf16 (9, cin_i, n_i); float32 the TF32 planes (2, 9, cin_i / 4, n_i, 4), present
    where every input width is a multiple of 4), conv5's outputs in the kernel's order
    (:func:`_conv5_order`, n_i its :func:`step_widths`); ``blob_b``: their float32 biases
    likewise.  ``an_s`` = exp(-logs) and ``an_b`` (K, c); ``logsum`` = the sum of every
    step's ActNorm logs.
    """
    nd = nets.net_dtype(compute_dtype)
    c = main[0]["actnorm"]["bias"].shape[0]
    c2 = c - 3
    perm = torch.cat([torch.arange(0, 2 * c2, 2), torch.arange(1, 2 * c2, 2)]).to(
        main[0]["actnorm"]["bias"].device)
    nets_k = [_pack_net(p["coupling"]["f"], *((3, 2 * c2, perm) if k % 2 == 0 else (c2, 3, None)),
                        nd) for k, p in enumerate(main)]
    packed = {}
    for tag, ks in (("e", range(0, len(main), 2)), ("o", range(1, len(main), 2))):
        for i in range(5 if ks else 0):  # a one-step chain has no odd step
            packed[f"w{tag}{i + 1}"] = torch.stack([nets_k[k][0][i] for k in ks]).contiguous()
            packed[f"b{tag}{i + 1}"] = torch.stack([nets_k[k][1][i] for k in ks]).contiguous()
    if all(w is not None for n in nets_k for w in n[2]):
        packed["blob_w"] = torch.cat([w for n in nets_k for w in n[2]])
        packed["blob_b"] = torch.cat([b for n in nets_k for b in n[3]])
    logs = torch.stack([p["actnorm"]["logs"] for p in main]).float()
    packed["an_s"] = torch.exp(-logs).contiguous()
    packed["an_b"] = torch.stack([p["actnorm"]["bias"] for p in main]).float().contiguous()
    packed["logsum"] = logs.sum()
    return packed


def _dims(packed):
    K, c = packed["an_s"].shape
    return K, c, nets.taps_shape(packed["we1"])[3]


def halo_rows(packed: dict) -> int:
    """Rows of halo each side that the chain reads around an output row: per step its
    dense block's five 3x3 convs, one row each, 5K in all."""
    ws = [packed[f"w{t}{i}"] for t in "eo" for i in range(1, 6) if f"w{t}{i}" in packed]
    return sum(w.shape[0] * ((math.isqrt(w.shape[1]) - 1) // 2) for w in ws)


def inverse_chain3s_plain(packed: dict, z: torch.Tensor):
    """The kernel's arithmetic in plain PyTorch (float32 convs, the net operands rounded
    to the packed weights' dtype).  Returns (z, logdet_delta)."""
    K, c, _ = _dims(packed)
    c2 = c - 3
    wd = packed["we1"].dtype

    def rnd(t):
        return t.to(wd).float()

    with nets.exact_f32():
        for k in reversed(range(K)):
            tag, idx = "eo"[k % 2], k // 2
            z1, z2 = z[..., :3], z[..., 3:]
            x = z1 if k % 2 == 0 else z2
            cin_pad = nets.taps(packed[f"w{tag}1"]).shape[2]
            feats = [rnd(F.pad(x, (0, cin_pad - x.shape[-1])))]
            for i in range(1, 5):
                h = nets.conv_taps(torch.cat(feats, -1), nets.taps(packed[f"w{tag}{i}"][idx]),
                                   packed[f"b{tag}{i}"][idx])
                feats.append(rnd(nets.lrelu(h)))
            p = nets.conv_taps(torch.cat(feats, -1), nets.taps(packed[f"w{tag}5"][idx]),
                               packed[f"b{tag}5"][idx])
            if k % 2 == 0:
                shift, scale = p[..., :c2], p[..., c2 : 2 * c2]
                z2 = z2 * torch.exp(-0.318 * torch.atan(2.0 * scale)) - shift
            else:
                z1 = z1 - p[..., :3]
            z = torch.cat([z1, z2], -1) * packed["an_s"][k] - packed["an_b"][k]
    return z, -packed["logsum"] * (z.shape[1] * z.shape[2])


def inverse_chain(packed: dict, z: torch.Tensor):
    """Run the K-step inverse chain (k = K-1 down to 0) on NHWC float32 z.  Returns
    (z, logdet_delta).  A CPU tensor takes the plain version; a CUDA tensor the
    kernel.  Either raises under autograd when an input requires grad."""
    _build.refuse_grad("chain3s", z, packed)
    if not z.is_cuda:
        return inverse_chain3s_plain(packed, z)
    return _launch(packed, z)


def _blob_sizes(K: int, c: int, gc: int, f32: bool) -> tuple:
    """(weight elements, bias floats) the blobs of a K-step chain hold."""
    w = b = 0
    for k in range(K):
        cinp, n5 = step_widths(c)[k % 2]
        w += sum((2 if f32 else 1) * 9 * (cinp + i * gc) * (gc if i < 4 else n5) for i in range(5))
        b += 4 * gc + n5
    return w, b


def check_pack(packed: dict) -> tuple:
    """The kernel's checks of a pack, which need no card: one dtype (bf16 or float32), a
    growth and a width the kernel takes, and the weight and bias blobs of the layout
    :func:`pack_inverse_chain3s` makes, of the sizes the chain's widths give.  Returns
    (dtype, growth); raises a ValueError (a pack of an earlier layout, with no blobs,
    by name)."""
    K, c, gc = _dims(packed)
    names = [f"{t}{i}" for t in "eo" for i in range(1, 6) if f"w{t}{i}" in packed]
    wd = nets.pack_dtype([packed[f"w{n}"] for n in names], "chain3s")
    _check_widths(c, gc)
    if "blob_w" not in packed or "blob_b" not in packed:
        raise ValueError("the chain3s kernel reads the pack's weight and bias blobs ('blob_w', "
                         "'blob_b'), which this pack lacks (an earlier layout, or float32 "
                         "widths that are not multiples of 4): repack the chain with "
                         "pack_inverse_chain3s")
    nw, nb = _blob_sizes(K, c, gc, wd == torch.float32)
    wb, bb = packed["blob_w"], packed["blob_b"]
    if (wb.dtype != wd or wb.shape != (nw,) or bb.dtype != torch.float32
            or bb.shape != (nb,)):
        raise ValueError(f"the chain3s blobs must hold {nw} {wd} weights and {nb} float32 "
                         f"biases, not {wb.numel()} {wb.dtype} and {bb.numel()} {bb.dtype}: "
                         "repack the chain with pack_inverse_chain3s")
    return wd, gc


def _launch(packed, z):
    K, c, _ = _dims(packed)
    B, H, W, cz = z.shape
    if cz != c or z.dtype != torch.float32:
        raise ValueError(f"z must be float32 with {c} channels, got {z.dtype} {tuple(z.shape)}")
    wd, gc = check_pack(packed)
    z = z.contiguous()
    tensors = (z, packed["blob_w"], packed["blob_b"], packed["an_s"], packed["an_b"])
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("chain3s kernel inputs must be contiguous CUDA tensors")
    f32 = wd == torch.float32
    out = torch.empty_like(z)
    fn = _FN[wd]
    lib = _build.load("chain3s", fn, _ARGTYPES_F32 if f32 else _ARGTYPES)
    scratch = []  # held until the call has queued its launches
    _build.check(lib, fn, getattr(lib, fn)(*_args(packed, z, out, gc, scratch)))
    key = "f32" if f32 else "bf16"
    launches_by[key] = launches_by.get(key, 0) + launches_per_chain(K, f32)
    return out, -packed["logsum"] * (H * W)


def _args(packed, z, out, gc, scratch: list) -> tuple:
    """The C entry point's arguments for a checked pack and contiguous CUDA z and out:
    bf16 with every other step's z in a scratch tensor and the plan, float32 with the
    dense buffers and the tiles' counts of stages done (scratch the kernel writes before
    it reads).  The scratch tensors are appended to ``scratch``, which the caller holds
    through the call."""
    K, c, _ = _dims(packed)
    B, H, W, _ = z.shape
    ptrs = (packed["blob_w"].data_ptr(), packed["blob_b"].data_ptr(), packed["an_s"].data_ptr(),
            packed["an_b"].data_ptr())
    ints = (B, H, W, c, gc, K)
    stream = torch.cuda.current_stream(z.device).cuda_stream
    if packed["blob_w"].dtype == torch.float32:
        dense = [torch.empty(B, H, W, cinp + 4 * gc, device=z.device) for cinp, _ in
                 step_widths(c)]
        done = torch.empty(B * -(-H // 16) * -(-W // 8), dtype=torch.int32, device=z.device)
        scratch += [*dense, done]
        return (z.data_ptr(), out.data_ptr(), *(d.data_ptr() for d in dense), done.data_ptr(),
                *ptrs, *ints, stream)
    tmp = torch.empty_like(z) if K > 1 else out  # every other step's z
    scratch.append(tmp)
    p = plan(B, H, W, c, gc)
    # {th, tw, stages, smem} of each parity, as ctypes arrays that the call keeps alive
    pe, po = ((ctypes.c_int * 4)(*(p[t][k] for k in ("th", "tw", "stages", "smem")))
              for t in ("even", "odd"))
    return (z.data_ptr(), out.data_ptr(), tmp.data_ptr(), *ptrs, *ints, pe, po, stream)
