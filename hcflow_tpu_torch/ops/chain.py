"""Inverse flow-step chain: the CUDA kernel ``csrc/chain.cu``, its plain version and
their packing.

Replaces ``hcflow_tpu/ops/pallas_chain.py`` (``inverse_chain`` / ``_make_kernel``).  A
chain is K Affine+FCN+invconv steps run from k = K-1 down to 0.  Step k:

1. ``h1 = relu((conv3x3(z1) + uc_k + b1) * e1)``          (uc_k: hoisted cond term)
2. ``h2 = relu((h1 @ W2 + b2) * e2)``
3. ``p = conv3x3(h2) * g3 + bg3`` = [shift | scale]      (``exp(3*logs)`` folded in)
4. ``z2 = z2 * exp(-0.318 * atan(2 * scale)) - shift``
5. ``z = [z1, z2] @ Wt.T - ab``, ``Wt = diag(exp(-logs)) W^-1``, all float32.

In the bf16 recipe z1, h1, h2 and the net weights are rounded to bf16 and every sum
is float32; the invertible tail (steps 4-5) stays float32 throughout.

On the card (``csrc/chain.cu``): one launch per step, with z ping-ponging between
two buffers, at coupling width (hid) 32 or 64.  The bf16 recipe: a block of 8 warps
owns an output tile sized per shape (16x16 at 80x80, 8x20 at 40x40, 4x10 at 20x20 for
batch 16 at hid 64; ``plan`` reports it).  It runs the three convs on tensor cores
(``mma.sync`` m16n8k16, bf16 in, float32 sums) with h1 in registers and h2 in shared
memory, and the tail in float32 on CUDA cores, so only z and the cond term touch
device memory.  The float32 recipe (a float32 pack): the same step with float32
operands and sums, on tensor cores as ``mma.sync`` m16n8k8 TF32 products, each product
split in three (3xTF32: ``x = hi + lo``, ``hi*hi + hi*lo + lo*hi``, an error of
float32's order; no single-pass TF32), tiles by the same planner; it computes what the
plain version computes under ``nets.exact_f32()``, and is bound by its products.  The
bf16 recipe is bound by operations, barely (19-91 kFLOP per pixel of bf16 convs against
50-450 bytes); the least time is 0.01-0.05 ms per 13-step chain at the main path's
shapes, and the kernel is bound by latency: the step's weights staged per block and
three dependent convs on a small tile.  The kernel takes
the padded pack (``pack_inverse_chain(..., padded=True)``): c1 padded to 8 and shift
and scale to 8 each, with zeros, so that shift j and scale j sit in one thread's
fragment, and hid padded up to 32 or 64 with zero channels, whose activations are
relu((0 + 0) * 1) = 0 and which carry nothing into conv3; the plain version reads
either pack.  A chain wider than the kernel's widths (:func:`takes`: hid over 64, c
outside 2 to 64) is not packed for the card (:func:`packs`) and serves on the plain
step loop.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import _build
from . import nets

# chain-step kernel launches (one per flow step), by variant: "bf16 hid 64", "f32 hid 32", ...
launches_by = {}

_FN = "hcflow_chain_inverse"
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
HIDS = (32, 64)  # the coupling widths the kernel takes


def _up(x: int, m: int) -> int:
    return -(-x // m) * m


def supported(step_spec) -> bool:
    """The steps the kernel computes: Affine coupling, FCN net, plain-weight invconv
    (``hcflow_tpu/ops/pallas_chain.py`` ``supported``); a chain of other steps serves
    on the plain path."""
    return (step_spec.flow_permutation == "invconv" and step_spec.flow_coupling == "Affine"
            and step_spec.nn_module == "FCN" and not step_spec.lu_decomposed)


def padded_hid(hid: int) -> int:
    """The coupling width a padded pack holds: hid up to 32 -> 32, 33 to 64 -> 64, a
    wider one as it is."""
    return nets.pad_width(hid, HIDS)


def takes(c: int, hid: int) -> bool:
    """Whether the kernel runs a chain of c channels at coupling width hid (csrc/chain.cu
    ``with_hid`` and ``with_widths``): the limit that :func:`packs` and the wrapper
    both apply."""
    return hid in HIDS and 2 <= c <= 64


def packs(step_spec, c: int, hid: int, device) -> bool:
    """Whether a chain of c channels and coupling width hid whose params lie on
    ``device`` is packed for serving: where the JAX package packs it
    (:func:`supported`, any width) and, on the card, where its padded pack is one the
    kernel takes; a wider chain serves on the plain step loop there."""
    return supported(step_spec) and (torch.device(device).type != "cuda"
                                     or takes(c, padded_hid(hid)))


def pack_inverse_chain(steps: list, compute_dtype=None, padded: bool = False) -> dict:
    """Pack a chain's per-step params (invconv inverses attached) for the kernel.

    The conv weights go to the net dtype; the tail ``Wt``/``ab`` and the per-channel
    vectors stay float32.  Per step k: ``w1`` (9, c1, hid) ``[tap][c][j]``, ``w2``
    (hid, hid) ``[in][out]``, ``w3`` (9, hid, 2 c2) with the outputs permuted from
    the even/odd "cross" split to [shift | scale], ``vec`` = b1, e1, b2, e2, g3, bg3
    (``e = exp(logs)``, ``g3 = exp(3 logs3)`` folded into conv3's gain and bias),
    ``wt`` = diag(exp(-logs)) W^-1 and ``ab`` the ActNorm bias.

    ``padded``: the CUDA kernel's layout, with zeros added: ``w1`` (9, C1P, HP), C1P
    = c1 rounded up to a multiple of 8; shift and scale each padded to S = c2 rounded
    up to a multiple of 8, so ``w3`` is (9, HP, 2 S) as [shift (S) | scale (S)] and
    g3, bg3 have 2 S entries each; the coupling width padded to HP =
    :func:`padded_hid` (hid), ``w2`` (HP, HP), with zero weights into and out of the
    padded channels and their b1, e1, b2, e2 set to 0, 1, 0, 1.  A hoisted cond term
    reaches a padded pack through :func:`pad_uc`.
    """
    nd = nets.net_dtype(compute_dtype)
    f = [p["coupling"]["f"] for p in steps]
    c = steps[0]["invconv"]["w_inv"].shape[0]
    c1, c2 = c // 2, c - c // 2
    perm = torch.cat([torch.arange(0, 2 * c2, 2), torch.arange(1, 2 * c2, 2)]).to(
        steps[0]["invconv"]["w_inv"].device)
    w1 = torch.stack([q["conv1"]["w"][:, :c1] for q in f])  # (K, hid, c1, 3, 3)
    w2 = torch.stack([q["conv2"]["w"][:, :, 0, 0] for q in f])  # (K, out, in)
    w3 = torch.stack([q["conv3"]["w"][perm] for q in f])
    K, hid = w1.shape[:2]
    g3 = torch.stack([torch.exp(3.0 * q["conv3"]["logs"]) for q in f])[:, perm]
    bg3 = torch.stack([q["conv3"]["b"] for q in f])[:, perm] * g3
    vec = torch.cat([
        torch.stack([q["conv1"]["actnorm"]["bias"] for q in f]),
        torch.stack([torch.exp(q["conv1"]["actnorm"]["logs"]) for q in f]),
        torch.stack([q["conv2"]["actnorm"]["bias"] for q in f]),
        torch.stack([torch.exp(q["conv2"]["actnorm"]["logs"]) for q in f]),
        g3, bg3,
    ], 1)
    wt = torch.stack([torch.exp(-p["actnorm"]["logs"])[:, None] * p["invconv"]["w_inv"]
                      for p in steps])
    packed = {
        "w1": w1.permute(0, 3, 4, 2, 1).reshape(K, 9, c1, hid),
        "w2": w2.transpose(1, 2),
        "w3": w3.permute(0, 3, 4, 2, 1).reshape(K, 9, hid, 2 * c2),
        "vec": vec,
        "wt": wt,
        "ab": torch.stack([p["actnorm"]["bias"] for p in steps]),
    }
    if padded:
        pad, ph = _up(c2, 8) - c2, padded_hid(hid) - hid
        F = torch.nn.functional

        def halves(t):  # [shift | scale] on the last axis, each half padded to S
            return torch.cat([F.pad(t[..., :c2], (0, pad)), F.pad(t[..., c2:], (0, pad))], -1)

        packed["w1"] = F.pad(packed["w1"], (0, ph, 0, _up(c1, 8) - c1))
        packed["w2"] = F.pad(packed["w2"], (0, ph, 0, ph))
        packed["w3"] = halves(F.pad(packed["w3"], (0, 0, 0, ph)))
        b, g, bg = vec.split([4 * hid, 2 * c2, 2 * c2], 1)
        if ph:  # b1, e1, b2, e2 of the padded channels: 0, 1, 0, 1
            b = torch.cat([F.pad(v, (0, ph), value=float(i % 2))
                           for i, v in enumerate(b.split(hid, 1))], 1)
        packed["vec"] = torch.cat([b, halves(g), halves(bg)], 1)
    return {k: v.to(nd if k in ("w1", "w2", "w3") else torch.float32).contiguous()
            for k, v in packed.items()}


def _dims(packed):
    """(K, c1, c, hid, S) of a pack, padded or not (S: the width of the shift half)."""
    K, c = packed["wt"].shape[:2]
    return K, c // 2, c, packed["w2"].shape[-1], packed["w3"].shape[-1] // 2


def halo_rows(packed: dict) -> int:
    """Rows of halo each side that the chain reads around an output row: per step
    conv1's and conv3's radius (3x3: one each; conv2 is 1x1), 2K in all."""
    K = packed["wt"].shape[0]
    return K * sum((math.isqrt(packed[n].shape[1]) - 1) // 2 for n in ("w1", "w3"))


def pad_uc(packed: dict, uc: torch.Tensor) -> torch.Tensor:
    """The hoisted cond terms of :func:`stack.compute_u_contribs` ((B, H, W, K hid), step
    k's at ``[k hid, (k + 1) hid)``) in a pack's layout: each step's hid channels padded
    with zeros to the pack's coupling width, in the packed weights' dtype, contiguous."""
    K, hp = packed["w2"].shape[:2]
    B, H, W, n = uc.shape
    if n != K * hp:
        uc = torch.nn.functional.pad(uc.reshape(B, H, W, K, n // K), (0, hp - n // K))
    return uc.reshape(B, H, W, K * hp).to(packed["w1"].dtype).contiguous()


def inverse_chain_plain(packed: dict, z: torch.Tensor, uc=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (float32 convs, bf16 rounding where
    the kernel rounds), from either pack."""
    K, c1, c, hid, S = _dims(packed)
    c2 = c - c1
    bf = packed["w1"].dtype == torch.bfloat16
    rnd = (lambda t: t.to(torch.bfloat16).float()) if bf else (lambda t: t)
    with nets.exact_f32():
        for k in reversed(range(K)):
            b1, e1, b2, e2, g3, bg3 = packed["vec"][k].split([hid] * 4 + [2 * S] * 2)
            z1, z2 = z[..., :c1], z[..., c1:]
            h = nets.conv_taps(rnd(z1), packed["w1"][k][:, :c1])
            if uc is not None:
                h = h + uc[..., k * hid : (k + 1) * hid].float()
            h = rnd(torch.relu((h + b1) * e1))
            h = rnd(torch.relu((h @ packed["w2"][k].float() + b2) * e2))
            p = nets.conv_taps(h, packed["w3"][k]) * g3 + bg3
            shift, scale = p[..., :c2], p[..., S : S + c2]
            z2 = z2 * torch.exp(-0.318 * torch.atan(2.0 * scale)) - shift
            z = torch.cat([z1, z2], -1) @ packed["wt"][k].T - packed["ab"][k]
    return z


def inverse_chain(packed: dict, z: torch.Tensor, uc=None) -> torch.Tensor:
    """Run the K-step inverse chain (k = K-1 down to 0) on NHWC float32 z.

    ``uc`` (a conditional chain only): the hoisted cond terms of
    ``stack.compute_u_contribs`` in the pack's layout (:func:`pad_uc`), (B, H, W, K*hid)
    at the pack's hid, in the packed weights' dtype.  A CPU tensor takes the plain
    version; a CUDA tensor the kernel, which takes the padded pack, bf16 or float32, of
    widths it takes (:func:`takes`), or raises.  Either raises under autograd when an
    input requires grad."""
    _build.refuse_grad("chain", z, uc, packed)
    K, _, _, hid, _ = _dims(packed)
    if uc is not None and uc.shape[-1] != K * hid:
        raise ValueError(f"uc has {uc.shape[-1]} channels, not the pack's K * hid = {K * hid} "
                         "(pad it to the pack's layout with pad_uc)")
    if not z.is_cuda:
        return inverse_chain_plain(packed, z, uc)
    return _launch(packed, z, uc)


def _launch(packed, z, uc):
    K, c1, c, hid, _ = _dims(packed)
    B, H, W, cz = z.shape
    if cz != c or z.dtype != torch.float32:
        raise ValueError(f"z must be float32 with {c} channels, got {z.dtype} {tuple(z.shape)}")
    if not takes(c, hid):
        raise ValueError(f"the chain kernel takes hid {HIDS} and 2 to 64 channels, not {hid}, {c}")
    nd = packed["w1"].dtype
    if nd not in (torch.bfloat16, torch.float32) or any(packed[n].dtype != nd for n in ("w2", "w3")):
        raise ValueError("the chain kernel takes bf16 or float32 packed weights, all of one dtype")
    S = _up(c - c1, 8)
    shapes = {"w1": (K, 9, _up(c1, 8), hid), "w2": (K, hid, hid), "w3": (K, 9, hid, 2 * S),
              "vec": (K, 4 * hid + 4 * S), "wt": (K, c, c), "ab": (K, c)}
    for name, shape in shapes.items():
        if tuple(packed[name].shape) != shape:
            raise ValueError(f"packed {name} has shape {tuple(packed[name].shape)}, not {shape} "
                             "(the kernel takes pack_inverse_chain(..., padded=True))")
    if uc is not None and (uc.dtype != nd or tuple(uc.shape) != (B, H, W, K * hid)):
        raise ValueError(f"uc must be {nd} of shape {(B, H, W, K * hid)}")
    z = z.contiguous()
    tensors = [z, *(packed[n] for n in ("w1", "w2", "w3", "vec", "wt", "ab"))]
    if uc is not None:
        tensors.append(uc)
    if not all(t.is_cuda and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("chain kernel inputs must be contiguous, 16-byte aligned CUDA tensors")
    bufs = [torch.empty_like(z), torch.empty_like(z)]
    lib = _build.load("chain", _FN, _ARGTYPES)
    err = lib.hcflow_chain_inverse(
        z.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
        uc.data_ptr() if uc is not None else None,
        *(packed[n].data_ptr() for n in ("w1", "w2", "w3", "vec", "wt", "ab")),
        B, H, W, c, hid, K, int(nd == torch.float32),
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    _build.check(lib, _FN, err)
    key = f"{'f32' if nd == torch.float32 else 'bf16'} hid {hid}"
    launches_by[key] = launches_by.get(key, 0) + K
    return bufs[(K - 1) % 2]


def plan(B: int, H: int, W: int, c: int, hid: int = 64, f32: bool = False) -> dict:
    """The kernel's tile plan for one step at (B, H, W, c) and coupling width hid, in
    the bf16 recipe or (``f32``) the float32 one, on the current card: tile height and
    width, blocks, shared-memory bytes a block, blocks per SM."""
    lib = _build.load("chain", "hcflow_chain_plan", [ctypes.c_int] * 6 + [ctypes.c_void_p])
    out = (ctypes.c_int * 5)()
    _build.check(lib, "hcflow_chain_plan",
                 lib.hcflow_chain_plan(B, H, W, c, hid, int(f32), out))
    return dict(zip(("th", "tw", "blocks", "smem", "blocks_per_sm"), out))
