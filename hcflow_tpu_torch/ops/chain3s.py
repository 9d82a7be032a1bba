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

On the card (``csrc/chain3s.cu``): one launch per dense-block conv plus one that
copies z and stages the first net input, 1 + 5K per chain.  Bound: operations
(~1.2 MFLOP per pixel for an 8-step chain against ~100 bytes).  The net input is
zero-padded to a multiple of 16 channels and conv5's outputs likewise, with zero
weights at pack time; the padding never reaches z.
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import _build
from . import nets

launches_by = {}  # chain3s kernel launches (1 + 5 per flow step), by recipe: "bf16", "f32"

# the C entry points by the packed weights' dtype: the bf16 and the float32 recipe
_FN = {torch.bfloat16: "hcflow_chain3s_inverse", torch.float32: "hcflow_chain3s_inverse_f32"}
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]


def _rup16(n: int) -> int:
    return -(-n // 16) * 16


def supported(lv, hidden_channels: int) -> bool:
    """The chains the kernel computes (``hcflow_tpu/ops/pallas_chain3s.py``
    ``supported``): a level's alternating main chain of at least two Affine3shift
    steps with DenseBlock nets of a growth that is a multiple of 8, no permutation, no
    cond, more than the 3 LR channels; a chain of other steps serves on the plain path."""
    ms = lv.main_spec
    return (lv.alternate_lrvsothers and lv.n_main >= 2 and ms.flow_permutation == "none"
            and ms.flow_coupling == "Affine3shift" and ms.nn_module == "DenseBlock"
            and ms.cond_channels is None and hidden_channels % 8 == 0 and lv.channels > 3)


def _pack_net(f: dict, cin: int, fout: int, perm, nd) -> tuple:
    """One dense block's weights by ``nets.pack_taps`` (bf16 [tap][ci][co], float32
    [tap][co][ci]) with the net input padded to 16 channels (zero rows) and conv5's
    outputs permuted by ``perm`` and zero-padded; their biases; in float32, where every
    conv's input width is a multiple of 4, also their TF32 planes (``nets.pack_tf32``),
    else None."""
    pad_in = _rup16(cin) - cin
    ws, bs, ts = [], [], []
    for i in range(1, 6):
        w, b = f[f"conv{i}"]["w"], f[f"conv{i}"]["b"]  # OIHW
        if i == 5:
            if perm is not None:
                w, b = w[perm], b[perm]
            pad_out = _rup16(fout) - fout
            w, b = F.pad(w, (0, 0, 0, 0, 0, 0, 0, pad_out)), F.pad(b, (0, pad_out))
        w = torch.cat([w[:, :cin], w.new_zeros(w.shape[0], pad_in, 3, 3), w[:, cin:]], 1)
        ws.append(nets.pack_taps(w, nd))
        bs.append(b.float())
        ts.append(nets.pack_tf32(w) if nd == torch.float32 and w.shape[1] % 4 == 0 else None)
    return ws, bs, ts


def pack_inverse_chain3s(main: list, compute_dtype=None) -> dict:
    """Pack an alternating chain's per-step params for the kernel.

    Stacked per parity (``e``: even k, net input z1; ``o``: odd k, net input z2),
    index k // 2: ``w{e,o}{1..5}`` (n, 9, cin_i, cout_i) in the net dtype (float32: (n,
    9, cout_i, cin_i), K-major), ``b{e,o}{1..5}`` float32 and, in float32 where the
    growth is a multiple of 4, ``t{e,o}{1..5}`` (n, 2, 9, cin_i / 4, cout_i, 4), the
    weights' TF32 planes (``nets.pack_tf32``), which the kernel reads; the even conv5's
    outputs go from the even/odd "cross" split to [shift | scale].  ``an_s`` =
    exp(-logs) and ``an_b`` (K, c); ``logsum`` = the sum of every step's ActNorm logs.
    """
    nd = nets.net_dtype(compute_dtype)
    c = main[0]["actnorm"]["bias"].shape[0]
    c2 = c - 3
    perm = torch.cat([torch.arange(0, 2 * c2, 2), torch.arange(1, 2 * c2, 2)]).to(
        main[0]["actnorm"]["bias"].device)
    packed = {}
    for tag, ks, cin, fout, pm in (("e", range(0, len(main), 2), 3, 2 * c2, perm),
                                   ("o", range(1, len(main), 2), c2, 3, None)):
        nets_k = [_pack_net(main[k]["coupling"]["f"], cin, fout, pm, nd) for k in ks]
        for i in range(5 if nets_k else 0):  # a one-step chain has no odd step
            packed[f"w{tag}{i + 1}"] = torch.stack([n[0][i] for n in nets_k]).contiguous()
            packed[f"b{tag}{i + 1}"] = torch.stack([n[1][i] for n in nets_k]).contiguous()
            if nets_k[0][2][i] is not None:
                packed[f"t{tag}{i + 1}"] = torch.stack([n[2][i] for n in nets_k]).contiguous()
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


def check_pack(packed: dict) -> tuple:
    """The kernel's checks of a pack, which need no card: one dtype (bf16 or float32), a
    growth the kernel takes and, in float32, every conv's TF32 planes.  Returns (dtype,
    growth, the convs' names, the prefix of the keys whose weights the kernel reads: "w",
    or "t" for the TF32 planes); raises a ValueError."""
    gc = _dims(packed)[2]
    names = [f"{t}{i}" for t in "eo" for i in range(1, 6) if f"w{t}{i}" in packed]
    wd = nets.pack_dtype([packed[f"w{n}"] for n in names], "chain3s")
    if gc not in (16, 32, 64):
        raise ValueError(f"the chain3s kernel takes a growth of 16, 32 or 64, not {gc}")
    if wd == torch.bfloat16:
        return wd, gc, names, "w"
    for n in names:
        w, t = packed[f"w{n}"], packed.get(f"t{n}")
        cin, cout = nets.taps_shape(w)[-2:]
        if t is None or t.dtype != torch.float32 or tuple(t.shape) != (
                w.shape[0], 2, 9, cin // 4, cout, 4):
            raise ValueError(f"the float32 chain3s kernel reads conv {n}'s TF32 planes: pack "
                             "the chain with pack_inverse_chain3s (nets.pack_tf32)")
    return wd, gc, names, "t"


def _launch(packed, z):
    K, c, _ = _dims(packed)
    B, H, W, cz = z.shape
    if cz != c or z.dtype != torch.float32:
        raise ValueError(f"z must be float32 with {c} channels, got {z.dtype} {tuple(z.shape)}")
    wd, gc, names, wk = check_pack(packed)
    cin_e, sp_e = nets.taps_shape(packed["we1"])[2], nets.taps_shape(packed["we5"])[3]
    cin_o, sp_o = ((nets.taps_shape(packed["wo1"])[2], nets.taps_shape(packed["wo5"])[3])
                   if K > 1 else (16, 16))
    z = z.contiguous()
    tensors = [z, packed["an_s"], packed["an_b"]]
    tensors += [packed[x + n] for x in (wk, "b") for n in names]
    if not all(t.is_cuda and t.is_contiguous() for t in tensors):
        raise ValueError("chain3s kernel inputs must be contiguous CUDA tensors")
    out = torch.empty_like(z)
    # the padding channels of the net inputs are read and never written: zero them
    dense_e = torch.zeros((B, H, W, cin_e + 4 * gc), dtype=wd, device=z.device)
    dense_o = torch.zeros((B, H, W, cin_o + 4 * gc), dtype=wd, device=z.device)
    w_ptrs = (ctypes.c_void_p * (5 * K))()
    b_ptrs = (ctypes.c_void_p * (5 * K))()
    for k in range(K):
        tag, idx = "eo"[k % 2], k // 2
        for i in range(5):
            w_ptrs[5 * k + i] = packed[f"{wk}{tag}{i + 1}"][idx].data_ptr()
            b_ptrs[5 * k + i] = packed[f"b{tag}{i + 1}"][idx].data_ptr()
    fn = _FN[wd]
    lib = _build.load("chain3s", fn, _ARGTYPES)
    err = getattr(lib, fn)(
        z.data_ptr(), out.data_ptr(), dense_e.data_ptr(), dense_o.data_ptr(),
        ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs),
        packed["an_s"].data_ptr(), packed["an_b"].data_ptr(),
        B, H, W, c, gc, K, cin_e, cin_o, sp_e, sp_o,
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    _build.check(lib, fn, err)
    key = "f32" if wd == torch.float32 else "bf16"
    launches_by[key] = launches_by.get(key, 0) + 1 + 5 * K
    return out, -packed["logsum"] * (H * W)
