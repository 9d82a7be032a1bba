"""Weights drawn on the device from the seed, as a state_dict in the authors' layout.

The layout is the one a released ``.pth`` checkpoint of ``HCFlowNet_SR`` or
``HCFlowNet_Rescaling`` has (``flow.layers.<i>.*`` for the main flow steps,
``flow.level<i>_condFlow.*`` for the encoders, prior heads and conditional steps), so
that the program takes them through its loader for released weights and the
reference reads the same dict.

Each leaf is drawn from a normal law whose variance is the model's init plus the
perturbation rule of ``chip_smoke.py``'s ``perturb``: a conv weight gains noise of
std 0.1 / sqrt(fan_in), every other float leaf 0.02, so that the zero-initialised
layers (the couplings' last convs, the dense blocks' conv5, the prior heads) do work
and 28 RRDBs stay stable.  Every invertible 1x1 conv is an orthogonal matrix (the Q of
a QR).  One ``randn`` call fills every dense leaf and one QR a batch of invconvs of a
size: a few large calls on the card, float32 as served.
"""

from __future__ import annotations

import hashlib

import torch

XAVIER = 0.1  # the init scale of the dense blocks', RRDBs' and FCNs' convs
NOISE_CONV, NOISE_OTHER = 0.1, 0.02  # the perturbation rule


def mix(seed: int, *tags) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed and the stream's tags."""
    text = "/".join(map(str, (seed, *tags))).encode()
    return int.from_bytes(hashlib.sha256(text).digest()[:8], "little") >> 1


def _conv_var(shape, init: str) -> float:
    o, i, kh, kw = shape
    fan_in, fan_out = i * kh * kw, o * kh * kw
    noise = NOISE_CONV ** 2 / fan_in
    if init == "xavier":
        return XAVIER ** 2 * 2.0 / (fan_in + fan_out) + noise
    if init == "default":  # PyTorch's Conv2d: U(+-1 / sqrt(fan_in))
        return 1.0 / (3.0 * fan_in) + noise
    return noise  # zero-initialised


def layout(top) -> tuple:
    """([(name, shape, variance)] of the dense leaves, [(name, channels)] of the
    invconvs) of a model of topology ``top`` (:class:`reference.hcflow.Topology`)."""
    dense, inv = [], []
    other = NOISE_OTHER ** 2

    def conv(p, cout, cin, k, init, bias=True, bias_init=None):
        shape = (cout, cin, k, k)
        dense.append((f"{p}.weight", shape, _conv_var(shape, init)))
        if bias:
            bvar = (1.0 / (3.0 * cin * k * k) + other) if bias_init == "default" else other
            dense.append((f"{p}.bias", (cout,), bvar))

    def actnorm(p, c):
        dense.extend([(f"{p}.bias", (1, c, 1, 1), other), (f"{p}.logs", (1, c, 1, 1), other)])

    def conv_zeros(p, cout, cin):
        conv(p, cout, cin, 3, "zeros")
        dense.append((f"{p}.logs", (cout, 1, 1), other))

    def fcn(p, cin, hid, cout):
        conv(f"{p}.conv1", hid, cin, 3, "xavier", bias=False)
        actnorm(f"{p}.conv1.actnorm", hid)
        conv(f"{p}.conv2", hid, hid, 1, "xavier", bias=False)
        actnorm(f"{p}.conv2.actnorm", hid)
        conv_zeros(f"{p}.conv3", cout, hid)

    def dense_block(p, cin, gc, cout, last="zeros"):
        for k in range(4):
            conv(f"{p}.conv{k + 1}", gc, cin + k * gc, 3, "xavier")
        conv(f"{p}.conv5", cout, cin + 4 * gc, 3, last)

    def step(p, c, cond, kind, nn, hid, permutation, k):
        actnorm(f"{p}.actnorm", c)
        if permutation == "invconv":
            inv.append((f"{p}.permute.weight", c))
        if kind == "Affine3shift":
            cin, cout = (3, 2 * (c - 3)) if k % 2 == 0 else (c - 3, 3)
        else:
            cin, cout = c // 2 + cond, 2 * (c - c // 2)
        if nn == "FCN":
            fcn(f"{p}.affine.f", cin, hid, cout)
        else:
            dense_block(f"{p}.affine.f", cin, hid, cout)

    for i, (c, keep, a, n_main) in enumerate(top.levels):
        first = top.layer_index(i)
        for k in range(n_main):
            step(f"flow.layers.{first + k}", c, 0, top.coupling, top.nn, top.hid,
                 top.permutation, k)
        p = f"flow.level{i}_condFlow"
        conv(f"{p}.conv_first", top.nf, keep + top.cond_ch * (top.L - 1 - i), 3, "default",
             bias_init="default")
        for t in (0, 1):
            for j in range(top.nb[t]):
                for r in (1, 2, 3):
                    dense_block(f"{p}.RRDB_trunk{t}.{j}.RDB{r}", top.nf, top.gc, top.nf,
                                last="xavier")
        conv(f"{p}.trunk_conv1", top.nf, top.nf, 3, "default", bias_init="default")
        conv_zeros(f"{p}.f", 2 * a, top.cond_ch)
        for k in range(top.after[i]):
            step(f"{p}.additional_flow_steps.{k}", a, top.cond_ch, "Affine", "FCN", top.so_hid,
                 top.so_permutation, k)
    return dense, inv


def state_dict(top, seed: int, device) -> dict:
    """The model's weights for ``seed``, drawn on ``device`` in float32."""
    dense, inv = layout(top)
    gen = torch.Generator(device=device).manual_seed(mix(seed, "weights"))
    sizes = [torch.Size(s).numel() for _, s, _ in dense]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    std = torch.tensor([v ** 0.5 for _, _, v in dense], device=device)
    flat.mul_(torch.repeat_interleave(std, torch.tensor(sizes, device=device),
                                      output_size=flat.numel()))
    sd = {name: t.view(shape) for (name, shape, _), t in zip(dense, flat.split(sizes))}
    by_size = {}
    for name, c in inv:
        by_size.setdefault(c, []).append(name)
    for c, names in sorted(by_size.items()):
        g = torch.randn(len(names), c, c, generator=gen, device=device)
        q = torch.linalg.qr(g).Q
        sd.update(zip(names, q.unbind(0)))
    return sd
