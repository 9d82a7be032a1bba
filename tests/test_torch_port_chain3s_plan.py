"""The chain3s kernel's plan and pack, on the CPU (no card, no JAX).

- ``chain3s.plan`` (the bf16 kernel's tiles) at every shape ``chip_smoke.py`` gives the
  kernel (phase 2's batch-16 levels and its ragged border shape, phase 9's serving
  levels, phase 10's validations, phase 12's bands plus halo) and at every growth and
  width the kernel takes: each step parity's shared memory is what the kernel's layout
  gives and fits a block, its tiles cover every output pixel exactly once, and its
  regions are the tile plus the halo a conv reads; widths the kernel does not take are
  refused.
- The pack's weight and bias blobs: each conv read back from the blob in the kernel's
  layout equals the plain version's pack (bf16) or is its TF32 split (float32); conv5's
  outputs in the kernel's order give the plain version's shift and scale; ``check_pack``
  accepts the pack and refuses one of the earlier per-conv layout by name.
"""

import math

import pytest
import torch

import chip_smoke as cs
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.ops import chain3s, nets


def _sp(f):
    rs = cs.SP_RS_HR // cs.SCALE
    return cs._sp_band(rs, f, 8 * 5)


_LV = (cs.SERVE_X4_HR[0] // cs.SCALE, cs.SERVE_X4_HR[1] // cs.SCALE)
_LR4 = cs.TRAIN_VAL_HR[0] // cs.SCALE
# (B, H, W, c) of chip_smoke.py's chain3s rows: the levels L1 (c 24) and L0 (c 12)
SMOKE_SHAPES = [
    (cs.BATCH, cs.LR_HW, cs.LR_HW, 24), (cs.BATCH, 2 * cs.LR_HW, 2 * cs.LR_HW, 12),  # phase 2
    (*cs.CHAIN3S_BORDER, 12),  # phase 2, ragged
    (1, *_LV, 24), (1, 2 * _LV[0], 2 * _LV[1], 12),  # phase 9
    (1, _LR4, _LR4, 24), (1, 2 * _LR4, 2 * _LR4, 12),  # phase 10
    (*_sp(1), 24), (*_sp(2), 12),  # phase 12
]


def _check_plan(B, H, W, c, gc):
    p = chain3s.plan(B, H, W, c, gc)
    assert set(p) == {"even", "odd"}
    for t, (cinp, n5) in zip(("even", "odd"), chain3s.step_widths(c)):
        s = p[t]
        th, tw = s["th"], s["tw"]
        assert (s["cinp"], s["n5"]) == (cinp, n5) and s["smem"] <= chain3s.BLOCK_SMEM == 232448
        assert 8 <= th <= chain3s.MAX_TILE and 8 <= tw <= chain3s.MAX_TILE
        assert s["stages"] in (2, 3)
        assert s["smem"] == chain3s.smem_bytes(th, tw, cinp, gc, n5, s["stages"])
        # the kernel's own check: conv5 in one pass, its staged sums within room
        assert chain3s._runs(th, tw, cinp, gc, n5, s["stages"])
        assert s["regions"] == [(th + 2 * h, tw + 2 * h) for h in (5, 4, 3, 2, 1, 0)]
        assert s["waves"] == math.ceil(s["blocks"] / chain3s.SMS)
        gx, gy, gb = s["grid"]
        assert gb == B and s["blocks"] == gx * gy * B
        # every output pixel in exactly one tile
        cover = torch.zeros(H, W, dtype=torch.int32)
        for by in range(gy):
            for bx in range(gx):
                cover[by * th:(by + 1) * th, bx * tw:(bx + 1) * tw] += 1
        assert bool((cover == 1).all())
        assert (gx - 1) * tw < W and (gy - 1) * th < H  # no tile wholly outside
    return p


@pytest.mark.parametrize("B,H,W,c", SMOKE_SHAPES)
def test_plan_fits_and_covers_at_the_smoke_shapes(B, H, W, c):
    _check_plan(B, H, W, c, 32)


@pytest.mark.parametrize("gc", [16, 32, 64])
@pytest.mark.parametrize("c", [6, 12, 24, 35, 48])
def test_plan_fits_every_width(c, gc):
    """Every width the kernel takes (c - 3 up to 32) has a plan; a wider chain (c 48) is
    refused, as the kernel refuses it."""
    if c - 3 > 32:
        with pytest.raises(ValueError, match="4 to 35 channels"):
            chain3s.plan(2, 37, 53, c, gc)
        return
    _check_plan(2, 37, 53, c, gc)
    _check_plan(cs.BATCH, 2 * cs.LR_HW, 2 * cs.LR_HW, c, gc)


def test_plan_refuses_a_growth_the_kernel_lacks():
    with pytest.raises(ValueError, match="growth of 16, 32 or 64"):
        chain3s.plan(2, 37, 53, 12, 24)


def test_launches_per_chain():
    """One launch a step in bf16, one a chain in float32."""
    assert [chain3s.launches_per_chain(K) for K in (1, 4, 8)] == [1, 4, 8]
    assert [chain3s.launches_per_chain(K, f32=True) for K in (1, 4, 8)] == [1, 1, 1]


def test_plan_fills_the_card_at_batch_16():
    """The bf16 plans of phase 2's two levels: one wave of 128 blocks at 40x40, two of
    256 at 80x80 (132 SMs), tiles larger than the shared tile conv's 16 x 8 / 16 x 16."""
    p1 = chain3s.plan(16, 40, 40, 24, 32)
    p0 = chain3s.plan(16, 80, 80, 12, 32)
    assert [p1[t]["blocks"] for t in ("even", "odd")] == [128, 128]
    assert [p0[t]["blocks"] for t in ("even", "odd")] == [256, 256]
    for p, tile in ((p1, 16 * 8), (p0, 16 * 16)):
        assert p["even"]["th"] * p["even"]["tw"] > tile


def _steps(c, K, cd, seed=5, gc=32):
    specs = [FlowStepSpec(in_channels=c, hidden_channels=gc, compute_dtype=cd,
                          flow_permutation="none", flow_coupling="Affine3shift",
                          nn_module="DenseBlock", lr_vs_others=(k % 2 == 0)) for k in range(K)]
    g = torch.Generator().manual_seed(seed)
    steps = [s.init(g) for s in specs]
    for p in steps:  # break the zero init of the last conv
        for conv in p["coupling"]["f"].values():
            conv["w"] = conv["w"] + 0.05 * torch.randn(conv["w"].shape, generator=g)
            conv["b"] = conv["b"] + 0.05 * torch.randn(conv["b"].shape, generator=g)
    return steps


def _blob_convs(packed, K, c, gc, f32):
    """Every step's five convs read back from the blobs in the kernel's layout, as (9,
    cin, n) float32 [tap][ci][co] (float32: hi + lo of the TF32 planes) and their biases."""
    out, wo, bo = [], 0, 0
    for k in range(K):
        cinp, n5 = chain3s.step_widths(c)[k % 2]
        convs = []
        for i in range(5):
            cin, n = cinp + i * gc, (gc if i < 4 else n5)
            size = (2 if f32 else 1) * 9 * cin * n
            w = packed["blob_w"][wo:wo + size]
            if f32:
                hi, lo = w.view(2, 9, cin // 4, n, 4).transpose(3, 4).reshape(2, 9, cin, n)
                w = hi + lo
            convs.append((w.view(9, cin, n).float(), packed["blob_b"][bo:bo + n]))
            wo, bo = wo + size, bo + n
        out.append(convs)
    assert wo == packed["blob_w"].numel() and bo == packed["blob_b"].numel()
    return out


# every growth the kernels take, and c - 3 from 3 to 32 (the widest conv5 the kernels
# take, 64) and past it
@pytest.mark.parametrize("gc", [16, 32, 64])
@pytest.mark.parametrize("cd", ["bfloat16", None])
@pytest.mark.parametrize("c,K", [(12, 4), (24, 3), (6, 2), (35, 2), (48, 2)])
def test_blob_holds_the_plain_packs_convs_in_the_kernels_order(cd, c, K, gc):
    steps = _steps(c, K, cd, gc=gc)
    packed = chain3s.pack_inverse_chain3s(steps, cd)
    f32 = cd is None
    if c - 3 > 32:  # the kernels' conv5 is at most 64 wide
        with pytest.raises(ValueError, match="4 to 35 channels"):
            chain3s.check_pack(packed)
    else:
        assert chain3s.check_pack(packed) == (nets.net_dtype(cd), gc)
    c2 = c - 3
    for k, convs in enumerate(_blob_convs(packed, K, c, gc, f32)):
        tag, idx = "eo"[k % 2], k // 2
        for i, (w, b) in enumerate(convs):
            ref = nets.taps(packed[f"w{tag}{i + 1}"][idx]).float()
            bref = packed[f"b{tag}{i + 1}"][idx]
            if i == 4:  # conv5: the kernel's order of the plain pack's [shift | scale]
                order = chain3s._conv5_order(c2, k % 2 == 0)
                ref = torch.stack([ref[:, :, r] if r >= 0 else torch.zeros_like(ref[:, :, 0])
                                   for r in order], -1)
                bref = torch.stack([bref[r] if r >= 0 else bref.new_zeros(()) for r in order])
            if f32:  # hi + lo within 2^-21 of each weight
                assert (w - ref).abs().max() <= 2.0 ** -21 * ref.abs().max()
            else:
                assert torch.equal(w, ref)
            assert torch.equal(b, bref)


@pytest.mark.parametrize("c", [12, 24])
def test_conv5_order_puts_shift_and_scale_in_one_fragment(c):
    """In the kernel's conv5 order, accumulator column 8 (2 pr) + 2q + e holds shift j and
    column 8 (2 pr + 1) + 2q + e scale j, j = 8 pr + 2q + e (mma's fragment: a thread holds
    columns 2q, 2q + 1 of each n8 tile), for every j < c - 3; the rest are zero rows."""
    c2 = c - 3
    order = chain3s._conv5_order(c2, True)
    assert len(order) == chain3s.step_widths(c)[0][1] and len(order) % 16 == 0
    for pr in range(len(order) // 16):
        for q in range(4):
            for e in range(2):
                j = 8 * pr + 2 * q + e
                shift, scale = order[16 * pr + 2 * q + e], order[16 * pr + 8 + 2 * q + e]
                assert (shift, scale) == ((j, c2 + j) if j < c2 else (-1, -1))
    assert chain3s._conv5_order(c2, False) == [0, 1, 2] + [-1] * 13


def test_check_pack_refuses_an_earlier_layout_by_name():
    steps = _steps(12, 4, None)
    packed = chain3s.pack_inverse_chain3s(steps)
    old = {k: v for k, v in packed.items() if k not in ("blob_w", "blob_b")}
    for t in "eo":  # the per-conv TF32 planes the earlier kernel read
        for i in range(1, 6):
            old[f"t{t}{i}"] = nets.pack_tf32(torch.zeros(16, 16, 3, 3))
    with pytest.raises(ValueError, match="weight and bias blobs.*earlier layout"):
        chain3s.check_pack(old)
    short = dict(packed, blob_w=packed["blob_w"][:-1])
    with pytest.raises(ValueError, match="blobs must hold"):
        chain3s.check_pack(short)
    bf = chain3s.pack_inverse_chain3s(steps, "bfloat16")
    with pytest.raises(ValueError, match="blobs must hold"):
        chain3s.check_pack(dict(bf, blob_w=packed["blob_w"]))
    assert chain3s.check_pack(bf) == (torch.bfloat16, 32)
