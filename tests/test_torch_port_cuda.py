"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (a CUDA
kernel has no CPU mode; tests/test_torch_port_kernels.py holds the plain versions
against JAX on the CPU).  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_port_cuda.py

Tolerance: kernel and plain version take the same bf16 operands and sum in float32
in another order, so a feature rounded to bf16 can land one bf16 step (2^-8
relative) apart and carry on, damped; 1e-3 of the output's largest magnitude.
"""

import numpy as np
import pytest
import torch

from hcflow_tpu_torch.flow import stack
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.ops import chain, chain3s, conv, nets, rrdb

RTOL = 1e-3

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _perturb(tree, gen):
    if isinstance(tree, dict):
        return {k: _perturb(v, gen) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_perturb(v, gen) for v in tree]
    tree = tree.cuda()
    if not tree.is_floating_point():  # a permutation's indices
        return tree
    std = 0.1 / tree[0].numel() ** 0.5 if tree.ndim == 4 else 0.02
    return tree + std * torch.randn(tree.shape, device="cuda", generator=gen)


def _close(got, ref):
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= RTOL * ref.abs().max().item()


# SR encoders (64/32); rescaling encoders (64/16); a narrower trunk (32/16)
WIDTHS = [(64, 32), (64, 16), (32, 16)]
# The tile is 16 rows by 16 columns where W rounds up to 16 no further than to 8, else
# by 8: exact 16x16 tiles; 8-wide tiles ragged in H and W; 16-wide tiles ragged in H
# and W; 20x20 (the x8 model's smallest level), whose 12 tiles leave most SMs idle.
SHAPES = [(2, 8, 16), (3, 13, 21), (3, 21, 13), (2, 20, 20)]


@pytest.mark.parametrize("nf,gc", WIDTHS)
@pytest.mark.parametrize("B,H,W", SHAPES)
def test_rrdb_kernel_matches_plain(gen, B, H, W, nf, gc):
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(1), 1, nf, gc), gen)
    packed = rrdb.pack_rrdb(trunk[0], "bfloat16")
    x = torch.randn(B, H, W, nf, device="cuda", generator=gen)
    before = sum(rrdb.launches_by.values())
    got = rrdb.rrdb_apply(packed, x)
    torch.cuda.synchronize()
    assert sum(rrdb.launches_by.values()) == before + rrdb.LAUNCHES_PER_RRDB
    _close(got, rrdb.rrdb_apply_plain(packed, x))


@pytest.mark.parametrize("nf,gc", WIDTHS)
@pytest.mark.parametrize("B,H,W", SHAPES)
def test_rrdb_trunk_kernel_equals_per_rrdb_kernel(gen, B, H, W, nf, gc):
    """The resident-trunk kernel (one cooperative launch for nb 2) is bit-identical to
    the per-RRDB kernel run twice: the same tile conv, tiles, chunks and epilogue order."""
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(4), 2, nf, gc), gen)
    res = rrdb.pack_rrdb_trunk(trunk, "bfloat16", resident=True)
    x = torch.randn(B, H, W, nf, device="cuda", generator=gen)
    x0 = x.clone()
    before = sum(rrdb.trunk_launches_by.values())
    got = rrdb.trunk_apply(res, x)
    torch.cuda.synchronize()
    assert sum(rrdb.trunk_launches_by.values()) == before + 1
    assert torch.equal(x, x0)  # the input is not written
    assert torch.equal(got, rrdb.trunk_apply(rrdb.pack_rrdb_trunk(trunk, "bfloat16"), x))
    _close(got, rrdb.trunk_apply_resident_plain(res, x))


@pytest.mark.parametrize("C,N,bias,relu", [(20, 100, True, True), (3, 64, False, False),
                                           (64, 24, True, False), (140, 48, False, True),
                                           (24, 16, True, True)])
def test_conv3x3_kernel_matches_plain(gen, C, N, bias, relu):
    """Ragged C and N (padded to multiples of 16, N in chunks of at most 64; C 24 a
    multiple of 8 whose last chunk is half padding) and ragged tiles."""
    x = torch.randn(2, 13, 21, C, device="cuda", generator=gen)
    w = 0.1 * torch.randn(3, 3, C, N, device="cuda", generator=gen)
    b = 0.1 * torch.randn(N, device="cuda", generator=gen) if bias else None
    before = conv.launches
    got = conv.conv3x3(x, w, b, relu=relu)
    torch.cuda.synchronize()
    assert conv.launches == before + 1 + (N + 63) // 64
    assert got.shape == (2, 13, 21, N) and got.dtype == torch.float32
    _close(got, conv.conv3x3_plain(x, w, b, relu=relu))


# the x4 level widths (c 21 and 6 ragged against the tiles), the x8 level-2 widths at
# 20x20 (one cond, one plain) and one chain of the main paths' 13 steps
@pytest.mark.parametrize("cond,c,K,H,W", [(True, 21, 3, 10, 12), (True, 6, 3, 9, 17),
                                          (False, 24, 3, 10, 12), (False, 12, 3, 9, 17),
                                          (True, 45, 3, 20, 20), (False, 48, 3, 20, 20),
                                          (True, 6, 3, 21, 37), (True, 12, 13, 40, 40)])
def test_chain_kernel_matches_plain(gen, cond, c, K, H, W):
    spec = FlowStepSpec(in_channels=c, cond_channels=128 if cond else None,
                        hidden_channels=64, compute_dtype="bfloat16")
    steps = stack.init_stack(spec, torch.Generator().manual_seed(2), K)
    steps = stack.precompute_invconv(_perturb(steps, gen))
    packed = chain.pack_inverse_chain(steps, "bfloat16", padded=True)
    z = torch.randn(2, H, W, c, device="cuda", generator=gen)
    uc = None
    if cond:
        u = torch.randn(2, H, W, 128, device="cuda", generator=gen)
        uc = stack.compute_u_contribs(spec, steps, u).to(torch.bfloat16).contiguous()
    before = sum(chain.launches_by.values())
    got = chain.inverse_chain(packed, z, uc)
    torch.cuda.synchronize()
    assert sum(chain.launches_by.values()) == before + K
    _close(got, chain.inverse_chain_plain(packed, z, uc))


@pytest.mark.parametrize("c,hw", [(21, 40), (6, 80), (24, 40), (12, 80), (45, 20), (12, 40),
                                  (48, 20)])  # every chain shape of the main paths
def test_chain_tiles_cover_the_card(gen, c, hw):
    """At batch 16 each step's grid covers every SM with two blocks fitting an SM."""
    p = chain.plan(16, hw, hw, c)
    assert p["blocks"] >= torch.cuda.get_device_properties(0).multi_processor_count
    assert p["blocks_per_sm"] >= 2


# both level widths; a border shape, H and W multiples of neither the tiles nor 8; and
# every step instance the library holds: growth 16, 32, 64 by conv5 16 (c 6), 32 (c 12),
# 48 (c 24) and 64 (c 35) wide on the even steps (the odd steps' conv5 is 16 wide)
@pytest.mark.parametrize("c,K,H,W,gc", [(12, 4, 10, 12, 32), (24, 3, 9, 17, 32),
                                        (12, 4, 37, 53, 32)]
                         + [(c, 2, 13, 21, gc) for gc in (16, 32, 64) for c in (6, 12, 24, 35)])
def test_chain3s_kernel_matches_plain(gen, c, K, H, W, gc):
    specs = [FlowStepSpec(in_channels=c, hidden_channels=gc, compute_dtype="bfloat16",
                          flow_permutation="none", flow_coupling="Affine3shift",
                          nn_module="DenseBlock", lr_vs_others=(k % 2 == 0)) for k in range(K)]
    steps = _perturb([s.init(torch.Generator().manual_seed(3 + k)) for k, s in enumerate(specs)],
                     gen)
    packed = chain3s.pack_inverse_chain3s(steps, "bfloat16")
    z = torch.randn(2, H, W, c, device="cuda", generator=gen)
    before = sum(chain3s.launches_by.values())
    got, ld = chain3s.inverse_chain(packed, z)
    torch.cuda.synchronize()
    assert sum(chain3s.launches_by.values()) == before + chain3s.launches_per_chain(K)
    ref, ld_ref = chain3s.inverse_chain3s_plain(packed, z)
    _close(got, ref)
    assert torch.equal(ld, ld_ref)


# The chain kernel at both coupling widths it takes and in both recipes: bf16 (tensor
# cores) against the 1e-3 tolerance above; float32 (CUDA-core fmaf, no TF32) against
# 1e-5 of the output's largest magnitude, the same float32 arithmetic summed in
# another order.  Ragged shapes: c 21 and 6 against the tiles, c 45 / 48 at 20x20.
F32_RTOL = 1e-5


@pytest.mark.parametrize("cd", ["bfloat16", None])
@pytest.mark.parametrize("hid", [32, 64])
@pytest.mark.parametrize("cond,c,K,H,W", [(True, 21, 3, 10, 12), (False, 12, 3, 9, 17),
                                          (True, 45, 2, 20, 20), (False, 6, 2, 21, 37)])
def test_chain_kernel_widths_and_recipes(gen, cd, hid, cond, c, K, H, W):
    spec = FlowStepSpec(in_channels=c, cond_channels=128 if cond else None,
                        hidden_channels=hid, compute_dtype=cd)
    steps = stack.init_stack(spec, torch.Generator().manual_seed(5), K)
    steps = stack.precompute_invconv(_perturb(steps, gen))
    packed = chain.pack_inverse_chain(steps, cd, padded=True)
    z = torch.randn(2, H, W, c, device="cuda", generator=gen)
    uc = None
    if cond:
        u = torch.randn(2, H, W, 128, device="cuda", generator=gen)
        uc = stack.compute_u_contribs(spec, steps, u).to(packed["w1"].dtype).contiguous()
    before = sum(chain.launches_by.values())
    got = chain.inverse_chain(packed, z, uc)
    torch.cuda.synchronize()
    assert sum(chain.launches_by.values()) == before + K
    ref = chain.inverse_chain_plain(packed, z, uc)
    assert torch.isfinite(got).all()
    tol = RTOL if cd else F32_RTOL
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    p = chain.plan(2, H, W, c, hid=hid, f32=cd is None)
    assert p["blocks"] >= 1 and p["blocks_per_sm"] >= 1


# The float32 recipe's RRDB, resident-trunk and chain3s kernels (3xTF32 products on
# tensor cores) against their plain versions (float32, TF32 off): an error of float32's
# order, ~2^-21 relative a product, summed over the 15 convs of an RRDB: 1e-5 of the
# output's largest magnitude, as the float32 chain kernel.  Odd widths, gc 16 and nf 32.
@pytest.mark.parametrize("nf,gc", WIDTHS)
@pytest.mark.parametrize("B,H,W", SHAPES)
def test_rrdb_kernel_f32_matches_plain(gen, B, H, W, nf, gc):
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(1), 1, nf, gc), gen)
    packed = rrdb.pack_rrdb(trunk[0])
    assert packed["w"][0].dtype == torch.float32
    x = torch.randn(B, H, W, nf, device="cuda", generator=gen)
    before = rrdb.launches_by.get("f32", 0)
    got = rrdb.rrdb_apply(packed, x)
    torch.cuda.synchronize()
    assert rrdb.launches_by["f32"] == before + rrdb.LAUNCHES_PER_RRDB
    ref = rrdb.rrdb_apply_plain(packed, x)
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= F32_RTOL * ref.abs().max().item()


@pytest.mark.parametrize("nf,gc", WIDTHS)
@pytest.mark.parametrize("B,H,W", [(2, 8, 16), (3, 13, 21), (2, 20, 20), (1, 80, 80)])
def test_rrdb_trunk_kernel_f32_equals_per_rrdb_kernel(gen, B, H, W, nf, gc):
    """The float32 resident trunk is bit-identical to the float32 per-RRDB kernel, also
    at 80x80 (16-wide tiles, the x8 model's largest level)."""
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(4), 2, nf, gc), gen)
    res = rrdb.pack_rrdb_trunk(trunk, None, resident=True)
    x = torch.randn(B, H, W, nf, device="cuda", generator=gen)
    before = rrdb.trunk_launches_by.get("f32", 0)
    got = rrdb.trunk_apply(res, x)
    torch.cuda.synchronize()
    assert rrdb.trunk_launches_by["f32"] == before + 1
    assert torch.equal(got, rrdb.trunk_apply(rrdb.pack_rrdb_trunk(trunk, None), x))
    ref = rrdb.trunk_apply_resident_plain(res, x)
    assert (got - ref).abs().max().item() <= F32_RTOL * ref.abs().max().item()


# conv5 of width 16 (c 6, and the odd steps), 32 (c 12), 48 (c 24) and 64 (c 35), on 8-
# and 16-wide tiles, ragged in H and W, at growth 16, 32 and 64 (every kernel instance);
# the border shape as in the bf16 test
@pytest.mark.parametrize("c,K,H,W,gc", [(12, 4, 10, 12, 32), (24, 3, 9, 17, 32), (6, 2, 21, 37, 32),
                                        (24, 2, 20, 20, 32), (24, 2, 9, 32, 32),
                                        (12, 4, 37, 53, 32), (6, 2, 21, 37, 16),
                                        (35, 2, 20, 20, 16), (35, 3, 9, 17, 64),
                                        (12, 2, 9, 32, 64)])
def test_chain3s_kernel_f32_matches_plain(gen, c, K, H, W, gc):
    specs = [FlowStepSpec(in_channels=c, hidden_channels=gc, flow_permutation="none",
                          flow_coupling="Affine3shift", nn_module="DenseBlock",
                          lr_vs_others=(k % 2 == 0)) for k in range(K)]
    steps = _perturb([s.init(torch.Generator().manual_seed(3 + k)) for k, s in enumerate(specs)],
                     gen)
    packed = chain3s.pack_inverse_chain3s(steps)
    z = torch.randn(2, H, W, c, device="cuda", generator=gen)
    before = chain3s.launches_by.get("f32", 0)
    got, ld = chain3s.inverse_chain(packed, z)
    torch.cuda.synchronize()
    assert chain3s.launches_by["f32"] == before + chain3s.launches_per_chain(K, f32=True)
    ref, ld_ref = chain3s.inverse_chain3s_plain(packed, z)
    assert (got - ref).abs().max().item() <= F32_RTOL * ref.abs().max().item()
    assert torch.equal(ld, ld_ref)


def test_float32_packs_without_tf32_planes_raise(gen):
    """The float32 kernels read the weights' TF32 planes (chain3s's in its weight blob): a
    float32 pack without them raises before any launch, and launches nothing."""
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(9), 2, 32, 16), gen)
    x = torch.randn(1, 8, 8, 32, device="cuda", generator=gen)
    before = dict(rrdb.launches_by), dict(rrdb.trunk_launches_by), dict(chain3s.launches_by)
    for pk, fn in ((rrdb.pack_rrdb(trunk[0]), rrdb.rrdb_apply),
                   (rrdb.pack_rrdb_trunk(trunk, resident=True), rrdb.trunk_apply)):
        del pk["tf32"]
        with pytest.raises(ValueError, match="TF32 planes"):
            fn(pk, x)
    specs = [FlowStepSpec(in_channels=12, hidden_channels=32, flow_permutation="none",
                          flow_coupling="Affine3shift", nn_module="DenseBlock",
                          lr_vs_others=(k % 2 == 0)) for k in range(2)]
    pk = chain3s.pack_inverse_chain3s(
        _perturb([s.init(torch.Generator().manual_seed(8)) for s in specs], gen))
    del pk["blob_w"]  # the blob of the weights' TF32 planes
    with pytest.raises(ValueError, match="weight and bias blobs"):
        chain3s.inverse_chain(pk, torch.randn(1, 8, 8, 12, device="cuda", generator=gen))
    assert (rrdb.launches_by, rrdb.trunk_launches_by, chain3s.launches_by) == before


def test_mixed_dtype_packs_raise(gen):
    """The RRDB, trunk and chain3s kernels take bf16 or float32 packs, all of one
    dtype: a pack that mixes them raises before any launch."""
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(9), 2, 32, 16), gen)
    x = torch.randn(1, 8, 8, 32, device="cuda", generator=gen)
    packed = rrdb.pack_rrdb(trunk[0])
    packed["w"][3] = packed["w"][3].to(torch.bfloat16)
    with pytest.raises(ValueError, match="all of one dtype"):
        rrdb.rrdb_apply(packed, x)
    res = rrdb.pack_rrdb_trunk(trunk, "bfloat16", resident=True)
    res["w"][4] = res["w"][4].float()
    with pytest.raises(ValueError, match="all of one dtype"):
        rrdb.trunk_apply(res, x)
    specs = [FlowStepSpec(in_channels=12, hidden_channels=32, flow_permutation="none",
                          flow_coupling="Affine3shift", nn_module="DenseBlock",
                          lr_vs_others=(k % 2 == 0)) for k in range(2)]
    pk = chain3s.pack_inverse_chain3s(
        _perturb([s.init(torch.Generator().manual_seed(8)) for s in specs], gen))
    pk["wo2"] = pk["wo2"].to(torch.bfloat16)
    with pytest.raises(ValueError, match="all of one dtype"):
        chain3s.inverse_chain(pk, torch.randn(1, 8, 8, 12, device="cuda", generator=gen))


def test_kernel_wrappers_refuse_autograd(gen):
    """No kernel has a backward pass: each wrapper raises under grad mode when an
    input requires grad, and runs under torch.no_grad()."""
    spec = FlowStepSpec(in_channels=12, hidden_channels=64, compute_dtype="bfloat16")
    steps = stack.precompute_invconv(_perturb(stack.init_stack(
        spec, torch.Generator().manual_seed(6), 2), gen))
    packed = chain.pack_inverse_chain(steps, "bfloat16", padded=True)
    z = torch.randn(1, 8, 8, 12, device="cuda", generator=gen, requires_grad=True)
    with pytest.raises(ValueError, match="no backward pass"):
        chain.inverse_chain(packed, z)
    with torch.no_grad():
        chain.inverse_chain(packed, z)
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(7), 1, 32, 16), gen)
    x = torch.randn(1, 8, 8, 32, device="cuda", generator=gen, requires_grad=True)
    for pk in (rrdb.pack_rrdb_trunk(trunk, "bfloat16"),
               rrdb.pack_rrdb_trunk(trunk, "bfloat16", resident=True)):
        with pytest.raises(ValueError, match="no backward pass"):
            rrdb.trunk_apply(pk, x)
    specs = [FlowStepSpec(in_channels=12, hidden_channels=32, compute_dtype="bfloat16",
                          flow_permutation="none", flow_coupling="Affine3shift",
                          nn_module="DenseBlock", lr_vs_others=(k % 2 == 0)) for k in range(2)]
    pk3 = chain3s.pack_inverse_chain3s(
        _perturb([s.init(torch.Generator().manual_seed(8)) for s in specs], gen), "bfloat16")
    with pytest.raises(ValueError, match="no backward pass"):
        chain3s.inverse_chain(pk3, z)


# ------------------------------------------------- serving whole models on the card
def _tiny_spec(cd, encoder_dtype=None, **kw):
    """The topology of the tiny trained checkpoint (weights/ref_trained), with the
    changes kw makes."""
    from hcflow_tpu_torch.models import HCFlowSRSpec

    from _torch_port_util import TINY_CKPT

    return HCFlowSRSpec.for_scale(4, compute_dtype=cd, encoder_dtype=encoder_dtype,
                                  **dict(TINY_CKPT, **kw))


# (compute_dtype, encoder_dtype): the bf16 serving recipe, the shipped training recipe
# (bf16 encoders, float32 couplings) and the float32 recipe
RECIPES = [("bfloat16", None), (None, "bfloat16"), (None, None)]


@pytest.mark.parametrize("cd,ed", RECIPES)
def test_precompute_inference_packs_what_the_kernels_take(gen, cd, ed):
    """Chains packed in the coupling dtype, trunks in the encoder dtype (bf16 or
    float32); the fused reverse runs with the counted launches."""
    model = _tiny_spec(cd, ed)
    params = model.init(0, device="cuda")
    pp = model.flow.precompute_inference(params, fused=True)
    chain_dtype = torch.bfloat16 if cd else torch.float32
    for lv in range(2):
        assert pp[f"level{lv}"]["main_fused"]["w1"].dtype == chain_dtype
        assert pp[f"level{lv}"]["cond"]["steps_fused"]["w1"].dtype == chain_dtype
        trunk_dtype = torch.bfloat16 if "bfloat16" in (cd, ed) else torch.float32
        assert pp[f"level{lv}"]["cond"]["trunk0_fused"][0]["w"][0].dtype == trunk_dtype
    lr = torch.rand(2, 6, 7, 3, device="cuda", generator=gen)
    chain.launches_by.clear()
    rrdb.launches_by.clear()
    out = model.reverse(pp, lr, 0.9, generator=torch.Generator(device="cuda").manual_seed(1))
    torch.cuda.synchronize()
    assert out.shape == (2, 24, 28, 3) and torch.isfinite(out).all()
    assert sum(chain.launches_by.values()) == 4 * 4
    assert sum(rrdb.launches_by.values()) == 4 * rrdb.LAUNCHES_PER_RRDB * 2


@pytest.mark.parametrize("cd", ["bfloat16", None])
@pytest.mark.parametrize("gc", [8, 24])
def test_trunks_at_other_widths_serve_padded(gen, cd, gc):
    """A model whose gc passes JAX's gate but is not a width the RRDB kernels hold an
    instance for (8, 24) packs its trunks padded to gc 16 or 32: the fused reverse runs
    the RRDB kernel on them and the chain kernel, and matches the plain one."""
    model = _tiny_spec(cd, rrdb_gc=gc)
    params = _perturb(model.init(0, device="cuda"), gen)
    fused = model.flow.precompute_inference(params, fused=True)
    plain = model.flow.precompute_inference(params)
    for lv in range(2):
        packs = fused[f"level{lv}"]["cond"]["trunk0_fused"]
        assert nets.taps_shape(packs[0]["w"][0])[-1] == {8: 16, 24: 32}[gc]
    lr = torch.rand(2, 6, 7, 3, device="cuda", generator=gen)
    eps = [torch.randn(2, 12, 14, 6, device="cuda", generator=gen),
           torch.randn(2, 6, 7, 21, device="cuda", generator=gen)]
    chain.launches_by.clear()
    rrdb.launches_by.clear()
    with torch.no_grad():
        got = model.flow.reverse_flow(fused, lr, 0.9, eps_list=eps)
        torch.cuda.synchronize()
        assert sum(chain.launches_by.values()) == 4 * 4
        assert rrdb.launches_by == {"bf16" if cd else "f32": 4 * rrdb.LAUNCHES_PER_RRDB * 2}
        ref = model.flow.reverse_flow(plain, lr, 0.9, eps_list=eps)
    assert torch.isfinite(got).all()
    d = (got - ref).abs()
    if cd is None:
        assert d.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert d.max().item() <= 5e-2 * ref.abs().max().item()
        assert d.mean().item() <= 1e-2 * ref.abs().mean().item()


# ---------------------------------- padded packs: widths with no kernel instance of their own
# A chain at coupling width 8, 12, 24 or 48 runs the kernel at 32 or 64, chain3s at growth
# 8, 24 or 48 at 16, 32 or 64, an RRDB trunk at (24, 8), (32, 24), (48, 40) or (64, 8) at
# (32, 16), (32, 32), (64, 64) or (64, 16): zero weights and biases on the padded
# channels, which stay 0.  Each kernel against its plain version on the same padded pack,
# at the limits above.
@pytest.mark.parametrize("cd", ["bfloat16", None])
@pytest.mark.parametrize("hid", [8, 12, 24, 48])
@pytest.mark.parametrize("cond,c", [(True, 21), (False, 12)])
def test_padded_chain_kernel_matches_plain(gen, cd, hid, cond, c):
    K, H, W = 3, 10, 12
    spec = FlowStepSpec(in_channels=c, cond_channels=128 if cond else None,
                        hidden_channels=hid, compute_dtype=cd)
    steps = stack.init_stack(spec, torch.Generator().manual_seed(5), K)
    steps = stack.precompute_invconv(_perturb(steps, gen))
    packed = chain.pack_inverse_chain(steps, cd, padded=True)
    hp = chain.padded_hid(hid)
    assert packed["w2"].shape[1:] == (hp, hp) and chain.takes(c, hp)
    z = torch.randn(2, H, W, c, device="cuda", generator=gen)
    uc = None
    if cond:
        u = torch.randn(2, H, W, 128, device="cuda", generator=gen)
        uc = chain.pad_uc(packed, stack.compute_u_contribs(spec, steps, u))
        assert uc.shape[-1] == K * hp and not uc.reshape(2, H, W, K, hp)[..., hid:].any()
    key = f"{'bf16' if cd else 'f32'} hid {hp}"
    before = chain.launches_by.get(key, 0)
    got = chain.inverse_chain(packed, z, uc)
    torch.cuda.synchronize()
    assert chain.launches_by[key] == before + K
    ref = chain.inverse_chain_plain(packed, z, uc)
    assert torch.isfinite(got).all()
    tol = RTOL if cd else F32_RTOL
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize("cd", ["bfloat16", None])
@pytest.mark.parametrize("gc", [8, 24, 48])
@pytest.mark.parametrize("c,K,H,W", [(12, 4, 10, 12), (24, 3, 9, 17)])
def test_padded_chain3s_kernel_matches_plain(gen, cd, gc, c, K, H, W):
    specs = [FlowStepSpec(in_channels=c, hidden_channels=gc, compute_dtype=cd,
                          flow_permutation="none", flow_coupling="Affine3shift",
                          nn_module="DenseBlock", lr_vs_others=(k % 2 == 0)) for k in range(K)]
    steps = _perturb([s.init(torch.Generator().manual_seed(3 + k)) for k, s in enumerate(specs)],
                     gen)
    packed = chain3s.pack_inverse_chain3s(steps, cd)
    assert chain3s.check_pack(packed)[1] == chain3s.padded_growth(gc) > gc
    z = torch.randn(2, H, W, c, device="cuda", generator=gen)
    key = "bf16" if cd else "f32"
    before = chain3s.launches_by.get(key, 0)
    got, ld = chain3s.inverse_chain(packed, z)
    torch.cuda.synchronize()
    assert chain3s.launches_by[key] == before + chain3s.launches_per_chain(K, f32=cd is None)
    ref, ld_ref = chain3s.inverse_chain3s_plain(packed, z)
    tol = RTOL if cd else F32_RTOL
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()
    assert torch.equal(ld, ld_ref)


@pytest.mark.parametrize("cd", ["bfloat16", None])
@pytest.mark.parametrize("nf,gc", [(24, 8), (32, 24), (48, 40), (64, 8)])
def test_padded_trunk_kernels_match_plain(gen, cd, nf, gc):
    """The per-RRDB and resident-trunk kernels on padded packs (nb 2) through trunk_apply:
    bit-identical to each other, against the plain version on the padded input, and the
    padded channels exactly 0 at the trunk's end."""
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(4), 2, nf, gc), gen)
    per = rrdb.pack_rrdb_trunk(trunk, cd)
    res = rrdb.pack_rrdb_trunk(trunk, cd, resident=True)
    nfp, gcp = rrdb.padded_widths(nf, gc)
    x = torch.randn(2, 13, 21, nf, device="cuda", generator=gen)
    key = "bf16" if cd else "f32"
    before = rrdb.launches_by.get(key, 0), rrdb.trunk_launches_by.get(key, 0)
    got = rrdb.trunk_apply(per, x)
    got_res = rrdb.trunk_apply(res, x)
    torch.cuda.synchronize()
    assert (rrdb.launches_by[key], rrdb.trunk_launches_by[key]) == (
        before[0] + 2 * rrdb.LAUNCHES_PER_RRDB, before[1] + 1)
    assert got.shape == x.shape and torch.equal(got, got_res)
    xp = torch.nn.functional.pad(x, (0, nfp - nf))
    wide = rrdb.trunk_apply_resident(res, xp)
    assert not wide[..., nf:].any()  # the padded channels stay 0
    ref = xp
    for p in per:
        ref = rrdb.rrdb_apply_plain(p, ref)
    ref = ref[..., :nf]
    tol = RTOL if cd else F32_RTOL
    assert (got - ref).abs().max().item() <= tol * ref.abs().max().item()


def _width_model(name, cd):
    """The models the CPU tests (tests/test_torch_port_widths.py) hold against JAX, in the
    recipe cd: configs/smoke_train.yml's (coupling width 8, RRDB gc 4), x4 rescaling at
    growth 24 and x4 SR at coupling width 48 (each with split-off chains and trunks at
    padded widths too), and a 3-level rescaling model whose level 2 (c 48) chain3s does
    not take."""
    import dataclasses
    from pathlib import Path

    from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
    from hcflow_tpu_torch.utils import config

    if name == "smoke":
        opt = Path(__file__).resolve().parents[1] / "configs/smoke_train.yml"
        model = config.model_spec_from_opt(config.load_yaml(str(opt)))
        return dataclasses.replace(model, flow=dataclasses.replace(model.flow, compute_dtype=cd))
    kw = dict(K=(4, 4), after_splitoff=(2, 2), rrdb_nb=(1, 1), compute_dtype=cd)
    if name == "rescaling24":
        return HCFlowRescalingSpec.default_x4(hidden_channels=24, so_hidden_channels=24,
                                              rrdb_nf=24, rrdb_gc=8, **kw)
    if name == "sr48":
        return HCFlowSRSpec.for_scale(4, hidden_channels=48, so_hidden_channels=48, rrdb_nf=24,
                                      rrdb_gc=24, **kw)
    return HCFlowRescalingSpec.default_x4(L=3, K=(4, 4, 4), after_splitoff=(2, 2, 2),
                                          rrdb_nb=(1, 1, 1), compute_dtype=cd)


def _expected_launches(model) -> dict:
    """A reverse's kernel launches, counted from the model's structure and its packs on
    the card: per level K of a packed chain's steps, chain3s's launches of a main chain,
    16 of each RRDB of a packed trunk."""
    f32 = model.flow.compute_dtype is None
    want = {"chain": 0, "chain3s": 0, "rrdb": 0}
    for lv, names in zip(model.flow.levels, model.flow.kernel_packs("cuda").values()):
        want["chain"] += (lv.n_main if "main_fused" in names else 0) + (
            lv.cond_spec.n_flow_step if "steps_fused" in names else 0)
        want["chain3s"] += (chain3s.launches_per_chain(lv.n_main, f32)
                            if "main3s_fused" in names else 0)
        nb = lv.cond_spec.rrdb_nb  # trunk0's and trunk1's RRDBs
        want["rrdb"] += (nb[0] + nb[1]) * rrdb.LAUNCHES_PER_RRDB if "trunk0_fused" in names else 0
    return want


@pytest.mark.parametrize("cd", ["bfloat16", None])
@pytest.mark.parametrize("name", ["smoke", "rescaling24", "sr48", "rescaling_l3"])
def test_models_at_padded_widths_serve_through_the_kernels(gen, name, cd):
    """Each model's fused reverse on the card runs every chain and trunk the JAX package
    packs through a kernel at padded widths (before, the chain kernels raised on the
    smoke config's coupling width 8 and on a growth of 24), with exact launch counts,
    and matches the plain reverse; the 3-level model's level-2 chain (c 48) serves on
    the plain step loop, with no chain3s launch."""
    model = _width_model(name, cd)
    params = _perturb(model.init(0, device="cuda"), gen)
    fused = model.flow.precompute_inference(params, fused=True)
    plain = model.flow.precompute_inference(params)
    want = _expected_launches(model)
    if name == "rescaling_l3":
        assert "main3s_fused" not in fused["level2"] and "main3s_fused" in fused["level1"]
        assert want["chain3s"] == 2 * chain3s.launches_per_chain(2, cd is None)
    L, LH = model.flow.L, 6
    lr = torch.rand(2, LH, LH + 1, 3, device="cuda", generator=gen)
    eps = [0.3 * torch.randn(2, LH * 2 ** (L - 1 - lv.level), (LH + 1) * 2 ** (L - 1 - lv.level),
                             lv.cond_spec.a_channels, device="cuda", generator=gen)
           for lv in model.flow.levels]
    for counts in (chain.launches_by, chain3s.launches_by, rrdb.launches_by):
        counts.clear()
    with torch.no_grad():
        got = model.flow.reverse_flow(fused, lr, 0.9, eps_list=eps)
        torch.cuda.synchronize()
        launches = {"chain": sum(chain.launches_by.values()),
                    "chain3s": sum(chain3s.launches_by.values()),
                    "rrdb": sum(rrdb.launches_by.values())}
        ref = model.flow.reverse_flow(plain, lr, 0.9, eps_list=eps)
    assert launches == want and want["chain"] > 0
    assert got.shape == ref.shape and torch.isfinite(got).all()
    d = (got - ref).abs()
    if cd is None:
        assert d.max().item() <= 1e-4 * ref.abs().max().item()
    else:
        assert d.max().item() <= 5e-2 * ref.abs().max().item()
        assert d.mean().item() <= 1e-2 * ref.abs().mean().item()


def test_padded_chains_and_trunks_sharded_on_the_card(gen):
    """The x4 SR model at coupling width 48 (chains padded to 64, trunks at nf 24 / gc 24
    padded to 32) served on a (1, 2) mesh, 2 ranks on the card over gloo: each rank's
    launches as the unsharded pass's, its halo exchanges and bytes as counted from the
    model's structure (a padded trunk exchanges its real channels only), the image
    within 1e-4 x max |unsharded| (float32 recipe)."""
    from hcflow_tpu_torch.parallel import dryrun

    model = _width_model("sr48", None)
    params = dryrun.perturb(model.init(0, device="cpu"), 3)
    lr = torch.rand(1, 16, 12, 3, generator=torch.Generator().manual_seed(2))
    case = dryrun.ServeCase(model, params, lr, 0.9, seed=1)
    ref = dryrun.serve(case, None, "cuda")
    assert sum(ref["launches"]["chain"].values()) == _expected_launches(model)["chain"]
    counts, nbytes = dryrun.expected_exchanges(model.flow, (1, 8, 12), 2)
    for r, rec in enumerate(dryrun.serve_spatial(2, [case])):
        assert rec[0]["launches"] == ref["launches"], r
        assert rec[0]["exchanges"] == counts and rec[0]["bytes"] == nbytes, r
        if r == 0:
            out, want = rec[0]["image"], ref["out"].cpu()
            assert out.shape == want.shape
            assert (out - want).abs().max().item() <= 1e-4 * want.abs().max().item()


@pytest.mark.parametrize("cd", ["bfloat16", None])
def test_tiny_checkpoint_served_fused(gen, cd):
    """weights/ref_trained/tiny_x4_400_G.pth (hidden 32, RRDB nf 32 / gc 16) served on
    the kernel path against the plain path under the same latents, in both recipes:
    the chain kernel at hid 32 in bf16 or float32, the RRDB kernel at nf 32 / gc 16
    (bf16 recipe)."""
    from pathlib import Path

    from hcflow_tpu_torch.convert import params_from_state_dict

    pth = Path(__file__).resolve().parents[1] / "weights/ref_trained/tiny_x4_400_G.pth"
    model = _tiny_spec(cd)
    params = params_from_state_dict(torch.load(pth, map_location="cpu"), model, device="cuda")
    fused = model.flow.precompute_inference(params, fused=True)
    plain = model.flow.precompute_inference(params)
    lr = torch.rand(2, 8, 8, 3, device="cuda", generator=gen)
    eps = [torch.randn(2, 16, 16, 6, device="cuda", generator=gen),
           torch.randn(2, 8, 8, 21, device="cuda", generator=gen)]
    chain.launches_by.clear()
    with torch.no_grad():
        got = model.flow.reverse_flow(fused, lr, 0.9, eps_list=eps)
        ref = model.flow.reverse_flow(plain, lr, 0.9, eps_list=eps)
    torch.cuda.synchronize()
    assert sum(chain.launches_by.values()) == 16
    assert torch.isfinite(got).all()
    d = (got - ref).abs()
    if cd is None:  # float32 kernels against the float32 plain path
        assert d.max().item() <= 1e-4 * ref.abs().max().item()
    else:  # as chip_smoke.py holds the bf16 kernel path against the plain path
        assert d.max().item() <= 5e-2 * ref.abs().max().item()
        assert d.mean().item() <= 1e-2 * ref.abs().mean().item()


def _write_pairs(root, n, hr_hw, scale):
    """n smooth synthetic GT/LQ PNG pairs (LR by MATLAB bicubic) under root/HR, root/LR."""
    from hcflow_tpu_torch.data.imresize import imresize
    from hcflow_tpu_torch.data.util import save_img

    rng = np.random.default_rng(0)
    for d in ("HR", "LR"):
        (root / d).mkdir(parents=True)
    for i in range(n):
        h, w = hr_hw
        hr = np.kron(rng.uniform(0.1, 0.9, (h // 8, w // 8, 3)), np.ones((8, 8, 1)))
        hr = (hr + 0.02 * rng.standard_normal(hr.shape)).clip(0, 1).astype(np.float32)
        save_img(str(root / "HR" / f"{i}.png"), hr)
        save_img(str(root / "LR" / f"{i}.png"), np.clip(imresize(hr, 1 / scale), 0, 1))
    return {"mode": "GTLQ", "phase": "test", "scale": scale, "name": "pairs",
            "dataroot_GT": str(root / "HR"), "dataroot_LQ": str(root / "LR")}


def test_evaluator_kernel_path_matches_plain_path(gen, tmp_path):
    """The tiny checkpoint's Evaluator at heat 0 in the float32 recipe (the shipped test
    configs') on packed params (the float32 RRDB and chain kernels, in the forward's
    encoders too) against the plain params, on 2 pairs of HR 104x88: the SR images within
    the float32 path limit, 1e-4 x max |plain|, PSNR within 0.05 dB, the NLL (the same
    noise: one seed) within 1e-3 relative."""
    from pathlib import Path

    from hcflow_tpu_torch.cli.evaluate import Evaluator
    from hcflow_tpu_torch.data import DataLoader, create_dataset
    from hcflow_tpu_torch.utils.checkpoint import load_any

    pth = Path(__file__).resolve().parents[1] / "weights/ref_trained/tiny_x4_400_G.pth"
    model = _tiny_spec(None)
    params = load_any(str(pth), model.flow, device="cuda")
    dopt = _write_pairs(tmp_path, 2, (104, 88), 4)

    class Capture(Evaluator):
        def sample(self, *args):
            out = super().sample(*args)
            self.srs.append(out)
            return out

    runs = []
    for fused in (True, False):
        ev = Capture(model, model.flow.precompute_inference(params, fused=fused), [0.0])
        ev.srs = []
        rrdb.launches_by.clear()
        chain.launches_by.clear()
        res = ev.run(DataLoader(create_dataset(dopt)), torch.Generator("cuda").manual_seed(1))
        torch.cuda.synchronize()
        # per image: the forward's and the reverse's 2 x 2 x 2 RRDBs, 16 launches each;
        # the reverse's 4 chains of 4 steps
        launches = (sum(rrdb.launches_by.values()), sum(chain.launches_by.values()))
        assert launches == ((2 * 2 * 128, 2 * 16) if fused else (0, 0))
        runs.append((res, ev.srs))
    (got, got_srs), (ref, ref_srs) = runs
    assert sorted(got) == sorted(ref)
    for a, b in zip(got_srs, ref_srs):
        d = np.abs(a - b).max()
        assert d <= 1e-4 * np.abs(b).max(), d
    for k in ("psnr@0.0", "psnr_y@0.0", "bic_psnr@0.0"):
        assert abs(got[k] - ref[k]) <= 0.05, k
    assert abs(got["nll"] - ref["nll"]) <= 1e-3 * abs(ref["nll"])


def test_predictor_kernel_path_matches_plain_path(gen, tmp_path):
    """Predictor on the tiny checkpoint (float32 recipe), tiled (an LR of 61x57 over
    max_tile 32: 9 tiles, two batches of 8), fused "all" against "off": the SR within a
    level of the 8-bit grid."""
    from pathlib import Path

    from hcflow_tpu_torch.cli.predict import Predictor
    from hcflow_tpu_torch.data.util import read_img, save_img

    root = Path(__file__).resolve().parents[1]
    img = np.random.default_rng(3).random((61, 57, 3)).astype(np.float32)
    save_img(str(tmp_path / "lr.png"), img)
    outs = []
    for fused in ("all", "off"):
        pred = Predictor(opt_path=str(root / "weights/ref_trained/tiny_x4_parity.yml"),
                         checkpoint=str(root / "weights/ref_trained/tiny_x4_400_G.pth"),
                         fused=fused)
        rrdb.launches_by.clear()
        out = pred.predict(str(tmp_path / "lr.png"), str(tmp_path / f"{fused}.png"), heat=0.0,
                           max_tile=32)
        assert sum(rrdb.launches_by.values()) == (2 * 128 if fused == "all" else 0)
        outs.append(read_img(out))
    assert outs[0].shape == (244, 228, 3)
    d = np.abs(outs[0] - outs[1])
    assert d.max() <= 1 / 255 + 1e-6 and (d > 0).mean() <= 0.01


def test_train_cli_on_the_card_validates_through_the_kernels(gen, tmp_path):
    """cli.train.main on the card: 2 iterations of the HCFlow+ recipe (bf16 encoders,
    float32 couplings) at widths the kernels take (coupling width 32, RRDB nf 32 / gc
    16), then its validation on the packed params: the bf16 RRDB kernel and the float32
    chain kernel at hid 32, with exact launches, finite averages."""
    import math
    from pathlib import Path

    import yaml

    from _torch_port_util import train_data, train_option_file
    from hcflow_tpu_torch.cli import train

    data = train_data(tmp_path / "data")
    opt = Path(train_option_file(tmp_path / "opt.yml", "train_SR_DF2K_4X_HCFlow+.yml", data,
                                 tmp_path / "run", val_freq=2))
    o = yaml.safe_load(opt.read_text())
    o["network_G"]["encoder_dtype"] = "bfloat16"
    o["network_G"]["flowDownsampler"].update(K=4, hidden_channels=32)
    o["network_G"]["flowDownsampler"]["splitOff"].update(
        after_flowstep=[2, 2], hidden_channels=32, RRDB_nb=[1, 1], RRDB_nf=32, RRDB_gc=16)
    opt.write_text(yaml.safe_dump(o))
    results = []
    run = train.Evaluator.run

    def recording(self, *a, **k):
        rrdb.launches_by.clear()
        chain.launches_by.clear()
        out = run(self, *a, **k)
        torch.cuda.synchronize()
        results.append((out, dict(rrdb.launches_by), dict(chain.launches_by)))
        return out

    train.Evaluator.run = recording
    try:
        state = train.main(["--opt", str(opt), "--max_steps", "2"])
    finally:
        train.Evaluator.run = run
    assert state.step == 2
    assert all(t.is_cuda and torch.isfinite(t).all() for t in
               [p for lv in state.params.values() for p in lv["cond"]["conv_first"].values()])
    (avg, rrdb_launches, chain_launches), = results
    assert all(math.isfinite(v) for v in avg.values())
    # one image of HR 64: the forward and one reverse at heat 0, 4 RRDBs of 16 launches
    # each; the reverse's 4 chains of 2 steps
    assert rrdb_launches == {"bf16": 2 * 4 * 16}
    assert chain_launches == {"f32 hid 32": 4 * 2}


# ------------------------------------------- data parallelism, remat, the inventory
def _inventory_model(**kw):
    from hcflow_tpu_torch.models import HCFlowSRSpec

    return HCFlowSRSpec.for_scale(4, K=(4, 4), after_splitoff=(2, 2), rrdb_nb=(1, 1), rrdb_nf=32,
                                  rrdb_gc=16, hidden_channels=32, so_hidden_channels=32, **kw)


@pytest.mark.parametrize("perm, so_perm, main_packed, so_packed", [
    ("shuffle", "reverse", False, False), ("none", "invconv", False, True)])
def test_chains_the_chain_kernel_cannot_take_serve_plain(gen, perm, so_perm, main_packed,
                                                         so_packed):
    """A permuted (or unpermuted) chain is not packed: the fused reverse launches the RRDB
    kernel and the chain kernel only for the invconv split-off chains, and matches the
    plain path."""
    model = _inventory_model(compute_dtype="bfloat16", flow_permutation=perm,
                             so_flow_permutation=so_perm)
    params = _perturb(model.init(0, device="cuda"), gen)
    fused = model.flow.precompute_inference(params, fused=True)
    plain = model.flow.precompute_inference(params)
    for lv in model.flow.levels:
        lp = fused[f"level{lv.level}"]
        assert ("main_fused" in lp, "steps_fused" in lp["cond"]) == (main_packed, so_packed)
    lr = torch.rand(2, 8, 8, 3, device="cuda", generator=gen)
    eps = [torch.randn(2, 8 * 2 ** (1 - lv.level), 8 * 2 ** (1 - lv.level),
                       lv.cond_spec.a_channels, device="cuda", generator=gen)
           for lv in model.flow.levels]
    rrdb.launches_by.clear()
    chain.launches_by.clear()
    with torch.no_grad():
        got = model.flow.reverse_flow(fused, lr, 0.9, eps_list=eps)
        torch.cuda.synchronize()
        assert rrdb.launches_by == {"bf16": 4 * 16}
        assert chain.launches_by == ({"bf16 hid 32": 2 * 2} if so_packed else {})
        ref = model.flow.reverse_flow(plain, lr, 0.9, eps_list=eps)
    d = (got - ref).abs()
    assert d.max() <= 5e-2 * ref.abs().max() and d.mean() <= 1e-2 * ref.abs().mean()


def test_remat_steps_gradient_on_the_card(gen):
    import dataclasses

    from hcflow_tpu_torch.train import schedules, trainer

    model = _inventory_model(encoder_dtype="bfloat16")
    params = _perturb(model.init(0, device="cuda"), gen)
    hr = torch.rand(2, 32, 32, 3, device="cuda", generator=gen)
    lr = hr.reshape(2, 8, 4, 8, 4, 3).mean((2, 4))
    noise = torch.rand(hr.shape, device="cuda", generator=gen)
    topt = {"lr_G": 5e-5, "lr_steps": [100]}
    tx = trainer.make_optimizer(topt, schedules.schedule_from_opt(topt))
    grads = []
    for on in (False, True):
        m = dataclasses.replace(model, flow=dataclasses.replace(model.flow, remat_steps=on))
        grads.append(trainer.make_sr_nll_step(m, tx)(trainer.init_state(params, tx), hr, lr,
                                                     noise=noise)[-1]["grads"])
    scale = max(g.abs().max().item() for g in grads[0])
    assert max((a - b).abs().max().item() for a, b in zip(*grads)) <= 1e-5 * scale


def test_dryrun_multigpu_two_ranks_on_the_card(gen):
    from hcflow_tpu_torch.parallel.dryrun import dryrun_multigpu

    rep = dryrun_multigpu(2, mesh_shape=(2, 1))
    assert rep["digests_equal"] and rep["calibrate_equal"]
    assert all(r["rel"] <= 1e-4 for r in rep["passes"].values()) and rep["d_loss"]["rel"] <= 1e-5


def test_dryrun_multigpu_spatial_mesh_on_the_card(gen):
    """Training on a (1, 2) mesh, 2 ranks on the one card over gloo, each a band of the
    images' rows: every pass's all-reduced gradient within 1e-4 x max |g| of the
    one-process pass on the card in every leaf, the ranks' params equal, the calibration
    one process's, a halo one row short breaking the NLL's and the rescaling pass's limit."""
    from hcflow_tpu_torch.parallel.dryrun import dryrun_multigpu

    rep = dryrun_multigpu(2, mesh_shape=(1, 2))
    assert rep["mesh"]["shape"] == (1, 2)
    assert rep["digests_equal"] and rep["calibrate_equal"]
    assert all(r["rel"] <= 1e-4 for r in rep["passes"].values()) and rep["d_loss"]["rel"] <= 1e-5
    assert all(rep["controls"][p]["rel"] > 1e-4 for p in ("plusplus_nll", "rescaling"))


def test_train_cli_world_1_on_nccl(gen, tmp_path):
    """cli.train.main as the launcher's one rank on NCCL: trains, saves and validates."""
    import yaml

    import _parallel_ranks
    from _torch_port_util import train_data, train_option_file
    from hcflow_tpu_torch.parallel.dryrun import launch

    data = train_data(tmp_path / "data")
    opt = train_option_file(tmp_path / "opt.yml", "train_SR_DF2K_4X_HCFlow+.yml", data,
                            tmp_path / "run", val_freq=2)
    o = yaml.safe_load(open(opt))
    # widths the kernels take (the validation serves fused on the card)
    o["network_G"]["flowDownsampler"].update(K=4, hidden_channels=32)
    o["network_G"]["flowDownsampler"]["splitOff"].update(
        after_flowstep=[2, 2], hidden_channels=32, RRDB_nb=[1, 1], RRDB_nf=32, RRDB_gc=16)
    with open(opt, "w") as f:
        yaml.safe_dump(o, f)
    rec, = launch(1, _parallel_ranks.train_cli, (opt, 2, None, None, False), cpu=False)
    assert rec["step"] == 2 and rec["validations"] == 1
    assert rec["saves"] == ["1_G.ckpt", "1.state", "2_G.ckpt", "2.state", "latest_G.ckpt"]


def test_spatial_serving_two_ranks_on_one_card(gen):
    """The x4 SR reverse in the bf16 serving recipe at a small width (the kernels' widths:
    RRDB nf 32 / gc 16, chains hid 32), batch 1, LR 32x24, on a (1, 2) mesh: 2 ranks on
    the one card over gloo (parallel.dryrun.serve_spatial), against the unsharded pass on
    the card within phase 3's limits of chip_smoke.py (5e-2 x max, 1e-2 x mean); each
    rank's kernel launches the unsharded pass's, its halo exchanges as counted."""
    from hcflow_tpu_torch.models import HCFlowSRSpec
    from hcflow_tpu_torch.models.hcflow_sr import to_device
    from hcflow_tpu_torch.parallel import dryrun

    model = HCFlowSRSpec.for_scale(4, compute_dtype="bfloat16", K=(4, 4), after_splitoff=(2, 2),
                                   rrdb_nb=(1, 1), rrdb_nf=32, rrdb_gc=16, hidden_channels=32,
                                   so_hidden_channels=32)
    params = to_device(_perturb(model.init(0, device="cuda"), gen), "cpu")
    lr = torch.rand(1, 32, 24, 3, generator=torch.Generator().manual_seed(1))
    case = dryrun.ServeCase(model, params, lr, 0.9, seed=3)
    ref = dryrun.serve(case, None, "cuda")
    assert sum(ref["launches"]["rrdb"].values()) == 4 * rrdb.LAUNCHES_PER_RRDB
    assert sum(ref["launches"]["chain"].values()) == 4 * 2
    counts, nbytes = dryrun.expected_exchanges(model.flow, (1, 16, 24), 2)
    ranks = dryrun.serve_spatial(2, [case])
    for r in ranks:
        assert r[0]["launches"] == ref["launches"]
        assert r[0]["exchanges"] == counts and r[0]["bytes"] == nbytes
    got, want = ranks[0][0]["image"], ref["out"].cpu()
    assert got.shape == want.shape and torch.isfinite(got).all()
    d = (got - want).abs()
    assert d.max() <= 5e-2 * want.abs().max() and d.mean() <= 1e-2 * want.abs().mean()


def _f32_mesh_case(name):
    """A float32-recipe case (the shipped test configs' recipe) at the kernels' small
    widths, batch 1, and the kernel launches of a request: x4 rescaling (RRDB nf 32 /
    gc 16, chain3s growth 32, split-off chains hid 32) on HR 192x48; x8 SR on resident
    trunks (nf 32 / gc 16, chains hid 32) from LR 64x12: at 2 ranks each band is taller
    than an RRDB's or a trunk's halo."""
    from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
    from hcflow_tpu_torch.parallel import dryrun

    g = torch.Generator().manual_seed(5)
    if name == "rescaling":
        model = HCFlowRescalingSpec.default_x4(K=(4, 4), after_splitoff=(2, 2), rrdb_nb=(1, 1),
                                               rrdb_nf=32, rrdb_gc=16, so_hidden_channels=32)
        # both directions: 4 RRDBs each; 2 split-off steps and a main chain of 2 a level
        want = {"rrdb": {"f32": 8 * rrdb.LAUNCHES_PER_RRDB}, "chain": {"f32 hid 32": 4},
                "chain3s": {"f32": 2 * chain3s.launches_per_chain(2, True)}}
        return (dryrun.ServeCase(model, dryrun.perturb(model.init(0, device="cpu"), 4),
                                 torch.rand(1, 192, 48, 3, generator=g), 1.0, seed=2), want)
    model = HCFlowSRSpec.for_scale(8, K=(2, 2, 2), after_splitoff=(1, 1, 1), rrdb_nb=(2, 1),
                                   rrdb_nf=32, rrdb_gc=16, hidden_channels=32,
                                   so_hidden_channels=32)
    want = {"rrdb_trunk": {"f32": 6}, "chain": {"f32 hid 32": 6}}  # 2 trunks, 2 chains a level
    return (dryrun.ServeCase(model, dryrun.perturb(model.init(0, device="cpu"), 4),
                             torch.rand(1, 64, 12, 3, generator=g), 0.8, resident=True, seed=3),
            want)


@pytest.mark.parametrize("name", ["rescaling", "x8"])
def test_float32_recipes_sharded_on_the_card(gen, name):
    """x4 rescaling and x8 SR (resident trunks) in the float32 recipe on a (1, 2) mesh, 2
    ranks on the card over gloo: each rank's launches of the float32 kernels the unsharded
    pass's, its halo exchanges and bytes as counted from the model's structure; the
    image within 1e-4 x max |unsharded|.  Rescaling: the ranks upscale the unsharded
    pass's 8-bit codes (ServeCase.codes); its LR before quantization within 1e-4 x max,
    its flips against the unsharded LR's codes one code at most, and the HR from the
    same codes within 1e-4 x max."""
    import dataclasses

    from hcflow_tpu_torch.models import HCFlowRescalingSpec
    from hcflow_tpu_torch.parallel import dryrun

    case, want = _f32_mesh_case(name)
    ref = dryrun.serve(case, None, "cuda")
    for k, counts in want.items():
        assert ref["launches"][k] == counts, (k, ref["launches"])
    rescaling = isinstance(case.model, HCFlowRescalingSpec)
    if rescaling:
        case = dataclasses.replace(case, codes=dryrun.lr_codes(ref["lr"]))
    B, H, W = case.image.shape[:3]
    f = 4 if rescaling else 1
    counts, nbytes = dryrun.expected_exchanges(case.model.flow, (B, H // f // 2, W // f), 2,
                                               resident=case.resident, forward=rescaling)
    ranks = dryrun.serve_spatial(2, [case])
    for r, rec in enumerate(ranks):
        assert rec[0]["launches"] == ref["launches"], r
        assert rec[0]["exchanges"] == counts and rec[0]["bytes"] == nbytes, r
    pairs = [(ranks[0][0]["image"], ref["out"].cpu())]
    if rescaling:
        lr, want_lr = ranks[0][0]["lr_image"], ref["lr"].cpu()
        pairs.append((lr, want_lr))
        assert dryrun.code_flips(lr, want_lr)["steps"] <= 1
    for got, want_t in pairs:
        assert got.shape == want_t.shape and torch.isfinite(got).all()
        assert (got - want_t).abs().max().item() <= 1e-4 * want_t.abs().max().item()


# the port's kernels by name: csrc/chain.cu, chain3s.cu, rrdb.cu, rrdb_trunk.cu and the
# tile conv's conv3x3.cuh
PORT_KERNELS = ("chain_step_", "chain3s_", "to_dense_kernel", "feature_kernel",
                "residual_kernel", "trunk_kernel")


@pytest.mark.parametrize("config", ["sr_x4_f32", "rescaling_x4_f32"])
def test_kernel_launches_fall_under_the_wrapper_spans(gen, config):
    """A fused float32 reverse of the benchmark's configurations at a few steps and narrow
    (unpadded) widths, profiled: every device operation of the port's kernels was launched
    inside an ``hcflow.rrdb|chain|chain3s`` span, and each wrapper opens one span a call
    that the benchmark's ``Calls`` hook counts."""
    import json
    import sys
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    repo = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(repo))
    from h100_bench import harness, program_trace, trace, weights
    from h100_bench.reference.hcflow import Topology
    from hcflow_tpu_torch import convert

    cfg = json.loads((repo / "h100_bench" / "configs" / f"{config}.json").read_text())
    fd = cfg["network_G"]["flowDownsampler"]
    fd.update(K=4, hidden_channels=32)
    fd["splitOff"].update(after_flowstep=[2, 2], hidden_channels=32, RRDB_nf=32, RRDB_gc=16,
                          RRDB_nb=[1, 2])
    sr = config.startswith("sr")
    top = Topology(cfg["network_G"], sr)
    model = harness.build_model(cfg)
    params = model.flow.precompute_inference(
        convert.params_from_state_dict(weights.state_dict(top, 3, "cuda"), model, "cuda"),
        fused=True)
    lr = torch.rand(2, 12, 20, 3, device="cuda", generator=gen)
    calls, seen = trace.Calls(top), []
    calls._add = lambda name, flops, nbytes: seen.append(name)
    calls.install()
    try:
        with torch.no_grad():
            model.reverse(params, lr, 0.8, generator=gen)  # warm-up
            seen.clear()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                with trace.span("bench.window"):
                    model.reverse(params, lr, 0.8, generator=gen)
                    torch.cuda.synchronize()
    finally:
        calls.uninstall()
    events = trace.chrome_events(prof)
    pt = program_trace.ProgramTrace(events)
    launch = {(e.get("args") or {}).get("correlation"): e["ts"] for e in events
              if e.get("ph") == "X" and str(e.get("cat", "")).lower() in trace._LAUNCH}
    ops = [e for e in events if e.get("ph") == "X" and str(e.get("cat", "")).lower() == "kernel"
           and any(k in e["name"] for k in PORT_KERNELS)]
    assert len(ops) >= 3 * 16  # the three RRDBs of a level's trunks, at least
    wrappers = {f"hcflow.{w}" for w in trace.WRAPPERS}
    for op in ops:
        i = pt.innermost(launch[op["args"]["correlation"]])
        assert i >= 0 and pt.names[pt.in_program[i]] in wrappers, op["name"]
    assert {w: pt.names.count(f"hcflow.{w}") for w in trace.WRAPPERS} == \
        {w: seen.count(w) for w in trace.WRAPPERS}
    assert {w for w in trace.WRAPPERS if w in seen} == (
        {"rrdb", "chain"} | (set() if sr else {"chain3s"}))
