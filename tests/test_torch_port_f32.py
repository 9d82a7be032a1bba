"""The float32 serving recipe (no compute_dtype, as the shipped test configs set none)
on the port's fused path, against the JAX package's fused path on the CPU.

- Packing: ``precompute_inference(fused=True)`` in the float32 recipe attaches a
  trunk pack at every level where JAX's ``precompute_inference(fused="all")`` does
  (nf and gc multiples of 8; on the card also widths the kernels take), in float32,
  and the rescaling model's chain3s pack; the float32 tile-conv pack (K-major,
  ``[tap][co][ci]``) round-trips to the OIHW weights.
- Whole paths: the fused float32 x4 SR reverse and the fused float32 rescaling
  reverse, through the plain versions of the float32 packs, against JAX's fused
  ``"all"`` reverse under the same latents (its Pallas kernels in interpret mode, as
  the JAX package's tests run them on the CPU; chain3s with its TPU rollout gate
  ``pallas_chain3s.ENABLED`` switched on): 1e-4, the float32 tolerance of
  tests/test_torch_port_model.py (the same arithmetic summed in another order;
  measured worst 2.1e-6 on values up to 3.1, rescaling 2.0e-6 up to 3.9).
- The 3xTF32 split that the float32 kernels run (csrc/conv3x3.cuh ``split_tf32``),
  emulated in plain PyTorch for the tests only: operands rounded to TF32 by bit
  arithmetic (nearest, ties away from zero, as ``cvt.rna.tf32.f32``), the three
  products exact in float32 and summed in float32, against a float64 product on
  conv-shaped sums: within 2e-6 of the largest magnitude (~2^-21 a product, plus
  float32 summation; measured 4.2-4.9e-7, as a plain float32 product's 4.8-4.9e-7);
  single-pass TF32 is measurably worse (above 1e-4; measured 2.9-3.0e-4).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from hcflow_tpu.models.hcflow_rescaling import HCFlowRescalingSpec as JHCFlowRescalingSpec
from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec
from hcflow_tpu.ops import pallas_chain3s as p3
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
from hcflow_tpu_torch.ops import chain3s, nets, rrdb

from _torch_port_util import TINY, assert_close, perturb, randn, to_jax

TOL = 1e-4
# x4 SR topologies: nf 16 / gc 8 passes JAX's trunk gate (hcflow_tpu/flow/flownet.py:374);
# TINY's gc 4 does not
SR8 = dict(TINY, rrdb_nf=16, rrdb_gc=8)
TOPOLOGIES = {"nf16_gc8": SR8, "tiny_gc4": TINY}
TINY_RS = dict(K=(4, 4), after_splitoff=(2, 2), hidden_channels=8, so_hidden_channels=8,
               rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=8)
B, LH, LW = 2, 4, 6  # non-square LR
PACKS = ("main_fused", "main3s_fused", "steps_fused", "trunk0_fused", "trunk1_fused")


def _packs(level: dict) -> set:
    return {k for k in PACKS if k in level or k in level["cond"]}


@functools.lru_cache(maxsize=None)
def _sr_case(name):
    """The float32 x4 SR model, its params read back from the JAX tree, JAX's fused
    "all" params, the LR image, the latents and JAX's fused reverse before the clamp."""
    topo = TOPOLOGIES[name]
    model = HCFlowSRSpec.for_scale(4, **topo)
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    params = params_from_jax(jp, model, device="cpu")
    jmodel = JHCFlowSRSpec.for_scale(4, **topo)
    jfused = jmodel.flow.precompute_inference(jp, fused="all")
    lr = np.random.default_rng(1).uniform(size=(B, LH, LW, 3)).astype(np.float32)
    eps = [randn(2, (B, 2 * LH, 2 * LW, 6)), randn(3, (B, LH, LW, 21))]
    reverse = jax.jit(lambda p, x, e: jmodel.flow.reverse_flow(
        p, jax.random.PRNGKey(4), x, 0.9, eps_list=e))
    ref = np.asarray(reverse(jfused, lr, eps))
    return model, params, jfused, torch.from_numpy(lr), [torch.from_numpy(e) for e in eps], ref


@functools.lru_cache(maxsize=None)
def _rescaling_case():
    """The float32 x4 rescaling model and JAX's fused "all" params (chain3s's rollout
    gate on), the LR of JAX's downscale, latents, and JAX's fused upscale before the
    clamp."""
    model = HCFlowRescalingSpec.default_x4(**TINY_RS)
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    params = params_from_jax(jp, model, device="cpu")
    jmodel = JHCFlowRescalingSpec.default_x4(**TINY_RS)
    enabled, p3.ENABLED = p3.ENABLED, True
    try:
        jfused = jmodel.flow.precompute_inference(jp, fused="all")
    finally:
        p3.ENABLED = enabled
    hr = np.random.default_rng(1).uniform(size=(B, 4 * LH, 4 * LW, 3)).astype(np.float32)
    lr = np.array(jax.jit(jmodel.forward)(jp, hr)[0])
    eps = [0.3 * randn(2, (B, 2 * LH, 2 * LW, 6)), 0.3 * randn(3, (B, LH, LW, 21))]
    reverse = jax.jit(lambda p, x, e: jmodel.flow.reverse_flow(
        p, jax.random.PRNGKey(4), x, 1.0, eps_list=e))
    ref = np.asarray(reverse(jfused, lr, eps))
    return model, params, jfused, torch.from_numpy(lr), [torch.from_numpy(e) for e in eps], ref


# ------------------------------------------------------------------------ packing
@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_float32_packs_follow_jax_fused_all(name):
    """The port packs, level for level, what JAX's fused="all" packs, all in float32:
    the chains, and the trunks where nf and gc are multiples of 8."""
    model, params, jfused, _, _, _ = _sr_case(name)
    pp = model.flow.precompute_inference(params, fused=True)
    for lv in range(model.flow.L):
        got, want = _packs(pp[f"level{lv}"]), _packs(jfused[f"level{lv}"])
        assert got == want, (lv, got, want)
        assert ("trunk0_fused" in got) == (name == "nf16_gc8")
        cond = pp[f"level{lv}"]["cond"]
        assert cond["steps_fused"]["w1"].dtype == torch.float32
        for trunk in ("trunk0_fused", "trunk1_fused"):
            for p in cond.get(trunk, []):
                assert all(w.dtype == torch.float32 for w in p["w"])


def test_rescaling_float32_packs():
    """The float32 rescaling model packs its alternating main chain for chain3s and its
    trunks for the RRDB kernel, in float32, as JAX's fused="all" does with chain3s's
    rollout gate on."""
    model, params, jfused, _, _, _ = _rescaling_case()
    pp = model.flow.precompute_inference(params, fused=True)
    for lv in range(model.flow.L):
        assert _packs(pp[f"level{lv}"]) == _packs(jfused[f"level{lv}"])
    assert "main3s_fused" in pp["level0"]
    packed = pp["level0"]["main3s_fused"]
    assert all(v.dtype == torch.float32 for k, v in packed.items() if k[0] == "w")
    assert pp["level1"]["cond"]["trunk0_fused"][0]["w"][0].dtype == torch.float32


# (nf, gc, packed on the CPU, packed on the card): JAX's gate everywhere; on the card
# also widths whose padding (up to 16, 32 or 64) the RRDB kernels take
@pytest.mark.parametrize("nf,gc,cpu,card", [(64, 32, True, True), (32, 16, True, True),
                                            (16, 8, True, True), (64, 24, True, True),
                                            (48, 32, True, True), (16, 4, False, False),
                                            (12, 16, False, False), (72, 32, True, False),
                                            (64, 80, True, False)])
def test_trunk_packing_gate(nf, gc, cpu, card):
    """rrdb.packs_trunk: where nf and gc are multiples of 8 (JAX's gate); for params on
    the card only where the padded widths are ones the kernels take (nf and gc up to
    64), so that wider trunks keep the plain path there instead of reaching a kernel
    that refuses them."""
    assert rrdb.packs_trunk(nf, gc, "cpu") is cpu
    assert rrdb.packs_trunk(nf, gc, torch.device("cuda", 0)) is card


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tap_pack_round_trips_to_oihw(dtype):
    """nets.pack_taps: float32 K-major (9, cout, cin) [tap][co][ci], bf16 (9, cin,
    cout); each reads back to the OIHW weight, and nets.taps gives both as [tap][ci][co]."""
    w = torch.from_numpy(randn(5, (24, 40, 3, 3)))  # OIHW, cout 24, cin 40
    packed = nets.pack_taps(w, dtype)
    assert packed.dtype == dtype and packed.is_contiguous()
    if dtype == torch.float32:
        assert packed.shape == (9, 24, 40)
        back = packed.reshape(3, 3, 24, 40).permute(2, 3, 0, 1)
        assert torch.equal(back, w)
    else:
        assert packed.shape == (9, 40, 24)
        back = packed.reshape(3, 3, 40, 24).permute(3, 2, 0, 1)
        assert torch.equal(back, w.to(dtype))
    t = nets.taps(packed)
    assert t.shape == (9, 40, 24)
    assert torch.equal(t[4].float(), w[:, :, 1, 1].T.to(dtype).float())  # the centre tap


def test_float32_rrdb_and_chain3s_packs_read_back():
    """The float32 RRDB pack, per RRDB and stacked for the resident trunk, gives back
    the OIHW weights it was made from (gc 8 padded to 16: each feature's 8 rows followed
    by 8 zero rows, conv1-4's outputs by 8 zero outputs); chain3s's float32 pack is
    K-major too, its growth of 8 padded to 16 likewise."""
    trunk = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(2), 2, 16, 8))
    per = rrdb.pack_rrdb_trunk(trunk)
    res = rrdb.pack_rrdb_trunk(trunk, resident=True)
    for n, p in enumerate(trunk):
        for r in range(3):
            for i in range(5):
                w = p[f"rdb{r + 1}"][f"conv{i + 1}"]["w"]
                cout, cin = 16, 16 + 16 * i  # the pack's nf and gc are both 16
                real = torch.zeros(cout, cin, 3, 3)
                rows = [*range(16)] + [16 + 16 * j + q for j in range(i) for q in range(8)]
                real[: w.shape[0], rows] = w
                w = real
                for got in (per[n]["w"][5 * r + i], res["w"][i][3 * n + r]):
                    assert got.shape == (9, cout, cin)
                    assert torch.equal(got.reshape(3, 3, cout, cin).permute(2, 3, 0, 1), w)
    model = HCFlowRescalingSpec.default_x4(**TINY_RS)
    main = model.init(0, device="cpu")["level0"]["main"]
    packed = chain3s.pack_inverse_chain3s(perturb(main))
    assert packed["we2"].shape[-2:] == (16, 16 + 16) and packed["we2"].dtype == torch.float32
    assert not packed["we2"][..., 8:, :].any() and not packed["we2"][..., 24:].any()


# --------------------------------------------------------------- the whole paths
def test_fused_float32_sr_reverse_matches_jax_fused_all():
    """The float32 x4 SR reverse on the port's fused path (the RRDB, chain kernels'
    plain versions on float32 packs) against JAX's fused "all" reverse."""
    model, params, _, lr, eps, ref = _sr_case("nf16_gc8")
    assert ((ref > 0) & (ref < 1)).mean() > 0.3  # mostly not saturated by the clamp
    pp = model.flow.precompute_inference(params, fused=True)
    with torch.no_grad():
        out = model.flow.reverse_flow(pp, lr, 0.9, eps_list=eps)
        assert_close(out, ref, TOL)
        assert_close(model.reverse(pp, lr, 0.9, eps_list=eps), np.clip(ref, 0, 1), TOL)


def test_fused_float32_rescaling_reverse_matches_jax_fused_all():
    """The float32 x4 rescaling upscale on the port's fused path (chain3s and the RRDB
    kernel's plain versions on float32 packs) against JAX's fused "all" reverse, whose
    main chains run the chain3s Pallas kernel."""
    model, params, _, lr, eps, ref = _rescaling_case()
    assert ((ref > 0) & (ref < 1)).mean() > 0.3
    pp = model.flow.precompute_inference(params, fused=True)
    with torch.no_grad():
        assert_close(model.flow.reverse_flow(pp, lr, 1.0, eps_list=eps), ref, TOL)


# ------------------------------------------------------------ the 3xTF32 split
def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 x rounded to TF32 (10 mantissa bits) to nearest, ties away from zero, as
    cvt.rna.tf32.f32: half a TF32 ulp added to the bits, the low 13 bits cleared."""
    assert x.dtype == torch.float32
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def product_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the float32 kernels compute it: each operand split as hi = rna(x), lo =
    rna(x - hi), and hi @ hi + hi @ lo + lo @ hi, every product of two TF32 values exact
    in float32, the sums in float32."""
    ah, bh = tf32_rna(a), tf32_rna(b)
    al, bl = tf32_rna(a - ah), tf32_rna(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def test_tf32_rounding_is_nearest_ties_away():
    """tf32_rna against rounding in float64: random values, and values exactly half a
    TF32 ulp above a TF32 value (ties, both signs), which go away from zero."""
    x = torch.from_numpy(randn(7, (4096,)) * 10.0 ** np.random.default_rng(8).integers(
        -6, 6, 4096).astype(np.float32))
    e = torch.floor(torch.log2(x.abs().double()))
    ulp = 2.0 ** (e - 10)
    ref = torch.sign(x.double()) * torch.floor(x.abs().double() / ulp + 0.5) * ulp
    assert torch.equal(tf32_rna(x).double(), ref)
    base = tf32_rna(x)
    tie = base.double() + torch.sign(base.double()) * 2.0 ** (torch.floor(
        torch.log2(base.abs().double())) - 11)
    tie = tie.float()  # exact: a TF32 value plus half its ulp fits float32
    assert torch.equal(tf32_rna(tie).double(), (base.double() + torch.sign(base.double())
                                                * 2.0 ** (torch.floor(torch.log2(
                                                    base.abs().double())) - 10)))


# conv-shaped sums: M pixels x K = 9 taps x cin, N outputs (an RRDB's conv1 and conv5,
# the chain's conv3)
@pytest.mark.parametrize("M,K,N", [(256, 9 * 64, 32), (256, 9 * 192, 64), (160, 9 * 64, 32)])
def test_3xtf32_product_matches_float64(M, K, N):
    a = torch.from_numpy(randn(1, (M, K)))
    b = torch.from_numpy((randn(2, (K, N)) / np.sqrt(K)).astype(np.float32))
    ref = a.double() @ b.double()
    scale = ref.abs().max().item()
    err = (product_3xtf32(a, b).double() - ref).abs().max().item()
    single = (tf32_rna(a) @ tf32_rna(b)).double()
    err1 = (single - ref).abs().max().item()
    assert err <= 2e-6 * scale, err / scale
    assert err1 >= 1e-4 * scale, err1 / scale  # single-pass TF32 is not float32's accuracy


# ------------------------------------------------- the weights split once at pack time
def _ties(shape, seed):
    """float32 weights of shape ``shape``, a quarter of them exactly half a TF32 ulp above
    a TF32 value (ties, both signs), which rna rounds away from zero."""
    w = torch.from_numpy(randn(seed, shape) * 0.05)
    base = tf32_rna(w)
    tie = (base.double() + torch.sign(base.double()) * 2.0 ** (
        torch.floor(torch.log2(base.abs().double())) - 11)).float()
    mask = torch.from_numpy(np.random.default_rng(seed + 1).uniform(size=shape) < 0.25)
    return torch.where(mask, tie, w)


def _planes_oihw(planes: torch.Tensor, cout: int, cin: int) -> torch.Tensor:
    """pack_tf32's (2, 9, cin / 4, cout, 4) planes read back as two OIHW weights."""
    return planes.permute(0, 3, 2, 4, 1).reshape(2, cout, cin, 3, 3)


@pytest.mark.parametrize("cout,cin", [(32, 64), (64, 192), (16, 16), (48, 144)])
def test_tf32_planes_round_to_nearest_ties_away(cout, cin):
    """nets.pack_tf32: hi = rna(w) and lo = rna(w - hi) bit for bit against tf32_rna, the
    low 13 bits of both clear; hi + lo within 2^-21 of w relative."""
    w = _ties((cout, cin, 3, 3), cout + cin)
    planes = nets.pack_tf32(w)
    assert planes.shape == (2, 9, cin // 4, cout, 4) and planes.dtype == torch.float32
    assert planes.is_contiguous()
    hi, lo = _planes_oihw(planes, cout, cin)
    assert torch.equal(hi.view(torch.int32), tf32_rna(w).view(torch.int32))
    assert torch.equal(lo.view(torch.int32), tf32_rna(w - tf32_rna(w)).view(torch.int32))
    assert not (planes.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - w.double()).abs()
    assert (err <= 2.0 ** -21 * w.double().abs()).all()


def test_tf32_planes_are_wgmma_k_major_core_matrices():
    """The planes' layout, element by element: [hi, lo][tap][ci // 4][co][ci % 4], so that
    8 consecutive outputs x 4 inputs are one 128-byte core matrix (16 bytes a row)."""
    w = torch.from_numpy(randn(6, (24, 40, 3, 3)))  # OIHW, cout 24, cin 40
    planes = nets.pack_tf32(w)
    hi = tf32_rna(w)
    for co, ci, ky, kx in ((0, 0, 0, 0), (5, 13, 1, 2), (23, 39, 2, 2), (8, 4, 2, 0)):
        assert planes[0, 3 * ky + kx, ci // 4, co, ci % 4] == hi[co, ci, ky, kx]
    flat = planes[0].reshape(9, 10, 3, 8, 4)  # [tap][k group][8-output group][8][4]
    assert torch.equal(flat[4, 2, 1], hi[8:16, 8:12, 1, 1])  # one core matrix, centre tap


@pytest.mark.parametrize("M,cin,N", [(256, 64, 32), (256, 192, 64), (160, 64, 32)])
def test_3xtf32_product_from_the_planes_matches_float64(M, cin, N):
    """A conv-shaped product (M pixels x K = 9 taps x cin, N outputs) from the pre-split
    planes in the kernels' order (lo x hi, hi x lo, hi x hi; A split as the kernels split a
    stage): the same sums as product_3xtf32, within its float64 bound."""
    a = torch.from_numpy(randn(1, (M, 9 * cin)))
    w = torch.from_numpy((randn(2, (N, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32))
    b = w.permute(2, 3, 1, 0).reshape(9 * cin, N)  # [tap][ci][co], K = tap * cin + ci
    planes = nets.pack_tf32(w)
    bh, bl = (p.permute(0, 1, 3, 2).reshape(9 * cin, N) for p in planes)
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    got = al @ bh + ah @ bl + ah @ bh
    assert torch.equal(got, product_3xtf32(a, b))
    ref = a.double() @ b.double()
    assert (got.double() - ref).abs().max().item() <= 2e-6 * ref.abs().max().item()


def test_float32_packs_without_tf32_planes_fail_the_kernel_checks():
    """The CUDA wrappers' pack checks, which run before any launch and need no card: a
    float32 pack without its TF32 planes (or with planes of another shape) raises; a
    complete pack gives the planes as the weights the kernel reads, a bf16 pack its
    weights."""
    trunk = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(2), 2, 32, 16))
    per, res = rrdb.pack_rrdb(trunk[0]), rrdb.pack_rrdb_trunk(trunk, resident=True)
    assert rrdb.check_pack(per, 32)[2] is per["tf32"]
    assert rrdb.check_trunk_pack(res, 32)[3] is res["tf32"]
    bf = rrdb.pack_rrdb(trunk[0], "bfloat16")
    assert "tf32" not in bf and rrdb.check_pack(bf, 32)[2] is bf["w"]
    bad = dict(per, tf32=per["tf32"][:14] + [per["tf32"][14][:, :, :-1]])
    for pk, check in ((dict(per, tf32=None), rrdb.check_pack), (bad, rrdb.check_pack),
                      ({k: v for k, v in res.items() if k != "tf32"}, rrdb.check_trunk_pack)):
        with pytest.raises(ValueError, match="TF32 planes"):
            check(pk, 32)
    model = HCFlowRescalingSpec.default_x4(**dict(TINY_RS, hidden_channels=16))
    main = perturb(model.init(0, device="cpu")["level0"]["main"])
    packed = chain3s.pack_inverse_chain3s(main)
    assert chain3s.check_pack(packed) == (torch.float32, 16)
    # the TF32 planes of every step's convs, (2, 9, cin_i / 4, n_i, 4) each, in one blob
    K, c = packed["an_s"].shape
    sizes = [2 * 9 * (chain3s.step_widths(c)[k % 2][0] + i * 16)
             * (16 if i < 4 else chain3s.step_widths(c)[k % 2][1]) for k in range(K)
             for i in range(5)]
    assert packed["blob_w"].shape == (sum(sizes),) and packed["blob_w"].dtype == torch.float32
    assert chain3s.check_pack(chain3s.pack_inverse_chain3s(main, "bfloat16"))[0] == torch.bfloat16
    del packed["blob_w"]
    with pytest.raises(ValueError, match="weight and bias blobs"):
        chain3s.check_pack(packed)


@pytest.mark.parametrize("M,cin", [(256, 64), (256, 192), (160, 64)])
def test_wide_cout32_product_from_the_planes_matches_float64(M, cin):
    """The wide float32 tile conv at 32 outputs (csrc/conv3x3.cuh ``conv_tile_f32w``):
    [W hi; W lo] times X lo, then times X hi, one 64-row product each, and the epilogue
    adds rows o and o + 32, so all four TF32 products of a split pair are summed, lo x lo
    too: within product_3xtf32's float64 bound."""
    N = 32
    a = torch.from_numpy(randn(3, (M, 9 * cin)))
    w = torch.from_numpy((randn(4, (N, cin, 3, 3)) / np.sqrt(9 * cin)).astype(np.float32))
    b = w.permute(2, 3, 1, 0).reshape(9 * cin, N)
    bh, bl = (p.permute(0, 1, 3, 2).reshape(9 * cin, N) for p in nets.pack_tf32(w))
    ah = tf32_rna(a)
    al = tf32_rna(a - ah)
    got = (al @ bh + ah @ bh) + (al @ bl + ah @ bl)
    ref = a.double() @ b.double()
    assert (got.double() - ref).abs().max().item() <= 2e-6 * ref.abs().max().item()


# ------------------------------------ the float32 tile conv's orientation, counted
def _stub_library(calls):
    """A kernel library where the card is absent: its RRDB entry points record their
    arguments and return 0; ``hcflow_rrdb_f32_wide`` the rule of csrc/conv3x3.cuh
    ``wide_f32`` (wide where [W hi; W lo] fills wgmma's 64 rows)."""
    import types

    def wide(cout):
        return int(2 * cout >= 64)

    return types.SimpleNamespace(
        hcflow_rrdb_f32_wide=wide,
        hcflow_rrdb_apply=lambda *args: calls.append(args) or 0,
        hcflow_rrdb_apply_f32=lambda *args: calls.append(args) or 0,
        hcflow_rrdb_trunk_apply_f32=lambda *args: calls.append(args) or 0)


@pytest.mark.parametrize("nf,gc,wide,narrow", [(64, 32, 15, 0), (64, 16, 3, 12), (32, 32, 15, 0),
                                               (32, 16, 3, 12), (16, 16, 0, 15), (16, 32, 12, 3)])
def test_rrdb_conv_paths_follow_the_library_rule(nf, gc, wide, narrow):
    """rrdb.conv_paths: an RRDB's 12 feature convs (gc outputs) and 3 conv5 (nf outputs)
    by the orientation the library's rule gives their width."""
    got = rrdb.conv_paths(_stub_library([]), nf, gc)
    assert got == {"f32.wide": wide, "f32.narrow": narrow}


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, to reach a wrapper's kernel branch
    with a stub library."""

    @property
    def is_cuda(self):
        return True


def test_rrdb_wrappers_count_conv_paths(monkeypatch):
    """The float32 wrappers add their convs to rrdb.conv_paths_by after each launch: a
    gc-16 RRDB 3 wide and 12 narrow, a resident trunk of nb 2 at gc 32 30 wide; the plain
    path on the CPU and a bf16 launch count nothing."""
    import types

    calls = []
    lib = _stub_library(calls)
    monkeypatch.setattr(rrdb._build, "load", lambda name, fn, argtypes: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    for name in ("launches_by", "trunk_launches_by", "conv_paths_by"):
        monkeypatch.setattr(rrdb, name, {})

    def card(tree):
        if isinstance(tree, dict):
            return {k: card(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [card(v) for v in tree]
        return tree.as_subclass(_OnCard)

    x = torch.from_numpy(randn(5, (1, 8, 16, 64)))
    narrow = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(2), 1, 64, 16))
    wide = perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(3), 2, 64, 32))
    with torch.no_grad():
        rrdb.rrdb_apply(rrdb.pack_rrdb(narrow[0]), x)  # the plain path
        assert rrdb.conv_paths_by == {} and not calls
        rrdb.rrdb_apply(card(rrdb.pack_rrdb(narrow[0])), x.as_subclass(_OnCard))
        assert rrdb.conv_paths_by == {"f32.wide": 3, "f32.narrow": 12}
        rrdb.trunk_apply_resident(card(rrdb.pack_rrdb_trunk(wide, resident=True)),
                                  x.as_subclass(_OnCard))
        assert rrdb.conv_paths_by == {"f32.wide": 33, "f32.narrow": 12}
        rrdb.rrdb_apply(card(rrdb.pack_rrdb(narrow[0], "bfloat16")), x.as_subclass(_OnCard))
    assert len(calls) == 3  # a bf16 RRDB runs no float32 conv
    assert rrdb.conv_paths_by == {"f32.wide": 33, "f32.narrow": 12}
    assert rrdb.launches_by == {"f32": 16, "bf16": 16} and rrdb.trunk_launches_by == {"f32": 1}
