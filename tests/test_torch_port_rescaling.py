"""The port's x4 rescaling serving path against the JAX package on the CPU.

Small rescaling topology (K (4, 4) with 2 split-off steps, hidden 8, so_hidden 8,
RRDB nb (1, 1), nf 8, gc 8), HR 16 x 24, batch 2.  Params come from the port's inits,
perturbed with numpy noise from a seed, and go to the JAX package in its own layout
(``to_jax``: the alternating main chains stay lists of per-step dicts); inputs and
latents are numpy arrays made from a seed.  Every JAX call is jitted; the Pallas
chain3s kernel runs in interpret mode, as tests/test_pallas_chain3s.py runs it.

Tolerances (stated beside each test's constants):

- float32: the same arithmetic summed in another order, 2e-5 on single ops, 1e-4
  through the whole model;
- bf16 recipe against the JAX plain path: the port's plain path rounds each net
  conv's OUTPUT through bf16, as hcflow_tpu/ops/nets.py:48-55 asks, and XLA on the
  CPU keeps it in float32, so an output can land a bf16 step (2^-8 = 3.9e-3
  relative) apart: 5e-3 on single ops, 1e-2 through the whole model;
- chain3s's plain version against the Pallas kernel: both round only the conv
  OPERANDS to bf16 and sum in float32: 2e-5 in float32 (the JAX test's own figure;
  measured worst 1.7e-6); 1e-3 in bf16, where a feature summed in another order can
  round the other way, a bf16 step carried damped through the chain (measured worst
  4.3e-4 on values up to 4.4).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcflow_tpu.flow.conditional import ConditionalFlowSpec as JConditionalFlowSpec
from hcflow_tpu.flow.flowstep import FlowStepSpec as JFlowStepSpec
from hcflow_tpu.models.hcflow_rescaling import HCFlowRescalingSpec as JHCFlowRescalingSpec
from hcflow_tpu.ops import coupling as jcoupling
from hcflow_tpu.ops import nets as jnets
from hcflow_tpu.ops import pallas_chain3s as p3
from hcflow_tpu.ops import squeeze as jsqueeze
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.flow.conditional import ConditionalFlowSpec
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.models import HCFlowRescalingSpec, quantize
from hcflow_tpu_torch.ops import chain, chain3s, coupling, nets, rrdb, squeeze

from _torch_port_util import assert_close, perturb, randn, to_jax

F32, BF16 = 2e-5, 5e-3  # single ops: float32; bf16 recipe vs the JAX plain path
RECIPES = [(None, F32), ("bfloat16", BF16)]
# the whole model (measured worst: float32 3.8e-6, bf16 3.2e-3 on HR values up to 3.9)
MODEL_TOL = {None: 1e-4, "bfloat16": 1e-2}
EPS_SCALE = 0.3  # latents at 0.3: random weights would send most of HR out of [0, 1]
PALLAS_TOL = {None: 2e-5, "bfloat16": 1e-3}  # chain3s plain version vs the Pallas kernel
TINY_RS = dict(K=(4, 4), after_splitoff=(2, 2), hidden_channels=8, so_hidden_channels=8,
               rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=8)
B, HH, HW = 2, 16, 24  # non-square HR; LR is 4 x 6


def _t(a):
    return torch.from_numpy(np.array(a))


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------- Haar squeeze
def test_haar_squeeze_round_trip_and_jax():
    # integers: every sum and the 1/4 scale are exact, so the round trip is exact
    xi = np.random.default_rng(0).integers(-8, 9, (2, 4, 6, 5)).astype(np.float32)
    assert torch.equal(squeeze.haar_unsqueeze2d(squeeze.haar_squeeze2d(_t(xi))), _t(xi))
    x = randn(1, (2, 4, 6, 5))
    assert_close(squeeze.haar_squeeze2d(_t(x)), jsqueeze.haar_squeeze2d(jnp.asarray(x)), 1e-6)
    y = randn(2, (2, 2, 3, 20))
    assert_close(squeeze.haar_unsqueeze2d(_t(y)), jsqueeze.haar_unsqueeze2d(jnp.asarray(y)), 1e-6)


# ---------------------------------------------------------------- DenseBlock net
@pytest.mark.parametrize("cd,tol", RECIPES)
def test_dense_block_matches_jax(cd, tol):
    params = perturb(nets.init_dense_block(_g(1), 5, 6, 8))
    x = randn(3, (2, 5, 7, 5))
    assert_close(nets.apply_dense_block(params, _t(x), cd),
                 jnets.apply_dense_block(to_jax(params), x, cd), tol, tol)


# ------------------------------------------------- Affine3shift coupling, flow step
def _rs_step(lr_vs_others, cd, perm="none"):
    kw = dict(in_channels=12, hidden_channels=8, compute_dtype=cd, flow_permutation=perm,
              flow_coupling="Affine3shift", nn_module="DenseBlock", lr_vs_others=lr_vs_others)
    return FlowStepSpec(**kw), JFlowStepSpec(**kw)


@pytest.mark.parametrize("lr_vs_others", [True, False])
@pytest.mark.parametrize("cd,tol", RECIPES)
def test_affine3shift_matches_jax(cd, tol, lr_vs_others):
    spec, jspec = _rs_step(lr_vs_others, cd)
    cs, jcs = spec.coupling_spec, jspec.coupling_spec
    p = perturb(cs.init(_g(2)))
    jp = to_jax(p)
    z, ld = randn(4, (2, 5, 6, 12)), np.zeros(2, np.float32)
    out, ldo = cs.forward(p, _t(z), None, _t(ld))
    jout, jldo = jcs.forward(jp, z, None, ld)
    assert_close(out, jout, tol, tol)
    assert_close(ldo, jldo, 1e-4, tol)
    inv, ldi = cs.inverse(p, _t(z), None, _t(ld))
    jinv, jldi = jcs.inverse(jp, z, None, ld)
    assert_close(inv, jinv, tol, tol)
    assert_close(ldi, jldi, 0)  # the Affine3shift inverse adds nothing to logdet
    assert_close(cs.inverse(p, out)[0], z, 1e-5, 1e-5)  # forward then inverse


@pytest.mark.parametrize("lr_vs_others", [True, False])
def test_flowstep_forward_without_permutation_matches_jax(lr_vs_others):
    spec, jspec = _rs_step(lr_vs_others, None)
    p = perturb(spec.init(_g(3)))
    assert "invconv" not in p
    z, ld = randn(5, (2, 5, 6, 12)), np.zeros(2, np.float32)
    out, ldo = spec.forward(p, _t(z), None, _t(ld))
    jout, jldo = jspec.forward(to_jax(p), z, None, ld)
    assert_close(out, jout, F32, F32)
    assert_close(ldo, jldo, 1e-4, F32)
    assert_close(spec.inverse(p, out)[0], z, 1e-5, 1e-5)


def test_invconv_step_forward_and_hoisted_match_jax():
    """The split-off steps' forward (invconv, Affine, FCN), plain and hoisted."""
    kw = dict(in_channels=6, cond_channels=16, hidden_channels=8)
    spec, jspec = FlowStepSpec(**kw), JFlowStepSpec(**kw)
    p = perturb(spec.init(_g(4)))
    jp = to_jax(p)
    z, u, uc = randn(6, (2, 5, 6, 6)), randn(7, (2, 5, 6, 16)), randn(8, (2, 5, 6, 8))
    ld = np.zeros(2, np.float32)
    out, ldo = spec.forward(p, _t(z), _t(u), _t(ld))
    jout, jldo = jspec.forward(jp, z, u, ld)
    assert_close(out, jout, F32, F32)
    assert_close(ldo, jldo, 1e-4, F32)
    assert_close(spec.forward_hoisted(p, _t(z), _t(uc))[0],
                 jspec.forward_hoisted(jp, z, uc)[0], F32, F32)


# --------------------------------------------------------- conditional, sr=False
@pytest.mark.parametrize("cd,tol", RECIPES)
def test_rescaling_conditional_matches_jax(cd, tol):
    kw = dict(num_channels=12, num_channels_split=6, n_flow_step=2, num_levels_condition=1,
              sr=False, rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=8, hidden_channels=8,
              compute_dtype=cd)
    spec, jspec = ConditionalFlowSpec(**kw), JConditionalFlowSpec(**kw)
    assert spec.cond_channels == jspec.cond_channels == 8
    p = perturb(spec.init(_g(5)), scale=0.02)
    jp = to_jax(p)
    u, a, eps = randn(9, (2, 5, 6, 14)), randn(10, (2, 5, 6, 6)), randn(11, (2, 5, 6, 6))
    assert_close(spec.cond_feature(p, _t(u)), jspec.cond_feature(jp, u), tol, tol)
    # the prior's logscale is clamped in rescaling mode
    mean, logs = spec._prior(p, spec.cond_feature(p, _t(u)))
    jmean, jsecond = jspec._prior(jp, jspec.cond_feature(jp, u))
    assert_close(mean, jmean, tol, tol)
    assert_close(logs, jcoupling._clamp_logscale(jsecond), tol, tol)
    fake_z, cond = spec.forward(p, _t(a), _t(u))
    jfake_z, jcond = jspec.forward(jp, a, u, np.zeros(2, np.float32))
    assert_close(fake_z, jfake_z, tol, tol)
    assert_close(cond, jcond, tol, tol)
    z, _ = spec.reverse(p, _t(u), 1.0, eps=_t(eps))
    jz, _ = jspec.reverse(jp, jax.random.PRNGKey(0), u, 1.0, eps=eps)
    assert_close(z, jz, tol, tol)


# -------------------------------------------------------------------------- chain3s
def _chain(c, K, cd, seed=6):
    specs = [FlowStepSpec(in_channels=c, hidden_channels=8, compute_dtype=cd,
                          flow_permutation="none", flow_coupling="Affine3shift",
                          nn_module="DenseBlock", lr_vs_others=(k % 2 == 0)) for k in range(K)]
    steps = perturb([s.init(_g(seed + k)) for k, s in enumerate(specs)])
    jspecs = [JFlowStepSpec(**dataclasses.asdict(s)) for s in specs]
    return specs, jspecs, steps


@pytest.mark.parametrize("c,K", [(12, 4), (24, 3)])  # both level widths; even and odd K
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_chain3s_plain_matches_pallas_and_step_loop(cd, c, K):
    H, W = 5, 6
    specs, jspecs, steps = _chain(c, K, cd)
    jsteps = to_jax(steps)
    assert isinstance(jsteps, list)  # heterogeneous steps stay a list, as in JAX
    z = randn(12, (2, H, W, c))
    ld = np.zeros(2, np.float32)

    packed = chain3s.pack_inverse_chain3s(steps, cd)
    out, ld_delta = chain3s.inverse_chain(packed, _t(z))
    # the Pallas kernel in interpret mode, on weights packed by the JAX package
    jspec = p3.Chain3sSpec(K=K, c=c, gc=8, H=H, W=W, compute_dtype=cd)
    jpacked = p3.pack_inverse_chain3s(jspec, jsteps)
    pallas = jax.jit(lambda pk, x: p3.inverse_chain(jspec, pk, x, interpret=True))
    jout, jld = pallas(jpacked, z)
    assert_close(out, jout, PALLAS_TOL[cd], PALLAS_TOL[cd])
    assert_close(ld_delta, jld, 1e-4, 1e-6)

    # the JAX unrolled step loop (flow/flownet.py:193-195), the chain's oracle
    def loop(ps, x, l):
        for k in reversed(range(K)):
            x, l = jspecs[k].inverse(ps[k], x, None, l)
        return x, l

    ref, ld_ref = jax.jit(loop)(jsteps, z, ld)
    tol = F32 if cd is None else BF16
    assert_close(out, ref, tol, tol)
    assert_close(_t(ld) + ld_delta, ld_ref, 1e-4, 1e-6)
    # and the port's own plain step loop, which the model runs when not packed; in bf16
    # it rounds every conv output, so up to a bf16 step per flow step (measured worst
    # 7.3e-3 at K 3 on values up to 5.1)
    plain = _t(z)
    for k in reversed(range(K)):
        plain = specs[k].inverse(steps[k], plain)[0]
    assert_close(plain, ref, tol * (1 if cd is None else K), tol)


def test_chain3s_packing_layout():
    """Net inputs and conv5 outputs are zero-padded to 16 channels, and the growth 8 to
    16 (zero outputs of conv1-4, zero rows where the later convs read them); the even
    conv5's outputs go from the cross split to [shift | scale]; the float32 pack holds
    the weights K-major ([tap][co][ci]), read as [tap][ci][co] through nets.taps."""
    _, _, steps = _chain(12, 3, None)
    packed = chain3s.pack_inverse_chain3s(steps)
    assert packed["we1"].shape == (2, 9, 16, 16) and packed["we1"].is_contiguous()
    packed = {k: nets.taps(v) if k[0] == "w" else v for k, v in packed.items()}
    assert packed["we1"].shape == (2, 9, 16, 16) and packed["wo1"].shape == (1, 9, 16, 16)
    assert packed["we2"].shape == (2, 9, 32, 16)
    assert not packed["we1"][..., 8:].any() and not packed["be1"][:, 8:].any()
    assert packed["we5"].shape == (2, 9, 80, 32) and packed["wo5"].shape == (1, 9, 80, 16)
    w5 = steps[2]["coupling"]["f"]["conv5"]["w"]  # step 2 = even index 1; (18, 3 + 32, 3, 3)
    tap4 = packed["we5"][1, 4]  # centre tap, (cin_pad + 4 padded gc, 32)
    feats = tap4[16:].reshape(4, 16, 32)  # x1..x4, each 8 real rows and 8 zero rows
    assert torch.equal(tap4[:3, :9], w5[0::2, :3, 1, 1].T)  # shifts from the input rows
    assert torch.equal(feats[:, :8].reshape(32, 32)[:, 9:18], w5[1::2, 3:, 1, 1].T)  # scales
    assert not tap4[3:16].any() and not tap4[:, 18:].any()  # the padding is zero
    assert not feats[:, 8:].any()
    logs = torch.stack([s["actnorm"]["logs"] for s in steps])
    assert torch.allclose(packed["an_s"], torch.exp(-logs)) and torch.isclose(
        packed["logsum"], logs.sum())


# ----------------------------------------------------------------- the whole slice
@functools.lru_cache(maxsize=None)
def _case(cd):
    """The port model, its params read back from the JAX tree, the inputs, and the
    JAX package's forward and reverse (jitted) on the same params."""
    model = HCFlowRescalingSpec.default_x4(compute_dtype=cd, **TINY_RS)
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    assert isinstance(jp["level0"]["main"], list) and isinstance(jp["level1"]["cond"]["steps"],
                                                                 dict)
    params = params_from_jax(jp, model, device="cpu")
    jmodel = JHCFlowRescalingSpec.default_x4(compute_dtype=cd, **TINY_RS)
    hr = np.random.default_rng(1).uniform(size=(B, HH, HW, 3)).astype(np.float32)
    eps = [EPS_SCALE * randn(2, (B, HH // 2, HW // 2, 6)),
           EPS_SCALE * randn(3, (B, HH // 4, HW // 4, 21))]
    jlr, jzs = jax.jit(jmodel.forward)(jp, hr)
    lr = np.asarray(jlr)
    reverse = jax.jit(lambda p, x, e: jmodel.flow.reverse_flow(
        p, jax.random.PRNGKey(4), x, 1.0, eps_list=e))
    jhr = np.asarray(reverse(jmodel.flow.precompute_inference(jp), lr, eps))
    ref = dict(lr=lr, fake_zs=[np.asarray(f) for f in jzs], hr=jhr)
    return model, params, jp, hr, eps, ref


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_forward_matches_jax(cd):
    model, params, _, hr, _, ref = _case(cd)
    tol = MODEL_TOL[cd]
    lr, fake_zs = model.forward(params, _t(hr))
    assert lr.shape == (B, HH // 4, HW // 4, 3)
    assert ((ref["lr"] > 0) & (ref["lr"] < 1)).mean() > 0.5  # mostly not clamped
    assert_close(lr, ref["lr"], tol)
    for fz, jfz in zip(fake_zs, ref["fake_zs"]):
        assert fz.shape == jfz.shape
        assert_close(fz, jfz, tol)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_reverse_matches_jax(cd):
    """reverse_flow with explicit latents, before the clamp, and the clamped reverse."""
    model, params, _, _, eps, ref = _case(cd)
    assert ((ref["hr"] > 0) & (ref["hr"] < 1)).mean() > 0.3  # not mostly clamped
    lr, eps = _t(ref["lr"]), [_t(e) for e in eps]
    for fused in (True, False):
        pp = model.flow.precompute_inference(params, fused=fused)
        # chain3s and the RRDB kernels take bf16 and float32, so both recipes pack for
        # them, as JAX's fused="all" does for the trunks (TINY_RS's nf and gc of 8 pass
        # its gate)
        assert ("main3s_fused" in pp["level0"]) == fused and "main_fused" not in pp["level0"]
        assert ("trunk0_fused" in pp["level1"]["cond"]) == fused
        assert_close(model.flow.reverse_flow(pp, lr, 1.0, eps_list=eps), ref["hr"], MODEL_TOL[cd])
        out = model.reverse(pp, lr, 1.0, eps_list=eps)
        assert out.shape == (B, HH, HW, 3)
        assert_close(out, np.clip(ref["hr"], 0, 1), MODEL_TOL[cd])


# Round trip HR -> (LR, fake_zs) -> HR before the clamp and the quantization.  float32:
# exact up to float32 rounding (measured worst 5.4e-7).  bf16 recipe: the inverse
# recomputes each net's input only to float32 rounding, and an input on the other side
# of a bf16 rounding boundary moves that net's output by a bf16 step; the fused path's
# kernel versions also do not round the net outputs through bf16 as the forward does
# (measured worst 5.6e-4 plain, 1.5e-3 fused).
ROUND_TRIP_TOL = {None: 1e-5, "bfloat16": 5e-3}


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_round_trip_reproduces_hr(cd):
    model, params, _, hr, _, _ = _case(cd)
    z, fake_zs = model.flow.normal_flow(params, _t(hr))
    for fused in (False, True):
        pp = model.flow.precompute_inference(params, fused=fused)
        back = model.flow.reverse_flow(pp, z, 1.0, eps_list=fake_zs)
        assert_close(back, hr, ROUND_TRIP_TOL[cd])


def test_params_from_jax_reads_the_jax_tree():
    """params_from_jax inverts to_jax: every tensor comes back unchanged, the main
    chains as lists of per-step dicts (their steps differ in shape)."""
    model = HCFlowRescalingSpec.default_x4(**TINY_RS)
    params = perturb(model.init(0, device="cpu"))
    back = params_from_jax(to_jax(params), model, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) == jax.tree.structure(
        jax.tree.map(np.asarray, back))
    for (path, a), (_, b) in zip(flat(params), flat(back)):
        assert torch.equal(a, b), path
    assert back["level1"]["main"][0]["coupling"]["f"]["conv1"]["w"].shape == (8, 3, 3, 3)
    assert back["level1"]["main"][1]["coupling"]["f"]["conv1"]["w"].shape == (8, 21, 3, 3)


def test_serving_protocol_heat_and_counters():
    """Downscale, quantize, upscale from generator draws: heat 0 is deterministic,
    heat 1 differs by seed; on the CPU no kernel launch is counted."""
    model, params, _, hr, _, _ = _case("bfloat16")
    pp = model.flow.precompute_inference(params, fused=True)
    for counts in (rrdb.launches_by, chain.launches_by, chain3s.launches_by):
        counts.clear()
    lr, _ = model.forward(params, _t(hr))
    lq = quantize(lr)
    assert torch.equal(lq * 255, torch.round(lq * 255)) and (lq - lr).abs().max() <= 0.5 / 255

    def run(heat, seed):
        return model.reverse(pp, lq, heat, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0.0, 1), run(0.0, 2))
    a, b = run(1.0, 1), run(1.0, 2)
    assert torch.isfinite(a).all() and not torch.equal(a, b) and torch.equal(a, run(1.0, 1))
    assert a.min() >= 0 and a.max() <= 1
    assert not (rrdb.launches_by or chain.launches_by or chain3s.launches_by)
    assert coupling.clamp_logscale(torch.tensor(1e9)) < 0.5  # the bounded prior scale
