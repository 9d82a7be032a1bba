"""Serving packs at widths the card's kernels do not hold an instance for, on the CPU.

The chain, chain3s and RRDB kernels are built at a few widths (chain: coupling width 32
or 64; chain3s: growth 16, 32 or 64; RRDB: nf and gc 16, 32 or 64).  The JAX package
packs its TPU kernels at any coupling width and at growths, nf and gc that are
multiples of 8, so the port packs the same chains and trunks zero-padded up to the
kernels' next width, and on the card leaves past the widest ones on the plain path
(``chain.packs``, ``chain3s.packs``, ``rrdb.packs_trunk``, all of them
``FlowNetSpec.kernel_packs``).  Here:

- each padded pack through the port's plain version against the JAX oracle at the
  original width: the chain against ``flow/stack.py``'s ``inverse_stack`` /
  ``inverse_stack_hoisted``, chain3s against the JAX step loop, the RRDB trunk (per
  RRDB and resident) against ``ops/nets.py``'s ``apply_rrdb_trunk``.  Tolerances as in
  tests/test_torch_port_kernels.py: 1e-4 in float32 (the same arithmetic summed in
  another order), 5e-3 in bf16 (a bf16 step, 2^-8 relative, where the two round a sum
  the other way);
- whole models in their float32 recipe (the shipped test configs set no compute_dtype)
  against JAX at the same weights (``convert.params_from_jax``) and latents, 1e-4: the
  ``configs/smoke_train.yml`` model against JAX's ``fused="all"`` reverse (its Pallas
  chain kernel in interpret mode, as the JAX package's own tests run it on the CPU);
  ``default_x4(hidden_channels=24)`` and ``for_scale(4, hidden_channels=48)``, cut to
  a few steps and one RRDB, against JAX's plain reverse (the XLA step loop: interpret
  mode takes 10-13 s a model on the CPU); each model's packs on the CPU are JAX's
  ``fused="all"`` packs (chain3s's rollout gate ``pallas_chain3s.ENABLED`` on; its
  packers stubbed, as :func:`_jax_fused_all_packs` says);
- the card's choices, read without a card (``kernel_packs("cuda")``), and the packs at
  the shipped widths bit for bit as they were before padding existed.

tests/test_torch_port_cuda.py runs the padded kernels themselves on a card.
"""

import dataclasses
import functools
import hashlib
from unittest import mock
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hcflow_tpu.flow import stack as jstack
from hcflow_tpu.flow.flowstep import FlowStepSpec as JFlowStepSpec
from hcflow_tpu.models.hcflow_rescaling import HCFlowRescalingSpec as JHCFlowRescalingSpec
from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec
from hcflow_tpu.ops import nets as jnets
from hcflow_tpu.ops import pallas_chain3s as p3
from hcflow_tpu.utils import config as jconfig
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.flow import stack
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
from hcflow_tpu_torch.ops import chain, chain3s, nets, rrdb
from hcflow_tpu_torch.utils import config

from _torch_port_util import assert_close, jax_run, perturb, randn, to_jax

TOL = {None: 1e-4, "bfloat16": 5e-3}
SMOKE = str(Path(__file__).resolve().parents[1] / "configs/smoke_train.yml")
PACKS = ("main_fused", "main3s_fused", "steps_fused", "trunk0_fused", "trunk1_fused")


def _packs(params: dict, L: int) -> dict:
    return {lv: {k for k in PACKS if k in params[f"level{lv}"] or k in params[f"level{lv}"]["cond"]}
            for lv in range(L)}


# ---------------------------------------------------------------- padded kernels
@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("cond", [False, True])
@pytest.mark.parametrize("hid", [8, 12, 24, 48])
def test_padded_chain_matches_jax_stack(hid, cond, cd):
    """A chain at coupling width hid, packed at 32 or 64, with its cond terms padded
    (chain.pad_uc), against JAX's step loop at hid."""
    c, K, H, W, cond_ch = 12, 2, 5, 6, 8
    spec = FlowStepSpec(in_channels=c, cond_channels=cond_ch if cond else None,
                        hidden_channels=hid, compute_dtype=cd)
    jspec = JFlowStepSpec(**dataclasses.asdict(spec))
    steps = stack.precompute_invconv(perturb(stack.init_stack(spec, torch.Generator(), K)))
    packed = chain.pack_inverse_chain(steps, cd, padded=True)
    assert packed["w2"].shape[1:] == (chain.padded_hid(hid),) * 2 == ((32 if hid <= 32 else 64),) * 2
    z = randn(2, (2, H, W, c))
    zeros = np.zeros(2, np.float32)
    if cond:
        u = randn(3, (2, H, W, cond_ch))
        ref = jstack.inverse_stack_hoisted(jspec, to_jax(steps), z, u, zeros)[0]
        uc = chain.pad_uc(packed, stack.compute_u_contribs(spec, steps, torch.from_numpy(u)))
    else:
        ref = jstack.inverse_stack(jspec, to_jax(steps), z, None, zeros)[0]
        uc = None
    assert_close(chain.inverse_chain(packed, torch.from_numpy(z), uc), ref, TOL[cd], TOL[cd])


def test_padded_chain_refuses_unpadded_cond_terms():
    """The cond terms of a padded pack must come in its layout: the hoisted conv's
    hid-wide terms raise, naming pad_uc."""
    spec = FlowStepSpec(in_channels=6, cond_channels=8, hidden_channels=8)
    steps = stack.precompute_invconv(perturb(stack.init_stack(spec, torch.Generator(), 2)))
    packed = chain.pack_inverse_chain(steps, padded=True)
    uc = stack.compute_u_contribs(spec, steps, torch.from_numpy(randn(4, (1, 4, 4, 8))))
    with pytest.raises(ValueError, match="pad_uc"):
        chain.inverse_chain(packed, torch.zeros(1, 4, 4, 6), uc)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("gc", [8, 24, 48])
def test_padded_chain3s_matches_jax_step_loop(gc, cd):
    """An alternating Affine3shift chain of growth gc, packed at 16, 32 or 64, against
    JAX's step loop at gc (hcflow_tpu/flow/flownet.py's unrolled inverse)."""
    c, K, H, W = 12, 3, 5, 6
    specs = [FlowStepSpec(in_channels=c, hidden_channels=gc, compute_dtype=cd,
                          flow_permutation="none", flow_coupling="Affine3shift",
                          nn_module="DenseBlock", lr_vs_others=(k % 2 == 0)) for k in range(K)]
    jspecs = [JFlowStepSpec(**dataclasses.asdict(s)) for s in specs]
    steps = perturb([s.init(torch.Generator().manual_seed(6 + k)) for k, s in enumerate(specs)])
    packed = chain3s.pack_inverse_chain3s(steps, cd)
    assert chain3s.check_pack(packed) == (nets.net_dtype(cd), chain3s.padded_growth(gc))
    z = randn(12, (2, H, W, c))

    def loop(ps, x, ld):
        for k in reversed(range(K)):
            x, ld = jspecs[k].inverse(ps[k], x, None, ld)
        return x, ld

    ref, ld_ref = jax_run(loop, to_jax(steps), z, np.zeros(2, np.float32))
    out, ld = chain3s.inverse_chain(packed, torch.from_numpy(z))
    assert_close(out, ref, TOL[cd], TOL[cd])
    assert_close(ld.expand(2), ld_ref, 1e-4, 1e-6)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("nf,gc,nb", [(24, 8, 2), (32, 24, 1), (48, 40, 1)])
def test_padded_rrdb_trunk_matches_jax(nf, gc, nb, cd):
    """A trunk of nb RRDBs at (nf, gc), packed at (32, 16), (32, 32) and (64, 64), per
    RRDB and resident, through trunk_apply (its input padded and its output cut once)
    against JAX's apply_rrdb_trunk at (nf, gc)."""
    trunk = perturb(nets.init_rrdb_trunk(torch.Generator(), nb, nf, gc))
    x = randn(5, (2, 5, 6, nf))
    ref = jax_run(lambda p, a: jnets.apply_rrdb_trunk(p, a, cd), to_jax(trunk), x)
    nfp, gcp = rrdb.padded_widths(nf, gc)
    assert rrdb.takes(nfp, gcp) and (nfp, gcp) != (nf, gc)
    for resident in (False, True):
        packed = rrdb.pack_rrdb_trunk(trunk, cd, resident=resident)
        out = rrdb.trunk_apply(packed, torch.from_numpy(x))
        assert out.shape == x.shape
        assert_close(out, ref, TOL[cd], TOL[cd])


# ------------------------------------------------------------------- whole models
def _smoke():
    return (config.model_spec_from_opt(config.load_yaml(SMOKE)),
            jconfig.model_spec_from_opt(jconfig.load_yaml(SMOKE)), 0.9)


def _rescaling24():  # its split-off chains at 24 too, trunks at nf 24, gc 8
    kw = dict(K=(4, 4), after_splitoff=(2, 2), rrdb_nb=(1, 1), hidden_channels=24,
              so_hidden_channels=24, rrdb_nf=24, rrdb_gc=8)
    return HCFlowRescalingSpec.default_x4(**kw), JHCFlowRescalingSpec.default_x4(**kw), 1.0


def _sr48():  # trunks at nf 24, gc 24
    kw = dict(K=(4, 4), after_splitoff=(2, 2), rrdb_nb=(1, 1), hidden_channels=48,
              so_hidden_channels=48, rrdb_nf=24, rrdb_gc=24)
    return HCFlowSRSpec.for_scale(4, **kw), JHCFlowSRSpec.for_scale(4, **kw), 0.9


def _rescaling_l3():
    kw = dict(L=3, K=(4, 4, 4), after_splitoff=(2, 2, 2), rrdb_nb=(1, 1, 1),
              so_hidden_channels=16, rrdb_nf=16, rrdb_gc=8)
    return HCFlowRescalingSpec.default_x4(**kw), JHCFlowRescalingSpec.default_x4(**kw), 1.0


# the models cut to a few steps, one RRDB a trunk and narrow encoders, at the widths
# that matter: the smoke config's hid 8, growth 24, hid 48, and a third level of c 48
MODELS = {"smoke": _smoke, "rescaling24": _rescaling24, "sr48": _sr48,
          "rescaling_l3": _rescaling_l3}
# and at their published widths and depths, whose packs the card's choices are read for
FULL = {"rescaling24": lambda: HCFlowRescalingSpec.default_x4(hidden_channels=24),
        "sr48": lambda: HCFlowSRSpec.for_scale(4, hidden_channels=48),
        "rescaling_l3": lambda: HCFlowRescalingSpec.default_x4(
            L=3, K=(4, 4, 4), after_splitoff=(2, 2, 2), rrdb_nb=(1, 1, 1))}


@functools.lru_cache(maxsize=None)
def _case(name):
    """The port model, its params read back from the JAX tree, the JAX model and
    params, and the heat the model serves at."""
    model, jmodel, heat = MODELS[name]()
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    return model, params_from_jax(jp, model, device="cpu"), jmodel, jp, heat


def _jax_fused_all_packs(jmodel, jp) -> dict:
    """The packs JAX's precompute_inference(fused="all") attaches, by level, with
    chain3s's rollout gate on: its gates run as they are, its packers and its invconv
    precompute are stubbed (they make the arrays, not the choice), which saves their
    eager compiles (7-14 s a model on the CPU)."""
    from hcflow_tpu.flow import stack as jstack_mod
    from hcflow_tpu.ops import pallas_chain, pallas_rdb

    def stub(*args, **kwargs):
        return {}

    with mock.patch.object(p3, "ENABLED", True), \
            mock.patch.object(p3, "pack_inverse_chain3s", stub), \
            mock.patch.object(pallas_chain, "pack_inverse_chain", stub), \
            mock.patch.object(pallas_rdb, "pack_rrdb_trunk", stub), \
            mock.patch.object(jstack_mod, "_augment_invconv", lambda steps, **kw: steps):
        return _packs(jmodel.flow.precompute_inference(jp, fused="all"), len(jmodel.flow.levels))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_cpu_packs_are_jax_fused_all_packs(name):
    """On the CPU the port packs, level for level, what JAX's fused="all" packs, every
    chain and trunk at any width it takes, padded."""
    model, params, jmodel, jp, _ = _case(name)
    pp = model.flow.precompute_inference(params, fused=True)
    want = _jax_fused_all_packs(jmodel, jp)
    assert _packs(pp, model.flow.L) == want == model.flow.kernel_packs("cpu")


@pytest.mark.parametrize("name,fused", [("smoke", True), ("rescaling24", False),
                                        ("sr48", False)])
def test_padded_model_matches_jax(name, fused):
    """The port's fused reverse (padded packs through the kernels' plain versions) in
    the float32 recipe against JAX's reverse under the same latents: its fused "all"
    reverse (Pallas in interpret mode) for the smoke model, its plain reverse for the
    others."""
    model, params, jmodel, jp, heat = _case(name)
    B, LH, LW = 2, 4, 6
    lr = np.random.default_rng(1).uniform(size=(B, LH, LW, 3)).astype(np.float32)
    eps = [0.3 * randn(2 + lv.level, (B, LH * 2 ** (model.flow.L - 1 - lv.level),
                                      LW * 2 ** (model.flow.L - 1 - lv.level),
                                      lv.cond_spec.a_channels)) for lv in model.flow.levels]
    ref = np.asarray(jax_run(lambda p, x, e: jmodel.flow.reverse_flow(
        jmodel.flow.precompute_inference(p, fused="all" if fused else False),
        jax.random.PRNGKey(4), x, heat, eps_list=e), jp, lr, eps))
    assert ((ref > 0) & (ref < 1)).mean() > 0.3  # mostly not saturated by the clamp
    pp = model.flow.precompute_inference(params, fused=True)
    assert _packs(pp, model.flow.L) == model.flow.kernel_packs("cpu")
    with torch.no_grad():
        out = model.flow.reverse_flow(pp, torch.from_numpy(lr), heat,
                                      eps_list=[torch.from_numpy(e) for e in eps])
    assert_close(out, ref, TOL[None])


# ----------------------------------------------------------- the card's choices
ALL = {"main_fused", "steps_fused", "trunk0_fused", "trunk1_fused"}
ALL3S = {"main3s_fused", "steps_fused", "trunk0_fused", "trunk1_fused"}


CARD = {
    # hid 8 chains padded to 32; gc 4 trunks fail JAX's gate, on the card too
    "smoke": {0: {"main_fused", "steps_fused"}, 1: {"main_fused", "steps_fused"}},
    "rescaling24": {0: ALL3S, 1: ALL3S},  # growth 24 padded to 32
    "sr48": {0: ALL, 1: ALL},  # hid 48 padded to 64
    # level 2's main chain has c 48: c - 3 past chain3s's 32, so it serves plain
    "rescaling_l3": {0: ALL3S, 1: ALL3S, 2: ALL3S - {"main3s_fused"}},
}


@pytest.mark.parametrize("name,full", [(n, False) for n in MODELS] + [(n, True) for n in FULL])
def test_card_packs_every_chain_its_kernels_take(name, full):
    """What the card packs, read from the widths alone, for the models as the other
    tests cut them and at their published widths: every chain and trunk whose padded
    widths a kernel takes, so none of these models raises on the card."""
    want = CARD[name]
    model = FULL[name]() if full else MODELS[name]()[0]
    assert model.flow.kernel_packs("cuda") == want
    assert model.flow.kernel_packs(torch.device("cuda", 0), trunks=False) == {
        lv: names - {"trunk0_fused", "trunk1_fused"} for lv, names in want.items()}


def test_card_leaves_widths_past_the_kernels_plain():
    """Past the widest instance the card packs nothing and serves the plain path: a
    coupling width of 72 (chain), a growth of 72 (chain3s), nf 72 or gc 72 (RRDB); the
    CPU packs them all, as JAX does."""
    sr = HCFlowSRSpec.for_scale(4, hidden_channels=72, so_hidden_channels=72, rrdb_nf=72)
    rs = HCFlowRescalingSpec.default_x4(hidden_channels=72, so_hidden_channels=72, rrdb_gc=72)
    for model, cpu in ((sr, ALL), (rs, ALL3S)):
        assert model.flow.kernel_packs("cuda") == {0: set(), 1: set()}
        assert model.flow.kernel_packs("cpu") == {0: cpu, 1: cpu}


# (step kind, c, width, packed on the card): the kernels' limits through each predicate
@pytest.mark.parametrize("kind,c,width,card", [
    ("chain", 12, 8, True), ("chain", 12, 64, True), ("chain", 12, 65, False),
    ("chain", 64, 32, True), ("chain", 65, 32, False), ("chain", 1, 32, False),
    ("chain3s", 35, 64, True), ("chain3s", 36, 16, False), ("chain3s", 12, 72, False),
    ("chain3s", 12, 12, False)])
def test_chain_predicates_follow_the_kernel_limits(kind, c, width, card):
    """chain.packs / chain3s.packs on the CPU follow JAX's gate (any coupling width; a
    growth that is a multiple of 8), on the card also the padded widths' limit, which
    the wrappers' checks apply too (chain.takes, chain3s.takes)."""
    if kind == "chain":
        spec = FlowStepSpec(in_channels=12, hidden_channels=width)
        assert chain.packs(spec, c, width, "cpu")
        assert chain.packs(spec, c, width, "cuda") is card
        assert chain.takes(c, chain.padded_hid(width)) is card
        return
    model = HCFlowRescalingSpec.default_x4(hidden_channels=width)
    lv = dataclasses.replace(model.flow.levels[0], channels=c)
    assert chain3s.packs(lv, width, "cpu") is (width % 8 == 0)
    assert chain3s.packs(lv, width, "cuda") is card
    if width % 8 == 0 and c - 3 <= 32 and width <= 64:
        assert chain3s.takes(c, chain3s.padded_growth(width))
    else:
        with pytest.raises(ValueError, match="chain3s kernel takes"):
            chain3s._check_widths(c, chain3s.padded_growth(width))


# ------------------------------------------------ the shipped widths, bit for bit
def _fill(tree, rng):
    """Every floating-point tensor of a param tree drawn anew from rng."""
    if isinstance(tree, dict):
        return {k: _fill(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_fill(v, rng) for v in tree]
    return torch.from_numpy(np.asarray(0.1 * rng.standard_normal(tuple(tree.shape)), np.float32))


def _digest(tree) -> str:
    h = hashlib.sha256()

    def go(t):
        if isinstance(t, dict):
            for k in sorted(t):
                h.update(k.encode())
                go(t[k])
        elif isinstance(t, (list, tuple)):
            for v in t:
                go(v)
        else:
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).contiguous().view(torch.uint8).numpy().tobytes())

    go(tree)
    return h.hexdigest()[:16]


def _shipped_pack(kind, cd, a, b, resident):
    if kind == "chain":  # hid a, c b: x4's level-1 main chain (c 24) or a split-off chain
        spec = FlowStepSpec(in_channels=b, cond_channels=None if b == 24 else 16,
                            hidden_channels=a, compute_dtype=cd)
        steps = stack.precompute_invconv(stack.init_stack(spec, torch.Generator(), 2))
        return chain.pack_inverse_chain(_fill(steps, np.random.default_rng(a + b)), cd,
                                        padded=True)
    if kind == "chain3s":  # growth a, c b
        specs = [FlowStepSpec(in_channels=b, hidden_channels=a, compute_dtype=cd,
                              flow_permutation="none", flow_coupling="Affine3shift",
                              nn_module="DenseBlock", lr_vs_others=(k % 2 == 0))
                 for k in range(2)]
        steps = [s.init(torch.Generator()) for s in specs]
        return chain3s.pack_inverse_chain3s(_fill(steps, np.random.default_rng(a + b)), cd)
    trunk = nets.init_rrdb_trunk(torch.Generator(), 2, a, b)  # nf a, gc b
    return rrdb.pack_rrdb_trunk(_fill(trunk, np.random.default_rng(a + b)), cd,
                                resident=resident)


# The packs' SHA-256 prefixes as the port made them before packs were padded (at
# fdfb6b2), from the same numpy draws: x4 SR chains at hid 64 (c 21 cond, 24), x8's c 45,
# the tiny checkpoint's hid 32 (c 6); rescaling chain3s at growth 32 (c 12, 24) and 16;
# the SR and x8 trunks (64, 32), rescaling's (64, 16), the tiny checkpoint's (32, 16)
SHIPPED = {
    ("chain", "bfloat16", 64, 21, False): "35d08cd96e4c592e",
    ("chain", "bfloat16", 64, 24, False): "efc61281e05080fe",
    ("chain", "bfloat16", 64, 45, False): "9deced7782efb8d8",
    ("chain", "bfloat16", 32, 6, False): "31e0adb815e0b2ec",
    ("chain3s", "bfloat16", 32, 12, False): "780aad952172be44",
    ("chain3s", "bfloat16", 32, 24, False): "00f3d94d2bb4ad60",
    ("chain3s", "bfloat16", 16, 12, False): "8eb5e4f26bb3b3c7",
    ("rrdb", "bfloat16", 64, 32, False): "5cf87b7ce1c0cb37",
    ("rrdb", "bfloat16", 64, 32, True): "db0dc22d8bce4e0c",
    ("rrdb", "bfloat16", 64, 16, False): "d26a424f79e25f49",
    ("rrdb", "bfloat16", 64, 16, True): "12cd8cfc65238002",
    ("rrdb", "bfloat16", 32, 16, False): "e1b3eae7aaca0e67",
    ("rrdb", "bfloat16", 32, 16, True): "dee397cfe1db8eac",
    ("chain", None, 64, 21, False): "82cdbf3d53cc588d",
    ("chain", None, 64, 24, False): "01d0713411f80c0c",
    ("chain", None, 64, 45, False): "add0cec81bfa22a7",
    ("chain", None, 32, 6, False): "45c5495e04410be6",
    ("chain3s", None, 32, 12, False): "baa1c3575efef637",
    ("chain3s", None, 32, 24, False): "6dc5875039838776",
    ("chain3s", None, 16, 12, False): "16dd2f82ba5fdf39",
    ("rrdb", None, 64, 32, False): "acce1e6c38255001",
    ("rrdb", None, 64, 32, True): "83c7f9435edea6a7",
    ("rrdb", None, 64, 16, False): "03cfb732d7b73a63",
    ("rrdb", None, 64, 16, True): "a29d27993370f3d3",
    ("rrdb", None, 32, 16, False): "f8915ea0b37f1114",
    ("rrdb", None, 32, 16, True): "35e9e880a08515a3",
}


@pytest.mark.parametrize("key", sorted(SHIPPED, key=str), ids=str)
def test_shipped_widths_pack_as_before(key):
    """At the widths the shipped configs serve, padding adds nothing: each pack is bit
    for bit the one made before packs were padded."""
    assert _digest(_shipped_pack(*key)) == SHIPPED[key]
