"""The port's x8 SR serving path, its resident-trunk RRDB and its standalone conv3x3
against the JAX package on the CPU.

The x8 topology is L=3 (``for_scale(8)``): level 0 conditions on its own channels and
the cond features of levels 1 and 2 (6 + 2 x 128 channels into ``conv_first`` at full
width), level 1 on those of level 2 (12 + 128), level 2 on the LR image alone.  Here
at a small width (nf 16, gc 8, hidden 16, K 2 with 1 split-off step, RRDB nb (2, 1)),
LR 3 x 4 -> HR 24 x 32, batch 2.  Params come from the port's inits, perturbed with
numpy noise from a seed, and go to the JAX package in its own layout (``to_jax``);
the latents are numpy arrays from a seed, handed to both.  Every JAX call is jitted
and cached per recipe; Pallas kernels run in interpret mode, as the JAX package's
own tests run them.

Tolerances (beside each constant):

- the whole x8 reverse pass: float32 1e-4 (the same arithmetic summed in another
  order over 3 levels; measured worst 3.7e-6 on values up to 4.2); bf16 recipe 1e-2
  (the port's plain path rounds each net conv's output through bf16 as
  hcflow_tpu/ops/nets.py:48-55 asks, XLA on the CPU does not, and the kernels' plain
  versions round only operands: a bf16 step, 2^-8 relative, here and there, carried
  through the flow; measured worst 7.2e-3 plain, 5.5e-3 fused);
- the resident trunk's plain version against the JAX resident-trunk kernel: 2e-5,
  the JAX test's own figure (tests/test_kernel_variants.py; measured worst 2.1e-6),
  float32 recipe; in the bf16 recipe the JAX kernel rounds each RRDB's input (its
  residual base) to bf16 (``_FIT16``) and the port keeps it float32, so the bf16
  recipe is held against ``nets.apply_rrdb_trunk`` instead, at 5e-3 (a bf16 step, as
  in tests/test_torch_port_kernels.py; measured worst 1.8e-3 on values up to 5.6);
- ``conv3x3_plain`` against ``conv3x3_pallas``: both sum exact products of the same
  bf16 operands in float32, in another order: 1e-5 (measured worst 4.8e-7).
"""

import functools

import jax
import numpy as np
import pytest
import torch

from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec
from hcflow_tpu.ops import nets as jnets
from hcflow_tpu.ops import pallas_rdb as pr
from hcflow_tpu.ops.pallas_conv import conv3x3_pallas
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.models import HCFlowSRSpec
from hcflow_tpu_torch.ops import chain, conv, nets, rrdb

from _torch_port_util import assert_close, perturb, randn, to_jax

TINY8 = dict(K=(2, 2, 2), after_splitoff=(1, 1, 1), rrdb_nb=(2, 1), rrdb_nf=16, rrdb_gc=8,
             hidden_channels=16, so_hidden_channels=16)
MODEL_TOL = {None: 1e-4, "bfloat16": 1e-2}
TRUNK_TOL = {None: 2e-5, "bfloat16": 5e-3}
CONV_TOL = 1e-5
HEAT = 0.8  # the CelebA-8X test config's second heat (configs/test_SR_CelebA_8X_HCFlow.yml)
B, LH, LW = 2, 3, 4  # non-square LR; HR is 24 x 32
PATHS = [(False, False), (True, False), (True, True)]  # (fused, resident_trunk)


@functools.lru_cache(maxsize=None)
def _case(cd):
    """The port model, its params read back from the JAX tree, the LR image, the
    latents and the JAX package's x8 reverse (jitted, XLA path) before the clamp."""
    model = HCFlowSRSpec.for_scale(8, compute_dtype=cd, **TINY8)
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    params = params_from_jax(jp, model, device="cpu")
    jmodel = JHCFlowSRSpec.for_scale(8, compute_dtype=cd, **TINY8)
    lr = np.random.default_rng(1).uniform(size=(B, LH, LW, 3)).astype(np.float32)
    eps = [randn(2, (B, 4 * LH, 4 * LW, 6)), randn(3, (B, 2 * LH, 2 * LW, 12)),
           randn(4, (B, LH, LW, 45))]
    reverse = jax.jit(lambda p, x, e: jmodel.flow.reverse_flow(
        p, jax.random.PRNGKey(4), x, HEAT, eps_list=e))
    ref = np.asarray(reverse(jmodel.flow.precompute_inference(jp), lr, eps))
    return model, params, jp, torch.from_numpy(lr), [torch.from_numpy(e) for e in eps], ref


# ------------------------------------------------------------------ the x8 topology
def test_x8_topology_matches_jax():
    """for_scale(8) is the CelebA-8X model at full width: 3 levels, 13 main and 13
    split-off steps each, RRDB nb 5, and the two-level cond concat."""
    model, jmodel = HCFlowSRSpec.for_scale(8), JHCFlowSRSpec.for_scale(8)
    assert (model.flow.L, model.flow.rrdb_nb, model.flow.rrdb_nf, model.flow.rrdb_gc) == (
        3, (5, 5), 64, 32)
    got = [(lv.channels, lv.split_channels, lv.n_main, lv.cond_spec.a_channels,
            lv.cond_spec.conv_first_in, lv.cond_spec.n_flow_step) for lv in model.flow.levels]
    want = [(lv.channels, lv.split_channels, lv.n_main, lv.cond_spec.a_channels,
             lv.cond_spec.conv_first_in, lv.cond_spec.n_flow_step) for lv in jmodel.flow.levels]
    assert got == want
    assert [g[4] for g in got] == [6 + 2 * 128, 12 + 128, 3]
    assert [g[3] for g in got] == [6, 12, 45]
    with pytest.raises(NotImplementedError):
        HCFlowSRSpec.for_scale(2)


def test_params_from_jax_reads_the_three_level_tree():
    """params_from_jax inverts to_jax on the x8 tree: every tensor comes back
    unchanged, the trunks and chains as lists."""
    model, params, jp, _, _, _ = _case(None)
    assert set(jp) == {"level0", "level1", "level2"}
    assert jp["level0"]["cond"]["trunk0"]["rdb1"]["conv1"]["w"].shape[0] == 2  # stacked nb
    back = params_from_jax(jp, model, device="cpu")
    flat = jax.tree_util.tree_leaves_with_path
    assert jax.tree.structure(jax.tree.map(np.asarray, params)) == jax.tree.structure(
        jax.tree.map(np.asarray, back))
    for (path, a), (_, b) in zip(flat(params), flat(back)):
        assert torch.equal(a, b), path
    assert len(back["level2"]["cond"]["trunk0"]) == 2 and len(back["level2"]["main"]) == 1
    assert back["level0"]["cond"]["conv_first"]["w"].shape == (16, 6 + 2 * 32, 3, 3)


# ------------------------------------------------------------ the whole x8 reverse
@pytest.mark.parametrize("fused,resident", PATHS)
@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_x8_reverse_matches_jax(cd, fused, resident):
    """reverse_flow with explicit latents before the clamp, and the clamped reverse,
    on the plain path, the per-RRDB kernel path and the resident-trunk kernel path
    (the kernels' plain versions on the CPU)."""
    model, params, _, lr, eps, ref = _case(cd)
    assert ((ref > 0) & (ref < 1)).mean() > 0.3  # mostly not saturated by the clamp
    pp = model.flow.precompute_inference(params, fused=fused, resident_trunk=resident)
    for lv in range(3):
        packed = pp[f"level{lv}"]["cond"].get("trunk0_fused")
        # trunks are packed in both recipes (the RRDB kernels take bf16 and float32),
        # as JAX's fused="all" packs them (TINY8's nf 16 and gc 8 pass its gate)
        assert (packed is not None) == fused
        assert isinstance(packed, dict) == (fused and resident)
        assert ("main_fused" in pp[f"level{lv}"]) == fused
    assert_close(model.flow.reverse_flow(pp, lr, HEAT, eps_list=eps), ref, MODEL_TOL[cd])
    out = model.reverse(pp, lr, HEAT, eps_list=eps)
    assert out.shape == (B, 8 * LH, 8 * LW, 3)
    assert_close(out, np.clip(ref, 0, 1), MODEL_TOL[cd])


def test_x8_sampling_heat_and_counters():
    """Sampling from a generator on the resident-trunk path: heat 0 is deterministic,
    heat 0.8 differs by seed; on the CPU no kernel launch is counted."""
    model, params, _, lr, _, _ = _case("bfloat16")
    pp = model.flow.precompute_inference(params, fused=True, resident_trunk=True)
    for counts in (chain.launches_by, rrdb.launches_by, rrdb.trunk_launches_by):
        counts.clear()
    conv.launches = 0

    def run(heat, seed):
        return model.reverse(pp, lr, heat, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0.0, 1), run(0.0, 2))
    a, b = run(HEAT, 1), run(HEAT, 2)
    assert torch.isfinite(a).all() and not torch.equal(a, b) and torch.equal(a, run(HEAT, 1))
    assert a.min() >= 0 and a.max() <= 1
    assert not (chain.launches_by or rrdb.launches_by or rrdb.trunk_launches_by)
    assert conv.launches == 0


# --------------------------------------------------------------- resident trunk
def _trunk(nb, nf, gc, seed=1):
    return perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(seed), nb, nf, gc))


@pytest.fixture
def resident_jax(monkeypatch):
    """The JAX package's packing in resident-trunk mode (HCFLOW_RDB_TRUNK=1), with the
    lru cache of ``_build_call_trunk`` cleared around the run, as
    tests/test_kernel_variants.py does."""
    monkeypatch.setattr(pr, "_TRUNK", True)
    pr._build_call_trunk.cache_clear()
    yield
    pr._build_call_trunk.cache_clear()


@pytest.mark.parametrize("nb", [1, 3])
def test_resident_trunk_plain_matches_pallas_trunk(resident_jax, nb):
    nf, gc, H, W = 64, 32, 5, 7
    trunk = _trunk(nb, nf, gc)
    x = randn(5, (2, H, W, nf))
    spec = pr.RDBSpec(nf=nf, gc=gc, H=H, W=W)
    jpacked = pr.pack_rrdb_trunk(spec, to_jax(trunk))
    assert isinstance(jpacked, dict) and jpacked["b"].shape[0] == 3 * nb
    ref = jax.jit(lambda pk, v: pr.trunk_apply(spec, pk, v, interpret=True))(jpacked, x)
    packed = rrdb.pack_rrdb_trunk(trunk, None, resident=True)
    assert_close(rrdb.trunk_apply_resident_plain(packed, torch.from_numpy(x)), ref,
                 TRUNK_TOL[None], TRUNK_TOL[None])


def test_resident_trunk_plain_matches_jax_bf16_trunk():
    nf, gc, H, W = 64, 32, 5, 7
    trunk = _trunk(2, nf, gc, seed=2)
    x = randn(6, (2, H, W, nf))
    ref = jax.jit(lambda p, v: jnets.apply_rrdb_trunk(p, v, "bfloat16"))(to_jax(trunk), x)
    packed = rrdb.pack_rrdb_trunk(trunk, "bfloat16", resident=True)
    assert packed["w"][0].dtype == torch.bfloat16 and packed["b"][0].dtype == torch.float32
    assert_close(rrdb.trunk_apply(packed, torch.from_numpy(x)), ref, TRUNK_TOL["bfloat16"],
                 TRUNK_TOL["bfloat16"])


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_resident_pack_stacks_the_per_rrdb_packs(cd):
    """Row j = 3 rrdb + r of the stacked conv i+1 is dense block r of that RRDB; the
    slices give the per-RRDB packs back, and both trunk forms compute the same.  (gc 8
    is packed at 16, the RRDB kernels' narrowest width.)"""
    trunk = _trunk(3, 16, 8, seed=3)
    per = rrdb.pack_rrdb_trunk(trunk, cd)
    res = rrdb.pack_rrdb_trunk(trunk, cd, resident=True)
    # read as [block][tap][ci][co] (a float32 pack holds them K-major)
    assert [tuple(nets.taps(w).shape) for w in res["w"]] == [
        (9, 9, 16 + 16 * i, 16) for i in range(4)] + [(9, 9, 80, 16)]
    assert [tuple(b.shape) for b in res["b"]] == [(9, 16)] * 4 + [(9, 16)]
    assert torch.equal(res["w"][2][3 * 1 + 2], per[1]["w"][5 * 2 + 2])
    for p, q in zip(rrdb.rrdb_slices(res), per):
        assert all(torch.equal(a, b) for a, b in zip(p["w"] + p["b"], q["w"] + q["b"]))
    x = torch.from_numpy(randn(7, (2, 4, 5, 16)))
    assert torch.equal(rrdb.trunk_apply(res, x), rrdb.trunk_apply(per, x))


# ---------------------------------------------------------------------- conv3x3
@pytest.mark.parametrize("bias,relu,alpha", [(False, False, 0.2), (True, False, 0.2),
                                             (False, True, 0.2), (True, True, 0.1)])
def test_conv3x3_plain_matches_pallas(bias, relu, alpha):
    """C 20 and N 24, neither a multiple of 16 (the kernel pads both)."""
    x = randn(8, (2, 6, 9, 20))
    w = 0.1 * randn(9, (3, 3, 20, 24))
    b = 0.1 * randn(10, (24,)) if bias else None
    ref = conv3x3_pallas(x, w, b, relu=relu, alpha=alpha, interpret=True)
    tb = None if b is None else torch.from_numpy(b)
    got = conv.conv3x3(torch.from_numpy(x), torch.from_numpy(w), tb, relu=relu, alpha=alpha)
    assert got.dtype == torch.float32 and got.shape == (2, 6, 9, 24)
    assert_close(got, ref, CONV_TOL, CONV_TOL)
    if relu:
        assert (got < 0).any() and torch.equal(got, conv.conv3x3_plain(
            torch.from_numpy(x), torch.from_numpy(w), tb, relu=True, alpha=alpha))
