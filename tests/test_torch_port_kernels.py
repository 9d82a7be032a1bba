"""The plain versions of the port's two kernels against the JAX oracles on the CPU.

- ``ops/chain.py`` (the inverse-chain kernel's arithmetic, from its packed weights)
  against ``flow/stack.py``'s ``inverse_stack`` / ``inverse_stack_hoisted``, the
  oracles that tests/test_pallas_chain.py holds the Pallas kernel against;
- ``ops/rrdb.py`` (the RRDB kernel's arithmetic, from its packed weights) against
  ``ops/nets.py``'s ``apply_rrdb_trunk``, the oracle of tests/test_pallas_rdb.py.

float32: the same arithmetic summed in another order, ~1e-5 relative after a few
steps.  bf16 recipe: the kernels round the conv OPERANDS to bf16 and sum in float32,
as XLA on the CPU does for the JAX bf16 recipe; the JAX path runs the coupling's
conv3 in float32 where the chain kernel takes bf16 operands, and the JAX source asks
for each conv output to be rounded through bf16 (hcflow_tpu/ops/nets.py:48-55), so
the two may differ by about a bf16 step (2^-8 = 3.9e-3 relative): 5e-3 (measured
worst: 3.6e-4).

Each test feeds the CUDA kernel's wrapper CPU tensors, which take its plain version;
tests/test_torch_port_cuda.py compares the kernels themselves on a card.
"""

import jax.numpy as jnp
import pytest
import torch

from hcflow_tpu.flow import stack as jstack
from hcflow_tpu.flow.flowstep import FlowStepSpec as JFlowStepSpec
from hcflow_tpu.ops import nets as jnets
from hcflow_tpu_torch.flow import stack
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.ops import chain, nets, rrdb

from _torch_port_util import assert_close, perturb, randn, to_jax

TOL = {None: 1e-4, "bfloat16": 5e-3}


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize(
    "cond,c,K,H,W",
    [
        (False, 12, 2, 6, 6),
        (True, 12, 2, 6, 6),
        (False, 6, 3, 5, 7),  # odd split + non-square spatial
        (True, 6, 2, 5, 7),
        (True, 21, 2, 6, 6),  # odd channel count (x4 level-1 cond shape)
    ],
)
def test_chain_plain_matches_jax_stack(cd, cond, c, K, H, W):
    cond_ch = 16 if cond else None
    jspec = JFlowStepSpec(in_channels=c, cond_channels=cond_ch, hidden_channels=8, compute_dtype=cd)
    spec = FlowStepSpec(in_channels=c, cond_channels=cond_ch, hidden_channels=8, compute_dtype=cd)
    steps = stack.precompute_invconv(perturb(stack.init_stack(spec, torch.Generator(), K)))
    stacked = to_jax(steps)
    z = randn(2, (2, H, W, c))
    zeros = jnp.zeros((2,))
    packed = chain.pack_inverse_chain(steps, cd)
    if cond:
        u = randn(3, (2, H, W, cond_ch))
        ref = jstack.inverse_stack_hoisted(jspec, stacked, z, u, zeros)[0]
        uc = stack.compute_u_contribs(spec, steps, torch.from_numpy(u)).to(packed["w1"].dtype)
    else:
        ref = jstack.inverse_stack(jspec, stacked, z, None, zeros)[0]
        uc = None
    out = chain.inverse_chain(packed, torch.from_numpy(z), uc)
    assert_close(out, ref, TOL[cd], TOL[cd])


def test_chain_packing_folds():
    """conv3's outputs go from the even/odd cross split to [shift | scale], and the
    tail is diag(exp(-logs)) W^-1."""
    spec = FlowStepSpec(in_channels=6, hidden_channels=8)
    steps = stack.precompute_invconv(perturb(stack.init_stack(spec, torch.Generator(), 2)))
    packed = chain.pack_inverse_chain(steps)
    w3 = steps[1]["coupling"]["f"]["conv3"]["w"]  # (2*c2, hid, 3, 3)
    tap4 = packed["w3"][1, 4]  # centre tap, (hid, 2*c2)
    assert torch.equal(tap4[:, :3], w3[0::2, :, 1, 1].T)
    assert torch.equal(tap4[:, 3:], w3[1::2, :, 1, 1].T)
    wt = torch.exp(-steps[0]["actnorm"]["logs"])[:, None] * steps[0]["invconv"]["w_inv"]
    assert torch.allclose(packed["wt"][0], wt)
    assert packed["w1"].shape == (2, 9, 3, 8) and packed["vec"].shape == (2, 4 * 8 + 2 * 6)


@pytest.mark.parametrize("c", [6, 12, 21, 24, 45, 48])  # every chain width of the main paths
def test_chain_plain_reads_padded_pack(c):
    """The CUDA kernel's padded pack (c1, shift and scale each to 8, the coupling width
    8 to 32, zeros; the cond terms padded to it by pad_uc) gives the plain version the
    same chain as pack_inverse_chain's own layout."""
    spec = FlowStepSpec(in_channels=c, cond_channels=16, hidden_channels=8,
                        compute_dtype="bfloat16")
    steps = stack.precompute_invconv(perturb(stack.init_stack(spec, torch.Generator(), 2)))
    z = torch.from_numpy(randn(6, (2, 5, 7, c)))
    uc = stack.compute_u_contribs(spec, steps, torch.from_numpy(randn(7, (2, 5, 7, 16))))
    uc = uc.to(torch.bfloat16)
    ref = chain.inverse_chain_plain(chain.pack_inverse_chain(steps, "bfloat16"), z, uc)
    padded = chain.pack_inverse_chain(steps, "bfloat16", padded=True)
    c1, c2 = c // 2, c - c // 2
    S = -(-c2 // 8) * 8
    assert padded["w1"].shape == (2, 9, -(-c1 // 8) * 8, 32)
    assert padded["w3"].shape == (2, 9, 32, 2 * S) and padded["vec"].shape == (2, 128 + 4 * S)
    assert not padded["w3"][..., c2:S].any() and not padded["w3"][..., S + c2:].any()
    assert not padded["w3"][:, :, 8:].any() and not padded["w1"][..., 8:].any()
    puc = chain.pad_uc(padded, uc)
    assert puc.shape == (2, 5, 7, 64) and not puc.reshape(2, 5, 7, 2, 32)[..., 8:].any()
    assert_close(chain.inverse_chain_plain(padded, z, puc), ref.numpy(), 1e-6, 1e-6)


@pytest.mark.parametrize("cd", [None, "bfloat16"])
@pytest.mark.parametrize("nf,gc,H,W", [(8, 4, 6, 6), (8, 4, 5, 7), (16, 8, 4, 5)])
def test_rrdb_plain_matches_jax_trunk(cd, nf, gc, H, W):
    trunk = perturb(nets.init_rrdb_trunk(torch.Generator(), 2, nf, gc))
    x = randn(5, (2, H, W, nf))
    ref = jnets.apply_rrdb_trunk(to_jax(trunk), x, cd)
    packed = rrdb.pack_rrdb_trunk(trunk, cd)
    out = rrdb.trunk_apply(packed, torch.from_numpy(x))
    assert_close(out, ref, TOL[cd], TOL[cd])


def test_rrdb_packing_layout():
    """Packed weight k = 5 r + i is dense block r's conv i+1, read as [tap][ci][co]
    through nets.taps; a float32 pack holds it K-major, [tap][co][ci]."""
    trunk = perturb(nets.init_rrdb_trunk(torch.Generator(), 1, 8, 4))
    packed = rrdb.pack_rrdb(trunk[0])
    assert len(packed["w"]) == 15 and len(packed["b"]) == 15
    w = trunk[0]["rdb2"]["conv3"]["w"]  # OIHW (4, 16, 3, 3)
    assert packed["w"][7].shape == (9, 4, 16) and packed["w"][7].is_contiguous()
    assert nets.taps(packed["w"][7]).shape == (9, 16, 4)
    assert torch.equal(nets.taps(packed["w"][7])[5], w[:, :, 1, 2].T)  # tap 5 = (ky 1, kx 2)
    assert nets.taps(packed["w"][14]).shape == (9, 24, 8)
