"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``: they need an NVIDIA GPU and nvcc, and skip elsewhere (a CUDA
kernel has no CPU mode; tests/test_torch_port_kernels.py holds the plain versions
against JAX on the CPU).  On a machine with the card:

    python -m pytest -m cuda tests/test_torch_port_cuda.py

Tolerance: kernel and plain version take the same bf16 operands and sum in float32
in another order, so a feature rounded to bf16 can land one bf16 step (2^-8
relative) apart and carry on, damped; 1e-3 of the output's largest magnitude.
"""

import pytest
import torch

from hcflow_tpu_torch.flow import stack
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.ops import chain, nets, rrdb

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
    std = 0.1 / tree[0].numel() ** 0.5 if tree.ndim == 4 else 0.02
    return tree + std * torch.randn(tree.shape, device="cuda", generator=gen)


def _close(got, ref):
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= RTOL * ref.abs().max().item()


@pytest.mark.parametrize("B,H,W", [(2, 8, 16), (3, 13, 21)])  # exact tiles, ragged edges
def test_rrdb_kernel_matches_plain(gen, B, H, W):
    trunk = _perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(1), 1, 64, 32), gen)
    packed = rrdb.pack_rrdb(trunk[0], "bfloat16")
    x = torch.randn(B, H, W, 64, device="cuda", generator=gen)
    before = rrdb.launches
    got = rrdb.rrdb_apply(packed, x)
    torch.cuda.synchronize()
    assert rrdb.launches == before + rrdb.LAUNCHES_PER_RRDB
    _close(got, rrdb.rrdb_apply_plain(packed, x))


@pytest.mark.parametrize("cond,c,H,W", [(True, 21, 10, 12), (True, 6, 9, 17),
                                        (False, 24, 10, 12), (False, 12, 9, 17)])
def test_chain_kernel_matches_plain(gen, cond, c, H, W):
    spec = FlowStepSpec(in_channels=c, cond_channels=128 if cond else None,
                        hidden_channels=64, compute_dtype="bfloat16")
    steps = stack.init_stack(spec, torch.Generator().manual_seed(2), 3)
    steps = stack.precompute_invconv(_perturb(steps, gen))
    packed = chain.pack_inverse_chain(steps, "bfloat16")
    z = torch.randn(2, H, W, c, device="cuda", generator=gen)
    uc = None
    if cond:
        u = torch.randn(2, H, W, 128, device="cuda", generator=gen)
        uc = stack.compute_u_contribs(spec, steps, u).to(torch.bfloat16).contiguous()
    before = chain.launches
    got = chain.inverse_chain(packed, z, uc)
    torch.cuda.synchronize()
    assert chain.launches == before + 3
    _close(got, chain.inverse_chain_plain(packed, z, uc))
