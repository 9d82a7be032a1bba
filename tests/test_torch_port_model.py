"""The port's whole x4 SR reverse pass against the JAX package's on the CPU.

The JAX side is the oracle the Pallas kernels are held against:
``precompute_inference(p)`` (the XLA path, no Pallas) + ``reverse_flow`` with
explicit latents ``eps_list`` + clip to [0, 1].  The port runs the same params
(converted by ``params_from_jax``) and the same latents, both with its kernels'
plain versions (``fused=True``: the CUDA wrappers get CPU tensors) and with its
plain step-by-step path.  JAX threefry and torch generators differ, so the latents
are made with numpy and handed to both.

Tolerances: float32 recipe 1e-4 (the same arithmetic summed in another order, over
26 flow steps and 4 RRDB trunks).  bf16 recipe: the two round at different places
(the port's plain path rounds each net conv's output through bf16, as
hcflow_tpu/ops/nets.py:48-55 asks, XLA on the CPU does not; the chain kernel takes
conv3's operands in bf16, the JAX path runs it in float32), a bf16 step (2^-8
relative) here and there, carried through the flow: 1e-2 on the [0, 1] output
(measured worst: 1.2e-3).
"""

import jax
import numpy as np
import pytest
import torch

from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.models import HCFlowSRSpec
from hcflow_tpu_torch.ops import chain, rrdb

from _torch_port_util import TINY, assert_close, perturb, randn, to_jax

TOL = {None: 1e-4, "bfloat16": 1e-2}
B, LH, LW = 2, 4, 6  # non-square LR; HR is 16 x 24


def _case(cd):
    model = HCFlowSRSpec.for_scale(4, compute_dtype=cd, **TINY)
    params = perturb(model.init(0, device="cpu"), scale=0.02)
    jp = to_jax(params)
    # the port reads the JAX layout back: params_from_jax inverts to_jax
    params = params_from_jax(jp, model, device="cpu")
    jmodel = JHCFlowSRSpec.for_scale(4, compute_dtype=cd, **TINY)
    lr = np.random.default_rng(1).uniform(size=(B, LH, LW, 3)).astype(np.float32)
    eps = [randn(2, (B, 2 * LH, 2 * LW, 6)), randn(3, (B, LH, LW, 21))]
    reverse = jax.jit(lambda p, x, e: jmodel.flow.reverse_flow(
        p, jax.random.PRNGKey(4), x, 0.9, eps_list=e))
    ref = np.clip(np.asarray(reverse(jmodel.flow.precompute_inference(jp), lr, eps)), 0, 1)
    return model, params, torch.from_numpy(lr), [torch.from_numpy(e) for e in eps], ref


@pytest.mark.parametrize("cd", [None, "bfloat16"])
def test_reverse_matches_jax(cd):
    model, params, lr, eps, ref = _case(cd)
    assert ((ref > 0) & (ref < 1)).mean() > 0.3  # mostly not saturated by the clip
    for fused in (True, False):
        pp = model.flow.precompute_inference(params, fused=fused)
        assert ("main_fused" in pp["level0"]) == fused
        # trunks are packed in either recipe where JAX's fused="all" packs them: nf and
        # gc multiples of 8 (hcflow_tpu/flow/flownet.py:374), which TINY's gc 4 is not
        gate = TINY["rrdb_nf"] % 8 == 0 and TINY["rrdb_gc"] % 8 == 0
        assert ("trunk0_fused" in pp["level1"]["cond"]) == (fused and gate)
        out = model.reverse(pp, lr, 0.9, eps_list=eps)
        assert out.shape == (B, 4 * LH, 4 * LW, 3)
        assert_close(out, ref, TOL[cd])


def test_reverse_sampling_heat_and_counters():
    """Sampling from a generator: heat 0 is deterministic, heat > 0 differs by seed;
    on the CPU the kernel wrappers run their plain versions and count no launch."""
    model, params, lr, _, _ = _case("bfloat16")
    pp = model.flow.precompute_inference(params, fused=True)
    chain.launches_by.clear()
    rrdb.launches_by.clear()

    def run(heat, seed):
        return model.reverse(pp, lr, heat, generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(0.0, 1), run(0.0, 2))
    a, b = run(0.9, 1), run(0.9, 2)
    assert torch.isfinite(a).all() and not torch.equal(a, b)
    assert torch.equal(a, run(0.9, 1))
    assert not chain.launches_by and not rrdb.launches_by
