"""Training on a ('data', 'spatial') mesh (``parallel/dryrun.py`` ``dryrun_multigpu``) on
the CPU: one launch of 4 gloo ranks on a (2, 2) mesh, so that both axes split the batch,
at the JAX package's ``dryrun_multichip`` topologies (tests/_spatial_ranks.py ``train``).

- every pass (two NLL steps, an NLL step with ``remat_steps`` and ``remat_trunks``, the
  HCFlow++ iteration's NLL, pixel, fea/GAN and D, the rescaling joint step): the
  all-reduced gradient within 1e-5 x max |g| of the port's one-process pass on the
  global batch in every leaf, the D loss within 1e-5; the ranks' params bit-identical
  after every pass; the calibration on the mesh equal to one process's bit for bit;
- the rescaling step's quantizer holds the one-process forward's 8-bit codes
  (``dryrun.HeldCodes``), and the sharded fake LR's flips against them are counted: at
  most one code; with its own codes the step is the default step bit for bit;
- the ++ NLL pass and the rescaling pass with every halo one row short break that limit;
- the halo exchanges: every rank's the same, one backward exchange for each forward one
  that carried a gradient, ``remat_steps`` rerunning forward exchanges inside the
  backward pass, the discriminators' gathers;
- the sharded NLL and pixel gradients against the JAX package's unsharded
  ``value_and_grad`` at ``TOL[None]``;
- a banded RRDB trunk under ``remat`` saves the RRDBs' inputs (band + halo) and nothing
  else, runs the plain banded exchanges, and gives the plain banded gradient bit for
  bit, both within 1e-6 of the whole image's;
- VGG19 features on a band height their pools do not divide raise.
"""

import functools

import numpy as np
import pytest
import torch

import _spatial_ranks
from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import TOL, _check_grads, jax_run, to_jax
from hcflow_tpu_torch.models import HCFlowSRSpec, vgg
from hcflow_tpu_torch.parallel import dryrun, mesh

PASSES = ["nll1", "nll2", "nll_remat", "plusplus_nll", "pixel", "feagan", "D", "rescaling"]
TOL_MESH = 1e-5  # of each leaf's max |g|
WORLD, SHAPE = 4, (2, 2)


@pytest.fixture(scope="module")
def report():
    return dryrun.dryrun_multigpu(WORLD, cpu=True, tol=TOL_MESH, mesh_shape=SHAPE,
                                  rank_fn=_spatial_ranks.train)


@pytest.mark.parametrize("name", PASSES)
def test_all_reduced_gradient_matches_one_process(report, name):
    r = report["passes"][name]
    assert r["rel"] <= TOL_MESH and r["max_abs_err"] <= TOL_MESH * r["max_abs_grad"], r


def test_ranks_params_bit_identical_and_calibration_equal(report):
    assert report["mesh"]["shape"] == SHAPE
    assert report["digests_equal"] and [n for n, _ in report["digests"]] == PASSES
    assert report["calibrate_equal"]
    assert report["d_loss"]["rel"] <= dryrun.D_LOSS_RTOL


def test_a_halo_one_row_short_breaks_the_nll_gradient(report):
    c = report["controls"]["plusplus_nll"]
    assert c["rel"] > 1e3 * TOL_MESH, c


def test_a_halo_one_row_short_breaks_the_rescaling_gradient(report):
    c = report["controls"]["rescaling"]
    assert c["tol"] == TOL_MESH and c["rel"] > 1e3 * TOL_MESH, c


def test_rescaling_flips_against_the_held_codes_are_counted(report):
    f = report["passes"]["rescaling"]["flips"]
    plan = dryrun.TrainPlan()
    B, hw = SHAPE[0] * plan.rows, plan.rs_hr // 4
    assert f["values"] == B * hw * hw * 3 and f["steps"] <= 1, f
    assert sum(r["rescaling"]["flips"]["flips"] for r in report["ranks"]) == f["flips"]


def test_held_codes_of_its_own_lr_leave_the_rescaling_step_bit_for_bit():
    """make_rescaling_step with dryrun.HeldCodes of the step's own forward LR (no flips)
    gives the default step's gradient and update bit for bit."""
    from hcflow_tpu_torch.models import HCFlowRescalingSpec
    from hcflow_tpu_torch.ops import nets
    from hcflow_tpu_torch.train.schedules import schedule_from_opt
    from hcflow_tpu_torch.train.trainer import (init_state, make_optimizer, make_rescaling_step,
                                                sample_latents, tree_leaves)

    model = HCFlowRescalingSpec.default_x4(**dict(dryrun.TINY, K=(2, 2)))
    opt = {"lr_G": 2e-4, "lr_steps": [100]}
    tx = make_optimizer(opt, schedule_from_opt(opt))
    params = dryrun.perturb(model.init(0, device="cpu"), 12)
    g = torch.Generator().manual_seed(1)
    hr = torch.rand(2, 16, 16, 3, generator=g)
    lr = hr.reshape(2, 4, 4, 4, 4, 3).mean((2, 4))
    eps = sample_latents(model, lr.shape, 1.0, torch.Generator().manual_seed(4), "cpu",
                         deepest_first=False)
    state = init_state(params, tx)
    with nets.exact_f32():
        own = model.forward(state.params, hr, grad=True)[0]
    held = dryrun.HeldCodes(own)
    outs = [make_rescaling_step(model, tx, 5e-2, 1e-5, 1.0, **kw)(init_state(params, tx), hr, lr,
                                                                   None, eps)
            for kw in ({}, {"quantize": held})]
    assert held.flips[0]["flips"] == 0
    (s0, m0), (s1, m1) = outs
    assert all(torch.equal(a, b) for a, b in zip(m0["grads"], m1["grads"]))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(s0.params), tree_leaves(s1.params)))


def test_exchanges_forward_and_backward(report):
    ranks = report["ranks"]
    for name in PASSES:
        assert all(r[name]["exchanges"] == ranks[0][name]["exchanges"] and
                   r[name]["bytes"] == ranks[0][name]["bytes"] for r in ranks), name
    nll, remat = ranks[0]["nll1"]["exchanges"], ranks[0]["nll_remat"]["exchanges"]
    # the NLL: every exchanged tensor carries a gradient; the RRDB is rerun, not its exchange
    assert set(nll) == {"conv", "rrdb", "conv.grad", "rrdb.grad"}
    assert nll["conv.grad"] == nll["conv"] and nll["rrdb.grad"] == nll["rrdb"]
    assert remat["conv"] > nll["conv"] and remat["rrdb"] == nll["rrdb"]
    assert remat["conv.grad"] == nll["conv.grad"] and remat["rrdb.grad"] == nll["rrdb.grad"]
    # the reverse with grad: the chains' halos; the LR input's conv carries none
    pix = ranks[0]["pixel"]["exchanges"]
    assert pix["chain.grad"] == pix["chain"] and pix["conv.grad"] == pix["conv"] - 1
    # the discriminator on the gathered images: fake and real gathered, fake's back
    assert ranks[0]["feagan"]["exchanges"]["gather"] == 2
    assert ranks[0]["feagan"]["exchanges"]["gather.grad"] == 1
    assert ranks[0]["D"]["exchanges"] == {"gather": 2}


@functools.lru_cache(maxsize=None)
def _jax_model(K):
    from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec

    kw = dict(dryrun.TINY, K=K)
    return HCFlowSRSpec.for_scale(4, **kw), JHCFlowSRSpec.for_scale(4, **kw)


def test_sharded_nll_gradient_matches_jax_unsharded(report):
    import jax

    model, jmodel = _jax_model((3, 3))
    r = report["nll"]
    hr, lr, noise = (r[k].numpy() for k in ("hr", "lr", "noise"))
    nll_j, g_j = jax_run(jax.value_and_grad(
        lambda p: jmodel.forward(p, None, hr, lr, noise=noise)[1]), to_jax(r["params"]))
    assert np.isfinite(float(nll_j))
    _check_grads(model, r["grads"], g_j, TOL[None])


def test_sharded_pixel_gradient_matches_jax_unsharded(report):
    import jax
    import jax.numpy as jnp

    model, jmodel = _jax_model((2, 2))
    r = report["pixel"]
    hr, lr = r["hr"].numpy(), r["lr"].numpy()
    pix_j, g_j = jax_run(jax.value_and_grad(lambda p: jnp.mean(
        jnp.abs(jmodel.reverse(p, jax.random.PRNGKey(0), lr, 0.0) - hr))), to_jax(r["params"]))
    assert np.isfinite(float(pix_j))
    _check_grads(model, r["grads"], g_j, TOL[None])


def test_banded_trunk_under_remat_keeps_only_its_inputs(report):
    t = report["trunk_remat"]
    assert t["saved"]["remat"] == t["inputs"] and t["saved"]["plain"] > 10 * t["inputs"]
    assert t["exchanges"]["remat"] == t["exchanges"]["plain"] == {"rrdb": 2, "rrdb.grad": 2}
    assert t["remat_vs_plain"] == 0.0
    assert t["plain"] <= 1e-6 and t["remat"] <= 1e-6, t


def test_vgg_features_on_a_band_their_pools_do_not_divide_raise():
    spec = vgg.VGG19FeatureSpec()
    assert spec.pools == 4
    with pytest.raises(ValueError, match="bands of 8 rows: .* multiple of 16"):
        spec.apply({}, torch.zeros(1, 8, 16, 3), mesh=mesh.Mesh((1, 2)))
