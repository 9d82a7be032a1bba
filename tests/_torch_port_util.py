"""Shared helpers of the tests/test_torch_port_*.py files.

Params are made by the PyTorch port's inits (fast, unlike the JAX package's eager
inits), perturbed with numpy noise from a seed, and handed to the JAX package in
its own layout by :func:`to_jax`.
"""

import functools

import numpy as np
import pytest
import torch

# The TINY topology of tests/test_pallas_chain.py: every module of the x4 SR
# reverse pass at a few channels.
TINY = dict(
    K=(3, 3), after_splitoff=(1, 1), rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4,
    hidden_channels=8, so_hidden_channels=8,
)


# The topology of weights/ref_trained/tiny_x4_parity.yml, the reference PyTorch model
# trained for 400 steps whose weights are weights/ref_trained/tiny_x4_400_G.pth: x4 SR,
# K 8 with 4 split-off steps a level, coupling width 32, RRDB nb 2, nf 32, gc 16.
TINY_CKPT = dict(
    K=(8, 8), after_splitoff=(4, 4), rrdb_nb=(2, 2), rrdb_nf=32, rrdb_gc=16,
    hidden_channels=32, so_hidden_channels=32,
)


def perturb(tree, seed=1, scale=0.05):
    """Every tensor plus scale * N(0, 1) noise, as tests/test_pallas_chain.py does:
    fresh inits zero each coupling conv3 and the prior head, which would make the
    affine updates and the prior no-ops."""
    rng = np.random.default_rng(seed)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, list):
            return [go(v) for v in t]
        return t + scale * torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32))

    return go(tree)


def to_jax(tree, key=None):
    """A port param tree in the JAX package's layout, as numpy: lists of per-step or
    per-RRDB dicts stacked along a leading axis, 4-D conv weights OIHW -> HWIO.  A list
    whose entries differ in shape (the rescaling model's alternating main chain) stays
    a list of per-step dicts, as the JAX package holds it."""
    if isinstance(tree, dict):
        return {k: to_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        if not tree:
            return []
        per = [to_jax(v) for v in tree]
        return _stack(per) if len({_shapes(p) for p in per}) == 1 else per
    a = tree.detach().numpy()
    return a.transpose(2, 3, 1, 0) if key == "w" and a.ndim == 4 else a


def _shapes(tree):
    if isinstance(tree, dict):
        return tuple((k, _shapes(v)) for k, v in sorted(tree.items()))
    return np.shape(tree)


def _stack(per):
    if isinstance(per[0], dict):
        return {k: _stack([p[k] for p in per]) for k in per[0]}
    return np.stack(per)


def randn(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def assert_close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


# ------------------------------------------ SR forward, calibrate, encode, train steps
# Shared by tests/test_torch_port_train.py (x4) and tests/test_torch_port_train_x8.py.
# Tolerances, as tests/test_torch_port_model.py: the float32 recipe 1e-4 (the same
# arithmetic summed in another order), the bf16 recipes 1e-2 (the two frameworks round
# to bf16 at other places), each relative to the largest magnitude of what is compared
# (an NLL, a latent, a gradient leaf) where that exceeds 1.  The fake LR is on the 1/255
# grid of the straight-through quantizer: a value at a rounding tie may move one level,
# so it is held to one level plus the tolerance.
TOL = {None: 1e-4, "bfloat16": 1e-2}
# (compute_dtype, encoder_dtype): the float32 recipe, the bf16 recipe and the shipped
# training recipe (bf16 encoders, float32 couplings)
RECIPES = [(None, None), ("bfloat16", None), (None, "bfloat16")]
RECIPE_IDS = ["f32", "bf16", "bf16_encoders"]
TRAIN_OPT = {"lr_G": 5e-5, "max_grad_clip": 5, "max_grad_norm": 100, "beta1": 0.9,
             "beta2": 0.99, "lr_steps": [2, 4]}
SR_B = 2


def recipe_tol(cd, ed):
    return TOL["bfloat16" if "bfloat16" in (cd, ed) else None]


def close_scaled(port, ref, tol, what=""):
    """max |port - ref| <= tol * max(1, max |ref|)."""
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape, what
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(port - ref).max())
    assert err <= tol * scale, f"{what}: max abs err {err:.3e} > {tol:g} x {scale:.3e}"


@functools.lru_cache(maxsize=None)
def sr_case(scale, cd, ed):
    """(port model, port params, JAX model, JAX params, hr, lr, noise) at a small x4
    or x8 topology; the params are the port's inits perturbed, read back through
    params_from_jax; hr, lr and the noise are numpy, for both."""
    from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec
    from hcflow_tpu_torch.convert import params_from_jax
    from hcflow_tpu_torch.models import HCFlowSRSpec

    kw = dict(TINY) if scale == 4 else dict(TINY, K=(2, 2, 2), after_splitoff=(1, 1, 1))
    model = HCFlowSRSpec.for_scale(scale, compute_dtype=cd, encoder_dtype=ed, **kw)
    params = perturb(model.init(0, device="cpu"), scale=0.02)
    jp = to_jax(params)
    params = params_from_jax(jp, model, device="cpu")
    jmodel = JHCFlowSRSpec.for_scale(scale, compute_dtype=cd, encoder_dtype=ed, **kw)
    rng = np.random.default_rng(scale)
    H, W = (16, 24) if scale == 4 else (16, 32)
    hr = rng.uniform(size=(SR_B, H, W, 3)).astype(np.float32)
    # the LR a trained model would give back is near the HR's box average
    lr = hr.reshape(SR_B, H // scale, scale, W // scale, scale, 3).mean((2, 4))
    noise = rng.uniform(size=hr.shape).astype(np.float32)
    return model, params, jmodel, jp, hr, lr, noise


def _t(a):
    return torch.from_numpy(np.asarray(a))


def jax_run(fn, *args):
    """fn(*args) compiled by XLA at backend optimisation level 0: the same
    computation, in a third of the compile time of jax.jit's default on the CPU (a
    model's gradient takes seconds to compile, and runs in milliseconds here)."""
    import jax

    lowered = jax.jit(fn).lower(*args)
    return lowered.compile(compiler_options={"xla_backend_optimization_level": 0})(*args)


def check_sr_forward(scale, cd, ed):
    """The SR forward, (fake LR, NLL), with explicit noise against JAX's."""
    import jax

    model, params, jmodel, jp, hr, lr, noise = sr_case(scale, cd, ed)
    fake_j, nll_j = jax_run(lambda p, a, b, n: jmodel.forward(p, None, a, b, noise=n),
                            jp, hr, lr, noise)
    fake, nll = model.forward(params, _t(hr), _t(lr), noise=_t(noise))
    tol = recipe_tol(cd, ed)
    assert np.isfinite(float(nll_j)) and torch.isfinite(nll)
    close_scaled(nll, nll_j, tol, "nll")
    assert fake.shape == (SR_B, hr.shape[1] // scale, hr.shape[2] // scale, 3)
    d = np.abs(fake.numpy() - np.asarray(fake_j))
    assert d.max() <= 1 / 255 + tol, d.max()
    assert (d > tol).mean() <= 0.05  # ties on the 1/255 grid are rare


def check_calibrate(scale):
    """The data-dependent ActNorm inits from the same dequantized batch."""
    import jax

    model, params, jmodel, jp, hr, lr, noise = sr_case(scale, None, None)
    x = hr + noise / model.quant
    ld = np.full((SR_B,), -np.log(model.quant) * hr.shape[1] * hr.shape[2], np.float32)
    new_j = jax_run(lambda p, a, b: jmodel.flow.calibrate(p, a, b)[0], jp, x, ld)
    new = model.calibrate(params, _t(hr), _t(lr), noise=_t(noise))
    assert jmodel.quant == model.quant == {4: 64, 8: 256}[scale]
    flat = jax.tree_util.tree_leaves_with_path
    got, ref = flat(to_jax(new)), flat(jax.tree.map(np.asarray, new_j))
    assert [p for p, _ in got] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(got, ref):
        close_scaled(a, b, TOL[None], jax.tree_util.keystr(path))
    # the flow ActNorms were re-initialised
    logs = new["level0"]["main"][0]["actnorm"]["logs"]
    assert not torch.equal(logs, params["level0"]["main"][0]["actnorm"]["logs"])


def check_encode(scale, cd, ed):
    """encode's z and whitened latents against JAX's; the port's encode -> reverse
    gives HR back on the plain and the fused params (float32: to float32 rounding;
    bf16 nets: an input landing across a bf16 rounding boundary moves a net's output
    by a bf16 step, at a few pixels)."""
    import jax

    model, params, jmodel, jp, hr, _, _ = sr_case(scale, cd, ed)
    z_j, eps_j = jax_run(jmodel.flow.encode, jp, hr)
    z, eps = model.flow.encode(params, _t(hr))
    tol = recipe_tol(cd, ed)
    close_scaled(z, z_j, tol, "z")
    for i, (e, ej) in enumerate(zip(eps, eps_j)):
        close_scaled(e, ej, tol, f"eps level {i}")
    for fused in (False, True):
        pp = model.flow.precompute_inference(params, fused=fused)
        back = model.flow.reverse_flow(pp, z, 0.9, eps_list=eps)
        err = (back - _t(hr)).abs().max().item()
        assert err <= (1e-5 if tol == TOL[None] else 5e-3), (fused, err)


def _check_grads(model, grads, jgrads, tol):
    import jax

    from hcflow_tpu_torch.convert import params_from_jax
    from hcflow_tpu_torch.train import trainer

    ref = trainer.tree_leaves(params_from_jax(jax.tree.map(np.asarray, jgrads), model,
                                              device="cpu"))
    assert len(ref) == len(grads)
    for i, (g, r) in enumerate(zip(grads, ref)):
        close_scaled(g, r.numpy(), tol, f"grad leaf {i}")


def check_steps(scale, cd, ed):
    """One NLL step and one pixel step: the loss and the gradient of every leaf against
    jax.value_and_grad of the JAX steps' loss functions; the NLL step advances the
    iteration, the pixel step does not, and both move the params."""
    import jax
    import jax.numpy as jnp

    from hcflow_tpu_torch.train import losses, schedules, trainer

    model, params, jmodel, jp, hr, lr, noise = sr_case(scale, cd, ed)
    tol = recipe_tol(cd, ed)
    nll_weight, pixel_weight = 0.5, 1.0
    nll_j, g_j = jax_run(jax.value_and_grad(
        lambda p: nll_weight * jmodel.forward(p, None, hr, lr, noise=noise)[1]), jp)
    pix_j, gp_j = jax_run(jax.value_and_grad(lambda p: pixel_weight * jnp.mean(
        jnp.abs(jmodel.reverse(p, jax.random.PRNGKey(0), lr, 0.0) - hr))), jp)

    tx = trainer.make_optimizer(TRAIN_OPT, schedules.schedule_from_opt(TRAIN_OPT))
    state = trainer.init_state(params, tx)
    nll_step = trainer.make_sr_nll_step(model, tx, nll_weight)
    pix_step = trainer.make_sr_pixel_step(model, tx, pixel_weight, losses.pixel_criterion("l1"))
    before = [t.detach().clone() for t in trainer.tree_leaves(state.params)]
    state, m = nll_step(state, _t(hr), _t(lr), noise=_t(noise))
    close_scaled(nll_weight * m["nll"], nll_j, tol, "nll")
    _check_grads(model, m["grads"], g_j, tol)
    assert state.step == 1
    moved = [not torch.equal(a, b) for a, b in zip(before, trainer.tree_leaves(state.params))]
    assert sum(moved) > len(moved) // 2

    # the pixel step's gradient at the params the JAX loss saw
    state = trainer.init_state(params, tx)
    state, m = pix_step(state, _t(hr), _t(lr), generator=torch.Generator().manual_seed(0))
    close_scaled(m["l_g_pix_hr"], pix_j, tol, "pixel loss")
    _check_grads(model, m["grads"], gp_j, tol)
    assert state.step == 0 and state.opt_state["count"] == 1
    for p in trainer.tree_leaves(state.params):
        assert p.requires_grad and p.is_leaf and torch.isfinite(p).all()


# -------------------------------------------- the ++ heads and the rescaling step
# Shared by tests/test_torch_port_heads.py and tests/test_torch_port_rescaling_train.py:
# HR 64 x 64 (the VGG discriminator's input halves five times), batch 2.
HEAD_B, HEAD_HW = 2, 64


def head_data(seed):
    """(hr, lr): a smooth HR batch (8 x 8 blocks plus fine noise) and its 4 x 4 mean."""
    B, HW = HEAD_B, HEAD_HW
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0.1, 0.9, (B, HW // 8, HW // 8, 3))
    hr = np.clip(np.kron(lo, np.ones((1, 8, 8, 1))) + 0.02 * rng.standard_normal((B, HW, HW, 3)),
                 0, 1).astype(np.float32)
    return hr, hr.reshape(B, HW // 4, 4, HW // 4, 4, 3).mean((2, 4))


@functools.lru_cache(maxsize=None)
def vgg_params():
    """The port's random VGG19 features and the same weights in the JAX package's layout."""
    from hcflow_tpu_torch.convert import heads_to_jax
    from hcflow_tpu_torch.models import vgg

    p = vgg.random_features(seed=0, device="cpu")
    return heads_to_jax(p), p


def patchgan():
    """(port spec, JAX spec, port params, JAX params) of the G steps' adversarial head:
    a PatchGAN, whose BatchNorms see batch x 56 x 56 maps.  (The VGG discriminator's
    last BatchNorms see 2 x 2 maps at HR 64; see tests/test_torch_port_heads.py
    ``test_d_step_matches_jax`` for why its gradient is not held against JAX.)"""
    from hcflow_tpu.models import discriminators as jdisc
    from hcflow_tpu_torch.convert import heads_to_jax
    from hcflow_tpu_torch.models import discriminators

    spec = discriminators.PatchGANDiscriminatorSpec(ndf=8, n_layers=2)
    d = spec.init(2, device="cpu")
    return spec, jdisc.PatchGANDiscriminatorSpec(ndf=8, n_layers=2), d, heads_to_jax(d)


def jax_update(p, g, advance):
    """The params ``p`` after one update by gradient ``g`` from a fresh state by the JAX
    package's optimizer (traceable)."""
    from hcflow_tpu.train import schedules as jschedules
    from hcflow_tpu.train import trainer as jtrainer

    jtx = jtrainer.make_optimizer(TRAIN_OPT, jschedules.schedule_from_opt(TRAIN_OPT))
    return jtrainer._apply(jtx, jtrainer.init_state(p, jtx), g, advance).params


def with_jax_update(loss, advance):
    """fn(p, *rest) -> (aux, grads, params after one update from a fresh state by the
    JAX package's optimizer), for ``loss(p, *rest) -> (total, aux)``."""
    import jax

    def fn(p, *rest):
        (_, aux), g = jax.value_and_grad(loss, has_aux=True)(p, *rest)
        return aux, g, jax_update(p, g, advance)

    return fn


def check_update(model, state, jnew, jgrads, tol, lr=TRAIN_OPT["lr_G"]):
    """The params after one update against JAX's.  Adam's first update is lr * g / (|g|
    + eps), about lr * sign(g): where the two gradients are held equal (|g| above the
    gradient tolerance) the signs agree and so must the params; below it a sign may
    differ, and the params by at most 2 lr."""
    import jax

    from hcflow_tpu_torch.convert import params_from_jax
    from hcflow_tpu_torch.train import trainer

    def tree(t):
        return trainer.tree_leaves(params_from_jax(jax.tree.map(np.asarray, t), model,
                                                   device="cpu"))

    ref, grads, got = tree(jnew), tree(jgrads), trainer.tree_leaves(state.params)
    assert len(ref) == len(got) == len(grads)
    for i, (a, b, g) in enumerate(zip(got, ref, grads)):
        a = a.detach()
        sure = g.abs() > tol * max(1.0, float(g.abs().max()))
        if sure.any():
            close_scaled(a[sure], b[sure].numpy(), tol, f"param leaf {i} after the update")
        assert float((a - b).abs().max()) <= 2 * lr * (1 + 1e-3), f"param leaf {i}"


# ----------------------------------------------------------- the training entry point
# Shared by tests/test_torch_port_train_loop.py and tests/test_torch_port_train_cli.py:
# the shipped training configs at a small topology on synthetic data.
TRAIN_FD = dict(K=3, hidden_channels=8)
TRAIN_SO = dict(after_flowstep=[1, 1], hidden_channels=8, RRDB_nb=[1, 1], RRDB_nf=8, RRDB_gc=8)


def smooth_image(rng, h, w):
    """A smooth random HWC image in [0, 1]: 8 x 8 blocks by bicubic, plus fine noise."""
    from hcflow_tpu_torch.data.imresize import imresize

    lo = rng.uniform(0.05, 0.95, (-(-h // 8), -(-w // 8), 3))
    return np.clip(imresize(lo, 8.0)[:h, :w] + 0.02 * rng.standard_normal((h, w, 3)), 0, 1
                   ).astype(np.float32)


def train_data(root):
    """Synthetic training data under root: LRHR_PKL crops (GT 32, x4) by the port's
    prepare_data pkl from two 64 x 64 PNGs under src/, GT/LQ .npy pairs under npy/ by
    its png2npy, one GT/LQ validation pair of HR 64 x 64 under val/."""
    from hcflow_tpu_torch.cli import prepare_data
    from hcflow_tpu_torch.data.imresize import imresize
    from hcflow_tpu_torch.data.util import save_img

    rng = np.random.default_rng(0)
    for d in ("src", "val/HR", "val/LR", "png/HR", "png/LR"):
        (root / d).mkdir(parents=True)
    for i in range(2):
        save_img(str(root / "src" / f"{i}.png"), smooth_image(rng, 64, 64))
    prepare_data.prepare_pkl(str(root / "src"), str(root / "pkl"), crops_per_image=3,
                             crop_size=32, scales=(4,))
    for d, n in (("val", 1), ("png", 3)):
        for i in range(n):
            hr = smooth_image(rng, 64, 64)
            save_img(str(root / d / "HR" / f"{i}.png"), hr)
            save_img(str(root / d / "LR" / f"{i}.png"), np.clip(imresize(hr, 0.25), 0, 1))
    for d in ("HR", "LR"):
        prepare_data.png2npy(str(root / "png" / d), str(root / "npy" / d))
    return root


def train_option_file(path, src, data, root, **train_opt):
    """A copy of the shipped training config configs/<src> at the small topology,
    float32 nets (XLA on the CPU runs bf16 convs slowly; the loop does not depend on
    the recipe), batch 2, GT 32, on train_data's files, writing under root, a
    checkpoint and a progress line every iteration; ``train_opt`` updates its train
    section."""
    import yaml

    from pathlib import Path

    opt = yaml.safe_load((Path(__file__).resolve().parents[1] / "configs" / src).read_text())
    fd = opt["network_G"]["flowDownsampler"]
    fd.update(TRAIN_FD)
    fd["splitOff"].update(TRAIN_SO)
    opt["network_G"].pop("encoder_dtype", None)
    tr = opt["datasets"]["train"]
    if tr["mode"] == "GTLQnpy":
        tr.update(dataroot_GT=str(data / "npy/HR"), dataroot_LQ=str(data / "npy/LR"))
    else:
        tr.update(dataroot_GT=str(data / "pkl/tr.pklv4"), dataroot_LQ=str(data / "pkl/tr_X4.pklv4"))
    tr.update(batch_size=2, GT_size=32, n_workers=0)
    opt["datasets"]["val"].update(dataroot_GT=str(data / "val/HR"),
                                  dataroot_LQ=str(data / "val/LR"))
    opt["path"].update(root=str(root), pretrain_model_G=None)
    opt["logger"].update(print_freq=1, save_checkpoint_freq=1)
    opt["val"].update(heats=[0.0], n_sample=1)
    opt["use_tb_logger"] = False
    opt["train"].update(train_opt)
    path.write_text(yaml.safe_dump(opt))
    return str(path)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads for a module's tests (imported by a test module, it applies to
    it): the suite runs test files in parallel processes, and the default of one thread
    a core spins idle threads against the other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
