"""The rest of the flow-op inventory in the port against the JAX package on the CPU:

- the cases of tests/test_extras.py (permutations, the reverse-permuted flow step, the
  sigmoid flow, the masked ActNorm, the learned-prior split, RDN), each against the
  JAX function on the same inputs and weights;
- the LU invconv, the AffineInjector coupling (with its calibration) and the
  noCoupling step against the JAX package's, and the Laplace density;
- small SR models from option files with each permutation and coupling value that
  ``config.model_spec_from_opt`` accepts beyond the shipped ones (``shuffle`` /
  ``reverse`` / ``none`` permutations, ``noCoupling``, a split-off ``AffineInjector``):
  the forward NLL with explicit noise and the reverse with explicit latents against
  JAX's, the reverse on the fused serving params too (a chain the chain kernel does
  not compute serves on the plain path), and the values it refuses;
- the serving fault of ``flow_permutation: none``: ``precompute_inference(fused=True)``
  packed every main chain for the chain kernel, which needs an invconv, and raised
  ``KeyError: 'invconv'``;
- ``params_from_state_dict`` on a synthetic state dict with the new keys, against the
  JAX package's ``convert_flowstep``.

Float32 throughout: 1e-4 x max(1, max |ref|), as tests/test_torch_port_model.py; the
invertible ops alone (no nets) 1e-5.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu.flow.flowstep import FlowStepSpec as JFlowStepSpec
from hcflow_tpu.ops import densities as jdens
from hcflow_tpu.ops import extras as jextras
from hcflow_tpu.ops import invconv as jinvconv
from hcflow_tpu.ops import permute as jpermute
from hcflow_tpu.utils import config as jconfig
from hcflow_tpu.utils.convert import convert_flowstep
from hcflow_tpu_torch import convert
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.ops import densities, extras, invconv, permute
from hcflow_tpu_torch.utils import config

from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import _t, close_scaled, jax_run, perturb, randn, to_jax

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4


def _np(t):
    return t.detach().numpy()


# ------------------------------------------------------------ tests/test_extras.py
@pytest.mark.parametrize("shuffle", [False, True])
def test_permute_matches_jax(shuffle):
    p, jp = permute.init(8, shuffle=shuffle, seed=3), jpermute.init(8, shuffle=shuffle, seed=3)
    assert np.array_equal(_np(p["indices"]), np.asarray(jp["indices"]))
    x = randn(0, (2, 4, 4, 8))
    y, _ = permute.forward(p, _t(x))
    assert np.array_equal(_np(y), np.asarray(jpermute.forward(jp, x)[0]))
    assert torch.equal(permute.inverse(p, y)[0], _t(x))
    if not shuffle:
        assert np.array_equal(_np(y), x[..., ::-1])


def _step_case(spec: FlowStepSpec, seed=0):
    """(port params, JAX params, JAX spec) of a perturbed step."""
    params = perturb(spec.init(torch.Generator().manual_seed(seed)), seed=seed + 1)
    jspec = JFlowStepSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})
    return params, to_jax(params), jspec


STEPS = {
    "reverse": FlowStepSpec(in_channels=8, flow_permutation="reverse", hidden_channels=8),
    "shuffle": FlowStepSpec(in_channels=8, flow_permutation="shuffle", hidden_channels=8),
    "lu": FlowStepSpec(in_channels=8, lu_decomposed=True, hidden_channels=8),
    "noCoupling": FlowStepSpec(in_channels=8, flow_coupling="noCoupling"),
    "injector": FlowStepSpec(in_channels=8, cond_channels=6, flow_coupling="AffineInjector",
                             hidden_channels=8),
    "injector_dense": FlowStepSpec(in_channels=8, cond_channels=6, nn_module="DenseBlock",
                                   flow_coupling="AffineInjector", hidden_channels=8),
}


@pytest.mark.parametrize("name", list(STEPS))
def test_flow_step_matches_jax(name):
    """Forward (z, logdet) and inverse against the JAX step; the round trip."""
    spec = STEPS[name]
    params, jp, jspec = _step_case(spec)
    x, ld0 = randn(2, (2, 4, 4, 8)), np.zeros(2, np.float32)
    u = randn(3, (2, 4, 4, 6)) if spec.cond_channels else None
    jy, jld = jspec.forward(jp, x, u, ld0)
    y, ld = spec.forward(params, _t(x), None if u is None else _t(u), _t(ld0))
    close_scaled(y, jy, TOL, "z")
    close_scaled(ld, jld, TOL, "logdet")
    jx, jld2 = jspec.inverse(jp, np.asarray(jy), u, np.asarray(jld))
    x2, ld2 = spec.inverse(params, y, None if u is None else _t(u), ld)
    close_scaled(x2, jx, TOL, "inverse")
    close_scaled(ld2, jld2, TOL, "inverse logdet")
    close_scaled(x2, x, TOL, "round trip")


@pytest.mark.parametrize("name", ["injector", "lu", "noCoupling"])
def test_flow_step_calibrate_matches_jax(name):
    spec = STEPS[name]
    params, jp, jspec = _step_case(spec)
    x = randn(4, (2, 4, 4, 8)) * 2 + 0.5
    u = randn(5, (2, 4, 4, 6)) if spec.cond_channels else None
    jnew, jz, _ = jspec.calibrate(jp, x, u, np.zeros(2, np.float32))
    new, z, _ = spec.calibrate(params, _t(x), None if u is None else _t(u), torch.zeros(2))
    close_scaled(z, jz, TOL, "z")
    got, ref = jax.tree_util.tree_leaves_with_path(to_jax(new)), jax.tree.leaves(jnew)
    assert len(got) == len(ref)
    for (path, a), b in zip(got, ref):
        close_scaled(a, np.asarray(b), TOL, jax.tree_util.keystr(path))


def test_calibrate_applies_the_permutation():
    """The port's calibrate runs the permutation as its forward does (the JAX
    package's skips reverse / shuffle: ROADMAP Queue 3)."""
    spec = STEPS["shuffle"]
    params, _, _ = _step_case(spec)
    x = _t(randn(6, (2, 4, 4, 8)))
    new, z, ld = spec.calibrate(params, x, None, torch.zeros(2))
    z2, ld2 = spec.forward(new, x, None, torch.zeros(2))
    assert torch.equal(z, z2) and torch.equal(ld, ld2)


def test_lu_invconv_matches_jax_and_its_weight():
    p = invconv.init_lu(torch.Generator().manual_seed(0), 6)
    p = {k: v + (0.05 * torch.from_numpy(randn(7, tuple(v.shape))) if k in ("l", "u", "log_s")
                 else 0) for k, v in p.items()}
    jp = {k: _np(v) for k, v in p.items()}
    l, u = invconv._lu_weight(p)
    w = p["p"] @ l @ u
    assert np.isclose(float(torch.linalg.slogdet(w)[1]), float(p["log_s"].sum()), atol=1e-5)
    jl, ju = jinvconv._lu_weight(jp)
    close_scaled(l, jl, 1e-6, "L")
    close_scaled(u, ju, 1e-6, "U")
    x = randn(8, (2, 3, 5, 6))
    for fn, jfn in ((invconv.forward, jinvconv.forward), (invconv.inverse, jinvconv.inverse)):
        y, ld = fn(p, _t(x), torch.zeros(2))
        jy, jld = jfn(jp, x, jnp.zeros(2))
        close_scaled(y, jy, 1e-5, fn.__name__)
        close_scaled(ld, jld, 1e-5, fn.__name__ + " logdet")
    assert invconv.precompute(p) is p  # nothing to attach: the logdet is a sum


def test_sigmoid_flow_matches_jax():
    x = randn(0, (2, 4, 4, 3))
    ld0 = np.zeros(2, np.float32)
    y, ld = extras.sigmoid_forward(_t(x), _t(ld0))
    jy, jld = jextras.sigmoid_forward(x, ld0)
    close_scaled(y, jy, 1e-6, "y")
    close_scaled(ld, jld, 1e-5, "logdet")
    x2, ld2 = extras.sigmoid_inverse(y, ld)
    jx2, jld2 = jextras.sigmoid_inverse(np.asarray(jy), np.asarray(jld))
    close_scaled(x2, jx2, 1e-5, "inverse")
    close_scaled(ld2, jld2, 1e-5, "inverse logdet")
    close_scaled(x2, x, 1e-4, "round trip")


def test_masked_actnorm_matches_jax():
    p = {"bias": _t(randn(1, (4,)) * 0.3), "logs": _t(randn(2, (4,)) * 0.2)}
    jp = {k: _np(v) for k, v in p.items()}
    x, mask = randn(3, (3, 4, 4, 4)), np.array([True, False, True])
    y, ld = extras.masked_actnorm_forward(p, _t(x), _t(mask), torch.zeros(3))
    jy, jld = jextras.masked_actnorm_forward(jp, x, mask, jnp.zeros(3))
    close_scaled(y, jy, 1e-6, "y")
    close_scaled(ld, jld, 1e-5, "logdet")
    assert torch.equal(y[1], _t(x)[1]) and ld[1] == 0
    x2, ld2 = extras.masked_actnorm_inverse(p, y, _t(mask), ld)
    close_scaled(x2, jextras.masked_actnorm_inverse(jp, np.asarray(jy), mask, np.asarray(jld))[0],
                 1e-6, "inverse")
    close_scaled(ld2, np.zeros(3), 1e-4, "inverse logdet")


@pytest.mark.parametrize("cond", [0, 5])
def test_split2d_matches_jax(cond):
    spec = extras.Split2dSpec(num_channels=8, num_channels_pass=4, cond_channels=cond,
                              logs_eps=0.01 if cond else 0.0)
    jspec = jextras.Split2dSpec(num_channels=8, num_channels_pass=4, cond_channels=cond,
                                logs_eps=0.01 if cond else 0.0)
    p = perturb(spec.init(), seed=1)
    jp = to_jax(p)
    x, ft = randn(2, (2, 4, 4, 8)), (randn(3, (2, 4, 4, cond)) if cond else None)
    z1, ld, eps = spec.forward(p, _t(x), torch.zeros(2), None if ft is None else _t(ft))
    jz1, jld, jeps = jspec.forward(jp, x, jnp.zeros(2), ft)
    close_scaled(z1, jz1, TOL, "z1")
    close_scaled(ld, jld, TOL, "logdet")
    close_scaled(eps, jeps, TOL, "eps")
    x2, ld2 = spec.inverse(p, z1, ld, eps=eps, ft=None if ft is None else _t(ft))
    jx2, jld2 = jspec.inverse(jp, None, np.asarray(jz1), np.asarray(jld), eps=np.asarray(jeps),
                              ft=ft)
    close_scaled(x2, jx2, TOL, "inverse")
    close_scaled(ld2, jld2, TOL, "inverse logdet")
    close_scaled(x2, x, TOL, "round trip")


def test_rdn_matches_jax():
    spec = extras.RDNSpec(in_channels=4, out_channels=6, nb=2, nf=8, gc=4)
    jspec = jextras.RDNSpec(in_channels=4, out_channels=6, nb=2, nf=8, gc=4)
    p = spec.init(torch.Generator().manual_seed(0))
    x = randn(1, (1, 8, 8, 4))
    assert spec.apply(p, _t(x)).abs().max() == 0  # the zero-init last conv
    p = perturb(p, seed=2)
    close_scaled(spec.apply(p, _t(x)), jspec.apply(to_jax(p), x), TOL, "rdn")


def test_laplace_matches_jax():
    mean, logs, x = randn(0, (2, 3, 3, 4)), randn(1, (2, 3, 3, 4)) * 0.3, randn(2, (2, 3, 3, 4))
    close_scaled(densities.laplace_logp(_t(mean), _t(logs), _t(x)),
                 jdens.laplace_logp(mean, logs, x), 1e-5, "logp")
    close_scaled(densities.laplace_likelihood(None, None, _t(x)),
                 jdens.laplace_likelihood(None, None, x), 1e-6, "standard")


# ----------------------------------------------------------- models from option files
def _opt(fd=None, so=None):
    opt = yaml.safe_load((ROOT / "configs" / "train_SR_DF2K_4X_HCFlow.yml").read_text())
    opt["network_G"].pop("encoder_dtype", None)  # float32 throughout
    f = opt["network_G"]["flowDownsampler"]
    f.update(K=2, hidden_channels=8, **(fd or {}))
    f["splitOff"].update(after_flowstep=[1, 1], hidden_channels=8, RRDB_nb=[1, 1], RRDB_nf=8,
                         RRDB_gc=4, **(so or {}))
    return opt


MODELS = {
    "shuffle_main_reverse_splitoff": ({"flow_permutation": "shuffle"},
                                      {"flow_permutation": "reverse"}),
    "none_main_shuffle_splitoff": ({"flow_permutation": "none"},
                                   {"flow_permutation": "shuffle"}),
    "reverse_main_none_splitoff": ({"flow_permutation": "reverse"},
                                   {"flow_permutation": "none"}),
    "noCoupling_main": ({"flow_coupling": "noCoupling"}, None),
    "injector_splitoff": (None, {"flow_coupling": "AffineInjector"}),
    "noCoupling_splitoff": (None, {"flow_coupling": "noCoupling"}),
}


def _model_case(opt):
    model, jmodel = config.model_spec_from_opt(opt), jconfig.model_spec_from_opt(opt)
    params = perturb(model.init(0, device="cpu"), scale=0.02)
    jp = to_jax(params)
    return model, convert.params_from_jax(jp, model, device="cpu"), jmodel, jp


def _check_model(opt, packs):
    """Forward NLL and reverse (plain and fused params) against JAX; ``packs``: which
    of the fused params' chains must be packed for the chain kernel."""
    model, params, jmodel, jp = _model_case(opt)
    rng = np.random.default_rng(0)
    hr = rng.uniform(size=(2, 16, 16, 3)).astype(np.float32)
    lr = hr.reshape(2, 4, 4, 4, 4, 3).mean((2, 4))
    noise = rng.uniform(size=hr.shape).astype(np.float32)
    nll_j = jax_run(lambda p, a, b, n: jmodel.forward(p, None, a, b, noise=n)[1], jp, hr, lr,
                    noise)
    nll = model.forward(params, _t(hr), _t(lr), noise=_t(noise))[1]
    assert np.isfinite(float(nll_j))
    close_scaled(nll, nll_j, TOL, "nll")
    eps = [randn(10 + lv.level, (2, 4 * 2 ** (model.flow.L - 1 - lv.level),
                                 4 * 2 ** (model.flow.L - 1 - lv.level), lv.cond_spec.a_channels))
           for lv in model.flow.levels]
    sr_j = jax_run(lambda p, x, e: jmodel.flow.reverse_flow(p, jax.random.PRNGKey(0), x, 0.8,
                                                            eps_list=e), jp, lr, eps)
    assert np.isfinite(np.asarray(sr_j)).all()
    fused = model.flow.precompute_inference(params, fused=True)
    for p in (params, fused):
        close_scaled(model.flow.reverse_flow(p, _t(lr), 0.8, eps_list=[_t(e) for e in eps]),
                     sr_j, TOL, "reverse")
    for lv in model.flow.levels:
        lp = fused[f"level{lv.level}"]
        assert ("main_fused" in lp, "steps_fused" in lp["cond"]) == packs, lv.level


@pytest.mark.parametrize("name", list(MODELS))
def test_option_file_model_matches_jax(name):
    fd, so = MODELS[name]
    perm_main = (fd or {}).get("flow_permutation", "invconv")
    packs = (perm_main == "invconv" and "flow_coupling" not in (fd or {}), so is None)
    _check_model(_opt(fd, so), packs)


def test_flow_permutation_none_serves_fused():
    """The fault: an SR model with flow_permutation none, served fused, against JAX's
    reverse with explicit latents; its main chains serve on the plain path and its
    split-off chains (invconv) through the chain kernel's pack."""
    _check_model(_opt({"flow_permutation": "none"}), (False, True))


@pytest.mark.parametrize("fd, so, match", [
    ({"flow_coupling": "AffineInjector"}, None, "no cond features"),
    ({"cond_channels": 16}, None, "no cond features"),
    (None, {"nn_module": "DenseBlock"}, "splitOff.nn_module"),
])
def test_config_refuses_what_jax_cannot_run(fd, so, match):
    with pytest.raises(NotImplementedError, match=match):
        config.model_spec_from_opt(_opt(fd, so))


# ------------------------------------------------------------- reference state_dicts
def test_params_from_state_dict_reads_the_new_keys():
    """Synthetic reference names (permute.{p,sign_s,l,log_s,u}, affine.f_injector.*, a
    noCoupling step, a reverse and a shuffle step) read as the JAX package reads them."""
    rng = np.random.default_rng(0)

    def net(p, cin, cout, hid=8):
        return {f"{p}.conv1.weight": rng.standard_normal((hid, cin, 3, 3)),
                f"{p}.conv1.actnorm.bias": rng.standard_normal((1, hid, 1, 1)),
                f"{p}.conv1.actnorm.logs": rng.standard_normal((1, hid, 1, 1)),
                f"{p}.conv2.weight": rng.standard_normal((hid, hid, 1, 1)),
                f"{p}.conv2.actnorm.bias": rng.standard_normal((1, hid, 1, 1)),
                f"{p}.conv2.actnorm.logs": rng.standard_normal((1, hid, 1, 1)),
                f"{p}.conv3.weight": rng.standard_normal((cout, hid, 3, 3)),
                f"{p}.conv3.bias": rng.standard_normal(cout),
                f"{p}.conv3.logs": rng.standard_normal((cout, 1, 1))}

    sd = {"s.actnorm.bias": rng.standard_normal((1, 8, 1, 1)),
          "s.actnorm.logs": rng.standard_normal((1, 8, 1, 1))}
    for k, shape in (("p", (8, 8)), ("sign_s", (8,)), ("l", (8, 8)), ("log_s", (8,)),
                     ("u", (8, 8))):
        sd[f"s.permute.{k}"] = rng.standard_normal(shape)
    sd.update(net("s.affine.f", 4 + 6, 8))
    sd.update(net("s.affine.f_injector", 6, 16))
    sd = {k: np.asarray(v, np.float32) for k, v in sd.items()}
    reader = convert._StateDict({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, "cpu")
    for spec in (dataclasses.replace(STEPS["injector"], lu_decomposed=True),
                 dataclasses.replace(STEPS["lu"], flow_coupling="noCoupling")):
        got = to_jax(reader.flowstep("s", spec))
        jspec = JFlowStepSpec(**{f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)})
        ref = convert_flowstep(sd, "s", jspec)
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(a, np.asarray(b))
    rev = reader.flowstep("s", dataclasses.replace(STEPS["reverse"], flow_coupling="noCoupling"))
    assert torch.equal(rev["permute"]["indices"], torch.arange(7, -1, -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="shuffle"):
        reader.flowstep("s", dataclasses.replace(STEPS["shuffle"], flow_coupling="noCoupling"))


def test_new_leaves_round_trip_and_train():
    """params_to_jax / params_from_jax carry a permutation's int32 indices and the
    injector's net (derived invconv entries dropped); a train step leaves the indices
    as they are and updates every float leaf."""
    from hcflow_tpu_torch.train import schedules, trainer

    opt = _opt({"flow_permutation": "shuffle"}, {"flow_coupling": "AffineInjector"})
    model, params, _, _ = _model_case(opt)
    served = model.flow.precompute_inference(params)
    back = convert.params_from_jax(convert.params_to_jax(served, model), model, device="cpu")
    a, b = trainer.tree_leaves(params), trainer.tree_leaves(back)
    assert len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(a, b))
    assert back["level0"]["main"][0]["permute"]["indices"].dtype == torch.int32
    topt = {"lr_G": 1e-3, "lr_steps": [100]}
    tx = trainer.make_optimizer(topt, schedules.schedule_from_opt(topt))
    state = trainer.init_state(params, tx)
    rng = np.random.default_rng(1)
    hr = _t(rng.uniform(size=(2, 16, 16, 3)).astype(np.float32))
    lr = hr.reshape(2, 4, 4, 4, 4, 3).mean((2, 4))
    state, m = trainer.make_sr_nll_step(model, tx)(state, hr, lr, noise=torch.zeros_like(hr))
    assert len(m["grads"]) == len(trainer.param_leaves(params)) < len(a)
    after = trainer.tree_leaves(state.params)
    ints = [(x, y) for x, y in zip(a, after) if not x.is_floating_point()]
    assert ints and all(torch.equal(x, y) for x, y in ints)
    assert all(not y.requires_grad for _, y in ints)
