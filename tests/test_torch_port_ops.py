"""The PyTorch port's ops and flow modules against their JAX counterparts on the CPU.

Params come from the port's inits, perturbed with numpy noise from a seed, and go
to both packages (to the JAX one in its own layout); inputs are numpy arrays made
from a seed.  Tolerances: float32 paths agree to ~1e-5 (the same arithmetic, summed
in another order).  In the bf16 recipe both packages run the net convs on bf16
operands with float32 sums; the port rounds each conv OUTPUT through bf16, as the
JAX source asks for (hcflow_tpu/ops/nets.py:48-55), while XLA on the CPU keeps that
sum in float32, so a conv output can land a bf16 step (2^-8 = 3.9e-3 relative)
apart; 5e-3 covers about one such step on the outputs compared here (measured
worst: 5.2e-4).
"""

import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hcflow_tpu.flow import stack as jstack
from hcflow_tpu.flow.flowstep import FlowStepSpec as JFlowStepSpec
from hcflow_tpu.ops import actnorm as jactnorm
from hcflow_tpu.ops import coupling as jcoupling
from hcflow_tpu.ops import densities as jdensities
from hcflow_tpu.ops import invconv as jinvconv
from hcflow_tpu.ops import nets as jnets
from hcflow_tpu.ops import squeeze as jsqueeze
from hcflow_tpu_torch.flow import stack
from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
from hcflow_tpu_torch.models import HCFlowSRSpec
from hcflow_tpu_torch.ops import actnorm, coupling, densities, invconv, nets, squeeze

from _torch_port_util import TINY, assert_close, perturb, randn, to_jax

F32 = 2e-5  # float32: same arithmetic, another summation order
BF16 = 5e-3  # bf16 recipe: about one bf16 step (2^-8 relative) on a conv output
RECIPES = [(None, F32), ("bfloat16", BF16)]


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------------ 1. squeeze
def test_squeeze_unsqueeze_upsample_match_jax():
    x = randn(0, (2, 4, 6, 3))
    sq = squeeze.squeeze2d(_t(x))
    assert_close(sq, jsqueeze.squeeze2d(jnp.asarray(x)), 0)
    assert_close(squeeze.unsqueeze2d(sq), x, 0)
    y = randn(1, (2, 2, 3, 12))
    assert_close(squeeze.unsqueeze2d(_t(y)), jsqueeze.unsqueeze2d(jnp.asarray(y)), 0)
    assert_close(squeeze.nearest_upsample(_t(y), 2),
                 jsqueeze.nearest_upsample(jnp.asarray(y), 2), 0)


# ------------------------------------------------------------------ 2. actnorm
def test_actnorm_forward_inverse_match_jax():
    p = perturb(actnorm.init(5), scale=0.1)
    x = randn(4, (2, 3, 4, 5))
    ld = np.zeros(2, np.float32)
    y, ldy = actnorm.forward(p, _t(x), _t(ld))
    jy, jldy = jactnorm.forward(to_jax(p), x, ld)
    assert_close(y, jy, F32)
    assert_close(ldy, jldy, 1e-4)
    xi, ldi = actnorm.inverse(p, y, ldy)
    jxi, jldi = jactnorm.inverse(to_jax(p), jy, jldy)
    assert_close(xi, jxi, F32)
    assert_close(ldi, jldi, 1e-4)


# ------------------------------------------------------------------ 3. invconv
def test_invconv_init_precompute_inverse_match_jax():
    p = invconv.init(_g(), 6)
    w = p["weight"]
    assert torch.allclose(w @ w.T, torch.eye(6), atol=1e-5)  # orthogonal (QR), as Glow's
    p = perturb(p)
    tp, jp = invconv.precompute(p), jinvconv.precompute(to_jax(p))
    assert_close(tp["w_inv"], jp["w_inv"], 1e-5)
    assert_close(tp["logdet_w"], jp["logdet_w"], 1e-5)
    y = randn(7, (2, 3, 4, 6))
    ld = np.zeros(2, np.float32)
    x, ldx = invconv.inverse(tp, _t(y), _t(ld))
    jx, jldx = jinvconv.inverse(jp, y, ld)
    assert_close(x, jx, F32)
    assert_close(ldx, jldx, 1e-4)


# ---------------------------------------------------------------- 4. densities
def test_gaussian_logp_and_sample():
    mean, logs, x = randn(8, (2, 3, 4, 5)), 0.1 * randn(9, (2, 3, 4, 5)), randn(10, (2, 3, 4, 5))
    assert_close(densities.gaussian_logp(_t(mean), _t(logs), _t(x)),
                 jdensities.gaussian_logp(mean, logs, x), 1e-4)
    s = densities.gaussian_sample(_g(3), _t(mean), _t(logs), 0.7)
    eps = torch.randn(mean.shape, generator=_g(3)).numpy()
    assert_close(s, mean + np.exp(logs) * eps * 0.7, 1e-6)
    assert torch.equal(densities.gaussian_sample(_g(3), _t(mean), _t(logs), 0.0), _t(mean))


# --------------------------------------------------------------------- 5. nets
@pytest.mark.parametrize("cd,tol", RECIPES)
def test_conv2d_matches_jax(cd, tol):
    x, w, b = randn(11, (2, 5, 6, 8)), 0.2 * randn(12, (4, 8, 3, 3)), randn(13, (4,))
    out = nets.conv2d(_t(x), _t(w), _t(b), compute_dtype=cd)
    assert out.dtype == torch.float32
    assert_close(out, jnets.conv2d(x, to_jax({"w": _t(w)})["w"], b, compute_dtype=cd), tol, tol)


@pytest.mark.parametrize("cd,tol", RECIPES)
def test_fcn_and_hoisted_fcn_match_jax(cd, tol):
    p = perturb(nets.init_fcn(_g(), 4 + 6, 8, 8))
    jp = to_jax(p)
    x = randn(14, (2, 5, 6, 10))
    assert_close(nets.apply_fcn(p, _t(x), cd), jnets.apply_fcn(jp, x, cd), tol, tol)
    z1, uc = randn(15, (2, 5, 6, 4)), randn(16, (2, 5, 6, 8))
    assert_close(nets.apply_fcn_hoisted(p, _t(z1), _t(uc), cd),
                 jnets.apply_fcn_hoisted(jp, z1, uc, cd), tol, tol)
    h = randn(17, (2, 5, 6, 8))
    assert_close(nets.apply_conv_zeros(p["conv3"], _t(h)),
                 jnets.apply_conv_zeros(jp["conv3"], h), F32, F32)


@pytest.mark.parametrize("cd,tol", [(None, 1e-4), ("bfloat16", BF16)])
def test_rrdb_trunk_matches_jax(cd, tol):
    trunk = perturb(nets.init_rrdb_trunk(_g(1), 2, 8, 4))
    x = randn(18, (2, 5, 6, 8))
    assert_close(nets.apply_rrdb_trunk(trunk, _t(x), cd),
                 jnets.apply_rrdb_trunk(to_jax(trunk), x, cd), tol, tol)


def test_inits_match_jax_shapes():
    """Port inits give the JAX inits' trees and shapes, in the JAX layout."""
    key = jax.random.PRNGKey(0)

    def shapes(tree):
        return jax.tree.map(np.shape, tree)

    def jshapes(init, *args):
        return jax.tree.map(lambda s: s.shape, jax.eval_shape(lambda k: init(k, *args), key))

    assert shapes(to_jax(nets.init_rrdb_trunk(_g(), 2, 8, 4))) == jshapes(
        jnets.init_rrdb_trunk, 2, 8, 4)
    assert shapes(to_jax(nets.init_fcn(_g(), 10, 8, 8))) == jshapes(jnets.init_fcn, 10, 8, 8)
    spec = FlowStepSpec(in_channels=6, cond_channels=16, hidden_channels=8)
    jspec = JFlowStepSpec(in_channels=6, cond_channels=16, hidden_channels=8)
    step = spec.init(_g())
    assert shapes(to_jax(step["coupling"])) == jshapes(jspec.coupling_spec.init)
    assert shapes(to_jax(step["invconv"])) == {"weight": (6, 6)}
    assert shapes(to_jax(step["actnorm"])) == shapes(jactnorm.init(6))


# ------------------------------------------------------- 6-8. coupling, step, stack
def _steps(c, cond_ch, K, cd):
    spec = FlowStepSpec(in_channels=c, cond_channels=cond_ch, hidden_channels=8, compute_dtype=cd)
    jspec = JFlowStepSpec(in_channels=c, cond_channels=cond_ch, hidden_channels=8,
                          compute_dtype=cd)
    steps = stack.precompute_invconv(perturb(stack.init_stack(spec, _g(2), K)))
    return spec, jspec, steps, to_jax(steps)


@pytest.mark.parametrize("cd,tol", RECIPES)
def test_coupling_inverse_matches_jax(cd, tol):
    spec, jspec, steps, jstacked = _steps(12, 16, 1, cd)
    p, jp = steps[0]["coupling"], jax.tree.map(lambda a: a[0], jstacked["coupling"])
    z, u = randn(19, (2, 5, 6, 12)), randn(20, (2, 5, 6, 16))
    ld = np.zeros(2, np.float32)
    cs, jcs = spec.coupling_spec, jspec.coupling_spec
    assert cs.supports_hoisting and jcs.supports_hoisting
    out, ldo = cs.inverse(p, _t(z), _t(u), _t(ld))
    jout, jldo = jcs.inverse(jp, z, u, ld)
    assert_close(out, jout, tol, tol)
    assert_close(ldo, jldo, 1e-4, tol)
    uc = randn(21, (2, 5, 6, 8))
    assert_close(cs.inverse_hoisted(p, _t(z), _t(uc))[0],
                 jcs.inverse_hoisted(jp, z, uc)[0], tol, tol)
    assert_close(coupling.clamp_logscale(_t(z)), jcoupling._clamp_logscale(jnp.asarray(z)), 1e-6)


@pytest.mark.parametrize("cd,tol", RECIPES)
def test_flowstep_inverse_matches_jax(cd, tol):
    spec, jspec, steps, jstacked = _steps(12, 16, 1, cd)
    jp = jax.tree.map(lambda a: a[0], jstacked)
    z, u = randn(22, (2, 5, 6, 12)), randn(23, (2, 5, 6, 16))
    assert_close(spec.inverse(steps[0], _t(z), _t(u))[0], jspec.inverse(jp, z, u)[0], tol, tol)
    uc = randn(24, (2, 5, 6, 8))
    assert_close(spec.inverse_hoisted(steps[0], _t(z), _t(uc))[0],
                 jspec.inverse_hoisted(jp, z, uc)[0], tol, tol)


@pytest.mark.parametrize("cd,tol", [(None, 1e-4), ("bfloat16", BF16)])
def test_stack_inverse_matches_jax(cd, tol):
    spec, jspec, steps, jstacked = _steps(6, 16, 3, cd)
    z, u = randn(25, (2, 5, 7, 6)), randn(26, (2, 5, 7, 16))
    ld = np.zeros(2, np.float32)
    uc = np.asarray(jstack.compute_u_contribs(jspec, jstacked, u))  # (K, B, H, W, hid)
    assert_close(stack.compute_u_contribs(spec, steps, _t(u)),
                 uc.transpose(1, 2, 3, 0, 4).reshape(2, 5, 7, 3 * 8), tol, tol)
    assert_close(stack.inverse_stack_hoisted(spec, steps, _t(z), _t(u))[0],
                 jstack.inverse_stack_hoisted(jspec, jstacked, z, u, ld)[0], tol, tol)
    assert_close(stack.inverse_stack(spec, steps, _t(z), _t(u))[0],
                 jstack.inverse_stack(jspec, jstacked, z, u, ld)[0], tol, tol)


# ---------------------------------------------------------------- e. imports, f. device
# the JAX package and what its orbax backend stands on (the port reads and writes the
# format itself: utils/orbax.py, utils/ocdbt.py, csrc/zstd_decode.cpp)
FORBIDDEN = ("jax", "jaxlib", "hcflow_tpu", "orbax", "tensorstore", "zstandard")


def _imported_modules(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_jax_package():
    """No module of the port imports jax or the JAX package, hcflow_tpu (matched by
    the exact top-level name: hcflow_tpu_torch starts with the same letters), nor
    orbax, tensorstore or zstandard."""
    pkg = pathlib.Path(__file__).resolve().parents[1] / "hcflow_tpu_torch"
    files = sorted(pkg.rglob("*.py"))
    assert len(files) >= 15
    bad = [(f.name, m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert bad == []


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/profile_port.py",
                                    "tools/ab_kernels.py", "tools/ab_passes.py",
                                    "tools/probe_conv_f32.py", "tools/probe_chain3s.py"])
def test_chip_scripts_import_no_jax(script):
    """The scripts that run the port on the card import neither jax nor hcflow_tpu
    (nor orbax, tensorstore or zstandard)."""
    path = pathlib.Path(__file__).resolve().parents[1] / script
    assert [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN] == []


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")
    model = HCFlowSRSpec.for_scale(4, **TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(0)
    assert model.init(0, device="cpu")["level0"]["main"]
