"""Shared helpers of the tests/test_torch_port_*.py files.

Params are made by the PyTorch port's inits (fast, unlike the JAX package's eager
inits), perturbed with numpy noise from a seed, and handed to the JAX package in
its own layout by :func:`to_jax`.
"""

import numpy as np
import torch

# The TINY topology of tests/test_pallas_chain.py: every module of the x4 SR
# reverse pass at a few channels.
TINY = dict(
    K=(3, 3), after_splitoff=(1, 1), rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4,
    hidden_channels=8, so_hidden_channels=8,
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
