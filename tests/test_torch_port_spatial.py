"""Spatially sharded serving of the port (``parallel/mesh.py``'s ('data', 'spatial')
mesh, ``parallel/halo.py``'s halo exchange) on the CPU, in gloo ranks started by
``parallel.dryrun.launch``: one launch of 2 ranks (mesh (1, 2)) and one of 4 ((2, 2) and
(1, 4)), each running every case of its world (tests/_spatial_ranks.py).

- the halo exchange: a stack of n random 3x3 convs on bands of 2 rows with a halo of n
  rows equals the stack on the whole image, also where n exceeds a band (spatial 4), and
  so does its gradient with respect to the input and the weights (the exchange's
  backward: each halo row's gradient returned to the rank that owns the row);
- ``make_mesh``: the rank layout is the JAX package's device layout, and each rank's
  groups are its data row and spatial column;
- the x4 SR reverse at the TINY topology with explicit global latents, float32 and bf16,
  fused (the kernels' plain versions on band + halo) and unfused, at (1, 2) and (2, 2):
  against JAX's ``reverse_flow`` at ``TOL[cd]`` and the port's unsharded pass at 1e-5 x
  max; the JAX package's own case (tests/test_sharding.py: LR 16x16 at heat 0, 2 rows a
  device on its (1, 8) mesh) at spatial 4 against JAX's SPMD result at 1e-4; sampling
  from a seeded generator at heat 0.9 sharded as unsharded; the x8 reverse on
  resident-trunk packs and the rescaling downscale -> quantize -> upscale (LR and HR),
  bf16 and float32 (the shipped test configs' recipe), against the unsharded run and
  JAX; the float32 rescaling case upscales the unsharded pass's 8-bit codes on the mesh
  (``ServeCase.codes``), and JAX upscales them too, so that an LR value that float32
  rounding moves across a code boundary cannot decide the comparison;
- the codes: ``dryrun.code_flips`` counts one flip for two LRs 1e-7 apart across a
  boundary and none away from it; ``dryrun.HeldCodes`` returns the codes it holds and
  passes the gradient as ``quantize_ste``;
- every rank's halo exchanges and bytes equal ``dryrun.expected_exchanges``, its kernel
  launches the unsharded pass's (none on the CPU); a halo one row short breaks the
  result; a height (or batch) that the axis does not divide raises; a mesh of one rank
  changes no bit.
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import _spatial_ranks
from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import TINY, TOL, jax_run, perturb, randn, to_jax
from hcflow_tpu_torch.convert import params_from_jax
from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec, quantize
from hcflow_tpu_torch.parallel import dryrun, mesh

WORLD_MESHES = {2: [(1, 2)], 4: [(2, 2), (1, 4)]}
B, LH, LW = 2, 8, 6  # x4 LR; 4 rows a band at spatial 2, 2 at spatial 4 (HR 32 x 24)
UNSHARDED_RTOL = 1e-5  # of max |unsharded|
TINY8 = dict(K=(2, 2, 2), after_splitoff=(1, 1, 1), rrdb_nb=(2, 1), rrdb_nf=16, rrdb_gc=8,
             hidden_channels=16, so_hidden_channels=16)
TINY_RS = dict(K=(4, 4), after_splitoff=(2, 2), hidden_channels=8, so_hidden_channels=8,
               rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=8)
# the JAX package's spatial test (tests/test_sharding.py:146-166)
SHARDING_TEST = dict(rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4, K=(2, 2), after_splitoff=(1, 1),
                     hidden_channels=8, so_hidden_channels=8)


def _port_params(model):
    """The port's perturbed init, read back through the JAX layout (as the JAX side gets
    it), and the JAX tree."""
    jp = to_jax(perturb(model.init(0, device="cpu"), scale=0.02))
    return params_from_jax(jp, model, device="cpu"), jp


@functools.lru_cache(maxsize=None)
def _cases():
    """name -> (ServeCase, its JAX reference or None); the cases of every world."""
    out = {}
    lr = np.random.default_rng(1).uniform(size=(B, LH, LW, 3)).astype(np.float32)
    eps = [randn(2, (B, 2 * LH, 2 * LW, 6)), randn(3, (B, LH, LW, 21))]
    for cd in (None, "bfloat16"):
        model = HCFlowSRSpec.for_scale(4, compute_dtype=cd, **TINY)
        params, jp = _port_params(model)
        ref = ("x4", cd, jp)
        for shape in ((1, 2), (2, 2)):
            for fused in (True, False):
                out[f"x4 {cd} fused={fused} {shape}"] = (dryrun.ServeCase(
                    model, params, torch.from_numpy(lr), 0.9, fused=fused,
                    eps_list=[torch.from_numpy(e) for e in eps], mesh_shape=shape), ref)
    model = HCFlowSRSpec.for_scale(4, compute_dtype="bfloat16", **TINY)
    params, _ = _port_params(model)
    sample = dryrun.ServeCase(model, params, torch.from_numpy(lr), 0.9, seed=7)
    out["x4 sample"] = (sample, None)
    out["x4 halo one row short"] = (dataclasses.replace(sample, halo_cut=1), None)

    model = HCFlowSRSpec.for_scale(4, **SHARDING_TEST)
    params, jp = _port_params(model)
    lr16 = np.random.default_rng(4).uniform(size=(1, 16, 16, 3)).astype(np.float32)
    out["jax sharding test"] = (dryrun.ServeCase(model, params, torch.from_numpy(lr16), 0.0,
                                                 fused=False, mesh_shape=(1, 4)),
                                ("spmd", jp, lr16))

    lr8 = np.random.default_rng(5).uniform(size=(B, 4, 4, 3)).astype(np.float32)
    eps8 = [randn(6, (B, 16, 16, 6)), randn(7, (B, 8, 8, 12)), randn(8, (B, 4, 4, 45))]
    hr = np.random.default_rng(9).uniform(size=(B, 16, 24, 3)).astype(np.float32)
    eps_r = [0.3 * randn(10, (B, 8, 12, 6)), 0.3 * randn(11, (B, 4, 6, 21))]
    for cd, sfx in (("bfloat16", ""), (None, " f32")):
        model = HCFlowSRSpec.for_scale(8, compute_dtype=cd, **TINY8)
        params, jp = _port_params(model)
        out["x8 resident" + sfx] = (dryrun.ServeCase(
            model, params, torch.from_numpy(lr8), 0.8, resident=True,
            eps_list=[torch.from_numpy(e) for e in eps8]), ("x8", jp, lr8, eps8, cd))
        model = HCFlowRescalingSpec.default_x4(compute_dtype=cd, **TINY_RS)
        params, jp = _port_params(model)
        out["rescaling" + sfx] = (dryrun.ServeCase(model, params, torch.from_numpy(hr), 1.0,
                                                   eps_list=[torch.from_numpy(e) for e in eps_r]),
                                  ("rescaling", jp, hr, eps_r, cd))
    return out


HOLD_CODES = {"rescaling f32"}  # cases that upscale the unsharded pass's codes on the mesh


@functools.lru_cache(maxsize=None)
def _case(name):
    """A case as the ranks serve it: with the unsharded pass's codes where it holds them."""
    case = _cases()[name][0]
    if name in HOLD_CODES:
        case = dataclasses.replace(case, codes=dryrun.lr_codes(_unsharded(name)["lr"]))
    return case


def _names(world):
    return [n for n, (c, _) in _cases().items() if c.mesh_shape in WORLD_MESHES[world]]


@functools.lru_cache(maxsize=None)
def _launch(world):
    """One launch of ``world`` ranks for every case and check of that world."""
    names = _names(world)
    ranks = dryrun.serve_spatial(world, [_case(n) for n in names], cpu=True,
                                 rank_fn=_spatial_ranks.run, args=(WORLD_MESHES[world],))
    return names, ranks


@functools.lru_cache(maxsize=None)
def _unsharded(name):
    """The unsharded pass (a rescaling case from its own codes)."""
    rec = dryrun.serve(_cases()[name][0], None, "cpu")
    return {k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in rec.items()}


def _result(name):
    world = next(w for w in WORLD_MESHES if _cases()[name][0].mesh_shape in WORLD_MESHES[w])
    names, ranks = _launch(world)
    i = names.index(name)
    return [r["serve"][i] for r in ranks]


@functools.lru_cache(maxsize=None)
def _jax(name):
    """The JAX package's output for a case (clipped to [0, 1] as the port's reverse)."""
    from hcflow_tpu.models.hcflow_rescaling import HCFlowRescalingSpec as JRescaling
    from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JSR

    case, ref = _cases()[name]
    key = jax.random.PRNGKey(4)
    if ref[0] == "x4":
        return _jax_x4(ref[1])
    if ref[0] == "x8":
        _, jp, lr, eps, cd = ref
        jm = JSR.for_scale(8, compute_dtype=cd, **TINY8)
        fn = lambda p, x, e: jm.flow.reverse_flow(p, key, x, 0.8, eps_list=e)  # noqa: E731
        return np.clip(np.asarray(jax_run(fn, jm.flow.precompute_inference(jp), lr, eps)), 0, 1)
    if ref[0] == "spmd":  # tests/test_sharding.py's setup, on the port's params
        from jax.sharding import NamedSharding, PartitionSpec as P

        from hcflow_tpu.parallel import make_mesh as jax_mesh

        _, jp, lr = ref
        jm = JSR.for_scale(4, **SHARDING_TEST)
        m = jax_mesh(axis_names=("data", "spatial"), mesh_shape=(1, 8))
        rev = jax.jit(lambda p, k, x: jm.reverse(p, k, x, 0.0))
        return np.asarray(rev(jax.device_put(jp, NamedSharding(m, P())), jax.random.PRNGKey(2),
                              jax.device_put(lr, NamedSharding(m, P("data", "spatial")))))
    _, jp, hr, eps, cd = ref
    jm = JRescaling.default_x4(compute_dtype=cd, **TINY_RS)
    jlr = np.asarray(jax_run(jm.forward, jp, hr)[0])
    # the JAX upscale of the codes the port's sharded pass upscaled: a rounding tie may
    # put the two frameworks' LRs one level apart, which the LR check allows and the HR
    # one would not
    codes = _case(name).codes
    lq = (quantize(_result(name)[0]["lr_image"]) if codes is None
          else dryrun.from_codes(codes)).numpy()
    fn = lambda p, x, e: jm.flow.reverse_flow(p, key, x, 1.0, eps_list=e)  # noqa: E731
    jhr = np.clip(np.asarray(jax_run(fn, jm.flow.precompute_inference(jp), lq, eps)), 0, 1)
    return {"lr": jlr, "hr": jhr}


@functools.lru_cache(maxsize=None)
def _jax_x4(cd):
    """JAX's x4 reverse of the x4 cases in recipe cd (one inputs for every mesh and path)."""
    from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JSR

    case, (_, _, jp) = _cases()[f"x4 {cd} fused=True (1, 2)"]
    jm = JSR.for_scale(4, compute_dtype=cd, **TINY)
    fn = lambda p, x, e: jm.flow.reverse_flow(  # noqa: E731
        p, jax.random.PRNGKey(4), x, 0.9, eps_list=e)
    return np.clip(np.asarray(jax_run(fn, jm.flow.precompute_inference(jp), case.image.numpy(),
                                      [e.numpy() for e in case.eps_list])), 0, 1)


def _close(got, want, tol, what):
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    assert got.shape == want.shape, what
    assert err <= tol, f"{what}: max abs err {err:.3e} > {tol:.3e}"


def _sharded_vs_unsharded(name):
    got, ref = _result(name)[0], _unsharded(name)
    for k, g in (("out", "image"), ("lr", "lr_image")):
        if ref[k] is not None:
            _close(got[g], ref[k], UNSHARDED_RTOL * float(ref[k].abs().max()), f"{name} {k}")


X4 = [n for n in _cases() if n.startswith("x4 None") or n.startswith("x4 bfloat16")]


@pytest.mark.parametrize("name", X4)
def test_x4_reverse_matches_jax_and_unsharded(name):
    case, (_, cd, _) = _cases()[name]
    got = _result(name)[0]["image"]
    assert got.shape == (B, 4 * LH, 4 * LW, 3)
    _close(got.numpy(), _jax(name), TOL[cd], name)
    _sharded_vs_unsharded(name)


def test_jax_spatial_sharding_case_at_spatial_4():
    name = "jax sharding test"
    _close(_result(name)[0]["image"].numpy(), _jax(name), 1e-4, name)
    _sharded_vs_unsharded(name)


def test_sampling_from_a_seeded_generator_sharded_as_unsharded():
    _sharded_vs_unsharded("x4 sample")


def test_a_halo_one_row_short_breaks_the_result():
    got = _result("x4 halo one row short")[0]["image"]
    ref = _unsharded("x4 sample")["out"]
    assert (got - ref).abs().max() > 1e2 * UNSHARDED_RTOL * ref.abs().max()


def test_x8_reverse_on_resident_trunks_matches_jax_and_unsharded():
    name = "x8 resident"
    _close(_result(name)[0]["image"].numpy(), _jax(name), TOL["bfloat16"], name)
    _sharded_vs_unsharded(name)


def test_x8_float32_reverse_on_resident_trunks_matches_jax_and_unsharded():
    name = "x8 resident f32"
    _close(_result(name)[0]["image"].numpy(), _jax(name), TOL[None], name)
    _sharded_vs_unsharded(name)


def test_rescaling_downscale_quantize_upscale_matches_jax_and_unsharded():
    name = "rescaling"
    got, ref = _result(name)[0], _jax(name)
    _close(got["lr_image"].numpy(), ref["lr"], TOL["bfloat16"], "LR")
    _close(got["image"].numpy(), ref["hr"], TOL["bfloat16"], "HR")
    _sharded_vs_unsharded(name)


def test_float32_rescaling_on_the_unsharded_codes_matches_jax_and_unsharded():
    """The LR before quantization, then the HR that both sides (and JAX) upscale from the
    unsharded pass's codes; the sharded LR's flips against them are at most one code."""
    name = "rescaling f32"
    got, ref = _result(name)[0], _jax(name)
    _close(got["lr_image"].numpy(), ref["lr"], TOL[None], "LR")
    _close(got["image"].numpy(), ref["hr"], TOL[None], "HR")
    _sharded_vs_unsharded(name)
    assert dryrun.code_flips(got["lr_image"], _unsharded(name)["lr"])["steps"] <= 1


@pytest.mark.parametrize("across", [True, False])
def test_code_flips_count_a_boundary_crossing(across):
    """Two LRs 1e-7 apart: one flip across the boundary (100 + 1/2) / 255, none away
    from it; the LR difference at the flip is theirs."""
    mid = (100.5 if across else 100.25) / 255
    lr = torch.tensor([mid - 5e-8, 0.25, 0.6], dtype=torch.float64).float()
    ref = torch.tensor([mid + 5e-8, 0.25, 0.6], dtype=torch.float64).float()
    f = dryrun.code_flips(lr, ref)
    assert f["values"] == 3
    if across:
        assert f["flips"] == 1 and f["steps"] == 1
        assert f["lr_diff"] == (ref - lr).abs().max().item() and f["lr_diff"] < 2e-7
    else:
        assert f == {"flips": 0, "steps": 0, "lr_diff": 0.0, "values": 3}
    assert torch.equal(dryrun.from_codes(dryrun.lr_codes(lr)), quantize(lr))


def test_held_codes_quantizer_returns_its_codes_and_passes_the_gradient():
    from hcflow_tpu_torch.ops.quant import quantize_ste

    g = torch.Generator().manual_seed(0)
    ref = torch.rand(2, 4, 6, 3, generator=g) * 1.2 - 0.1
    x = (ref + 0.01 * torch.randn(ref.shape, generator=g)).requires_grad_()
    held = dryrun.HeldCodes(ref)
    q = held(x)
    assert torch.equal(q, quantize(ref)) and torch.equal(dryrun.lr_codes(q), dryrun.lr_codes(ref))
    assert held.flips == [dryrun.code_flips(x.detach(), ref)] and held.flips[0]["flips"] > 0
    v = torch.randn(ref.shape, generator=g)
    got, = torch.autograd.grad((q * v).sum(), x)
    want, = torch.autograd.grad((quantize_ste(x) * v).sum(), x)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", [n for n in _cases() if "short" not in n])
def test_exchanges_and_launches_per_rank(name):
    case = _cases()[name][0]
    d, s = case.mesh_shape
    H = case.image.shape[1]
    rescaling = isinstance(case.model, HCFlowRescalingSpec)
    lr_band = (case.image.shape[0] // d, H // s // (4 if rescaling else 1),
               case.image.shape[2] // (4 if rescaling else 1))
    counts, nbytes = dryrun.expected_exchanges(case.model.flow, lr_band, s,
                                               resident=case.resident, forward=rescaling)
    for r in _result(name):
        assert r["exchanges"] == counts and r["bytes"] == nbytes
        assert r["launches"] == _unsharded(name)["launches"]


@pytest.mark.parametrize("world,shape,depth", [
    (w, s, n) for w, shapes in WORLD_MESHES.items() for s in shapes
    for n in _spatial_ranks.STACK_DEPTHS])
def test_conv_stack_on_bands_with_a_halo_equals_the_whole_image(world, shape, depth):
    _, ranks = _launch(world)
    assert ranks[0]["stacks"][(shape, depth)] <= 1e-6


@pytest.mark.parametrize("world,shape,depth", [
    (w, s, n) for w, shapes in WORLD_MESHES.items() for s in shapes
    for n in _spatial_ranks.STACK_DEPTHS])
def test_conv_stack_gradient_on_bands_equals_the_whole_image(world, shape, depth):
    _, ranks = _launch(world)
    assert ranks[0]["grads"][(shape, depth)] <= 1e-6


@pytest.mark.parametrize("world,shape", [(w, s) for w, ss in WORLD_MESHES.items() for s in ss])
def test_mesh_ranks_and_groups(world, shape):
    _, ranks = _launch(world)
    layout = mesh.rank_layout(world, mesh_shape=shape)
    for r, rec in enumerate(ranks):
        m = rec["meshes"][shape]
        assert m["rank"] == r and m["shape"] == shape
        assert layout[m["data_index"]][m["spatial_index"]] == r
        row = layout[m["data_index"]]
        col = [layout[i][m["spatial_index"]] for i in range(shape[0])]
        assert m["spatial_peers"] == (row if len(row) > 1 else None)
        assert m["data_peers"] == (col if len(col) > 1 else None)


@pytest.mark.parametrize("world", WORLD_MESHES)
def test_replicate_takes_strided_leaves_through_a_contiguous_broadcast(world):
    """Every rank holds rank 0's leaves after ``mesh.replicate``, a strided one too, under
    a broadcast that refuses non-contiguous tensors as NCCL does (without a contiguous
    copy, training on the mesh over NCCL raises on the invconv weights)."""
    _, ranks = _launch(world)
    want = [torch.arange(12.0).reshape(3, 4).t(), torch.zeros(2)]
    for r in ranks:
        assert all(torch.equal(a, b) for a, b in zip(r["replicate"], want))
        assert not r["replicate"][0].is_contiguous()


@pytest.mark.parametrize("n,axes,shape", [(8, ("data", "spatial"), (2, 4)),
                                          (8, ("data", "spatial"), None),
                                          (6, ("data", "spatial"), None),
                                          (3, ("data", "spatial"), None),
                                          (8, ("data",), None)])
def test_rank_layout_matches_jax_device_layout(n, axes, shape):
    from hcflow_tpu.parallel import make_mesh as jax_mesh

    jm = jax_mesh(n, axis_names=axes, mesh_shape=shape)
    ids = np.vectorize(lambda dev: dev.id)(jm.devices).tolist()
    assert mesh.rank_layout(n, axes, shape) == ids


def test_an_indivisible_height_or_batch_raises():
    m = mesh.Mesh((1, 2))
    with pytest.raises(ValueError, match="height of 5 rows .* 2 spatial"):
        m.shard(torch.zeros(1, 5, 4, 3))
    with pytest.raises(ValueError, match="batch of 3 .* 2 data"):
        mesh.Mesh((2, 1)).shard(torch.zeros(3, 4, 4, 3))
    with pytest.raises(ValueError, match="does not hold 4 ranks"):
        mesh.rank_layout(4, mesh_shape=(1, 8))


@pytest.mark.parametrize("fused", [True, False])
def test_a_mesh_of_one_rank_changes_no_bit(fused):
    case = _cases()["x4 sample"][0]
    pp = case.model.flow.precompute_inference(case.params, fused=fused)
    one = mesh.make_mesh(1)
    assert one.shape == (1, 1)

    def run(m, **kw):
        return case.model.reverse(pp, case.image, 0.9, mesh=m, **kw)

    eps = _cases()[X4[0]][0].eps_list
    assert torch.equal(run(one, eps_list=eps), run(None, eps_list=eps))
    assert torch.equal(run(one, generator=torch.Generator().manual_seed(3)),
                       run(None, generator=torch.Generator().manual_seed(3)))
