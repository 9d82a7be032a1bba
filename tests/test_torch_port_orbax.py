"""The port's orbax checkpoint backend (``hcflow_tpu_torch/utils/{orbax,ocdbt,zstd}.py``,
``csrc/zstd_decode.cpp``) against the JAX package's orbax backend on the CPU, at the
tiny topology of tests/test_checkpoint_orbax.py:

- every array of a ``_G.ckpt`` and a ``.state`` that JAX writes (optax's state, 0-d
  ``step`` / ``epoch``, ``None`` leaves, float16, int64 and the other dtypes) is read
  bit for bit: dtype, shape and bytes;
- JAX's ``load_checkpoint`` reads the ``_G.ckpt`` the port writes without ``like`` and
  with the ``like`` of its train CLI, and the port's ``.state`` without ``like``; the
  port's ``.state`` round-trips bit for bit; a JAX ``.state`` raises, naming the format;
- an array of several chunks, one of them absent (the fill value), written by
  tensorstore's zarr driver on an OCDBT store; a 2048 x 4096 float32 array (one zstd
  frame of many blocks); a B+tree of interior nodes and older versions; a corrupt
  CRC, a truncated file and a truncated zstd frame raise;
- the tiny model served from a JAX-written orbax ``_G.ckpt`` equals the same params
  served from JAX's pickle, under the same latents.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

from hcflow_tpu.train import init_state as jinit_state
from hcflow_tpu.train import make_optimizer as jmake_optimizer
from hcflow_tpu.train.schedules import multistep_restart
from hcflow_tpu.utils import checkpoint as jckpt
from hcflow_tpu_torch.models import HCFlowSRSpec
from hcflow_tpu_torch.train.trainer import init_state, make_optimizer
from hcflow_tpu_torch.utils import checkpoint, ocdbt, orbax, zstd

from _torch_port_util import perturb, to_jax

# tests/test_checkpoint_orbax.py's topology
TINY = dict(K=(2, 2), after_splitoff=(1, 1), rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4,
            hidden_channels=8, so_hidden_channels=8)
OPT = {"max_grad_clip": 5, "max_grad_norm": 100, "beta1": 0.9, "beta2": 0.99}


@pytest.fixture(scope="module")
def case():
    spec = HCFlowSRSpec.for_scale(4, **TINY)
    params = perturb(spec.init(0, device="cpu"), scale=0.02)
    jp = jax.tree.map(jnp.asarray, to_jax(params))
    jstate = jinit_state(jp, jmake_optimizer(OPT, multistep_restart(2.5e-4, [100])))
    return spec, params, jp, jstate


def _jax_save(path, tree):
    jckpt.save_checkpoint(str(path), tree, backend="orbax")
    jckpt.wait_for_saves()


def _flat(tree, prefix=()):
    """{key path: leaf} of a JAX tree (dicts, sequences, optax's NamedTuples) or of
    what the port reads back (dicts and lists), keys as orbax names them."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, prefix + (str(k),)))
    elif hasattr(tree, "_fields"):
        if not tree._fields:  # optax's EmptyState: orbax records a None
            out[prefix] = None
        for k in tree._fields:
            out.update(_flat(getattr(tree, k), prefix + (k,)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, prefix + (str(i),)))
    else:
        out[prefix] = tree
    return out


def _same_bits(port, ref):
    assert set(port) == set(ref), set(port) ^ set(ref)
    for k, r in ref.items():
        p = port[k]
        if r is None:
            assert p is None, k
            continue
        r = np.asarray(r)
        assert isinstance(p, np.ndarray), k
        assert (p.dtype, p.shape) == (r.dtype, r.shape), k
        assert p.tobytes() == r.tobytes(), k


def test_port_reads_the_g_ckpt_jax_writes_bit_for_bit(case, tmp_path):
    _, _, jp, _ = case
    tree = {"params": jp, "step": 5}
    _jax_save(tmp_path / "5_G.ckpt", tree)
    got = checkpoint.load_checkpoint(str(tmp_path / "5_G.ckpt"))
    _same_bits(_flat(got), _flat(jax.tree.map(np.asarray, {"params": jp, "step": np.asarray(5)})))
    assert got["step"].dtype == np.int64 and got["step"].shape == ()


def test_port_reads_the_state_jax_writes_bit_for_bit(case, tmp_path):
    _, _, _, jstate = case
    tree = {"step": 7, "params": jstate.params, "opt_state": jstate.opt_state,
            "d_params": None, "d_opt_state": None, "epoch": 1}
    _jax_save(tmp_path / "7.state", tree)
    got = checkpoint.load_checkpoint(str(tmp_path / "7.state"))
    ref = _flat(jax.tree.map(np.asarray, tree, is_leaf=lambda x: x is None))
    ref.update({("d_params",): None, ("d_opt_state",): None})
    _same_bits(_flat(got), ref)
    assert any(k[:2] == ("opt_state", "inner_state") for k in _flat(got))
    # a JAX .state holds optax's state and no marker of the port's format
    with pytest.raises(ValueError, match="not a training state of this package"):
        checkpoint.load_training_state(str(tmp_path / "7.state"), device="cpu")


def test_port_reads_every_dtype_and_none_jax_writes(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"f2": rng.standard_normal((3, 5)).astype(np.float16),
            "f8": rng.standard_normal(4),
            "i4": np.arange(-3, 3, dtype=np.int32),
            "i8": np.asarray([2 ** 40, -1], np.int64),
            "u1": np.arange(250, 256, dtype=np.uint8),
            "b1": np.asarray([[True, False], [False, True]]),
            "scalars": [1.5, True, 3], "none": None,
            "nested": {"a": [None, np.ones(2, np.float32)]},
            "empty": {"d": {}, "l": []}}
    _jax_save(tmp_path / "x_G.ckpt", tree)
    got = checkpoint.load_checkpoint(str(tmp_path / "x_G.ckpt"))
    ref = _flat({**tree, "scalars": [np.asarray(1.5), np.asarray(True), np.asarray(3)],
                 "empty": {}})
    ref.update({("none",): None, ("nested", "a", "0"): None})
    flat = _flat({**got, "empty": {}})
    _same_bits(flat, ref)
    assert got["empty"] == {"d": {}, "l": []}


def test_jax_reads_the_g_ckpt_the_port_writes(case, tmp_path):
    spec, params, jp, _ = case
    path = str(tmp_path / "3_G.ckpt")
    checkpoint.save_model(path, params, spec, 3, backend="orbax")
    assert os.path.isdir(path) and sorted(os.listdir(tmp_path)) == ["3_G.ckpt"]
    ref = _flat(jax.tree.map(np.asarray, {"params": jp, "step": np.asarray(3)}))
    plain = jckpt.load_checkpoint(path)  # as the JAX package's cli/test.py loads it
    _same_bits(_flat(jax.tree.map(np.asarray, plain)), ref)
    like = jckpt.load_checkpoint(path, like={"params": jp, "step": np.asarray(0)})  # cli/train.py
    _same_bits(_flat(jax.tree.map(np.asarray, like)), ref)
    # and the port reads its own directory back
    _same_bits(_flat(checkpoint.load_checkpoint(path)), ref)


def test_the_port_state_round_trips_and_jax_reads_it(case, tmp_path):
    _, params, _, _ = case
    tx = make_optimizer(OPT, multistep_restart(2.5e-4, [100]))
    state = init_state(params, tx)
    mu = {k: v for k, v in state.opt_state.items()}
    state.opt_state.update(count=3, notfinite_count=1, total_notfinite=2)
    mu["mu"] = perturb(state.opt_state["mu"], seed=3)
    path = str(tmp_path / "4.state")
    checkpoint.save_training_state(path, 4, state.params, {**state.opt_state, "mu": mu["mu"]},
                                   epoch=2, backend="orbax")
    back = checkpoint.load_training_state(path, device="cpu")
    assert (back["step"], back["epoch"]) == (4, 2) and isinstance(back["step"], int)
    assert back["d_params"] is None and back["d_opt_state"] is None
    for k in ("count", "notfinite_count", "total_notfinite"):
        assert back["opt_state"][k] == state.opt_state[k] and isinstance(back["opt_state"][k], int)
    for name, saved, got in (("params", state.params, back["params"]),
                             ("mu", mu["mu"], back["opt_state"]["mu"]),
                             ("nu", state.opt_state["nu"], back["opt_state"]["nu"])):
        a, b = _flat(saved), _flat(got)
        assert set(a) == set(b), name
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k].detach(), b[k].detach()), (name, k)
            assert b[k].requires_grad == (name == "params")
    meta = json.loads(open(os.path.join(path, "_CHECKPOINT_METADATA")).read())
    assert meta["custom_metadata"] == {"format": checkpoint.STATE_FORMAT}
    # JAX reads it without like: the port's layout, as nested dicts
    j = jckpt.load_checkpoint(path)
    assert int(j["step"]) == 4 and j["d_params"] is None
    for k, v in _flat(state.params).items():
        np.testing.assert_array_equal(np.asarray(_flat(j["params"])[k]), v.detach().numpy())
    # and the pickle backend still writes a file with the marker in the tree
    checkpoint.save_training_state(str(tmp_path / "5.state"), 5, state.params, state.opt_state)
    assert os.path.isfile(tmp_path / "5.state")
    assert checkpoint.load_training_state(str(tmp_path / "5.state"), device="cpu")["step"] == 5


def test_saving_over_a_checkpoint_replaces_it_and_retention_prunes_directories(tmp_path):
    d = str(tmp_path)
    for it in (4999, 5000, 5001, 5002, 5003):
        checkpoint.save_checkpoint(os.path.join(d, f"{it}_G.ckpt"), {"w": np.ones(2) * it},
                                   backend="orbax")
    checkpoint.save_checkpoint(os.path.join(d, "5003_G.ckpt"), {"w": np.zeros(3)}, backend="orbax")
    np.testing.assert_array_equal(checkpoint.load_checkpoint(os.path.join(d, "5003_G.ckpt"))["w"],
                                  np.zeros(3))
    checkpoint.prune_checkpoints(d, "_G.ckpt", keep=2, keep_period=5000)
    assert sorted(os.listdir(d)) == ["5000_G.ckpt", "5002_G.ckpt", "5003_G.ckpt"]
    assert checkpoint.latest_checkpoint(d, "_G.ckpt").endswith("5003_G.ckpt")
    with pytest.raises(ValueError, match="Unsupported type: <class 'str'>"):
        checkpoint.save_checkpoint(os.path.join(d, "s_G.ckpt"), {"format": "x"}, backend="orbax")
    with pytest.raises(ValueError, match="zero size"):
        checkpoint.save_checkpoint(os.path.join(d, "z_G.ckpt"), {"z": np.zeros((0, 2))},
                                   backend="orbax")
    assert not any("tmp" in f for f in os.listdir(d))  # a failed write leaves nothing


def test_multi_chunk_array_with_an_absent_chunk(tmp_path):
    """tensorstore's zarr driver on an OCDBT store: chunks 3 x 4 over a 7 x 10 array
    (edge chunks padded), one chunk never written (the fill value), zstd and raw."""
    rng = np.random.default_rng(1)
    for compressor, fill in (({"id": "zstd", "level": 3}, 1.5), (None, None)):
        root = tmp_path / str(fill)
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{root}",
                                             "path": "p.x/"},
                "metadata": {"shape": [7, 10], "chunks": [3, 4], "dtype": "<f4",
                             "compressor": compressor, "fill_value": fill}}
        arr = ts.open(spec, create=True).result()
        full = rng.standard_normal((7, 10)).astype(np.float32)
        arr[0:6, :].write(full[0:6]).result()
        arr[6:7, 0:8].write(full[6:7, 0:8]).result()  # chunk (2, 2) stays absent
        ref = arr.read().result()
        store = ocdbt.Store(str(root))
        assert "p.x/2.2" not in store and "p.x/0.0" in store
        got = orbax.read_array(store, "p.x")
        assert got.dtype == np.float32 and got.tobytes() == ref.tobytes()
        assert np.all(got[6, 8:] == (fill or 0.0))


def test_a_large_array_in_one_multi_block_frame(tmp_path):
    x = np.random.default_rng(2).standard_normal((2048, 4096)).astype(np.float32)
    _jax_save(tmp_path / "big_G.ckpt", {"x": x})
    store = ocdbt.Store(str(tmp_path / "big_G.ckpt"))
    frame = store.read("x/0.0")
    assert frame[:4] == zstd.MAGIC and len(frame) > 1 << 20  # indirect, in a data file
    assert checkpoint.load_checkpoint(str(tmp_path / "big_G.ckpt"))["x"].tobytes() == x.tobytes()


def test_interior_nodes_and_older_versions(tmp_path):
    """A store of 4 levels of B+tree nodes, indirect values in several data files and
    version-tree nodes in its manifest, written by tensorstore: the newest version."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 20,
                                     "version_tree_arity_log2": 2}}).result()
    rng = np.random.default_rng(0)
    for v in range(11):
        with ts.Transaction() as txn:
            for i in range(6):
                n = int(rng.integers(1, 60))
                value = rng.integers(0, 256, n, np.uint8).tobytes()
                kv.with_transaction(txn)[f"k{v:02d}_{i:03d}"] = value
    ref = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    store = ocdbt.Store(str(tmp_path))
    assert store.keys() == sorted(ref) and len(ref) == 66
    assert all(store.read(k) == v for k, v in ref.items())


def test_tensorstore_reads_what_the_port_writes(tmp_path):
    rng = np.random.default_rng(3)
    values = {f"k{i:03d}/{'x' * (i % 5)}": rng.integers(0, 256, int(rng.integers(0, 3000)),
                                                       np.uint8).tobytes() for i in range(200)}
    ocdbt.write(str(tmp_path / "a"), values)
    for base in ("a/", f"a/{ocdbt.PROCESS_DIR}/"):
        kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/{base}"}).result()
        assert {k.decode(): kv.read(k).result().value for k in kv.list().result()} == values
    ocdbt.write(str(tmp_path / "e"), {})
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/e/"}).result()
    assert kv.list().result() == [] and ocdbt.Store(str(tmp_path / "e")).keys() == []


def test_corrupt_and_truncated_files_raise(tmp_path):
    good = tmp_path / "good"
    _jax_save(good, {"w": np.arange(600, dtype=np.float32)})
    checkpoint.load_checkpoint(str(good))
    bad = tmp_path / "crc"
    shutil.copytree(good, bad)
    m = bytearray((bad / "manifest.ocdbt").read_bytes())
    m[20] ^= 1
    (bad / "manifest.ocdbt").write_bytes(bytes(m))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        checkpoint.load_checkpoint(str(bad))
    cut = tmp_path / "cut"
    shutil.copytree(good, cut)
    node = next((cut / "d").iterdir())
    node.write_bytes(node.read_bytes()[:-7])
    with pytest.raises(ValueError, match="past the end of its file|header says"):
        checkpoint.load_checkpoint(str(cut))
    frame = ocdbt.Store(str(good)).read("w/0")
    assert zstd.decompress(frame) == np.arange(600, dtype=np.float32).tobytes()
    for broken in (frame[:-5], frame[:9], frame[:4] + b"\x20" + frame[5:]):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(broken)


def test_serving_from_a_jax_orbax_g_ckpt_equals_its_pickle(case, tmp_path):
    spec, _, jp, _ = case
    _jax_save(tmp_path / "o_G.ckpt", {"params": jp, "step": 1})
    jckpt.save_checkpoint(str(tmp_path / "p_G.ckpt"), {"params": jp, "step": 1})
    from_orbax = checkpoint.load_any(str(tmp_path / "o_G.ckpt"), spec.flow, device="cpu")
    from_pickle = checkpoint.load_any(str(tmp_path / "p_G.ckpt"), spec.flow, device="cpu")
    rng = np.random.default_rng(5)
    lr = torch.from_numpy(rng.uniform(size=(2, 4, 6, 3)).astype(np.float32))
    gen = [torch.Generator().manual_seed(9) for _ in range(2)]
    out = [spec.reverse(spec.flow.precompute_inference(p, fused=True), lr, 0.8, generator=g)
           for p, g in zip((from_orbax, from_pickle), gen)]
    assert out[0].shape == (2, 16, 24, 3) and torch.isfinite(out[0]).all()
    assert torch.equal(out[0], out[1])
