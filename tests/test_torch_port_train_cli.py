"""The port's training entry point (``hcflow_tpu_torch/cli/train.py``) on the CPU, and
the files it and the data-prep / convert CLIs write, against the JAX package:

- the recipe chain HCFlow -> HCFlow+ -> HCFlow++ through ``pretrain_model_G`` (the ++
  run on the VGG discriminator and the random-feature perceptual loss), and the
  rescaling recipe: finite losses, the params moved, the step count, validation;
- a ``<iter>_G.ckpt`` the port wrote loads through the JAX package's ``load_any`` and
  JAX's reverse at heat 0 on it equals the port's, to 1e-5 x max;
- resume: a saved ``.state`` restores the params and the optimizer state bit for bit,
  and a step from the restored state equals the same step from the saved one bit for
  bit; ``resume_state: auto`` continues the loop from the newest state; a JAX
  ``.state`` raises;
- the on-chip recipe's ``path.checkpoint_backend: orbax`` trains, saves orbax
  directories, prunes them and resumes from them; any other backend than ``pickle`` or
  ``orbax`` raises before training starts;
- a CUDA error in a step saves the last finished iteration and exits 75; running out
  of memory and a plain error re-raise; SIGTERM saves and stops, and the handlers are
  restored; without a card and without ``--cpu`` the CLI raises, naming ``--cpu``;
- ``prepare_data`` (pkl, png2npy) writes JAX's files; ``convert model`` on the tiny
  trained checkpoint writes JAX's ``.ckpt`` leaf for leaf; ``convert vgg`` / ``lpips``
  write JAX's ``.npz``;
- the profiling helpers: ``ThroughputMeter`` keeps its window's rates, ``trace`` writes
  a ``torch.profiler`` trace of its block (the spans: tests/test_torch_port_tracing.py).
"""

import os
import pickle
import signal
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu.cli import convert as jconvert_cli
from hcflow_tpu.cli import prepare_data as jprepare
from hcflow_tpu.utils import config as jconfig
from hcflow_tpu.utils.checkpoint import load_any as jload_any
from hcflow_tpu.utils.checkpoint import load_checkpoint as jload_checkpoint
from hcflow_tpu_torch.cli import convert as convert_cli
from hcflow_tpu_torch.cli import prepare_data, train
from hcflow_tpu_torch.models import lpips
from hcflow_tpu_torch.train import trainer
from hcflow_tpu_torch.utils import checkpoint, config, profiling

from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import _t, smooth_image, train_data, train_option_file

ROOT = Path(__file__).resolve().parents[1]
PTH = ROOT / "weights" / "ref_trained" / "tiny_x4_400_G.pth"
YML = ROOT / "weights" / "ref_trained" / "tiny_x4_parity.yml"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return train_data(tmp_path_factory.mktemp("data"))


def _exp(root):
    return next((Path(root) / "experiments").iterdir())


def _finite_and_moved(state, before):
    leaves = trainer.tree_leaves(state.params)
    assert all(torch.isfinite(t).all() for t in leaves)
    moved = sum(not torch.equal(a, b) for a, b in zip(trainer.tree_leaves(before), leaves))
    assert moved > len(leaves) // 2, (moved, len(leaves))


@pytest.fixture(scope="module")
def chain(data, tmp_path_factory):
    """HCFlow (NLL) -> HCFlow+ -> HCFlow++ through pretrain_model_G, 2 iterations each:
    {recipe: (option file, final state, root)}."""
    base = tmp_path_factory.mktemp("chain")
    out, prev = {}, None
    for name, src, extra in (
            ("nll", "train_SR_DF2K_4X_HCFlow.yml", {}),
            ("plus", "train_SR_DF2K_4X_HCFlow+.yml", {}),
            ("plusplus", "train_SR_DF2K_4X_HCFlow++.yml",
             dict(feature_fallback="random", D_init_iters=1))):
        root = base / name
        root.mkdir()
        opt = train_option_file(root / "opt.yml", src, data, root, val_freq=2, **extra)
        if prev is not None:
            o = yaml.safe_load(Path(opt).read_text())
            o["path"]["pretrain_model_G"] = str(prev)
            Path(opt).write_text(yaml.safe_dump(o))
        state = train.main(["--opt", opt, "--cpu", "--max_steps", "2"])
        prev = _exp(root) / "models" / "latest_G.ckpt"
        out[name] = (opt, state, root)
    return out


def test_recipe_chain_trains_saves_and_validates(chain):
    for name, (opt, state, root) in chain.items():
        # G's step counts its NLL passes: the ++ run's first iteration trains D only
        assert state.step == (1 if name == "plusplus" else 2), name
        exp = _exp(root)
        assert sorted(os.listdir(exp / "models")) == ["1_G.ckpt", "2_G.ckpt", "latest_G.ckpt"]
        assert sorted(os.listdir(exp / "training_state")) == ["1.state", "2.state"]
        assert sorted(os.listdir(exp / "val_images" / "iter_2")) == [
            "SR_0_0.0_0.png"], name
        assert all(torch.isfinite(t).all() for t in trainer.tree_leaves(state.params))
    # each recipe starts from the one before: + from the NLL run's latest_G.ckpt
    spec = config.model_spec_from_opt(config.parse(chain["plus"][0]))
    start = checkpoint.load_any(str(_exp(chain["nll"][2]) / "models" / "latest_G.ckpt"),
                                spec.flow, device="cpu")
    _finite_and_moved(chain["plus"][1], start)
    # the ++ run trained D too: its state holds the D params and D's own step
    saved = checkpoint.load_training_state(str(_exp(chain["plusplus"][2]) / "training_state"
                                               / "2.state"), device="cpu")
    assert saved["d_params"] is not None and saved["d_opt_state"]["count"] == 2
    assert saved["opt_state"]["count"] == 3  # NLL, pixel and fea/GAN at iteration 2


def test_rescaling_trains(data, tmp_path):
    opt = train_option_file(tmp_path / "opt.yml", "train_Rescaling_DF2K_4X_HCFlow.yml", data,
                            tmp_path, val_freq=2)
    spec = config.model_spec_from_opt(config.parse(opt))
    state = train.main(["--opt", opt, "--cpu", "--max_steps", "2"])
    assert state.step == 2 and state.opt_state["count"] == 2
    _finite_and_moved(state, spec.init(0, device="cpu"))
    assert sorted(os.listdir(_exp(tmp_path) / "val_images" / "iter_2")) == [
        "SR_0_0.0_0.png"]


def test_g_ckpt_serves_in_the_jax_package(chain):
    """A model the port trained, served by both packages at heat 0."""
    opt, state, root = chain["plus"]
    path = str(_exp(root) / "models" / "latest_G.ckpt")
    spec = config.model_spec_from_opt(config.parse(opt))
    jspec = jconfig.model_spec_from_opt(jconfig.parse(opt))
    raw = jload_checkpoint(path)
    assert sorted(raw) == ["params", "step"] and int(raw["step"]) == 2
    jp = jload_any(path, jspec.flow)["params"]
    params = checkpoint.load_any(path, spec.flow, device="cpu")
    for a, b in zip(trainer.tree_leaves(params), trainer.tree_leaves(state.params)):
        assert torch.equal(a, b.detach())  # the port reads back what it trained, exactly
    lr = np.random.default_rng(3).uniform(0.2, 0.8, (1, 8, 12, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jspec.reverse)(jspec.flow.precompute_inference(jp),
                                            jax.random.PRNGKey(0), lr, 0.0))
    got = spec.reverse(spec.flow.precompute_inference(params), _t(lr), 0.0,
                       generator=torch.Generator().manual_seed(0)).numpy()
    assert got.shape == ref.shape == (1, 32, 48, 3)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def test_training_state_round_trip_and_repeatable_step(chain, tmp_path):
    opt, _, root = chain["plus"]
    spec = config.model_spec_from_opt(config.parse(opt))
    saved = checkpoint.load_training_state(str(_exp(root) / "training_state" / "2.state"),
                                           device="cpu")
    tx = trainer.make_optimizer({"lr_G": 5e-5, "max_grad_clip": 5, "max_grad_norm": 100},
                                lambda step: 5e-5)
    state = trainer.TrainState(step=saved["step"], params=saved["params"],
                               opt_state=saved["opt_state"])
    path = str(tmp_path / "again.state")
    checkpoint.save_training_state(path, state.step, state.params, state.opt_state, epoch=0)
    back = checkpoint.load_training_state(path, device="cpu")
    assert back["step"] == 2 and back["epoch"] == 0 and back["d_params"] is None
    for a, b in zip(trainer.tree_leaves(back["params"]), trainer.tree_leaves(state.params)):
        assert torch.equal(a, b) and a.requires_grad and a.is_leaf
    for k in ("count", "notfinite_count", "total_notfinite"):
        assert back["opt_state"][k] == state.opt_state[k]
    for k in ("mu", "nu"):
        assert all(torch.equal(a, b) for a, b in zip(back["opt_state"][k], state.opt_state[k]))
    # one NLL + pixel iteration from each, drawing from the loop's generators
    hr = np.stack([smooth_image(np.random.default_rng(i), 32, 32) for i in range(2)])
    lr = hr.reshape(2, 8, 4, 8, 4, 3).mean((2, 4))
    nll = trainer.make_sr_nll_step(spec, tx, 0.002)
    pix = trainer.make_sr_pixel_step(spec, tx, 1.0, torch.nn.functional.l1_loss)
    outs = []
    for s in (state, trainer.TrainState(back["step"], back["params"], back["opt_state"])):
        s, _ = nll(s, _t(hr), _t(lr), generator=train.step_generator("cpu", 0, 3, train.NLL))
        s, _ = pix(s, _t(hr), _t(lr), generator=train.step_generator("cpu", 0, 3, train.PIXEL))
        outs.append(s)
    for a, b in zip(trainer.tree_leaves(outs[0].params), trainer.tree_leaves(outs[1].params)):
        assert torch.equal(a, b)
    # a JAX package .state (optax's optimizer state) is refused, naming the format
    jstate = tmp_path / "jax.state"
    jstate.write_bytes(pickle.dumps({"step": np.asarray(2), "params": {}, "opt_state": ()}))
    with pytest.raises(ValueError, match="optax"):
        checkpoint.load_training_state(str(jstate), device="cpu")


def test_auto_resume_continues_from_the_newest_state(data, tmp_path):
    opt = train_option_file(tmp_path / "opt.yml", "train_SR_DF2K_4X_HCFlow+.yml", data,
                            tmp_path, val_freq=100)
    o = yaml.safe_load(Path(opt).read_text())
    o["logger"]["save_checkpoint_freq"] = 2
    Path(opt).write_text(yaml.safe_dump(o))
    first = train.main(["--opt", opt, "--cpu", "--max_steps", "2"])
    second = train.main(["--opt", opt, "--cpu", "--max_steps", "3"])
    assert first.step == 2 and second.step == 3
    assert second.opt_state["count"] == 2 * 3  # resumed with 4 updates, then NLL + pixel
    exp = _exp(tmp_path)
    assert sorted(os.listdir(exp / "training_state")) == ["2.state"]
    assert int(checkpoint.load_checkpoint(str(exp / "models" / "latest_G.ckpt"))["step"]) == 3


def _failing(monkeypatch, exc, at=3):
    real = train.make_sr_nll_step
    calls = {"n": 0}

    def make(*a, **k):
        step = real(*a, **k)

        def failing(*sa, **sk):
            calls["n"] += 1
            if calls["n"] >= at:
                raise exc
            return step(*sa, **sk)

        return failing

    monkeypatch.setattr(train, "make_sr_nll_step", make)


def test_device_failure_saves_and_exits_75(data, tmp_path, monkeypatch):
    """As tests/test_train_resume_e2e.py holds the JAX package's loop: a CUDA error at
    iteration 3 saves iteration 2 and exits 75; other errors re-raise."""
    opt = train_option_file(tmp_path / "opt.yml", "train_SR_DF2K_4X_HCFlow.yml", data, tmp_path,
                            val_freq=100)
    o = yaml.safe_load(Path(opt).read_text())
    o["logger"]["save_checkpoint_freq"] = 100
    Path(opt).write_text(yaml.safe_dump(o))
    _failing(monkeypatch, RuntimeError("CUDA error: an illegal memory access was encountered"))
    with pytest.raises(SystemExit) as e:
        train.main(["--opt", opt, "--cpu", "--max_steps", "6"])
    assert e.value.code == 75
    exp = _exp(tmp_path)
    assert os.listdir(exp / "models") == ["2_G.ckpt"]
    assert os.listdir(exp / "training_state") == ["2.state"]
    for exc in (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
                ValueError("a genuine program bug")):
        _failing(monkeypatch, exc, at=1)
        with pytest.raises(type(exc)):
            train.main(["--opt", opt, "--cpu", "--max_steps", "6"])


def test_sigterm_saves_and_stops(data, tmp_path, monkeypatch):
    opt = train_option_file(tmp_path / "opt.yml", "train_SR_DF2K_4X_HCFlow.yml", data, tmp_path,
                            val_freq=100)
    o = yaml.safe_load(Path(opt).read_text())
    o["logger"]["save_checkpoint_freq"] = 100
    Path(opt).write_text(yaml.safe_dump(o))
    real = train.make_sr_nll_step

    def make(*a, **k):
        step = real(*a, **k)

        def signalled(state, *sa, **sk):
            if state.step == 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(state, *sa, **sk)

        return signalled

    monkeypatch.setattr(train, "make_sr_nll_step", make)
    before = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    state = train.main(["--opt", opt, "--cpu", "--max_steps", "6"])
    assert state.step == 2
    assert (signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)) == before
    assert sorted(os.listdir(_exp(tmp_path) / "models")) == ["2_G.ckpt"]


def test_an_unknown_checkpoint_backend_raises_before_training(data, tmp_path, monkeypatch):
    """A path.checkpoint_backend other than pickle or orbax raises, naming it, before
    any step."""
    o = yaml.safe_load((ROOT / "configs" / "train_faces_x4_nll_onchip.yml").read_text())
    o["path"].update(root=str(tmp_path), checkpoint_backend="tensorstore")
    opt = tmp_path / "onchip.yml"
    opt.write_text(yaml.safe_dump(o))
    monkeypatch.setattr(train, "make_sr_nll_step", None)  # no trainer may be built
    with pytest.raises(NotImplementedError, match="path.checkpoint_backend = 'tensorstore'"):
        train.main(["--opt", str(opt), "--cpu", "--max_steps", "1"])
    assert not (tmp_path / "experiments").exists()
    for backend in ("orbax", "pickle", None):
        o["path"]["checkpoint_backend"] = backend
        assert train.check_checkpoint_backend(o) == (backend or "pickle")


def test_the_onchip_recipe_trains_saves_and_resumes_with_orbax(data, tmp_path):
    """configs/train_faces_x4_nll_onchip.yml (orbax checkpoints, resume_state auto) at
    the small topology: 2 steps save orbax directories, which hold the run's params
    and Adam moments bit for bit; a second run resumes from them to step 4, retention
    prunes directories, and the JAX package reads the model it saved."""
    opt = train_option_file(tmp_path / "opt.yml", "train_faces_x4_nll_onchip.yml", data, tmp_path,
                            val_freq=100)
    o = yaml.safe_load(Path(opt).read_text())
    assert (o["path"]["checkpoint_backend"], o["path"]["resume_state"]) == ("orbax", "auto")
    o["logger"]["save_checkpoint_freq"] = 2
    Path(opt).write_text(yaml.safe_dump(o))
    first = train.main(["--opt", opt, "--cpu", "--max_steps", "2"])
    exp = _exp(tmp_path)
    assert sorted(os.listdir(exp / "models")) == ["2_G.ckpt", "latest_G.ckpt"]
    assert os.path.isdir(exp / "models" / "2_G.ckpt") and os.path.isdir(exp / "training_state" / "2.state")
    saved = checkpoint.load_training_state(str(exp / "training_state" / "2.state"), device="cpu")
    assert saved["step"] == 2 and saved["opt_state"]["count"] == first.opt_state["count"] == 2
    for a, b in ((first.params, saved["params"]), (first.opt_state["mu"], saved["opt_state"]["mu"]),
                 (first.opt_state["nu"], saved["opt_state"]["nu"])):
        for x, y in zip(trainer.tree_leaves(a), trainer.tree_leaves(b)):
            assert torch.equal(x.detach(), y.detach())
    second = train.main(["--opt", opt, "--cpu", "--max_steps", "4"])
    assert second.step == 4 and second.opt_state["count"] == 4
    assert sorted(os.listdir(exp / "models")) == ["4_G.ckpt", "latest_G.ckpt"]
    assert sorted(os.listdir(exp / "training_state")) == ["2.state", "4.state"]
    j = jload_checkpoint(str(exp / "models" / "4_G.ckpt"))
    assert int(j["step"]) == 4
    np.testing.assert_array_equal(
        np.asarray(j["params"]["level0"]["main"]["actnorm"]["bias"]),
        np.asarray(checkpoint.load_checkpoint(str(exp / "models" / "4_G.ckpt"))["params"]["level0"]
                   ["main"]["actnorm"]["bias"]))


def test_without_a_card_raises_naming_cpu(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    opt = train_option_file(tmp_path / "opt.yml", "train_SR_DF2K_4X_HCFlow.yml", data, tmp_path)
    with pytest.raises(RuntimeError, match="--cpu"):
        train.main(["--opt", opt, "--max_steps", "1"])


# ------------------------------------------------------------- data prep, convert
def test_prepare_data_writes_what_jax_writes(tmp_path):
    rng = np.random.default_rng(4)
    (tmp_path / "src" / "sub").mkdir(parents=True)
    from hcflow_tpu_torch.data.util import save_img

    for i, hw in enumerate(((70, 90), (64, 64), (50, 40))):
        save_img(str(tmp_path / "src" / ("sub" if i == 1 else "") / f"{i}.png"),
                 smooth_image(rng, *hw))
    for who, mod in (("port", prepare_data), ("jax", jprepare)):
        mod.main(["pkl", "--input", str(tmp_path / "src"), "--output", str(tmp_path / who / "pkl"),
                  "--crops", "3", "--size", "48", "--scales", "4", "8", "--subset_frac", "0.5"])
        mod.main(["pkl", "--input", str(tmp_path / "src"), "--output", str(tmp_path / who / "aug"),
                  "--crops", "2", "--size", "32", "--augment", "--zooms", "1.0", "0.75"])
        mod.main(["png2npy", "--input", str(tmp_path / "src"), "--output",
                  str(tmp_path / who / "npy")])
    for d in ("pkl", "aug", "npy"):
        files = sorted(str(p.relative_to(tmp_path / "port" / d))
                       for p in (tmp_path / "port" / d).rglob("*") if p.is_file())
        assert files == sorted(str(p.relative_to(tmp_path / "jax" / d))
                               for p in (tmp_path / "jax" / d).rglob("*") if p.is_file())
        assert files
        for f in files:
            a, b = tmp_path / "port" / d / f, tmp_path / "jax" / d / f
            if f.endswith(".npy"):
                assert np.array_equal(np.load(a), np.load(b)), f
            else:
                pa, pb = pickle.loads(a.read_bytes()), pickle.loads(b.read_bytes())
                assert len(pa) == len(pb) and all(np.array_equal(x, y) for x, y in zip(pa, pb)), f


def test_convert_model_writes_jax_ckpt(tmp_path):
    out, jout = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    convert_cli.main(["model", "--pth", str(PTH), "--opt", str(YML), "--out", str(out)])
    jconvert_cli.main(["model", "--pth", str(PTH), "--opt", str(YML), "--out", str(jout)])
    got, ref = jload_checkpoint(str(out)), jload_checkpoint(str(jout))
    assert got["source"] == ref["source"] == str(PTH)
    flat = jax.tree_util.tree_leaves_with_path
    a, b = flat(got["params"]), flat(ref["params"])
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and np.array_equal(x, np.asarray(y)), jax.tree_util.keystr(path)


def test_convert_vgg_and_lpips_write_jax_npz(tmp_path):
    rng = np.random.default_rng(5)
    vgg_sd, idx, cin = {}, 0, 3
    for n, cout in ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512)):
        for _ in range(n):
            vgg_sd[f"features.{idx}.weight"] = torch.from_numpy(
                rng.standard_normal((cout, cin, 3, 3)).astype(np.float32))
            vgg_sd[f"features.{idx}.bias"] = torch.from_numpy(rng.standard_normal(cout)
                                                              .astype(np.float32))
            cin, idx = cout, idx + 2
        idx += 1
    alex = lpips.random_params(seed=1, device="cpu")
    lp_sd = {}
    for i, (sl, j) in enumerate((("slice1", 0), ("slice2", 3), ("slice3", 6), ("slice4", 8),
                                 ("slice5", 10))):
        lp_sd[f"net.{sl}.{j}.weight"] = alex[f"conv{i}"]["w"]
        lp_sd[f"net.{sl}.{j}.bias"] = alex[f"conv{i}"]["b"]
        lp_sd[f"lin{i}.model.1.weight"] = alex[f"lin{i}"]["w"].reshape(1, -1, 1, 1)
    for kind, sd in (("vgg", vgg_sd), ("lpips", lp_sd)):
        torch.save(sd, tmp_path / f"{kind}.pth")
        convert_cli.main([kind, "--pth", str(tmp_path / f"{kind}.pth"), "--out",
                          str(tmp_path / f"{kind}_port.npz")])
        jconvert_cli.main([kind, "--pth", str(tmp_path / f"{kind}.pth"), "--out",
                           str(tmp_path / f"{kind}_jax.npz")])
        a, b = np.load(tmp_path / f"{kind}_port.npz"), np.load(tmp_path / f"{kind}_jax.npz")
        assert sorted(a.files) == sorted(b.files)
        assert all(np.array_equal(a[k], b[k]) for k in a.files), kind
    back = lpips.load(str(tmp_path / "lpips_port.npz"), device="cpu")
    assert all(torch.equal(back[k][leaf], alex[k][leaf]) for k in alex for leaf in alex[k])


def test_throughput_meter_keeps_its_window(monkeypatch):
    clock = iter([0.0, 1.0, 3.0, 4.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: next(clock))
    meter = profiling.ThroughputMeter(window=2)
    for items, pixels in ((9, 9), (4, 2_000_000), (8, 4_000_000), (2, 1_000_000)):
        meter.tick(items, pixels)
    # the window holds the last two intervals: 2 s with 8 items, then 1 s with 2
    assert meter.times == [2.0, 1.0]
    assert meter.step_time == 1.5
    assert meter.items_per_sec == 10 / 3
    assert meter.megapixels_per_sec == 5 / 3


def test_trace_writes_a_profiler_trace(tmp_path):
    a = torch.ones(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        (a @ a).sum()
    assert any("aten::mm" in e.key for e in prof.key_averages())
    files = list(tmp_path.glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
