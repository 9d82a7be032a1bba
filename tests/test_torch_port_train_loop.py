"""The port's training loop (``hcflow_tpu_torch/cli/train.py``) against the JAX
package's (``hcflow_tpu/cli/train.py``) on the CPU: both ``main([... "--cpu"])`` on
the same tiny option file (a shipped training config with a small topology and the
synthetic data below), with their step factories, calibration, train loader and
Evaluator wrapped to record the passes of every iteration (tests/_train_loop_trace.py).
Equal sequences of passes, equal checkpoint file names after retention, equal metric
keys on every progress line, for:

- the NLL-only recipe (configs/train_SR_DF2K_4X_HCFlow.yml) with the ActNorm
  calibration window (act_norm_start_step 3), ``clear_state`` at a restart, a
  checkpoint every iteration pruned to the newest two, validation at the end;
- the ++ recipe (configs/train_SR_DF2K_4X_HCFlow++.yml) with D_update_ratio 2 and
  D_init_iters 1 (G and D turns alternate), a PatchGAN discriminator of width 8 and the
  perceptual loss off (the loop builds the fea/GAN pass for either head);
- the rescaling recipe (configs/train_Rescaling_DF2K_4X_HCFlow.yml) on .npy data.

The JAX loops run in subprocesses side by side, whose XLA compiles at backend
optimisation level 0 (tests/_train_loop_trace.py); both packages read the files the
port's ``prepare_data`` wrote.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from hcflow_tpu_torch.cli import train

import _train_loop_trace
from _torch_port_util import few_threads, train_data, train_option_file  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return train_data(tmp_path_factory.mktemp("data"))


def _files(root):
    exp = next((Path(root) / "experiments").iterdir())
    return {d: sorted(os.listdir(exp / d)) for d in ("models", "training_state")}


STEPS = 4
CASES = {
    "nll": ("train_SR_DF2K_4X_HCFlow.yml",
            dict(val_freq=4, clear_state=True, restarts=[2], restart_weights=[0.5])),
    "plusplus": ("train_SR_DF2K_4X_HCFlow++.yml",
                 dict(val_freq=100, D_update_ratio=2, D_init_iters=1, feature_weight=0)),
    "rescaling": ("train_Rescaling_DF2K_4X_HCFlow.yml", dict(val_freq=100)),
}


def case_option_file(case, data, root):
    src, train_opt = CASES[case]
    root.mkdir(parents=True, exist_ok=True)
    path = Path(train_option_file(root / "opt.yml", src, data, root, **train_opt))
    opt = yaml.safe_load(path.read_text())
    if case == "nll":  # the calibration window of the first two iterations
        opt["network_G"]["act_norm_start_step"] = 3
    if case == "plusplus":  # a small PatchGAN for D
        opt["network_D"] = {"which_model_D": "PatchGANDiscriminator", "in_nc": 3, "ndf": 8,
                            "n_layers": 1}
    path.write_text(yaml.safe_dump(opt))
    return str(path)


@pytest.fixture(scope="module")
def jax_records(data, tmp_path_factory):
    """The JAX package's loop on every case, a subprocess each, run side by side on one
    thread each (the suite runs test files in parallel): {case: (record, root)}."""
    base = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_backend_optimization_level=0 --xla_cpu_multi_thread_eigen=false",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    procs = {}
    for c in CASES:
        opt = case_option_file(c, data, base / c)
        procs[c] = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_train_loop_trace.py"),
             str(base / c / "record.json"), str(STEPS), opt],
            env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        for c, proc in procs.items():
            _, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, f"the JAX loop on {c} failed:\n{err.decode()[-3000:]}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return {c: (json.loads((base / c / "record.json").read_text())[0], base / c) for c in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_loop_matches_jax(case, data, jax_records, tmp_path, monkeypatch):
    opt = case_option_file(case, data, tmp_path / case)
    got = _train_loop_trace.record(train, ["--opt", opt, "--cpu", "--max_steps", str(STEPS)],
                                   monkeypatch.setattr)
    ref, ref_root = jax_records[case]
    assert got["events"] == ref["events"]
    assert got["metric_keys"] == ref["metric_keys"] and len(got["metric_keys"]) == STEPS
    assert _files(tmp_path / case) == _files(ref_root)
    ev = got["events"]
    assert ev.count("batch") == STEPS + 1  # the loop takes one more batch to see it is done
    if case == "nll":
        assert ev.count("calibrate") == 2 and ev.count("clear_state") == 1 and ev.count("val") == 1
        assert ev.index("clear_state") > [i for i, e in enumerate(ev) if e == "batch"][2]
        assert _files(tmp_path / case) == {"models": ["3_G.ckpt", "4_G.ckpt", "latest_G.ckpt"],
                                           "training_state": ["3.state", "4.state"]}
    elif case == "plusplus":  # G at the even iterations after the first, D at every one
        assert ev.count("D") == STEPS and ev.count("feagan") == ev.count("pixel") == 2
    else:
        assert ev.count("rescaling") == STEPS
