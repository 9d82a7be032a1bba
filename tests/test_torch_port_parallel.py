"""Data parallelism of the port (``hcflow_tpu_torch/parallel/``) on the CPU, in
2-process gloo groups started by ``parallel.dryrun.launch``:

- ``dryrun_multigpu(2, mesh_shape=(2, 1))`` (data parallelism alone): two SR NLL steps,
  one with ``remat_steps``, an HCFlow++ iteration (NLL, pixel, fea/GAN and D with
  BatchNorm over the global batch) and a rescaling joint step, each pass's all-reduced
  gradient within 1e-5 x max |g| of the one-process pass on the global batch in every
  leaf, with the same params, latents and noise (the discriminator in float64,
  see the dry run's docstring), the D loss within 1e-5 relative, the ranks' params
  bit-identical after every pass, the ActNorm calibration on the gathered batch equal
  to one process's bit for bit;
- the 2-rank NLL gradient against ``jax.value_and_grad`` of the JAX package's NLL on
  the global batch (float32: 1e-4 x max(1, max |g|), as tests/test_torch_port_train.py);
- the sampler: the two ranks' batches interleave to the one-process batches;
- ``cli.train.main`` under 2 ranks: only rank 0 writes checkpoints and validates (a
  stopping iteration saves and returns before its validation), a
  SIGTERM on rank 1 stops both ranks at the same iteration, the ranks' params stay
  bit-identical; a batch size the world size does not divide raises.
"""

import numpy as np
import pytest
import torch
import yaml

from hcflow_tpu_torch.data.loader import DataLoader, EnlargedSampler, create_dataloader
from hcflow_tpu_torch.models import HCFlowSRSpec
from hcflow_tpu_torch.parallel import dryrun, mesh

import _parallel_ranks
from _torch_port_util import few_threads  # noqa: F401
from _torch_port_util import TOL, _check_grads, close_scaled, jax_run, to_jax, train_data
from _torch_port_util import train_option_file

PASSES = ["nll1", "nll2", "nll_remat", "plusplus_nll", "pixel", "feagan", "D", "rescaling"]


@pytest.fixture(scope="module")
def report():
    return dryrun.dryrun_multigpu(2, cpu=True, tol=1e-5, mesh_shape=(2, 1))


@pytest.mark.parametrize("name", PASSES)
def test_all_reduced_gradient_matches_one_process(report, name):
    r = report["passes"][name]
    assert r["max_abs_err"] <= 1e-5 * r["max_abs_grad"], r


def test_d_loss_matches_one_process(report):
    assert report["d_loss"]["rel"] <= 1e-5, report["d_loss"]


def test_ranks_params_bit_identical_after_every_pass(report):
    assert report["digests_equal"] and [n for n, _ in report["digests"]] == PASSES


def test_calibration_on_the_gathered_batch_is_one_process_calibration(report):
    assert report["calibrate_equal"]


def test_two_rank_nll_gradient_matches_jax(report):
    import jax

    from hcflow_tpu.models.hcflow_sr import HCFlowSRSpec as JHCFlowSRSpec

    kw = dict(rrdb_nb=(1, 1), rrdb_nf=8, rrdb_gc=4, K=(3, 3), after_splitoff=(1, 1),
              hidden_channels=8, so_hidden_channels=8)
    model, jmodel = HCFlowSRSpec.for_scale(4, **kw), JHCFlowSRSpec.for_scale(4, **kw)
    r = report["nll"]
    hr, lr, noise = (r[k].numpy() for k in ("hr", "lr", "noise"))
    nll_j, g_j = jax_run(jax.value_and_grad(
        lambda p: jmodel.forward(p, None, hr, lr, noise=noise)[1]), to_jax(r["params"]))
    assert np.isfinite(float(nll_j))
    _check_grads(model, r["grads"], g_j, TOL[None])


class _Indices:
    def __len__(self):
        return 10

    def __getitem__(self, i):
        return {"i": np.array([i], np.float32)}


def test_sampler_ranks_interleave_to_the_one_process_batches():
    one = DataLoader(_Indices(), batch_size=4, drop_last=True,
                     sampler=EnlargedSampler(10, ratio=200, seed=3))
    ranks = [DataLoader(_Indices(), batch_size=2, drop_last=True,
                        sampler=EnlargedSampler(10, ratio=200, num_replicas=2, rank=r, seed=3))
             for r in (0, 1)]
    for epoch in (0, 1):
        for loader in (one, *ranks):
            loader.set_epoch(epoch)
        got = 0
        for b, b0, b1 in zip(one, *ranks):
            whole = torch.from_numpy(b["i"])
            assert torch.equal(mesh.shard_batch(whole, 0, 2), torch.from_numpy(b0["i"]))
            assert torch.equal(mesh.shard_batch(whole, 1, 2), torch.from_numpy(b1["i"]))
            got += 1
        assert got == len(one) == len(ranks[0])
    loader = create_dataloader(_Indices(), {"batch_size": 4, "phase": "train"},
                               sampler=ranks[0].sampler, num_replicas=2)
    assert loader.batch_size == 2


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """cli.train.main on a small HCFlow+ config under 2 ranks, 3 iterations asked,
    validation and a checkpoint every iteration; rank 1 gets SIGTERM in
    iteration 2."""
    base = tmp_path_factory.mktemp("cli")
    data = train_data(base / "data")
    opt = train_option_file(base / "opt.yml", "train_SR_DF2K_4X_HCFlow+.yml", data, base / "run",
                            val_freq=1)
    return dryrun.launch(2, _parallel_ranks.train_cli, (opt, 3, 1, 1), cpu=True), base / "run"


def test_only_rank_0_writes_checkpoints_and_validates(cli):
    ranks, root = cli
    assert ranks[0]["saves"] == ["1_G.ckpt", "1.state", "2_G.ckpt", "2.state"]
    assert ranks[1]["saves"] == []
    assert [r["validations"] for r in ranks] == [1, 0]
    exp = next((root / "experiments").iterdir())
    assert sorted(p.name for p in (exp / "models").iterdir()) == ["1_G.ckpt", "2_G.ckpt"]


def test_stop_request_on_one_rank_stops_every_rank(cli):
    ranks, _ = cli
    assert [r["step"] for r in ranks] == [2, 2]


def test_cli_ranks_params_bit_identical(cli):
    ranks, _ = cli
    assert len(ranks[0]["digests"]) == 2 and ranks[0]["digests"] == ranks[1]["digests"]


def test_batch_size_the_world_does_not_divide_raises(cli, tmp_path):
    _, root = cli
    opt = root.parent / "opt.yml"
    o = yaml.safe_load(opt.read_text())
    o["datasets"]["train"]["batch_size"] = 3
    odd = tmp_path / "odd.yml"
    odd.write_text(yaml.safe_dump(o))
    with pytest.raises(RuntimeError, match="not a multiple of the world size 2"):
        dryrun.launch(2, _parallel_ranks.train_cli, (str(odd), 1), cpu=True)
