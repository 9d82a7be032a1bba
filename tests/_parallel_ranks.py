"""What the ranks of tests/test_torch_port_parallel.py run, in processes that
``hcflow_tpu_torch.parallel.dryrun.launch`` starts: this module imports no JAX, so a
rank starts in a few seconds."""

import os
import signal

import torch

from hcflow_tpu_torch.cli import train
from hcflow_tpu_torch.parallel.dryrun import digest


def train_cli(opt_path, max_steps, term_rank=None, term_at_step=None, cpu=True):
    """``cli.train.main`` on opt_path (on the CPU, or with ``cpu`` False on the rank's
    card) under the process group, recording the
    checkpoint writes and validations of this rank and a digest of its params after
    every NLL pass; with ``term_rank``, that rank sends itself SIGTERM in the NLL pass
    of iteration ``term_at_step + 1``.  Returns {"step": G step, "digests": [per NLL
    pass], "saves": [file names], "validations": count}."""
    rank = torch.distributed.get_rank()
    saves, digests, vals = [], [], []
    real_model, real_state, real_nll = train.save_model, train.save_training_state, \
        train.make_sr_nll_step

    def save_model(path, *a, **k):
        saves.append(os.path.basename(path))
        return real_model(path, *a, **k)

    def save_training_state(path, *a, **k):
        saves.append(os.path.basename(path))
        return real_state(path, *a, **k)

    def make_nll(*a, **k):
        step = real_nll(*a, **k)

        def recorded(state, *sa, **sk):
            if rank == term_rank and state.step == term_at_step:
                os.kill(os.getpid(), signal.SIGTERM)
            out = step(state, *sa, **sk)
            digests.append(digest(out[0].params))
            return out

        return recorded

    class Evaluator(train.Evaluator):
        def run(self, *a, **k):
            vals.append(1)
            return super().run(*a, **k)

    train.save_model, train.save_training_state = save_model, save_training_state
    train.make_sr_nll_step, train.Evaluator = make_nll, Evaluator
    try:
        state = train.main(["--opt", opt_path, "--max_steps", str(max_steps)]
                           + (["--cpu"] if cpu else []))
    finally:
        train.save_model, train.save_training_state = real_model, real_state
        train.make_sr_nll_step, train.Evaluator = real_nll, Evaluator.__base__
    return {"step": state.step, "digests": digests, "saves": saves, "validations": len(vals)}
