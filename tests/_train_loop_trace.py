"""Record what a train CLI's loop does: the passes of every iteration, in order.

``record(module, argv, setattr_)`` runs ``module.main(argv)`` (the JAX package's or
the port's ``cli/train.py``) with its step factories, its calibration, its train
loader and its Evaluator wrapped so that each call appends an event: ``batch`` for
every batch the loop takes from the train loader (an iteration starts with one),
``calibrate``, ``nll``, ``pixel``, ``feagan``, ``D``, ``rescaling``, ``val``, and
``clear_state`` from the loop's log line.  Returns {"events": [...], "metric_keys":
[the metric names of each progress line]}.  ``setattr_`` installs a wrapper
(pytest's ``monkeypatch.setattr`` in-process, plain ``setattr`` in a subprocess).

Run as a script, it records the JAX package's loop on each option file in turn, in a
fresh process whose XLA compiles at backend optimisation level 0 (a third of the
compile time; the same computation), and writes the records as a JSON list:

    python tests/_train_loop_trace.py OUT.json STEPS OPT.yml [OPT.yml ...]
"""

import json
import logging
import os
import sys

FACTORIES = {"make_sr_nll_step": "nll", "make_sr_pixel_step": "pixel",
             "make_sr_feagan_step": "feagan", "make_d_step": "D",
             "make_rescaling_step": "rescaling"}


class _Lines(logging.Handler):
    def __init__(self, events, keys):
        super().__init__()
        self.events, self.keys = events, keys

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("clear_state"):
            self.events.append("clear_state")
        elif msg.startswith("<epoch:"):
            tail = msg.split("> ", 1)[1] if "> " in msg else ""
            self.keys.append(sorted(kv.split(": ")[0] for kv in tail.split(", ") if kv))


class _Loader:
    """A train loader whose batches append ``batch``."""

    def __init__(self, loader, events):
        self.loader, self.events = loader, events

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        for b in self.loader:
            self.events.append("batch")
            yield b


def _recording(fn, name, events):
    def wrapped(*a, **k):
        events.append(name)
        return fn(*a, **k)

    return wrapped


def record(module, argv, setattr_, jax_calibrate=False):
    events, keys = [], []
    for factory, name in FACTORIES.items():
        real = getattr(module, factory)
        setattr_(module, factory, lambda *a, _real=real, _n=name, **k:
                 _recording(_real(*a, **k), _n, events))
    build = module.build_loaders

    def build_loaders(*a, **k):
        train, val = build(*a, **k)
        return _Loader(train, events), val

    setattr_(module, "build_loaders", build_loaders)

    class Evaluator(module.Evaluator):
        def run(self, *a, **k):
            events.append("val")
            return super().run(*a, **k)

    setattr_(module, "Evaluator", Evaluator)
    if jax_calibrate:  # the JAX loop jits model_spec.calibrate: record each call of it
        import jax

        class _Jax:
            def __getattr__(self, name):
                return getattr(jax, name)

            @staticmethod
            def jit(fn, **kw):
                out = jax.jit(fn, **kw)
                return (_recording(out, "calibrate", events)
                        if getattr(fn, "__name__", "") == "calibrate" else out)

        setattr_(module, "jax", _Jax())
    else:  # the port's loop calls model_spec.calibrate
        from hcflow_tpu_torch.models.hcflow_sr import HCFlowSRSpec

        setattr_(HCFlowSRSpec, "calibrate",
                 _recording(HCFlowSRSpec.calibrate, "calibrate", events))
    handler = _Lines(events, keys)
    setup = module.setup_logger

    def setup_logger(*a, **k):
        logger = setup(*a, **k)
        logger.addHandler(handler)
        return logger

    setattr_(module, "setup_logger", setup_logger)
    try:
        module.main(argv)
    finally:
        logging.getLogger("base").removeHandler(handler)
    return {"events": events, "metric_keys": keys}


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import jax

    jax.config.update("jax_platforms", "cpu")
    from hcflow_tpu.cli import train

    out = []
    for opt in sys.argv[3:]:
        saved = {name: getattr(train, name) for name in (*FACTORIES, "build_loaders",
                                                         "Evaluator", "jax", "setup_logger")}
        out.append(record(train, ["--opt", opt, "--cpu", "--max_steps", sys.argv[2]], setattr,
                          jax_calibrate=True))
        for name, value in saved.items():
            setattr(train, name, value)
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)
