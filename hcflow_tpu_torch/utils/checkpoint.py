"""Checkpoint save/load with the reference's retention policy, and serving weights from
any checkpoint the repo's two packages or the reference write.

The counterpart of the JAX package's ``hcflow_tpu/utils/checkpoint.py`` with its two
backends: the same ``<iter>_G.ckpt`` / ``<iter>.state`` naming, retention of the 2
newest plus every ``keep_period`` multiple (5000; the reference's base_model.py) and
natural-sort ``latest_checkpoint`` (``resume_state: auto``), whatever the backend.

- ``pickle`` (the default): a file, the pickled tree with numpy leaves.
- ``orbax``: a directory in the layout of the JAX package's orbax backend (orbax's
  ``StandardCheckpointHandler``: OCDBT and zarr v2), written and read by
  ``utils/orbax.py`` without orbax, tensorstore or JAX, so that each package reads the
  other's.  Trees come back as nested dicts and lists of numpy arrays (a tuple as a
  list, a Python scalar as a 0-d array: see ``utils/orbax.py``); no ``like`` is needed.

:func:`load_any` gives this package's params for serving from a reference ``.pth``
state_dict (``convert.params_from_state_dict``) or from a ``.ckpt`` file or directory
that either package wrote (numpy in JAX's layout, converted by
``convert.params_from_jax``); a tree with a ``"params"`` key (what the train and
convert CLIs save) is unwrapped first.

Training writes (``cli/train.py``), with the backend of ``path.checkpoint_backend``:

- ``<iter>_G.ckpt`` and ``latest_G.ckpt`` in the JAX package's format,
  ``{"params": convert.params_to_jax(...), "step": n}`` (:func:`save_model`), so that
  both packages' ``load_any`` and ``cli/test.py`` serve a model the port trained;
- ``<iter>.state`` in the port's own layout (:func:`save_training_state`), numpy
  leaves: ``step``, ``params`` (this package's layout), ``opt_state`` (``count``,
  ``mu``, ``nu``, the non-finite counters), ``d_params``, ``d_opt_state``, ``epoch``,
  and the marker :data:`STATE_FORMAT`: a ``"format"`` entry of the pickled tree, or
  the ``format`` of an orbax directory's ``custom_metadata`` (orbax stores no ``str``
  leaf).  The JAX package's ``.state`` holds optax's state and no marker; reading one
  raises.

Every write is synchronous and atomic (a temporary file or directory, whose name no
listing matches, renamed into place), so :func:`wait_for_saves` has nothing to wait for.
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
from typing import Any, List, Optional

import numpy as np
import torch

from .. import convert
from ..models.hcflow_sr import device_for
from . import orbax

STATE_FORMAT = "hcflow_tpu_torch training state v1"


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _replace(tmp: str, path: str) -> None:
    """Move ``tmp`` to ``path``, replacing a file or directory there."""
    if not os.path.isdir(path):
        os.replace(tmp, path)
        return
    old = f"{path}.old-{os.getpid()}"
    os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old)


def _save_orbax(path: str, tree: Any, custom_metadata: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        orbax.write(tmp, tree, custom_metadata)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    _replace(tmp, path)


def save_checkpoint(path: str, tree: Any, backend: str = "pickle") -> None:
    """Write ``tree`` (tensors saved as numpy arrays) atomically: a pickle file, or an
    orbax directory with ``backend="orbax"``."""
    if backend == "orbax":
        _save_orbax(path, tree, {})
        return
    if backend != "pickle":
        raise ValueError(f"checkpoint backend {backend!r}: 'pickle' or 'orbax'")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(tree), f, protocol=4)
    _replace(tmp, path)


def wait_for_saves() -> None:
    """Nothing to wait for: every write here is synchronous."""


def save_model(path: str, params: dict, spec, step: int, backend: str = "pickle") -> None:
    """A model checkpoint in the JAX package's format, which both packages serve."""
    save_checkpoint(path, {"params": convert.params_to_jax(params, spec), "step": np.asarray(step)},
                    backend)


def save_training_state(path: str, step: int, params, opt_state: dict, d_params=None,
                        d_opt_state=None, epoch: int = 0, backend: str = "pickle") -> None:
    """The state that ``resume_state: auto`` restores, in the port's layout."""
    tree = {"step": step, "params": params, "opt_state": opt_state, "d_params": d_params,
            "d_opt_state": d_opt_state, "epoch": epoch}
    if backend == "orbax":
        _save_orbax(path, tree, {"format": STATE_FORMAT})
    else:
        save_checkpoint(path, {"format": STATE_FORMAT, **tree}, backend)


def _from_numpy(tree, device, leaf_grad: bool):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device, leaf_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_numpy(v, device, leaf_grad) for v in tree]
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(tree)).to(device)
        return t.requires_grad_(True) if leaf_grad else t
    return tree


def _ints(tree):
    """A tree read from orbax with its 0-d integer arrays as the Python ints they were
    saved from (the optimizer's counters)."""
    if isinstance(tree, dict):
        return {k: _ints(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ints(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.ndim == 0 and tree.dtype.kind == "i":
        return int(tree)
    return tree


def load_training_state(path: str, device="cuda") -> dict:
    """A ``.state`` written by :func:`save_training_state` with either backend, tensors
    on ``device``: params (and d_params) as leaves that require grad, as ``init_state``
    makes them.  Raises on the JAX package's ``.state`` (optax's optimizer state)."""
    device = device_for(device)
    if os.path.isdir(path):
        tree, custom = orbax.read(path)
        fmt = custom.get("format")
        if fmt == STATE_FORMAT:
            tree = {**tree, "step": int(tree["step"]), "epoch": int(tree["epoch"]),
                    "opt_state": _ints(tree["opt_state"]),
                    "d_opt_state": _ints(tree["d_opt_state"])}
    else:
        tree = load_checkpoint(path)
        fmt = tree.get("format") if isinstance(tree, dict) else None
    if fmt != STATE_FORMAT:
        raise ValueError(
            f"{path} is not a training state of this package (format {STATE_FORMAT!r}); a "
            "JAX package .state holds optax's optimizer state, which the port does not read: "
            "resume from its <iter>_G.ckpt through path.pretrain_model_G instead")
    out = dict(tree)
    for k in ("params", "d_params"):
        out[k] = _from_numpy(tree[k], device, True)
    for k in ("opt_state", "d_opt_state"):
        out[k] = _from_numpy(tree[k], device, False)
    return out


def load_checkpoint(path: str) -> Any:
    """A checkpoint as saved, numpy leaves: a pickle file, or an orbax directory (of
    either package) as nested dicts and lists."""
    if os.path.isdir(path):
        return orbax.read(path)[0]
    with open(path, "rb") as f:
        return pickle.load(f)


def _natural_key(s: str):
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", s)]


def list_checkpoints(directory: str, suffix: str = ".ckpt") -> List[str]:
    if not os.path.isdir(directory):
        return []
    files = [f for f in os.listdir(directory) if f.endswith(suffix)]
    return sorted(files, key=_natural_key)


def prune_checkpoints(directory: str, suffix: str = ".ckpt", keep: int = 2,
                      keep_period: int = 5000) -> None:
    """Keep the newest ``keep`` plus every ``keep_period`` multiple (the reference's
    base_model.py)."""
    files = list_checkpoints(directory, suffix)
    if len(files) <= keep:
        return
    for f in files[:-keep]:
        m = re.match(r"(\d+)", f)
        it = int(m.group(1)) if m else -1
        if keep_period and it >= 0 and it % keep_period == 0:
            continue
        full = os.path.join(directory, f)
        if os.path.isdir(full):  # orbax checkpoints are directories
            shutil.rmtree(full)
        else:
            os.remove(full)


def latest_checkpoint(directory: str, suffix: str = ".ckpt") -> Optional[str]:
    files = list_checkpoints(directory, suffix)
    return os.path.join(directory, files[-1]) if files else None


def load_any(path: str, flow_spec, prefix: str = "flow", device="cuda") -> dict:
    """This package's params for ``flow_spec`` (a ``FlowNetSpec``, or a model spec
    holding one) on ``device``, from a reference ``.pth`` state_dict or a ``.ckpt``
    (pickle file or orbax directory) in the JAX package's format."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu")
        return convert.params_from_state_dict(sd, flow_spec, device=device, prefix=prefix)
    tree = load_checkpoint(path)
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    return convert.params_from_jax(tree, flow_spec, device=device)

