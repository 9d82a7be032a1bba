"""Checkpoint save/load with the reference's retention policy, and serving weights from
any checkpoint the repo's two packages or the reference write.

The counterpart of the JAX package's ``hcflow_tpu/utils/checkpoint.py`` with its
``pickle`` backend: the same ``<iter>_G.ckpt`` / ``<iter>.state`` naming, retention of
the 2 newest plus every ``keep_period`` multiple (5000; the reference's
base_model.py) and natural-sort ``latest_checkpoint`` (``resume_state: auto``).  The
JAX package's ``orbax`` backend writes a directory of tensorstore files; no orbax is
installed beside the port, and reading one raises, naming the format.

:func:`load_any` gives this package's params for serving from a reference ``.pth``
state_dict (``convert.params_from_state_dict``) or from a pickled ``.ckpt`` that the
JAX package wrote (numpy in JAX's layout, converted by ``convert.params_from_jax``); a
tree with a ``"params"`` key (what the JAX package's train and convert CLIs save) is
unwrapped first.

Training writes (``cli/train.py``):

- ``<iter>_G.ckpt`` and ``latest_G.ckpt`` in the JAX package's format,
  ``{"params": convert.params_to_jax(...), "step": n}`` pickled
  (:func:`save_model`), so that both packages' ``load_any`` and ``cli/test.py`` serve
  a model the port trained;
- ``<iter>.state`` in the port's own layout (:func:`save_training_state`), numpy
  leaves: ``step``, ``params`` (this package's layout), ``opt_state`` (``count``,
  ``mu``, ``nu``, the non-finite counters), ``d_params``, ``d_opt_state``, ``epoch``.
  The JAX package's ``.state`` holds optax's state instead; reading one raises.

Every write is synchronous and atomic (a temporary file renamed into place), so
:func:`wait_for_saves` has nothing to wait for.
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

STATE_FORMAT = "hcflow_tpu_torch training state v1"


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def save_checkpoint(path: str, tree: Any) -> None:
    """Pickle ``tree`` with every tensor as a numpy array, written atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(tree), f, protocol=4)
    os.replace(tmp, path)


def wait_for_saves() -> None:
    """Nothing to wait for: every write here is synchronous."""


def save_model(path: str, params: dict, spec, step: int) -> None:
    """A model checkpoint in the JAX package's format, which both packages serve."""
    save_checkpoint(path, {"params": convert.params_to_jax(params, spec), "step": np.asarray(step)})


def save_training_state(path: str, step: int, params, opt_state: dict, d_params=None,
                        d_opt_state=None, epoch: int = 0) -> None:
    """The state that ``resume_state: auto`` restores, in the port's layout."""
    save_checkpoint(path, {"format": STATE_FORMAT, "step": step, "params": params,
                           "opt_state": opt_state, "d_params": d_params,
                           "d_opt_state": d_opt_state, "epoch": epoch})


def _from_numpy(tree, device, leaf_grad: bool):
    if isinstance(tree, dict):
        return {k: _from_numpy(v, device, leaf_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_from_numpy(v, device, leaf_grad) for v in tree]
    if isinstance(tree, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(tree)).to(device)
        return t.requires_grad_(True) if leaf_grad else t
    return tree


def load_training_state(path: str, device="cuda") -> dict:
    """A ``.state`` written by :func:`save_training_state`, tensors on ``device``:
    params (and d_params) as leaves that require grad, as ``init_state`` makes them.
    Raises on the JAX package's ``.state`` (optax's optimizer state)."""
    device = device_for(device)
    tree = load_checkpoint(path)
    if not isinstance(tree, dict) or tree.get("format") != STATE_FORMAT:
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
    """Load a pickled checkpoint (numpy leaves, as saved)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory, an orbax checkpoint of the JAX package: the port reads "
            "pickled .ckpt files only (save one with the JAX package's pickle backend)")
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
        if os.path.isdir(full):  # the JAX package's orbax checkpoints are directories
            shutil.rmtree(full)
        else:
            os.remove(full)


def latest_checkpoint(directory: str, suffix: str = ".ckpt") -> Optional[str]:
    files = list_checkpoints(directory, suffix)
    return os.path.join(directory, files[-1]) if files else None


def load_any(path: str, flow_spec, prefix: str = "flow", device="cuda") -> dict:
    """This package's params for ``flow_spec`` (a ``FlowNetSpec``, or a model spec
    holding one) on ``device``, from a reference ``.pth`` state_dict or a pickled
    ``.ckpt`` of the JAX package."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu")
        return convert.params_from_state_dict(sd, flow_spec, device=device, prefix=prefix)
    tree = load_checkpoint(path)
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]
    return convert.params_from_jax(tree, flow_spec, device=device)

