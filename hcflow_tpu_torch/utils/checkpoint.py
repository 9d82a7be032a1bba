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
"""

from __future__ import annotations

import os
import pickle
import re
import shutil
from typing import Any, List, Optional

import torch

from .. import convert


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

