"""The orbax checkpoint layout, read and written without orbax, tensorstore or JAX.

What ``orbax.checkpoint``'s ``StandardCheckpointHandler`` writes for a tree of arrays
(the JAX package's ``save_checkpoint(..., backend="orbax")``, one process, OCDBT and
zarr v2), and what it reads back:

- ``_CHECKPOINT_METADATA``: JSON; its ``custom_metadata`` is free for the writer (the
  port marks its ``.state`` there, since orbax stores no ``str`` leaf).
- ``_METADATA``: JSON; ``tree_metadata`` maps each leaf's key path, ``"('params', 'a',
  'w')"``, to its keys (``key_type`` 2 a dict key, 1 a sequence index) and its
  ``value_type``: ``np.ndarray`` or ``jax.Array`` (an array), or an empty ``None`` /
  ``Dict`` / ``List`` / ``Tuple`` (``skip_deserialize``).
- an OCDBT database (``utils/ocdbt.py``) holding every array as zarr v2 under its key
  path joined with ``.``: ``<name>/.zarray`` (JSON) and the chunks ``<name>/0.0.0``
  (``<name>/0`` for a 0-d array), each a zstd frame of the chunk's C-order bytes.

What the layout cannot hold, and what the port gets back: a tuple comes back as a list
(a sequence index does not say which it was), an empty tuple as ``()``; a Python
``int``, ``float`` or ``bool`` leaf is saved as a 0-d ``int64`` / ``float64`` / ``bool``
array (as the JAX package saves it) and comes back as that array; a ``str`` leaf and a
zero-size array raise, as in orbax.  Reading raises ``ValueError`` on any part of a
checkpoint it does not implement, naming it: a zarr v3 or non-OCDBT layout, a
compressor other than zstd or none, ``filters``, ``F`` order, a dtype outside
:data:`DTYPES`, a value type outside the list above.  A chunk that is absent reads as
the array's fill value (null: zero).
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from . import ocdbt, zstd

DTYPES = {"<f4": np.float32, "<f8": np.float64, "<f2": np.float16, "<i4": np.int32,
          "<i8": np.int64, "|b1": np.bool_, "|u1": np.uint8}
_DTYPE_NAMES = {np.dtype(v): k for k, v in DTYPES.items()}
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_ARRAY_TYPES = ("np.ndarray", "jax.Array")
_EMPTY = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_DICT_KEY, _SEQUENCE_KEY = 2, 1


# ------------------------------------------------------------------ zarr v2
def _fill(meta: dict, dtype) -> Any:
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):
        special = {"NaN": np.nan, "Infinity": np.inf, "-Infinity": -np.inf}
        if v not in special:
            raise ValueError(f"a zarr fill_value {v!r}")
        return special[v]
    return v


def read_array(store: ocdbt.Store, name: str) -> np.ndarray:
    """The zarr v2 array ``name`` of ``store``."""
    meta = json.loads(store.read(f"{name}/.zarray"))
    where = f"zarr array {name!r}"
    if meta.get("zarr_format") != 2:
        raise ValueError(f"{where}: zarr_format {meta.get('zarr_format')!r} (2 is implemented)")
    if meta.get("order", "C") != "C":
        raise ValueError(f"{where}: order {meta['order']!r} (C is implemented)")
    if meta.get("filters"):
        raise ValueError(f"{where}: filters {meta['filters']!r} (none are implemented)")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"{where}: compressor {comp.get('id')!r} (zstd or none are implemented)")
    if meta["dtype"] not in DTYPES:
        raise ValueError(f"{where}: dtype {meta['dtype']!r} (one of {sorted(DTYPES)})")
    sep = meta.get("dimension_separator", ".")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(chunks) != len(shape) or any(c < 1 for c in chunks):
        raise ValueError(f"{where}: chunks {list(chunks)} for shape {list(shape)}")
    dtype = np.dtype(DTYPES[meta["dtype"]])
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]

    def chunk(index) -> np.ndarray:
        key = f"{name}/{sep.join(str(i) for i in index) if index else '0'}"
        if key not in store:
            return None
        buf = store.read(key)
        out = np.empty(chunks, dtype)
        if comp is None:
            if len(buf) != out.nbytes:
                raise ValueError(f"{key}: {len(buf)} bytes where {out.nbytes} were expected")
            out[...] = np.frombuffer(buf, dtype).reshape(chunks)
        else:
            zstd.decompress_into(buf, out)
        return out

    if chunks == shape:  # one chunk: the array
        got = chunk((0,) * len(shape))
        return got if got is not None else np.full(shape, _fill(meta, dtype), dtype)
    out = np.empty(shape, dtype)
    for index in np.ndindex(*grid):
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        got = chunk(index)
        if got is None:
            out[region] = _fill(meta, dtype)
        else:
            out[region] = got[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def array_values(name: str, arr: np.ndarray) -> Dict[str, bytes]:
    """The store entries of ``arr`` as one zarr v2 chunk, as orbax writes a host array."""
    if arr.dtype not in _DTYPE_NAMES:
        raise ValueError(f"{name}: dtype {arr.dtype} (one of {sorted(DTYPES)})")
    if arr.size == 0:
        raise ValueError(f"Cannot save arrays with zero size: {name}")
    meta = {"chunks": list(arr.shape), "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _DTYPE_NAMES[arr.dtype], "fill_value": None,
            "filters": None, "order": "C", "shape": list(arr.shape), "zarr_format": 2}
    index = ".".join("0" for _ in arr.shape) or "0"
    return {f"{name}/.zarray": json.dumps(meta, separators=(",", ":"), sort_keys=True).encode(),
            f"{name}/{index}": zstd.frame_raw(np.ascontiguousarray(arr).data)}


# ------------------------------------------------------------------ trees
def _leaves(tree, path=()) -> List[Tuple[tuple, Any]]:
    """(key path of (key, key_type), leaf) pairs in JAX's flattening order (dict keys
    sorted, sequences by index), the order orbax rebuilds sequences in; an empty
    container is a leaf."""
    if isinstance(tree, dict):
        if not tree:
            return [(path, "Dict")]
        out = []
        for k, v in sorted(tree.items(), key=lambda kv: str(kv[0])):
            if not isinstance(k, str):
                raise ValueError(f"a dict key {k!r} at {[p for p, _ in path]}: keys are str")
            out += _leaves(v, path + ((k, _DICT_KEY),))
        return out
    if isinstance(tree, (list, tuple)):
        if not tree:
            return [(path, "Tuple" if isinstance(tree, tuple) else "List")]
        out = []
        for i, v in enumerate(tree):
            out += _leaves(v, path + ((str(i), _SEQUENCE_KEY),))
        return out
    if tree is None:
        return [(path, "None")]
    if isinstance(tree, str):
        raise ValueError(f"Unsupported type: <class 'str'> for key: {tuple(k for k, _ in path)}")
    if isinstance(tree, (bool, int, float)):
        return [(path, np.asarray(tree))]
    if hasattr(tree, "detach"):  # a torch tensor
        return [(path, tree.detach().cpu().numpy())]
    if isinstance(tree, np.ndarray):
        return [(path, tree)]
    if isinstance(tree, np.generic):
        return [(path, np.asarray(tree))]
    raise ValueError(f"Unsupported type: {type(tree)} for key: {tuple(k for k, _ in path)}")


def _name(path) -> str:
    return ".".join(k for k, _ in path)


def _path_str(path) -> str:
    return str(tuple(k for k, _ in path))


def write(directory: str, tree: Any, custom_metadata: dict = None) -> None:
    """Write ``tree`` as an orbax checkpoint into the new directory ``directory``."""
    t0 = time.time_ns()
    leaves = _leaves(tree)
    values, meta = {}, {}
    for path, leaf in leaves:
        if isinstance(leaf, str):
            value_type, skip = leaf, True
        else:
            value_type, skip = "np.ndarray", False
            values.update(array_values(_name(path), leaf))
        meta[_path_str(path)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in path],
            "value_metadata": {"value_type": value_type, "skip_deserialize": skip}}
    os.makedirs(directory)
    ocdbt.write(directory, values)
    # json.dumps, not json.dump: dump encodes in Python, piece by piece
    with open(os.path.join(directory, "_METADATA"), "w") as f:
        f.write(json.dumps({"tree_metadata": meta, "use_ocdbt": True, "use_zarr3": False,
                            "store_array_data_equal_to_fill_value": True,
                            "custom_metadata": None}))
    with open(os.path.join(directory, "_CHECKPOINT_METADATA"), "w") as f:
        f.write(json.dumps({"item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
                            "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
                            "custom_metadata": custom_metadata or {}}))


def _insert(root: dict, keys: List[dict], value, where: str) -> None:
    node = root
    for i, k in enumerate(keys):
        if k["key_type"] not in (_DICT_KEY, _SEQUENCE_KEY):
            raise ValueError(f"{where}: key type {k['key_type']} (1 and 2 are implemented)")
        slot = (k["key_type"], k["key"] if k["key_type"] == _DICT_KEY else int(k["key"]))
        if i == len(keys) - 1:
            if slot in node:
                raise ValueError(f"{where}: two leaves at one key path")
            node[slot] = value
        else:
            node = node.setdefault(slot, {})
            if not isinstance(node, dict):
                raise ValueError(f"{where}: a leaf that is also a container")


def _build(node):
    if not isinstance(node, dict):
        return node.value if isinstance(node, _Leaf) else node
    kinds = {t for t, _ in node}
    if kinds == {_SEQUENCE_KEY}:
        idx = sorted(i for _, i in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"sequence indices {idx} are not 0..{len(idx) - 1}")
        return [_build(node[(_SEQUENCE_KEY, i)]) for i in idx]
    if kinds == {_DICT_KEY}:
        return {k: _build(v) for (_, k), v in sorted(node.items())}
    raise ValueError("dict keys and sequence indices under one node")


class _Leaf:
    """A leaf value while the tree is built (a container value is no node)."""

    def __init__(self, value):
        self.value = value


def read(directory: str) -> Tuple[Any, dict]:
    """(tree, custom_metadata) of the orbax checkpoint ``directory``."""
    path = os.path.join(directory, "_METADATA")
    if not os.path.isfile(path):
        raise ValueError(f"{directory} is not an orbax checkpoint: it has no _METADATA")
    with open(path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False):
        raise ValueError(f"{directory}: a checkpoint without OCDBT (not implemented)")
    if meta.get("use_zarr3", False):
        raise ValueError(f"{directory}: a zarr v3 checkpoint (zarr v2 is implemented)")
    custom = {}
    ck = os.path.join(directory, "_CHECKPOINT_METADATA")
    if os.path.exists(ck):
        with open(ck) as f:
            custom = json.load(f).get("custom_metadata") or {}
    store = ocdbt.Store(directory)
    root = {}
    for path, entry in meta["tree_metadata"].items():
        keys = entry["key_metadata"]
        value_type = entry["value_metadata"]["value_type"]
        if value_type in _EMPTY:
            value = _EMPTY[value_type]()
        elif value_type in _ARRAY_TYPES:
            value = read_array(store, ".".join(k["key"] for k in keys))
        else:
            raise ValueError(f"{directory} {path}: value type {value_type!r} (one of "
                             f"{list(_EMPTY) + list(_ARRAY_TYPES)})")
        _insert(root, keys, _Leaf(value), f"{directory} {path}")
    return (_build(root) if root else {}), custom
