"""Tensorstore's OCDBT key-value store (the storage under an orbax checkpoint), read and
written without tensorstore.

A database is a directory.  ``manifest.ocdbt`` holds the configuration and the
versions; each version names the root of a B+tree whose nodes, like the manifest, are
files or parts of files (``d/<hex>``).  Every manifest and node has one frame:

    magic u32 big-endian (0x0cdb3a2a manifest, 0x0cdb20de node) | whole length u64 LE |
    version varint (0) | compression varint (0 none, 1 zstd) | body | CRC-32C u32 LE

with the CRC over everything before it.  Integers are little-endian varints unless
said; arrays of records are stored column by column.

- manifest body: config (uuid 16 bytes, manifest kind (0: the versions are inline),
  max_inline_value_bytes, max_decoded_node_bytes, version_tree_arity_log2 u8,
  compression (0 none, 1 zstd + level i32 LE)); a data-file table; the inline versions
  (generation, root height u8, root location (file, offset, length), num_keys,
  num_tree_bytes, num_indirect_value_bytes, commit time u64 LE); references to older
  version-tree nodes (generation, location, num_generations, commit time, height u8).
  The newest version is the last inline one.  An empty tree's root location is the
  file ``""`` at offset and length 2^64 - 1.
- data-file table: count, then for files 1.. the length of the prefix shared with the
  previous path, then every path's suffix length, every base-path length, the
  suffixes.  A path is base + relative, from the database's directory, so a merged
  top-level tree can point into ``ocdbt.process_<i>/d/``.
- node body: height u8, its data-file table, the entry count, the keys (the length of
  the prefix shared with the previous key for entries 1.., every suffix length, for an
  interior node every subtree's common-prefix length, the suffixes).  A leaf then has
  the value lengths, the value kinds (0 inline, 1 indirect), the indirect values'
  files and offsets, and the inline values back to back.  An interior node has its
  children's locations, key counts, tree bytes and indirect value bytes; a child's
  keys omit the first common-prefix-length bytes of its entry's key.

Orbax writes each process's database under ``ocdbt.process_<i>/`` and then a top-level
database whose tree refers to their data files; :class:`Store` starts at the top-level
manifest as tensorstore does, so one path reads a single- and a multi-process
checkpoint.  :func:`write` writes what one JAX process writes: ``ocdbt.process_0/``
and a top-level manifest and leaf, with orbax's configuration (values over 1024 bytes
in a data file, nodes up to 10^8 bytes).  Its tree is one leaf: a checkpoint whose
keys and inline values need more than 10^8 bytes raises.  Anything the reader does not
implement (numbered manifests, a node past ``max_decoded_node_bytes``), and a CRC, a
length or a field that does not hold, raises ``ValueError`` naming the file.
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from typing import Dict, List, Tuple

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # an empty tree's root offset and length
# orbax's configuration of the database
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
PROCESS_DIR = "ocdbt.process_0"


class _Cursor:
    def __init__(self, buf: bytes, where: str):
        self.buf, self.at, self.where = buf, 0, where

    def fail(self, what: str):
        raise ValueError(f"{self.where}: {what}")

    def raw(self, n: int) -> bytes:
        if self.at + n > len(self.buf):
            self.fail(f"truncated ({n} bytes wanted at {self.at} of {len(self.buf)})")
        out = self.buf[self.at:self.at + n]
        self.at += n
        return out

    def u8(self) -> int:
        return self.raw(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.raw(8))[0]

    def varint(self) -> int:
        v = shift = 0
        for _ in range(10):
            b = self.u8()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                if v >= 1 << 64:
                    break
                return v
            shift += 7
        self.fail(f"a varint over 64 bits at {self.at}")

    def column(self, n: int, read) -> list:
        return [read() for _ in range(n)]

    def end(self):
        if self.at != len(self.buf):
            self.fail(f"{len(self.buf) - self.at} bytes after the end of its fields")


def _unframe(buf: bytes, magic: int, where: str) -> bytes:
    c = _Cursor(buf, where)
    if len(buf) < 18:
        c.fail(f"{len(buf)} bytes, too short for a frame")
    got = struct.unpack(">I", buf[:4])[0]
    if got != magic:
        c.fail(f"magic 0x{got:08x} where 0x{magic:08x} was expected")
    length = struct.unpack("<Q", buf[4:12])[0]
    if length != len(buf):
        c.fail(f"a frame of {len(buf)} bytes whose header says {length}")
    crc = struct.unpack("<I", buf[-4:])[0]
    if zstd.crc32c(buf[:-4]) != crc:
        c.fail(f"CRC-32C mismatch (footer 0x{crc:08x})")
    c.at = 12
    version, compression = c.varint(), c.varint()
    if version != 0:
        c.fail(f"format version {version} (only 0 is known)")
    body = buf[c.at:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    c.fail(f"compression {compression} (0 none and 1 zstd are known)")


def _frame(body: bytes, magic: int) -> bytes:
    head = struct.pack(">I", magic)
    rest = bytes([0, 0]) + body  # version 0, compression 0 (none)
    length = len(head) + 8 + len(rest) + 4
    out = head + struct.pack("<Q", length) + rest
    return out + struct.pack("<I", zstd.crc32c(out))


def _varint(v: int) -> bytes:
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _common(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


# ------------------------------------------------------------------ data-file tables
def _read_files(c: _Cursor) -> List[str]:
    n = c.varint()
    prefix = [0] + c.column(n - 1, c.varint) if n else []
    suffix = c.column(n, c.varint)
    base = c.column(n, c.varint)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            c.fail(f"data file {i} shares {prefix[i]} bytes with a {len(prev)}-byte path")
        path = prev[:prefix[i]] + c.raw(suffix[i])
        if base[i] > len(path):
            c.fail(f"data file {i}'s base path is longer than its path")
        text = path.decode()
        if text.startswith("/") or ".." in text.split("/"):
            c.fail(f"data file path {text!r} leaves the database")
        paths.append(text)
        prev = path
    return paths


def _write_files(files: List[Tuple[str, str]]) -> bytes:
    """``files``: (base path, relative path) pairs."""
    paths = [(b + r).encode() for b, r in files]
    shared = [0] + [_common(paths[i - 1], paths[i]) for i in range(1, len(paths))]
    out = [_varint(len(files))] + [_varint(s) for s in shared[1:]]
    out += [_varint(len(p) - s) for p, s in zip(paths, shared)]
    out += [_varint(len(b.encode())) for b, _ in files]
    out += [p[s:] for p, s in zip(paths, shared)]
    return b"".join(out)


def _read_keys(c: _Cursor, n: int, interior: bool):
    prefix = [0] + c.column(n - 1, c.varint) if n else []
    suffix = c.column(n, c.varint)
    common = c.column(n, c.varint) if interior else None
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            c.fail(f"key {i} shares {prefix[i]} bytes with a {len(prev)}-byte key")
        key = prev[:prefix[i]] + c.raw(suffix[i])
        if keys and key <= keys[-1]:
            c.fail(f"key {i} is not after the key before it")
        keys.append(key)
        prev = key
    return keys, common


# ------------------------------------------------------------------ reading
class Store:
    """The newest version of the database under ``root``: ``keys()``, ``read(key)``."""

    def __init__(self, root: str):
        self.root = root
        self._values: Dict[str, object] = {}  # key -> bytes, or (path, offset, length)
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            c = _Cursor(_unframe(f.read(), MANIFEST_MAGIC, path), path)
        c.raw(16)  # uuid
        kind = c.varint()
        if kind != 0:
            c.fail(f"manifest kind {kind} (numbered manifests are not implemented)")
        c.varint()  # max_inline_value_bytes: a reader takes what each leaf says
        self.max_node_bytes = c.varint()
        c.u8()  # version_tree_arity_log2
        if c.varint() == 1:
            c.raw(4)  # zstd level
        files = _read_files(c)
        n = c.varint()
        gens = c.column(n, c.varint)
        heights = c.column(n, c.u8)
        fids = c.column(n, c.varint)
        offsets = c.column(n, c.varint)
        lengths = c.column(n, c.varint)
        c.column(3 * n, c.varint)  # num_keys, num_tree_bytes, num_indirect_value_bytes
        c.column(n, c.u64)  # commit times
        m = c.varint()  # older versions' tree nodes: generation, location, count, time, height
        c.column(5 * m, c.varint)
        c.column(m, c.u64)
        c.column(m, c.u8)
        c.end()
        if n == 0:
            c.fail("no version inline")
        if any(a >= b for a, b in zip(gens, gens[1:])):
            c.fail("inline versions out of order")
        if offsets[-1] == MISSING and lengths[-1] == MISSING:
            return  # the newest version's tree is empty
        self._node(files, fids[-1], offsets[-1], lengths[-1], heights[-1], b"", path)

    def _file(self, files: List[str], fid: int, where: str) -> str:
        if fid >= len(files):
            raise ValueError(f"{where}: data file {fid} of {len(files)}")
        return os.path.join(self.root, files[fid])

    def _node(self, files, fid, offset, length, height, prefix: bytes, where: str):
        path = self._file(files, fid, where)
        with open(path, "rb") as f:
            f.seek(offset)
            buf = f.read(length)
        name = f"{path}@{offset}"
        if len(buf) != length:
            raise ValueError(f"{name}: a node of {length} bytes past the end of its file")
        body = _unframe(buf, NODE_MAGIC, name)
        if len(body) > self.max_node_bytes:
            raise ValueError(f"{name}: a node of {len(body)} bytes (at most {self.max_node_bytes})")
        c = _Cursor(body, name)
        if c.u8() != height:
            c.fail(f"a node that is not at height {height}")
        node_files = _read_files(c)
        n = c.varint()
        keys, common = _read_keys(c, n, height > 0)
        if height == 0:
            lengths = c.column(n, c.varint)
            kinds = c.column(n, c.varint)
            if any(k > 1 for k in kinds):
                c.fail(f"value kind {max(kinds)} (0 inline and 1 indirect are known)")
            indirect = [i for i in range(n) if kinds[i] == 1]
            fids = c.column(len(indirect), c.varint)
            offsets = c.column(len(indirect), c.varint)
            refs = dict(zip(indirect, zip(fids, offsets)))
            for i, key in enumerate(keys):
                full = (prefix + key).decode()
                if kinds[i] == 0:
                    self._values[full] = c.raw(lengths[i])
                else:
                    vf, vo = refs[i]
                    self._values[full] = (self._file(node_files, vf, name), vo, lengths[i])
            c.end()
            return
        cols = [c.column(n, c.varint) for _ in range(6)]  # file, offset, length, 3 statistics
        c.end()
        for i, key in enumerate(keys):
            if common[i] > len(key):
                c.fail(f"entry {i}'s common prefix is longer than its key")
            self._node(node_files, cols[0][i], cols[1][i], cols[2][i], height - 1,
                       prefix + key[:common[i]], name)

    def keys(self) -> List[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def read(self, key: str) -> bytes:
        v = self._values[key]
        if isinstance(v, bytes):
            return v
        path, offset, length = v
        with open(path, "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise ValueError(f"{path}: a value of {length} bytes at {offset} past the end of "
                             "the file")
        return out


# ------------------------------------------------------------------ writing
def _hex_name() -> str:
    return "d/" + uuid.uuid4().hex


def _leaf(items: List[Tuple[bytes, bytes]], data_file: Tuple[str, str], offsets: Dict[int, int]):
    """A leaf of ``items`` (sorted (key, value)); values at ``offsets`` (index ->
    offset) are in ``data_file``, the rest inline."""
    keys = [k for k, _ in items]
    shared = [0] + [_common(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    out = [bytes([0]), _write_files([data_file] if offsets else []), _varint(len(items))]
    out += [_varint(s) for s in shared[1:]]
    out += [_varint(len(k) - s) for k, s in zip(keys, shared)]
    out += [k[s:] for k, s in zip(keys, shared)]
    out += [_varint(len(v)) for _, v in items]
    out += [bytes([1 if i in offsets else 0]) for i in range(len(items))]
    out += [_varint(0) for _ in offsets]  # every indirect value is in file 0
    out += [_varint(offsets[i]) for i in sorted(offsets)]
    out += [v for i, (_, v) in enumerate(items) if i not in offsets]
    body = b"".join(out)
    if len(body) > MAX_DECODED_NODE_BYTES:
        raise ValueError(f"a leaf of {len(body)} bytes: the writer makes one leaf of at most "
                         f"{MAX_DECODED_NODE_BYTES} bytes")
    return _frame(body, NODE_MAGIC)


def _manifest(node_path: str, node_len: int, n_keys: int, indirect_bytes: int) -> bytes:
    out = [uuid.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
           _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]),
           _varint(1), struct.pack("<i", 0)]  # nodes the database writes: zstd, level 0
    if node_path is None:  # an empty tree
        out += [_write_files([("", "")]), _varint(1), _varint(1), bytes([0]), _varint(0),
                _varint(MISSING), _varint(MISSING), _varint(0), _varint(0), _varint(0)]
    else:
        out += [_write_files([("", node_path)]), _varint(1), _varint(1), bytes([0]),
                _varint(0), _varint(0), _varint(node_len), _varint(n_keys), _varint(node_len),
                _varint(indirect_bytes)]
    out += [struct.pack("<Q", time.time_ns()), _varint(0)]  # no older version-tree nodes
    return _frame(b"".join(out), MANIFEST_MAGIC)


def _write(path: str, data) -> None:
    with open(path, "wb") as f:
        f.write(data)


def write(root: str, values: Dict[str, bytes]) -> None:
    """A database under ``root`` (which must not hold one) with one version holding
    ``values``, laid out as one orbax process writes it."""
    items = sorted((k.encode(), bytes(v)) for k, v in values.items())
    proc = os.path.join(root, PROCESS_DIR)
    os.makedirs(os.path.join(proc, "d"), exist_ok=True)
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    offsets, at = {}, 0
    for i, (_, v) in enumerate(items):
        if len(v) > MAX_INLINE_VALUE_BYTES:
            offsets[i] = at
            at += len(v)
    data_name = _hex_name()
    if offsets:
        with open(os.path.join(proc, data_name), "wb") as f:
            for i in sorted(offsets):
                f.write(items[i][1])
    for base, where in (("", proc), (PROCESS_DIR + "/", root)):
        if not items:
            _write(os.path.join(where, "manifest.ocdbt"), _manifest(None, 0, 0, 0))
            continue
        node = _leaf(items, (base, data_name), offsets)
        node_name = _hex_name()
        _write(os.path.join(where, node_name), node)
        _write(os.path.join(where, "manifest.ocdbt"),
               _manifest(node_name, len(node), len(items), at))
