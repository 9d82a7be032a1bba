"""LMDB-backed image reading, with a pure-Python fallback parser.

A copy of the JAX package's ``hcflow_tpu/data/lmdb_backend.py`` (pure Python), kept
here so that the port needs no JAX.  It follows the reference's data/util.py (paths
from LMDB meta_info.pkl, _read_img_lmdb) and GTLQ_dataset.py (lazy env init, flat
uint8 BGR buffers keyed by image name, 'C_H_W' resolution strings).

The ``lmdb`` package is optional, so this module implements a
read-only parser of the LMDB on-disk format directly (mmap'd data.mdb: meta-page
selection by txnid, B-tree walk over branch/leaf pages, F_BIGDATA overflow values) and
uses the real ``lmdb`` package instead whenever it is importable.  A minimal writer —
enough to produce spec-conformant single-writer databases — backs the tests and the
data-prep CLI.

Format reference: LMDB 0.9 (mdb.c) struct layout, little-endian:
  page header (16B):  pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
  meta page payload:  magic u32 (0xBEEFC0DE) | version u32 (1) | address u64 |
                      mapsize u64 | MDB_db[2] (48B each) | last_pg u64 | txnid u64
  MDB_db (48B):       pad u32 | flags u16 | depth u16 | branch_pages u64 |
                      leaf_pages u64 | overflow_pages u64 | entries u64 | root u64
                      (env page size lives in dbs[0].pad; main DB is dbs[1])
  node header (8B):   lo u16 | hi u16 | flags u16 | ksize u16, then key bytes.
                      leaf: data follows key (size = lo | hi<<16), or with F_BIGDATA
                      the key is followed by the u64 pgno of an overflow page run.
                      branch: child pgno = lo | hi<<16 | flags<<32.
"""

from __future__ import annotations

import mmap
import os
import pickle
import struct
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

_PAGE_HDR = struct.Struct("<QHHHH")
_NODE_HDR = struct.Struct("<HHHH")
_META = struct.Struct("<IIQQ")  # magic, version, address, mapsize (then dbs)
_DB = struct.Struct("<IHHQQQQQ")

_MAGIC = 0xBEEFC0DE
_DATA_VERSION = 1
_P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH, P_LEAF, P_OVERFLOW, P_META, P_LEAF2 = 0x01, 0x02, 0x04, 0x08, 0x20
F_BIGDATA = 0x01


class PureLmdbReader:
    """Read-only parser of an LMDB environment (directory with data.mdb, or a
    MDB_NOSUBDIR single file)."""

    def __init__(self, path: str):
        datafile = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        self._f = open(datafile, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        # page size is recorded in meta page 0 (dbs[0].pad); read it first
        psize = _DB.unpack_from(self._m, 16 + _META.size)[0]
        if psize < 512 or psize & (psize - 1):
            raise ValueError(f"{datafile}: implausible LMDB page size {psize}")
        self.psize = psize
        meta0 = self._read_meta(0)
        meta1 = self._read_meta(1)
        self._db = meta1 if meta1["txnid"] >= meta0["txnid"] else meta0

    def _read_meta(self, pageno: int) -> dict:
        off = pageno * self.psize
        _, _, flags, _, _ = _PAGE_HDR.unpack_from(self._m, off)
        if not flags & P_META:
            raise ValueError(f"page {pageno} is not a meta page (flags={flags:#x})")
        off += _PAGE_HDR.size
        magic, version, _, mapsize = _META.unpack_from(self._m, off)
        if magic != _MAGIC:
            raise ValueError(f"bad LMDB magic {magic:#x}")
        if version != _DATA_VERSION:
            raise ValueError(f"unsupported LMDB data version {version}")
        main = _DB.unpack_from(self._m, off + _META.size + _DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", self._m, off + _META.size + 2 * _DB.size)
        return {
            "depth": main[2], "entries": main[6], "root": main[7],
            "mapsize": mapsize, "last_pg": last_pg, "txnid": txnid,
        }

    # ------------------------------------------------------------- page access
    def _page(self, pgno: int) -> Tuple[int, int, List[int]]:
        """Returns (offset, flags, node offsets)."""
        off = pgno * self.psize
        _, _, flags, lower, _ = _PAGE_HDR.unpack_from(self._m, off)
        nkeys = (lower - _PAGE_HDR.size) >> 1
        ptrs = list(struct.unpack_from(f"<{nkeys}H", self._m, off + _PAGE_HDR.size))
        return off, flags, ptrs

    def _node(self, page_off: int, ptr: int) -> Tuple[int, int, bytes, int]:
        """Returns (lo|hi<<16, flags, key, data offset after key)."""
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(self._m, page_off + ptr)
        key_off = page_off + ptr + _NODE_HDR.size
        key = bytes(self._m[key_off: key_off + ksize])
        return lo | (hi << 16), flags, key, key_off + ksize

    def _leaf_value(self, size: int, nflags: int, data_off: int) -> bytes:
        if nflags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._m, data_off)
            start = ovpg * self.psize + _PAGE_HDR.size
            return bytes(self._m[start: start + size])
        return bytes(self._m[data_off: data_off + size])

    # ------------------------------------------------------------------ lookup
    def get(self, key: bytes) -> Optional[bytes]:
        if self._db["root"] == _P_INVALID:
            return None
        pgno = self._db["root"]
        while True:
            page_off, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                # child i covers keys >= key_i (key_0 = -inf); rightmost match wins
                child = None
                for i, ptr in enumerate(ptrs):
                    lohi, nflags, nkey, _ = self._node(page_off, ptr)
                    if i == 0 or nkey <= key:
                        child = lohi | ((nflags & 0xFFFF) << 32)
                    else:
                        break
                pgno = child
            elif flags & P_LEAF:
                for ptr in ptrs:
                    size, nflags, nkey, data_off = self._node(page_off, ptr)
                    if nkey == key:
                        return self._leaf_value(size, nflags, data_off)
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x} at pgno {pgno}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order scan of all (key, value) pairs."""
        if self._db["root"] == _P_INVALID:
            return
        stack = [self._db["root"]]
        while stack:
            pgno = stack.pop()
            page_off, flags, ptrs = self._page(pgno)
            if flags & P_BRANCH:
                children = []
                for ptr in ptrs:
                    lohi, nflags, _, _ = self._node(page_off, ptr)
                    children.append(lohi | ((nflags & 0xFFFF) << 32))
                stack.extend(reversed(children))
            else:
                for ptr in ptrs:
                    size, nflags, nkey, data_off = self._node(page_off, ptr)
                    yield nkey, self._leaf_value(size, nflags, data_off)

    def __len__(self):
        return self._db["entries"]

    def close(self):
        self._m.close()
        self._f.close()


# ----------------------------------------------------------------------- writer
def write_lmdb(
    dirpath: str,
    items: Dict[str, bytes],
    resolutions: Optional[Sequence[str]] = None,
    psize: int = 4096,
) -> None:
    """Create a minimal spec-conformant LMDB environment at ``dirpath``.

    Keys are sorted bytewise (LMDB's default comparator). Values larger than a
    quarter page go to overflow pages (F_BIGDATA). A meta_info.pkl with
    ``{'name', 'keys', 'resolution'}`` is written beside it, matching the
    reference's create-lmdb convention (codes/data/util.py:35-41 reads it).
    """
    os.makedirs(dirpath, exist_ok=True)
    encoded = {k.encode("ascii") if isinstance(k, str) else k: v for k, v in items.items()}
    keys = sorted(encoded)

    pages: List[bytes] = [b"", b""]  # meta pages filled last

    def _alloc(n: int) -> int:
        first = len(pages)
        pages.extend([None] * n)
        return first

    def _page_bytes(pgno, flags, nodes):
        """nodes: list of raw node byte strings, stored top-down; ptrs in order."""
        ptrs, blobs = [], []
        upper = psize
        for nb in nodes:
            size = len(nb) + (len(nb) & 1)  # even-align
            upper -= size
            ptrs.append(upper)
            blobs.append((upper, nb))
        lower = _PAGE_HDR.size + 2 * len(nodes)
        assert lower <= upper, "page overflow"
        buf = bytearray(psize)
        _PAGE_HDR.pack_into(buf, 0, pgno, 0, flags, lower, upper)
        struct.pack_into(f"<{len(ptrs)}H", buf, _PAGE_HDR.size, *ptrs)
        for off, nb in blobs:
            buf[off: off + len(nb)] = nb
        return bytes(buf)

    inline_max = psize // 4
    n_overflow = 0

    # ---- build leaf nodes (with overflow payloads) and pack into leaf pages
    def leaf_node(key: bytes, val: bytes) -> bytes:
        nonlocal n_overflow
        if len(val) > inline_max:
            npages = (len(val) + _PAGE_HDR.size + psize - 1) // psize
            first = _alloc(npages)
            blob = bytearray(npages * psize)
            _PAGE_HDR.pack_into(blob, 0, first, 0, P_OVERFLOW, 0, 0)
            struct.pack_into("<I", blob, 8, npages)  # pb_pages overlays lower/upper
            blob[_PAGE_HDR.size: _PAGE_HDR.size + len(val)] = val
            for i in range(npages):
                pages[first + i] = bytes(blob[i * psize: (i + 1) * psize])
            n_overflow += npages
            payload = struct.pack("<Q", first)
            flags = F_BIGDATA
        else:
            payload, flags = val, 0
        sz = len(val)
        return _NODE_HDR.pack(sz & 0xFFFF, sz >> 16, flags, len(key)) + key + payload

    leaf_pages: List[Tuple[int, bytes, List[bytes]]] = []  # (pgno, first_key, nodes)
    cur_nodes, cur_first, cur_used = [], None, 0
    budget = psize - _PAGE_HDR.size

    def flush_leaf():
        nonlocal cur_nodes, cur_first, cur_used
        if cur_nodes:
            pg = _alloc(1)
            leaf_pages.append((pg, cur_first, cur_nodes))
            cur_nodes, cur_first, cur_used = [], None, 0

    for k in keys:
        nb = leaf_node(k, encoded[k])
        need = len(nb) + (len(nb) & 1) + 2
        if cur_nodes and cur_used + need > budget:
            flush_leaf()
        if not cur_nodes:
            cur_first = k
        cur_nodes.append(nb)
        cur_used += need
    flush_leaf()

    for pg, _, nodes in leaf_pages:
        pages[pg] = _page_bytes(pg, P_LEAF, nodes)

    # ---- root: single leaf, or one branch page over the leaves
    n_branch = 0
    if not leaf_pages:
        root, depth = _P_INVALID, 0
    elif len(leaf_pages) == 1:
        root, depth = leaf_pages[0][0], 1
    else:
        root = _alloc(1)
        n_branch, depth = 1, 2
        bnodes = []
        for i, (pg, first_key, _) in enumerate(leaf_pages):
            key = b"" if i == 0 else first_key  # branch node 0: implicit -inf key
            bnodes.append(
                _NODE_HDR.pack(pg & 0xFFFF, (pg >> 16) & 0xFFFF, (pg >> 32) & 0xFFFF,
                               len(key)) + key
            )
        pages[root] = _page_bytes(root, P_BRANCH, bnodes)

    # ---- meta pages
    last_pg = len(pages) - 1
    mapsize = max(len(pages) * psize, 1 << 20)

    def meta_page(pgno: int, txnid: int) -> bytes:
        buf = bytearray(psize)
        _PAGE_HDR.pack_into(buf, 0, pgno, 0, P_META, 0, 0)
        off = _PAGE_HDR.size
        _META.pack_into(buf, off, _MAGIC, _DATA_VERSION, 0, mapsize)
        off += _META.size
        _DB.pack_into(buf, off, psize, 0, 0, 0, 0, 0, 0, _P_INVALID)  # FREE_DBI
        off += _DB.size
        _DB.pack_into(buf, off, 0, 0, depth, n_branch, len(leaf_pages), n_overflow,
                      len(keys), root)
        off += _DB.size
        struct.pack_into("<QQ", buf, off, last_pg, txnid)
        return bytes(buf)

    pages[0] = meta_page(0, 0)
    pages[1] = meta_page(1, 1)

    with open(os.path.join(dirpath, "data.mdb"), "wb") as f:
        for p in pages:
            f.write(p)
    with open(os.path.join(dirpath, "lock.mdb"), "wb") as f:
        f.write(b"\0" * 8)

    meta = {"name": os.path.basename(dirpath.rstrip("/")), "keys": [k.decode() for k in keys]}
    if resolutions is not None:
        meta["resolution"] = list(resolutions)
    with open(os.path.join(dirpath, "meta_info.pkl"), "wb") as f:
        pickle.dump(meta, f)


# ---------------------------------------------------------------------- facade
def paths_from_lmdb(dataroot: str) -> Tuple[List[str], List[str]]:
    """Returns (keys, resolutions 'C_H_W') from the meta_info.pkl beside the LMDB.
    A single resolution entry broadcasts to all keys (data/util.py:38-40)."""
    meta = os.path.join(dataroot, "meta_info.pkl")
    with open(meta, "rb") as f:
        info = pickle.load(f)
    sizes = info.get("resolution")
    if sizes and len(sizes) == 1:
        sizes = sizes * len(info["keys"])
    return info["keys"], sizes


class LmdbReader:
    """Flat-uint8-image reader over an LMDB env; real ``lmdb`` package when
    available, pure-Python parser otherwise."""

    def __init__(self, dataroot: str):
        try:
            import lmdb

            self.env = lmdb.open(
                dataroot, readonly=True, lock=False, readahead=False, meminit=False
            )
            self._pure = None
        except ImportError:
            self.env = None
            self._pure = PureLmdbReader(dataroot)

    def get(self, key: str) -> Optional[bytes]:
        if self.env is not None:
            with self.env.begin(write=False) as txn:
                return txn.get(key.encode("ascii"))
        return self._pure.get(key.encode("ascii"))

    def read(self, key: str, resolution: str) -> np.ndarray:
        """HWC uint8 image from the flat buffer at `key` ('C_H_W' resolution).
        Buffers follow the reference convention: cv2-written, i.e. BGR channel
        order (codes/data/util.py:66-69); callers convert at the cv2 boundary."""
        buf = self.get(key)
        if buf is None:
            raise KeyError(f"key {key!r} not found in LMDB")
        c, h, w = (int(s) for s in resolution.split("_"))
        return np.frombuffer(buf, dtype=np.uint8).reshape(h, w, c)
