"""zstd frames and CRC-32C for the orbax checkpoint backend, without a zstd package.

Reading uses the decoder in ``csrc/zstd_decode.cpp`` (RFC 8878, written for this
package; built on first use by ``_build`` with the system C++ compiler and loaded with
ctypes).  Writing makes frames of raw (stored) blocks: valid zstd that every decoder,
tensorstore's among them, reads.  On the float arrays of a checkpoint zstd's level 1
saves only ~7%, so the writer does not compress.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from .. import _build

MAGIC = b"\x28\xb5\x2f\xfd"
BLOCK = 128 * 1024  # a block's largest size
# Frame header descriptor: an 8-byte content size (flag 3), a window descriptor, no
# checksum, no dictionary.  Window descriptor: 2^(10 + 7) bytes = one block.
_HEADER = MAGIC + bytes([0xC0, 7 << 3])

_PTR = ctypes.POINTER(ctypes.c_void_p)


def _lib() -> ctypes.CDLL:
    lib = _build.cdll("zstd_decode")
    if not hasattr(lib, "_declared"):
        lib.hcflow_zstd_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t), _PTR, _PTR, ctypes.c_char_p, ctypes.c_size_t]
        lib.hcflow_zstd_decompress.restype = ctypes.c_int
        lib.hcflow_zstd_release.argtypes = [ctypes.c_void_p]
        lib.hcflow_zstd_release.restype = None
        lib.hcflow_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.hcflow_crc32c.restype = ctypes.c_uint32
        lib._declared = True
    return lib


def _bytes(data) -> bytes:
    return data if isinstance(data, bytes) else bytes(data)


def _call(data: bytes, dst, cap: int):
    size, handle, ptr = ctypes.c_size_t(), ctypes.c_void_p(), ctypes.c_void_p()
    err = ctypes.create_string_buffer(256)
    lib = _lib()
    rc = lib.hcflow_zstd_decompress(data, len(data), dst, cap, ctypes.byref(size),
                                    ctypes.byref(handle), ctypes.byref(ptr), err, len(err))
    if rc != 0:
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    return lib, size.value, handle, ptr


def decompress(data) -> bytes:
    """Every frame of ``data`` decoded (skippable frames skipped); raises ValueError on
    a corrupt, truncated or unsupported frame and on a content checksum that fails."""
    lib, size, handle, ptr = _call(_bytes(data), None, 0)
    try:
        return ctypes.string_at(ptr, size) if size else b""
    finally:
        lib.hcflow_zstd_release(handle)


def decompress_into(data, out: np.ndarray) -> None:
    """Decode ``data`` into the C-contiguous array ``out``, which it must fill exactly."""
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("decompress_into needs a writable C-contiguous array")
    _, size, _, _ = _call(_bytes(data), out.ctypes.data, out.nbytes)
    if size != out.nbytes:
        raise ValueError(f"zstd: a frame of {size} bytes where {out.nbytes} were expected")


def frame_raw(data) -> bytes:
    """One zstd frame holding ``data`` in raw blocks of at most 128 KiB, with its
    content size in the header."""
    view = memoryview(data).cast("B")
    n = len(view)
    parts = [_HEADER, struct.pack("<Q", n)]
    start = 0
    while True:
        size = min(BLOCK, n - start)
        last = start + size >= n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))  # block type 0: raw
        parts.append(view[start:start + size])
        start += size
        if last:
            return b"".join(parts)


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``, as OCDBT's file footers hold it."""
    data = _bytes(data)
    return _lib().hcflow_crc32c(data, len(data))
