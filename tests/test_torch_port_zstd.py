"""The port's zstd decoder (``hcflow_tpu_torch/csrc/zstd_decode.cpp`` through
``utils/zstd.py``) against libzstd on the CPU: frames that libzstd writes (loaded with
ctypes; the tests skip where it does not load) decode byte for byte to their source:

- levels -5, 1, 3 and 19, with a checksum and no content size, and (19 aside) with a
  content size and no checksum (and both, decoded into a buffer of the known size);
- sizes 0, 1, 128 KiB - 1, 128 KiB + 1 and 1 MiB of random, constant, repeated and
  float32 data, and of three kinds that take libzstd through the rest of the format
  (words: treeless Huffman tables and single-stream literals; 2-bit symbols: weights
  stored directly; sparse bytes: RLE offset tables and repeat offsets);
- a frame written here of RLE literals and RLE, then repeated, sequence tables;
- concatenated frames and a skippable frame between them;
- a checksum that does not match, a reserved bit, a dictionary and trailing bytes raise.

``frame_raw``'s frames decode in libzstd and, through a zarr array on an OCDBT store,
in tensorstore; the CRC-32C matches its published check value.
"""

import ctypes
import ctypes.util
import struct

import numpy as np
import pytest
import tensorstore as ts

from hcflow_tpu_torch.utils import ocdbt, orbax, zstd

SIZES = [0, 1, (128 << 10) - 1, (128 << 10) + 1, 1 << 20]
KINDS = ["random", "constant", "repeated", "float32", "words", "two_bit", "sparse"]
LEVELS = [-5, 1, 3, 19]
# ZSTD_cParameter values (zstd.h)
C_LEVEL, C_CONTENT_SIZE, C_CHECKSUM = 100, 200, 201


@pytest.fixture(scope="module")
def libzstd():
    try:
        lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    except OSError:
        pytest.skip("libzstd.so.1 does not load here")
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_char_p,
                                    ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    return lib


def _compress(lib, data: bytes, level: int, checksum: bool, content_size: bool) -> bytes:
    cctx = lib.ZSTD_createCCtx()
    try:
        for p, v in ((C_LEVEL, level), (C_CHECKSUM, int(checksum)),
                     (C_CONTENT_SIZE, int(content_size))):
            assert not lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, p, v))
        cap = lib.ZSTD_compressBound(len(data))
        buf = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, buf, cap, data, len(data))
        assert not lib.ZSTD_isError(n)
        return buf.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def _data(kind: str, n: int) -> bytes:
    rng = np.random.default_rng(n)
    if kind == "random":
        return rng.integers(0, 256, n, np.uint8).tobytes()
    if kind == "constant":
        return b"\x5a" * n
    if kind == "repeated":
        return (bytes(rng.integers(0, 256, 1000, np.uint8)) * (n // 1000 + 1))[:n]
    if kind == "float32":
        return rng.standard_normal(n // 4 + 1).astype(np.float32).tobytes()[:n]
    if kind == "words":
        vocab = [bytes(rng.integers(97, 123, int(rng.integers(2, 9)), np.uint8))
                 for _ in range(300)]
        return b" ".join(vocab[i] for i in rng.zipf(1.3, n // 3 + 1) % 300)[:n]
    if kind == "two_bit":
        return rng.integers(0, 4, n, np.uint8).tobytes()
    out = np.zeros(n, np.uint8)  # sparse
    at = rng.integers(0, max(n, 1), n // 50)
    out[at] = rng.integers(0, 256, len(at))
    return out.tobytes()


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("kind", KINDS)
def test_libzstd_frames_decode_byte_for_byte(libzstd, kind, n):
    data = _data(kind, n)
    for level in LEVELS:
        # level 19 takes ~1 s a MiB to compress: one frame, with the checksum
        variants = ((True, False),) if level == 19 else ((False, True), (True, False))
        for checksum, content_size in variants:
            frame = _compress(libzstd, data, level, checksum, content_size)
            assert zstd.decompress(frame) == data, (level, checksum, content_size)
    out = np.empty(n, np.uint8)
    zstd.decompress_into(_compress(libzstd, data, 3, True, True), out)
    assert out.tobytes() == data


def test_rle_literals_and_repeated_sequence_tables(libzstd):
    """Three blocks: 'a' and one sequence (offset 1, length 4) under RLE tables; 'b'
    and the same sequence under the repeated tables; 'ccc' as RLE literals."""
    def block(body, last=False):
        return ((len(body) << 3) | (2 << 1) | int(last)).to_bytes(3, "little") + body
    # raw literal; 1 sequence; LL, OF, ML RLE (codes 1, 2, 1); bitstream: the offset's
    # 2 extra bits (0: offset value 4, offset 1) under the end mark
    b1 = bytes([1 << 3]) + b"a" + bytes([1, 0x54, 1, 2, 1, 0x04])
    b2 = bytes([1 << 3]) + b"b" + bytes([1, 0xFC, 0x04])  # every table repeated
    b3 = bytes([(3 << 3) | 1]) + b"c" + bytes([0])  # RLE literals, no sequence
    frame = zstd.MAGIC + bytes([0x20, 13]) + block(b1) + block(b2) + block(b3, True)
    assert zstd.decompress(frame) == b"aaaaabbbbbccc"
    out = ctypes.create_string_buffer(13)
    assert libzstd.ZSTD_decompress(out, 13, frame, len(frame)) == 13 and out.raw == b"aaaaabbbbbccc"
    with pytest.raises(ValueError, match="repeated literal length table with no earlier"):
        zstd.decompress(zstd.MAGIC + bytes([0x20, 5]) + block(b2, True))


def test_concatenated_and_skippable_frames(libzstd):
    parts = [_data("float32", 70000), _data("repeated", 5000), b"", _data("random", 300)]
    frames = [_compress(libzstd, p, lv, True, lv != 3) for p, lv in zip(parts, (1, 3, 19, -5))]
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    stream = frames[0] + skip + b"".join(frames[1:]) + skip
    assert zstd.decompress(stream) == b"".join(parts)
    with pytest.raises(ValueError, match="the output is larger"):
        zstd.decompress_into(stream, np.empty(100, np.uint8))


def test_bad_frames_raise(libzstd):
    data = _data("float32", 40000)
    frame = bytearray(_compress(libzstd, data, 3, True, True))
    frame[-1] ^= 0xFF  # the checksum
    with pytest.raises(ValueError, match="content checksum"):
        zstd.decompress(bytes(frame))
    frame = bytearray(_compress(libzstd, data, 3, False, True))
    frame[4] |= 8  # the frame header's reserved bit
    with pytest.raises(ValueError, match="reserved bit"):
        zstd.decompress(bytes(frame))
    frame[4] = (frame[4] & ~8) | 1  # a 1-byte dictionary ID, after the window descriptor
    at = 5 if frame[4] & 0x20 else 6
    frame[at:at] = b"\x07"
    with pytest.raises(ValueError, match="dictionary 7"):
        zstd.decompress(bytes(frame))
    good = _compress(libzstd, data, 3, False, True)
    with pytest.raises(ValueError, match="trailing bytes"):
        zstd.decompress(good + b"\x00\x01")
    with pytest.raises(ValueError, match="magic"):
        zstd.decompress(good + b"\x00\x01\x02\x03\x04")
    for cut in (len(good) // 2, len(good) - 1):
        with pytest.raises(ValueError, match="zstd"):
            zstd.decompress(good[:cut])


@pytest.mark.parametrize("n", SIZES)
def test_frame_raw_decodes_in_libzstd(libzstd, n):
    data = _data("float32", n)
    frame = zstd.frame_raw(data)
    assert zstd.decompress(frame) == data
    out = ctypes.create_string_buffer(max(n, 1))
    got = libzstd.ZSTD_decompress(out, max(n, 1), frame, len(frame))
    assert not libzstd.ZSTD_isError(got) and out.raw[:got] == data


def test_tensorstore_reads_frame_raw_frames(tmp_path):
    x = np.random.default_rng(7).standard_normal((300, 257)).astype(np.float32)  # 2.4 blocks
    ocdbt.write(str(tmp_path), orbax.array_values("a.b", x))
    spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                                          "path": "a.b/"}}
    assert ts.open(spec).result().read().result().tobytes() == x.tobytes()


def test_crc32c_check_value():
    assert zstd.crc32c(b"123456789") == 0xE3069283  # CRC-32C's check value
    assert zstd.crc32c(b"") == 0
    assert zstd.crc32c(bytearray(b"a" * 100)) == zstd.crc32c(b"a" * 100)
