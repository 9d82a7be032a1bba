"""Decode rate of the port's zstd decoder (hcflow_tpu_torch/csrc/zstd_decode.cpp) on
this host's CPU, on the frame an orbax checkpoint holds for a 2048 x 4096 float32
array (33.5 MB; tensorstore writes it at zstd level 1 with no content size: here
libzstd does, loaded with ctypes).

    python3 tools/zstd_rate.py [--reps 5]

Prints the CPU's model, the frame's size and the MB/s (decoded bytes) of each
decode into a preallocated array (what the checkpoint reader does) and into a new
buffer (``zstd.decompress``).  It times the host, not the card.
"""

from __future__ import annotations

import argparse
import ctypes
import ctypes.util
import json
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hcflow_tpu_torch.utils import zstd  # noqa: E402

C_LEVEL, C_CONTENT_SIZE = 100, 200  # ZSTD_cParameter values (zstd.h)


def _cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def _compress(data: bytes, level: int) -> bytes:
    lib = ctypes.CDLL(ctypes.util.find_library("zstd") or "libzstd.so.1")
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.ZSTD_CCtx_setParameter.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                                   ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    cctx = lib.ZSTD_createCCtx()
    try:
        for p, v in ((C_LEVEL, level), (C_CONTENT_SIZE, 0)):
            if lib.ZSTD_isError(lib.ZSTD_CCtx_setParameter(cctx, p, v)):
                raise RuntimeError(f"ZSTD_CCtx_setParameter({p}, {v}) failed")
        cap = lib.ZSTD_compressBound(len(data))
        buf = ctypes.create_string_buffer(cap)
        n = lib.ZSTD_compress2(cctx, buf, cap, data, len(data))
        if lib.ZSTD_isError(n):
            raise RuntimeError("ZSTD_compress2 failed")
        return buf.raw[:n]
    finally:
        lib.ZSTD_freeCCtx(cctx)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    x = np.random.default_rng(0).standard_normal((2048, 4096)).astype(np.float32)
    frame = _compress(x.tobytes(), 1)
    out = np.empty_like(x)
    zstd.decompress_into(frame, out)  # builds the decoder on first use
    if out.tobytes() != x.tobytes():
        raise AssertionError("the decoded array differs from the source")
    into, fresh = [], []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        zstd.decompress_into(frame, out)
        into.append(x.nbytes / (time.perf_counter() - t0) / 1e6)
        t0 = time.perf_counter()
        zstd.decompress(frame)
        fresh.append(x.nbytes / (time.perf_counter() - t0) / 1e6)
    res = {"cpu": _cpu(), "threads": 1, "frame_bytes": len(frame), "decoded_bytes": x.nbytes,
           "into_mb_s": into, "decompress_mb_s": fresh}
    print(f"host CPU {res['cpu']} (one thread): a {len(frame)}-byte frame of {x.nbytes} bytes; "
          f"MB/s into an array {', '.join(f'{r:.1f}' for r in into)}; into a new buffer "
          f"{', '.join(f'{r:.1f}' for r in fresh)}")
    print(json.dumps(res))


if __name__ == "__main__":
    main()
