"""Build the CUDA kernels and the host libraries under ``csrc/`` and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles with nvcc, on first
use, into ``build/lib<name>-<hash>.so`` inside this package (a directory git ignores),
keyed by the content of the source and of the shared headers ``csrc/*.cuh``, so that an
edited source is rebuilt.  A ``csrc/<name>.cpp`` is host code (the zstd decoder that
reads orbax checkpoints) and compiles the same way with the system C++ compiler, which
the CPU tests have too.  Each build writes a temporary name and renames it into place,
so processes that build at once do not race.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
KERNELS = ("rrdb", "rrdb_trunk", "chain", "chain3s", "conv")
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
HOST_LIBS = ("zstd_decode",)

_loaded: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build where the CUDA toolkit is")
    return path


def _cxx() -> str:
    path = shutil.which("c++") or shutil.which("g++")
    if path is None:
        raise RuntimeError("no C++ compiler (c++ or g++) found: the host libraries build with it")
    return path


def source(name: str) -> Path:
    return SRC_DIR / (f"{name}.cpp" if name in HOST_LIBS else f"{name}.cu")


def _command(name: str) -> list:
    if name in HOST_LIBS:
        return [_cxx(), *HOST_FLAGS]
    return [_nvcc(), *NVCC_FLAGS]


def library(name: str) -> Path:
    if name in HOST_LIBS:
        text, flags = source(name).read_bytes(), HOST_FLAGS
    else:
        headers = b"".join(h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
        text, flags = source(name).read_bytes() + headers, NVCC_FLAGS
    digest = hashlib.sha1(text + " ".join(flags).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every missing library in parallel (one compiler per source).

    Returns {name: compiler output} for what was compiled (for a kernel, ptxas's
    register and shared-memory report); raises RuntimeError if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        lib = library(name)
        if lib.exists():
            continue
        tmp = lib.with_suffix(f".tmp{os.getpid()}")
        cmd = [*_command(name), "-o", str(tmp), str(source(name))]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, lib)
    logs, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{logs[name]}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("build failed: " + "\n".join(failed))
    return logs


def cdll(name: str) -> ctypes.CDLL:
    """Build ``name`` if needed and load it (once a process)."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library(name)))
        _loaded[name] = lib
    return lib


def load(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """Build if needed, load, and declare ``fn`` (returning a cudaError_t as int)."""
    lib = cdll(name)
    lib.hcflow_error_string.argtypes = [ctypes.c_int]
    lib.hcflow_error_string.restype = ctypes.c_char_p
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int
    return lib


def check(lib: ctypes.CDLL, fn: str, err: int) -> None:
    if err != 0:
        msg = lib.hcflow_error_string(err).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {err} ({msg})")


def refuse_grad(kernel: str, *trees) -> None:
    """Raise a ValueError if autograd would need a backward pass through ``kernel``.

    No kernel of the port has one, so a kernel never runs on an input that requires
    grad while grad mode is on (on the card or, for the same rule everywhere, in its
    plain version on the CPU): training runs the plain step-by-step path, on params that
    carry no packs, as the JAX package's rule at flow/flownet.py:308 has it.  Nothing is
    detached silently.
    """
    if not torch.is_grad_enabled():
        return
    stack = list(trees)
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.requires_grad:
            raise ValueError(f"the {kernel} kernel has no backward pass: call it under "
                             "torch.no_grad(), or train on params without packed weights")
