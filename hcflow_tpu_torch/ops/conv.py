"""3x3 'same' convolution: the CUDA kernel ``csrc/conv.cu`` and its plain version.

Replaces ``hcflow_tpu/ops/pallas_conv.py`` (``conv3x3_pallas`` / ``_conv3x3_kernel``),
with its signature and layout: x NHWC of any channel count C, w HWIO (3, 3, C, N),
an optional bias (N,), an optional fused leaky ReLU of slope ``alpha``; the operands
are cast to bf16 and the output is float32.  The JAX package keeps it off every
path, as a tested building block (its library convs already ran near the TPU's
lane-limited roofline); so does the port, whose library convs run in ``nets.py``.

Bound on the card: bytes at the model's shapes, narrowly (float32 in and out, 144-231
FLOP per byte at C 64-262 and N 64, under the ~295 FLOP/byte ridge).  The kernel
packs, in one launch, the weights in bf16 chunks of at most 64 output channels (N
padded to a multiple of 16), then runs the wgmma tile conv the dense-block kernels
share (``csrc/conv3x3.cuh``) once per chunk, reading float32 x and rounding it to
bf16 as it stages it; the epilogue adds the bias and the leaky ReLU in float32.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import nets

launches = 0  # CUDA kernel launches made by conv3x3 (1 weight pack + 1 per 64 outputs)
CHUNK = 64  # output channels per conv launch (the tile conv's widest)

_FN = "hcflow_conv3x3"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def _round16(n: int) -> int:
    return (n + 15) // 16 * 16


def conv3x3_plain(x, w, b=None, relu: bool = False, alpha: float = 0.2) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch: the float32 conv (no TF32) of the
    bf16-rounded operands, then the bias and the leaky ReLU in float32."""
    C, N = w.shape[2:]
    xb = x.to(torch.bfloat16).float()
    wb = w.to(torch.bfloat16).float().reshape(9, C, N)
    with nets.exact_f32():
        y = nets.conv_taps(xb, wb, None if b is None else b.float())
    return torch.where(y >= 0, y, alpha * y) if relu else y


def conv3x3(x, w, b=None, relu: bool = False, alpha: float = 0.2) -> torch.Tensor:
    """'same'-padded 3x3 conv on NHWC x with HWIO w (3, 3, C, N); optional bias (N,)
    and fused leaky ReLU.  Operands in bf16, output float32 (B, H, W, N).  A CPU
    tensor takes the plain version; a CUDA tensor the kernel, or it raises."""
    if not x.is_cuda:
        return conv3x3_plain(x, w, b, relu, alpha)
    global launches
    B, H, W, C = x.shape
    if w.ndim != 4 or tuple(w.shape[:3]) != (3, 3, C):
        raise ValueError(f"w must be (3, 3, {C}, N), got {tuple(w.shape)}")
    N = w.shape[3]
    if b is not None and tuple(b.shape) != (N,):
        raise ValueError(f"b must be ({N},), got {tuple(b.shape)}")
    if not w.is_cuda or (b is not None and not b.is_cuda):
        raise ValueError("conv3x3 weights must be CUDA tensors, as x is")
    cp, np_ = _round16(C), _round16(N)
    x, w = x.float().contiguous(), w.float().contiguous()
    if x.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x = x.clone()
    bias = None if b is None else b.float().contiguous()
    # scratch: the bf16 weights in chunks of at most 64 outputs, packed by the kernel
    wpack = torch.empty(9 * cp * np_, dtype=torch.bfloat16, device=x.device)
    out = torch.empty((B, H, W, N), dtype=torch.float32, device=x.device)
    lib = _build.load("conv", _FN, _ARGTYPES)
    err = lib.hcflow_conv3x3(
        x.data_ptr(), w.data_ptr(), wpack.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), B, H, W, C, N, int(relu),
        alpha, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(lib, _FN, err)
    launches += 1 + -(-np_ // CHUNK)
    return out
