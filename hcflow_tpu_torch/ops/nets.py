"""Non-invertible sub-networks: conv+ActNorm, Conv2dZeros, FCN, DenseBlock and the
RRDB encoder; the ``calib_*`` functions are the data-dependent ActNorm inits of the
nets' own ActNorms.

Functions take NHWC tensors and OIHW weights (PyTorch's conv layout); each conv runs
as ``F.conv2d`` on an NCHW view of the NHWC tensor, which is channels-last memory.
Under a spatial mesh (``mesh``, None by default) a conv and an RRDB run on this rank's
band of rows plus the halo they read (``parallel/halo.py``, :func:`halo_rows`), under
autograd too (the exchange's backward returns the halo's gradient to its owner); a net
given a mesh exchanges one row each side before each of its 3x3 convs.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..parallel import halo
from ..utils import profiling
from . import actnorm

_DTYPES = {"bfloat16": torch.bfloat16}  # compute_dtype None is the float32 recipe


def net_dtype(compute_dtype) -> torch.dtype:
    return torch.float32 if compute_dtype is None else _DTYPES[compute_dtype]


def tf32_flags() -> tuple:
    """(cuDNN's, the matrix products') TF32 flags, global to the process."""
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@contextlib.contextmanager
def tf32(flags):
    """Run with the TF32 flags set to ``flags`` (as :func:`tf32_flags` gives them)."""
    prev = tf32_flags()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def exact_f32():
    """Run float32 convolutions and matrix products in full float32.

    cuDNN computes float32 convolutions in TF32 by default (about three decimal
    digits), and a caller may have allowed TF32 matrix products; the invertible
    path and the plain kernel versions must use neither.
    """
    return tf32((False, False))


def halo_rows(params) -> int:
    """Rows of halo each side that a net of convs in sequence reads around an output
    row: the sum of its conv weights' radii (an FCN's 3x3, 1x1 and 3x3: 2; a
    DenseBlock's or an RDB's five 3x3: 5; an RRDB's fifteen: 15; a flow step: its
    coupling's nets).  ``params``: a nested dict/list holding OIHW weights."""
    if isinstance(params, dict):
        return sum(halo_rows(v) for v in params.values())
    if isinstance(params, list):
        return sum(halo_rows(v) for v in params)
    return (params.shape[2] - 1) // 2 if params.ndim == 4 else 0


def conv2d(x, w, b=None, compute_dtype=None, mesh=None) -> torch.Tensor:
    """'same'-padded stride-1 conv, NHWC x OIHW -> NHWC float32.

    compute_dtype=None: full float32.  compute_dtype='bfloat16': bf16 operands, the
    output rounded through bf16 and upcast, as hcflow_tpu/ops/nets.py:48-55 writes it;
    the operands' casts and the output's upcast each run in a span ``hcflow.cast``, and
    the conv between them in its caller's span.
    ``mesh``: on this rank's band plus the rows of halo the kernel reads.
    """
    pad = (w.shape[2] - 1) // 2
    if halo.sharded(mesh):
        return halo.banded(lambda t: conv2d(t, w, b, compute_dtype), x, pad, mesh, "conv")
    xc = x.permute(0, 3, 1, 2)
    if compute_dtype is not None:
        dt = _DTYPES[compute_dtype]
        with profiling.span("hcflow.cast"):
            xb, wb = xc.to(dt), w.to(dt)
        y = F.conv2d(xb, wb, padding=pad)
        with profiling.span("hcflow.cast"):
            y = y.float()
    else:
        with exact_f32():
            y = F.conv2d(xc.float(), w, padding=pad)
    y = y.permute(0, 2, 3, 1)
    if b is not None:
        y = y + b
    return y


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def conv_taps(x, w_tap, b=None) -> torch.Tensor:
    """3x3 'same' conv from a kernel's packed weight: x NHWC, w_tap (9, cin, cout)
    ``[3 ky + kx][ci][co]`` -> NHWC, in x's dtype (the plain kernel versions call it
    on float32 under :func:`exact_f32`)."""
    w = w_tap.to(x.dtype).reshape(3, 3, *w_tap.shape[1:]).permute(3, 2, 0, 1)
    return F.conv2d(x.permute(0, 3, 1, 2), w, b, padding=1).permute(0, 2, 3, 1)


def pack_taps(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An OIHW 3x3 conv weight as the tile-conv kernels' pack (csrc/conv3x3.cuh) in
    ``dtype``: bf16 as (9, cin, cout) ``[tap][ci][co]``, which the bf16 kernels read;
    float32 K-major, (9, cout, cin) ``[tap][co][ci]``, which the plain versions read (the
    float32 kernels read its TF32 planes, :func:`pack_tf32`) (tap = 3 * ky + kx)."""
    cout, cin = w.shape[:2]
    if dtype == torch.float32:
        return w.permute(2, 3, 0, 1).reshape(9, cout, cin).float().contiguous()
    return w.permute(2, 3, 1, 0).reshape(9, cin, cout).to(dtype).contiguous()


def pack_tf32(w: torch.Tensor) -> torch.Tensor:
    """An OIHW 3x3 conv weight (cin a multiple of 4) split once into the two TF32 planes
    that the float32 tile conv's 3xTF32 products read as B (csrc/conv3x3.cuh): hi =
    rna(w), lo = rna(w - hi), rna rounding to TF32 to nearest with ties away from zero
    (``cvt.rna.tf32.f32``) and clearing the low 13 bits; w - hi is exact, and hi + lo
    lies within 2^-21 of w relative.  Laid out as wgmma's K-major core matrices of 8
    outputs x 4 inputs (16-byte rows), which the kernels copy unchanged: ``(2, 9, cin //
    4, cout, 4)`` float32 ``[hi, lo][tap][ci // 4][co][ci % 4]``."""
    cout, cin = w.shape[:2]
    t = w.detach().float().permute(2, 3, 1, 0).reshape(9, cin // 4, 4, cout).transpose(2, 3)

    def rna(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    hi = rna(t)
    return torch.stack([hi, rna(t - hi)])


def pack_dtype(ws, kernel: str) -> torch.dtype:
    """The one dtype of a tile-conv kernel's packed weights ``ws``, bf16 or float32;
    raises a ValueError on anything else (the kernels take one recipe a call)."""
    dts = {w.dtype for w in ws}
    if len(dts) != 1 or not dts <= {torch.bfloat16, torch.float32}:
        raise ValueError(f"the {kernel} kernel takes bf16 or float32 packed weights, all of one "
                         f"dtype, not {sorted(map(str, dts))}")
    return dts.pop()


def pad_width(n: int, widths: tuple) -> int:
    """n rounded up to the least of a kernel's ``widths`` (ascending) that holds it;
    n itself past the widest."""
    return next((w for w in widths if w >= n), n)


def pad_dense_conv(w: torch.Tensor, b: torch.Tensor, ins, ins_to, cout_to: int) -> tuple:
    """An OIHW conv weight over a concat of input segments of widths ``ins``, and its
    bias, with each segment zero-padded to its width in ``ins_to`` and the outputs to
    ``cout_to``: zero weights on the padded inputs, zero weights and biases on the
    padded outputs.  Where every padded input is 0, so is every padded output before an
    activation with act(0) = 0, and the real outputs gain only exact zero terms."""
    ins, ins_to = list(ins), list(ins_to)
    pad_out = cout_to - w.shape[0]
    if ins == ins_to and pad_out == 0:
        return w, b
    w = torch.cat([F.pad(p, (0, 0, 0, 0, 0, t - n))
                   for p, n, t in zip(w.split(ins, 1), ins, ins_to)], 1)
    return F.pad(w, (0, 0, 0, 0, 0, 0, 0, pad_out)), F.pad(b, (0, pad_out))


def taps(w: torch.Tensor) -> torch.Tensor:
    """A packed tile-conv weight (:func:`pack_taps`; leading axes allowed) as ``(...,
    9, cin, cout)`` ``[tap][ci][co]``, a view."""
    return w.transpose(-1, -2) if w.dtype == torch.float32 else w


def taps_shape(w: torch.Tensor) -> tuple:
    """``taps(w).shape`` as a tuple, without making the view (the kernel wrappers check
    every packed weight on every call)."""
    s = tuple(w.shape)
    return s[:-2] + (s[-1], s[-2]) if w.dtype == torch.float32 else s


# ---------------------------------------------------------------------------- inits
def _fans(shape):  # OIHW
    o, i, kh, kw = shape
    return i * kh * kw, o * kh * kw


def xavier_normal(generator, shape, scale=1.0):
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return torch.randn(shape, generator=generator) * (std * scale)


def torch_default_conv(generator, shape):
    """PyTorch's default Conv2d init: U(+-1/sqrt(fan_in)) for weight and bias."""
    fan_in, _ = _fans(shape)
    bound = 1.0 / math.sqrt(fan_in)
    w = (torch.rand(shape, generator=generator) * 2 - 1) * bound
    b = (torch.rand(shape[0], generator=generator) * 2 - 1) * bound
    return w, b


# ------------------------------------------------------------------- Conv + ActNorm
def init_conv_actnorm(generator, cin, cout, ksize, scale=0.1):
    """Bias-free conv (xavier init) followed by ActNorm."""
    return {
        "w": xavier_normal(generator, (cout, cin, ksize, ksize), scale),
        "actnorm": actnorm.init(cout),
    }


def apply_conv_actnorm(params, x, compute_dtype=None, mesh=None):
    y = conv2d(x, params["w"], compute_dtype=compute_dtype, mesh=mesh)
    return actnorm.forward(params["actnorm"], y)[0]


def calib_conv_actnorm(params, x):
    """The ActNorm's data-dependent init on the float32 conv of x; returns (params,
    output)."""
    y = conv2d(x, params["w"])
    an = actnorm.calibrate(y)
    return {"w": params["w"], "actnorm": an}, actnorm.forward(an, y)[0]


# ----------------------------------------------------------------------- Conv2dZeros
def init_conv_zeros(cin, cout, ksize=3):
    return {
        "w": torch.zeros(cout, cin, ksize, ksize),
        "b": torch.zeros(cout),
        "logs": torch.zeros(cout),
    }


def apply_conv_zeros(params, x, logscale_factor: float = 3.0, mesh=None):
    """Always float32: its output feeds the invertible arithmetic."""
    y = conv2d(x, params["w"], params["b"], mesh=mesh)
    return y * torch.exp(params["logs"] * logscale_factor)


# ------------------------------------------------------------------------------ FCN
def init_fcn(generator, cin, cout, hidden, kernel_hidden=1):
    return {
        "conv1": init_conv_actnorm(generator, cin, hidden, 3),
        "conv2": init_conv_actnorm(generator, hidden, hidden, kernel_hidden),
        "conv3": init_conv_zeros(hidden, cout, 3),
    }


def apply_fcn(params, x, compute_dtype=None, mesh=None):
    x = torch.relu(apply_conv_actnorm(params["conv1"], x, compute_dtype, mesh))
    x = torch.relu(apply_conv_actnorm(params["conv2"], x, compute_dtype, mesh))
    return apply_conv_zeros(params["conv3"], x, mesh=mesh)


def calib_fcn(params, x):
    """conv1's and conv2's ActNorm inits, in order; returns (params, output)."""
    p1, x = calib_conv_actnorm(params["conv1"], x)
    p2, x = calib_conv_actnorm(params["conv2"], torch.relu(x))
    return {"conv1": p1, "conv2": p2, "conv3": params["conv3"]}, apply_conv_zeros(
        params["conv3"], torch.relu(x))


def apply_fcn_hoisted(params, z1, u_contrib, compute_dtype=None, mesh=None):
    """FCN whose conv1 contribution from the cond channels is precomputed.

    conv1 is linear and bias-free, so conv1(cat(z1, u)) = conv1_z(z1) + conv1_u(u).
    """
    w_z = params["conv1"]["w"][:, : z1.shape[-1]]
    h = conv2d(z1, w_z, compute_dtype=compute_dtype, mesh=mesh) + u_contrib
    h = torch.relu(actnorm.forward(params["conv1"]["actnorm"], h)[0])
    h = torch.relu(apply_conv_actnorm(params["conv2"], h, compute_dtype, mesh))
    return apply_conv_zeros(params["conv3"], h, mesh=mesh)


# ----------------------------------------------------------------------- DenseBlock
def init_dense_block(generator, cin, cout, gc=32):
    """5-conv dense block, xavier(0.1) convs; conv5 zero-init so the coupling starts
    as the identity."""
    p = {}
    for i in range(4):
        p[f"conv{i + 1}"] = {
            "w": xavier_normal(generator, (gc, cin + i * gc, 3, 3), 0.1),
            "b": torch.zeros(gc),
        }
    p["conv5"] = {"w": torch.zeros(cout, cin + 4 * gc, 3, 3), "b": torch.zeros(cout)}
    return p


def apply_dense_block(params, x, compute_dtype=None, mesh=None):
    """``x_i = lrelu(conv_i(cat(x, x_1..x_{i-1})))`` for i = 1..4, then conv5 over all."""
    feats = [x]
    for i in range(1, 5):
        c = params[f"conv{i}"]
        feats.append(lrelu(conv2d(torch.cat(feats, -1), c["w"], c["b"], compute_dtype, mesh)))
    c = params["conv5"]
    return conv2d(torch.cat(feats, -1), c["w"], c["b"], compute_dtype, mesh)


# --------------------------------------------------------------- RDB / RRDB encoder
def init_rdb(generator, nf=64, gc=32):
    """ResidualDenseBlock: xavier(0.1) convs, out = conv_stack(x) * 0.2 + x."""
    p = {}
    for i in range(5):
        cin, cout = nf + i * gc, (gc if i < 4 else nf)
        p[f"conv{i + 1}"] = {
            "w": xavier_normal(generator, (cout, cin, 3, 3), 0.1),
            "b": torch.zeros(cout),
        }
    return p


def apply_rdb(params, x, compute_dtype=None):
    feats = [x]
    for i in range(1, 5):
        c = params[f"conv{i}"]
        feats.append(lrelu(conv2d(torch.cat(feats, -1), c["w"], c["b"], compute_dtype)))
    c = params["conv5"]
    return conv2d(torch.cat(feats, -1), c["w"], c["b"], compute_dtype) * 0.2 + x


def init_rrdb(generator, nf=64, gc=32):
    return {f"rdb{i}": init_rdb(generator, nf, gc) for i in (1, 2, 3)}


def apply_rrdb(params, x, compute_dtype=None):
    out = x
    for i in (1, 2, 3):
        out = apply_rdb(params[f"rdb{i}"], out, compute_dtype)
    return out * 0.2 + x


def init_rrdb_trunk(generator, nb, nf=64, gc=32):
    """A trunk is a list of ``nb`` RRDB parameter dicts."""
    return [init_rrdb(generator, nf, gc) for _ in range(nb)]


def apply_rrdb_trunk(params, x, compute_dtype=None, remat: bool = False, mesh=None):
    """The trunk's RRDBs in order.  ``remat`` (with grad enabled): each RRDB's
    activations are recomputed in the backward pass instead of kept, so only the
    RRDBs' inputs stay (``torch.utils.checkpoint``, as the JAX package's
    ``jax.checkpoint`` of the scan body).  ``mesh``: each RRDB on this rank's band plus
    its halo, as the RRDB kernel runs (ops/rrdb.py); under ``remat`` the RRDB on the
    extended band is recomputed, the exchange is not."""

    def rrdb(p, t):
        if remat and torch.is_grad_enabled():
            return checkpoint(apply_rrdb, p, t, compute_dtype, use_reentrant=False)
        return apply_rrdb(p, t, compute_dtype)

    for p in params:
        x = halo.banded(lambda t, p=p: rrdb(p, t), x, halo_rows(p), mesh, "rrdb")
    return x
