"""Operations and bytes that a call must do and move, counted from shapes, and the
card's peaks that the per-layer shares are read against.

``rrdb_work``, ``trunk_work``, ``chain_work`` and ``chain3s_work`` are copies of the
functions of the same names in ``chip_smoke.py`` (the kernel table's arithmetic), kept
here so that a change to the program cannot move the yardstick.  Every count is of the
arithmetic the algorithm needs at the call's real (unpadded) widths: an input read
once, an output written once, the weights read once.  ``model_flops`` is the whole
serving pass, every convolution and 1x1 product of every level, from the option
file's topology (:class:`reference.hcflow.Topology`).

Float32 operations are charged at the card's TF32 tensor-core peak, which bounds every
float32 implementation (a 3xTF32 product runs three TF32 products for one float32
one, so it cannot pass a third of that peak); bytes at the HBM3 peak.  Published
dense rates of one H100 SXM (NVIDIA's data sheet) at its 700 W limit.
"""

from __future__ import annotations

PEAK_TF32 = 495e12  # FLOP/s, dense TF32 tensor-core peak: bounds any float32 product
PEAK_BYTES = 3.35e12  # HBM3 bytes/s


def rrdb_work(B, H, W, nf, gc, es=4):
    """(FLOP, bytes) of one RRDB: the input read once, the output written once, the
    weights (es bytes each) and float32 biases read once."""
    px = B * H * W
    macs = sum(9 * (nf + i * gc) * (gc if i < 4 else nf) for i in range(5))  # a block
    weights, biases = 3 * macs, 3 * (4 * gc + nf)  # one weight per MAC of a pixel
    return 2 * 3 * macs * px, 2 * px * nf * 4 + es * weights + 4 * biases


def trunk_work(B, H, W, nf, gc, nb, es=4):
    """(FLOP, bytes) of a trunk of nb RRDBs: the input read once, the output written
    once, every RRDB's weights and biases read once."""
    flops, nbytes = rrdb_work(B, H, W, nf, gc, es)
    io = 2 * B * H * W * nf * 4
    return nb * flops, io + nb * (nbytes - io)


def chain_work(B, H, W, c, hid, K, cond, f32=True):
    """(bf16 FLOP, f32 FLOP, bytes) of one K-step inverse chain: z in and out once,
    the cond terms once, the packed weights once."""
    px = B * H * W
    c1, c2 = c // 2, c - c // 2
    convs = 2 * px * K * (9 * c1 * hid + hid * hid + 9 * hid * 2 * c2)
    tail = 2 * px * K * c * c
    es = 4 if f32 else 2  # bytes of a net weight and of a cond term
    weights = K * (es * (9 * c1 * hid + hid * hid + 9 * hid * 2 * c2)
                   + 4 * (4 * hid + 4 * c2 + c * c + c))
    nbytes = 2 * px * c * 4 + (px * K * hid * es if cond else 0) + weights
    return (0, convs + tail, nbytes) if f32 else (convs, tail, nbytes)


def chain3s_work(B, H, W, c, gc, K, f32=True):
    """(bf16 FLOP, f32 FLOP, bytes) of one K-step rescaling main chain: z in and out
    once, the weights once."""
    px = B * H * W
    macs = 0
    for k in range(K):
        cin, fout = (3, 2 * (c - 3)) if k % 2 == 0 else (c - 3, 3)
        macs += sum(9 * (cin + i * gc) * (gc if i < 4 else fout) for i in range(5))
    tail = 4 * px * K * c  # the coupling update and the ActNorm inverse, ~4 FLOP a value
    es = 4 if f32 else 2
    weights = es * macs + 4 * K * (4 * gc + 2 * c)  # one weight per MAC; biases, ActNorm
    nbytes = 2 * px * c * 4 + weights
    return (0, 2 * px * macs + tail, nbytes) if f32 else (2 * px * macs, tail, nbytes)


def least_s(flops, nbytes):
    """The least time the card could take: operations over the TF32 peak or bytes
    over the HBM peak, whichever is longer."""
    return max(flops / PEAK_TF32, nbytes / PEAK_BYTES)


def _dense_macs(cin, gc, fout):
    return sum(9 * (cin + i * gc) * (gc if i < 4 else fout) for i in range(5))


def _fcn_macs(cin, hid, cout):
    return 9 * cin * hid + hid * hid + 9 * hid * cout


def level_macs(top, level: int) -> int:
    """Multiply-adds per pixel of level ``level`` (at its resolution) of one serving
    pass, reverse or forward (the same products either way): the encoder, the prior
    head, the conditional steps and the main steps."""
    c, keep, a, n_main = top.levels[level]
    nf, gc = top.nf, top.gc
    cin_first = keep + top.cond_ch * (top.L - 1 - level)
    rrdb = 3 * _dense_macs(nf, gc, nf)
    macs = 9 * cin_first * nf + sum(top.nb) * rrdb + 9 * nf * nf  # conv_first, trunks, conv1
    macs += 9 * top.cond_ch * 2 * a  # the prior head
    a1 = a // 2
    macs += top.after[level] * (_fcn_macs(a1 + top.cond_ch, top.so_hid, 2 * (a - a1))
                                + (a * a if top.so_permutation == "invconv" else 0))
    for k in range(n_main):
        if top.coupling == "Affine3shift":
            cin, fout = (3, 2 * (c - 3)) if k % 2 == 0 else (c - 3, 3)
            macs += _dense_macs(cin, top.hid, fout)
        else:
            macs += _fcn_macs(c // 2, top.hid, 2 * (c - c // 2))
        macs += c * c if top.permutation == "invconv" else 0
    return macs


def model_flops(top, B: int, H_hr: int, W_hr: int) -> int:
    """FLOP of one serving pass over a batch of B images of HR size H_hr x W_hr."""
    return sum(2 * level_macs(top, i) * B * (H_hr >> (i + 1)) * (W_hr >> (i + 1))
               for i in range(top.L))
