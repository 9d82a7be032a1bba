"""Plain float32 reference of HCFlow's serving passes, in PyTorch, NCHW.

Written from the published model (Liang et al., "Hierarchical Conditional Flow: A
Unified Framework for Image Super-Resolution and Image Rescaling", ICCV 2021, and the
authors' code layout, whose state_dict names it reads): L levels of squeeze -> main
flow steps -> split, where the split-off channels ``a`` of level i are modelled
conditionally on ``u_i = cat(z_i, up_2(cond_{i+1}), up_4(cond_{i+2}), ...)``:

- encoder: ``first = conv_first(u)``, ``feat1 = RRDB_trunk0(first)``,
  ``feat2 = trunk_conv1(RRDB_trunk1(feat1)) + first``; cond = cat(feat1, feat2) for SR,
  feat2 for rescaling.  An RRDB is ESRGAN's: three residual dense blocks (five 3x3
  convs over growing concats, leaky ReLU 0.2, ``x + 0.2 * conv5``), ``x + 0.2 * out``;
- prior: a Conv2dZeros head (``conv(cond) * exp(3 * logs)``), split even/odd into
  (mean, logs); rescaling bounds ``logs <- 0.318 * atan(2 * logs)``;
- a flow step is ActNorm ``(x + b) * exp(s)`` -> invertible 1x1 conv (or none) ->
  affine coupling.  ``Affine``: z1 = the first half, ``h = FCN(cat(z1, cond))`` split
  even/odd into (shift, scale), ``z2 <- (z2 + shift) * exp(0.318 * atan(2 * scale))``.
  ``Affine3shift`` (rescaling): at even steps the 3 LR channels drive an affine
  transform of the others, at odd steps the others drive a shift of the 3 LR channels;
- squeeze: space-to-depth (``pixel_unshuffle``) for SR, the orthogonal Haar transform
  for rescaling.

Reverse: the levels deepest first: ``a = mean + exp(logs) * eps`` with the given
whitened latent eps (the heat already in it), the conditional steps inverted, then the
main steps inverted on cat(z, a), then unsqueeze.  Forward (rescaling's downscale): the
squeezes and main steps down, then each level's conditional steps forward on a and the
whitened latent ``(a' - mean) * exp(-logs)``.

Every convolution and product runs in float32 with TF32 off (:func:`precision`); the
invertible 1x1 convs' inverses are taken in float64 and applied in float32.  The
control switches TF32 on (``tf32=True``), the step below float32 that a faster kernel
might take.  Nothing here imports the program under test.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(tf32: bool):
    """Run with cuDNN's and the matrix products' TF32 switches set to ``tf32``."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def _per_level(value, L):
    return list(value)[:L] if isinstance(value, (list, tuple)) else [value] * L


class Topology:
    """The level structure of ``network_G`` (the option file's section)."""

    def __init__(self, network_g: dict, sr: bool):
        fd = network_g["flowDownsampler"]
        so = fd["splitOff"]
        self.sr = sr
        self.L = fd["L"]
        self.K = _per_level(fd["K"], self.L)
        self.after = _per_level(so["after_flowstep"], self.L)
        self.squeeze = fd.get("squeeze") or "checkerboard"
        self.permutation = fd.get("flow_permutation") or "invconv"
        self.coupling = fd.get("flow_coupling") or "Affine"
        self.nn = fd.get("nn_module") or "FCN"
        self.hid = fd.get("hidden_channels", 64)
        self.so_permutation = so.get("flow_permutation") or "invconv"
        self.so_hid = so.get("hidden_channels", 64)
        self.nb = list(so["RRDB_nb"])
        self.nf = so["RRDB_nf"]
        self.gc = so["RRDB_gc"]
        self.cond_ch = 2 * self.nf if sr else self.nf
        c = network_g.get("in_nc", 3)
        self.levels = []  # (channels, retained, split-off, main steps) per level
        for i in range(self.L):
            c *= 4
            keep = c // 2 if i < self.L - 1 else 3
            self.levels.append((c, keep, c - keep, self.K[i] - self.after[i]))
            c = keep

    def layer_index(self, level: int) -> int:
        """Index in ``flow.layers`` of the level's first main step: every level lists a
        squeeze, its main steps and a split."""
        return sum(n + 2 for _, _, _, n in self.levels[:level]) + 1


class HCFlowReference:
    """The serving passes on a state_dict in the authors' layout (``flow.layers.<i>...``,
    ``flow.level<i>_condFlow...``), every tensor read as float32 on ``device``."""

    def __init__(self, state_dict: dict, network_g: dict, sr: bool, device, tf32=False):
        self.sd = state_dict
        self.top = Topology(network_g, sr)
        self.device = torch.device(device)
        self.tf32 = tf32
        self._inv = {}

    # ------------------------------------------------------------------ tensors
    def t(self, name: str) -> torch.Tensor:
        return torch.as_tensor(self.sd[name]).to(self.device, torch.float32)

    def vec(self, name: str) -> torch.Tensor:
        return self.t(name).reshape(1, -1, 1, 1)

    # ------------------------------------------------------------------- layers
    def conv(self, p: str, x, bias=True):
        w = self.t(f"{p}.weight")
        return F.conv2d(x, w, self.t(f"{p}.bias") if bias else None, padding=w.shape[-1] // 2)

    def actnorm(self, p: str, x):
        return (x + self.vec(f"{p}.bias")) * torch.exp(self.vec(f"{p}.logs"))

    def actnorm_inverse(self, p: str, x):
        return x * torch.exp(-self.vec(f"{p}.logs")) - self.vec(f"{p}.bias")

    def conv_zeros(self, p: str, x):
        return self.conv(p, x) * torch.exp(3.0 * self.vec(f"{p}.logs"))

    def fcn(self, p: str, x):
        x = F.relu(self.actnorm(f"{p}.conv1.actnorm", self.conv(f"{p}.conv1", x, bias=False)))
        x = F.relu(self.actnorm(f"{p}.conv2.actnorm", self.conv(f"{p}.conv2", x, bias=False)))
        return self.conv_zeros(f"{p}.conv3", x)

    def dense_block(self, p: str, x):
        """Five 3x3 convs over growing concats; leaky ReLU after the first four."""
        feats = [x]
        for k in range(1, 5):
            feats.append(F.leaky_relu(self.conv(f"{p}.conv{k}", torch.cat(feats, 1)), 0.2))
        return self.conv(f"{p}.conv5", torch.cat(feats, 1))

    def rrdb(self, p: str, x):
        out = x
        for r in (1, 2, 3):
            out = out + 0.2 * self.dense_block(f"{p}.RDB{r}", out)
        return x + 0.2 * out

    def encoder(self, level: int, u):
        p, top = f"flow.level{level}_condFlow", self.top
        first = self.conv(f"{p}.conv_first", u)
        feat1 = first
        for j in range(top.nb[0]):
            feat1 = self.rrdb(f"{p}.RRDB_trunk0.{j}", feat1)
        feat2 = feat1
        for j in range(top.nb[1]):
            feat2 = self.rrdb(f"{p}.RRDB_trunk1.{j}", feat2)
        feat2 = self.conv(f"{p}.trunk_conv1", feat2) + first
        return torch.cat([feat1, feat2], 1) if top.sr else feat2

    def prior(self, level: int, cond):
        h = self.conv_zeros(f"flow.level{level}_condFlow.f", cond)
        mean, logs = h[:, 0::2], h[:, 1::2]
        return mean, (logs if self.top.sr else 0.318 * torch.atan(2.0 * logs))

    def invconv(self, p: str, x, inverse: bool):
        w = self.t(f"{p}.weight")
        if inverse:
            if p not in self._inv:
                self._inv[p] = torch.linalg.inv(w.double()).float()
            w = self._inv[p]
        return F.conv2d(x, w[:, :, None, None])

    # -------------------------------------------------------------- flow steps
    def _affine_h(self, p, z1, cond):
        return self.fcn(f"{p}.affine.f", z1 if cond is None else torch.cat([z1, cond], 1))

    def step(self, p: str, z, cond, kind: str, permutation: str, k: int, inverse: bool):
        """One flow step (ActNorm, permutation, coupling) or its inverse; ``k`` the step's
        index in its chain (Affine3shift alternates on it)."""
        if not inverse:
            z = self.actnorm(f"{p}.actnorm", z)
            if permutation == "invconv":
                z = self.invconv(f"{p}.permute", z, False)
        if kind == "Affine3shift" and k % 2 == 1:  # the others shift the LR channels
            lr, others = z[:, :3], z[:, 3:]
            shift = self.dense_block(f"{p}.affine.f", others)
            z = torch.cat([lr - shift if inverse else lr + shift, others], 1)
        else:
            n1 = 3 if kind == "Affine3shift" else z.shape[1] // 2
            z1, z2 = z[:, :n1], z[:, n1:]
            h = (self.dense_block(f"{p}.affine.f", z1) if kind == "Affine3shift"
                 else self._affine_h(p, z1, cond))
            shift, scale = h[:, 0::2], 0.318 * torch.atan(2.0 * h[:, 1::2])
            z2 = z2 * torch.exp(-scale) - shift if inverse else (z2 + shift) * torch.exp(scale)
            z = torch.cat([z1, z2], 1)
        if inverse:
            if permutation == "invconv":
                z = self.invconv(f"{p}.permute", z, True)
            z = self.actnorm_inverse(f"{p}.actnorm", z)
        return z

    def _main(self, level: int, z, inverse: bool):
        top = self.top
        first, n = top.layer_index(level), top.levels[level][3]
        order = reversed(range(n)) if inverse else range(n)
        for k in order:
            z = self.step(f"flow.layers.{first + k}", z, None, top.coupling, top.permutation, k,
                          inverse)
        return z

    def _cond_steps(self, level: int, a, cond, inverse: bool):
        n = self.top.after[level]
        for k in (reversed(range(n)) if inverse else range(n)):
            a = self.step(f"flow.level{level}_condFlow.additional_flow_steps.{k}", a, cond,
                          "Affine", self.top.so_permutation, k, inverse)
        return a

    # ---------------------------------------------------------------- squeezes
    def _haar(self, c):
        w = torch.ones(4, 1, 2, 2, device=self.device)
        w[1, 0, 0, 1] = w[1, 0, 1, 1] = -1  # x00 - x01 + x10 - x11
        w[2, 0, 1, 0] = w[2, 0, 1, 1] = -1  # x00 + x01 - x10 - x11
        w[3, 0, 1, 0] = w[3, 0, 0, 1] = -1  # x00 - x01 - x10 + x11
        return w.repeat(c, 1, 1, 1)

    def squeeze(self, x):
        if self.top.squeeze != "haar":
            return F.pixel_unshuffle(x, 2)
        B, C, H, W = x.shape  # filter-major channels: filter k of channel c at k * C + c
        out = F.conv2d(x, self._haar(C), stride=2, groups=C) / 4.0
        return out.reshape(B, C, 4, H // 2, W // 2).transpose(1, 2).reshape(B, 4 * C, H // 2,
                                                                             W // 2)

    def unsqueeze(self, x):
        if self.top.squeeze != "haar":
            return F.pixel_shuffle(x, 2)
        B, C4, H, W = x.shape
        C = C4 // 4
        x = x.reshape(B, 4, C, H, W).transpose(1, 2).reshape(B, C4, H, W)
        return F.conv_transpose2d(x, self._haar(C), stride=2, groups=C)

    def _cond_input(self, level: int, z, conds):
        ups = [F.interpolate(conds[j], scale_factor=2 ** (j - level), mode="nearest")
               for j in range(level + 1, self.top.L)]
        return torch.cat([z, *ups], 1) if ups else z

    # ------------------------------------------------------------------ passes
    @torch.no_grad()
    def reverse(self, lr, eps_list):
        """LR (NCHW) -> HR (NCHW), clamped to [0, 1]; ``eps_list[i]`` the whitened latent
        of level i (NCHW), the heat already in it."""
        with precision(self.tf32):
            z, conds = lr.float(), [None] * self.top.L
            for i in reversed(range(self.top.L)):
                cond = self.encoder(i, self._cond_input(i, z, conds))
                mean, logs = self.prior(i, cond)
                a = self._cond_steps(i, mean + torch.exp(logs) * eps_list[i], cond, True)
                z = self.unsqueeze(self._main(i, torch.cat([z, a], 1), True))
                conds[i] = cond
            return z.clamp(0.0, 1.0)

    @torch.no_grad()
    def forward(self, hr):
        """HR (NCHW) -> (LR clamped to [0, 1], [whitened latent per level]), NCHW: the
        rescaling model's downscale."""
        with precision(self.tf32):
            z, ys, a_s = hr.float(), [], []
            for i, (_, keep, _, _) in enumerate(self.top.levels):
                z = self._main(i, self.squeeze(z), False)
                ys.append(z[:, :keep])
                a_s.append(z[:, keep:])
                z = ys[-1]
            conds, latents = [None] * self.top.L, [None] * self.top.L
            for i in reversed(range(self.top.L)):
                cond = self.encoder(i, self._cond_input(i, ys[i], conds))
                a = self._cond_steps(i, a_s[i], cond, False)
                mean, logs = self.prior(i, cond)
                latents[i] = (a - mean) * torch.exp(-logs)
                conds[i] = cond
            return ys[-1].clamp(0.0, 1.0), latents


def codes(lr: torch.Tensor) -> torch.Tensor:
    """An LR image in [0, 1] as the 8-bit codes an image store keeps: round(255 x)."""
    return torch.round(lr.clamp(0.0, 1.0) * 255.0).to(torch.uint8)

