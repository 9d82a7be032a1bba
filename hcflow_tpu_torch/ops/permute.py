"""Fixed channel permutations (``reverse`` / ``shuffle``) on NHWC tensors, as the JAX
package's ``hcflow_tpu/ops/permute.py`` (the reference's Permute2d).

Volume-preserving (logdet passes through).  The indices are fixed at init (the
reversal, or a shuffle seeded by numpy's ``default_rng(seed)``, the JAX package's
draw) and kept as int32 tensors in the params, so that checkpoints carry them; the
trainer leaves integer params as they are.
"""

from __future__ import annotations

import numpy as np
import torch


def init(num_channels: int, shuffle: bool = False, seed: int = 0) -> dict:
    idx = np.arange(num_channels - 1, -1, -1)
    if shuffle:
        np.random.default_rng(seed).shuffle(idx)
    inv = np.zeros(num_channels, np.int32)
    inv[idx] = np.arange(num_channels)
    return {"indices": torch.from_numpy(idx.astype(np.int32)),
            "indices_inverse": torch.from_numpy(inv)}


def forward(params: dict, x: torch.Tensor, logdet=None):
    return x.index_select(-1, params["indices"]), logdet


def inverse(params: dict, y: torch.Tensor, logdet=None):
    return y.index_select(-1, params["indices_inverse"]), logdet
