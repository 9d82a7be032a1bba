"""HCFlow in PyTorch for NVIDIA Hopper: x4 and x8 SR and x4 rescaling, served and
trained (data-parallel over several cards with ``parallel/``).

The counterpart of ``hcflow_tpu`` (JAX): the same module names, NHWC tensors at
every public function, parameters as nested dicts of tensors with OIHW conv
weights, per-step lists in place of ``lax.scan`` stacks.  The hot kernels of the serving
paths, the RRDB encoder block (per RRDB, or a whole trunk in one launch), the inverse
flow-step chain and the inverse rescaling main chain, and the standalone 3x3 conv,
are hand-written CUDA C++ under ``csrc/`` (built on first use by ``_build.py``); each
has a plain PyTorch version beside it that the CPU runs.  The serving entry points
(``cli/test.py``, ``cli/predict.py``) and what they stand on (``data/``, ``utils/``,
``models/lpips.py``) are counterparts of the JAX package's modules of the same paths.
"""

from .models import HCFlowRescalingSpec, HCFlowSRSpec, quantize

__all__ = ["HCFlowRescalingSpec", "HCFlowSRSpec", "quantize"]
