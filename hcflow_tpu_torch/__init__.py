"""HCFlow in PyTorch for NVIDIA Hopper: the x4 SR serving reverse pass.

The counterpart of ``hcflow_tpu`` (JAX): the same module names, NHWC tensors at
every public function, parameters as nested dicts of tensors with OIHW conv
weights, per-step lists in place of ``lax.scan`` stacks.  The two hot kernels of
the serving path, the RRDB encoder block and the inverse flow-step chain, are
hand-written CUDA C++ under ``csrc/`` (built on first use by ``_build.py``); each
has a plain PyTorch version beside it that the CPU runs.
"""

from .models.hcflow_sr import HCFlowSRSpec

__all__ = ["HCFlowSRSpec"]
