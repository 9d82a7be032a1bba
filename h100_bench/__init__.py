"""The benchmark of the PyTorch and CUDA port ``hcflow_tpu_torch`` (see README.md)."""
