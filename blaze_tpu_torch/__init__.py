"""blaze_tpu_torch: the PyTorch/CUDA port of blaze_tpu.

The package mirrors `blaze_tpu/` module for module, so the counterpart of
`blaze_tpu/kernels/radix.py` is `blaze_tpu_torch/kernels/radix.py`.  It
imports torch, numpy, pyarrow and protobuf, and never jax or anything of
`blaze_tpu` (importing `blaze_tpu` turns on `jax_enable_x64` for the whole
process).

The device comes from one conf key, `auron.torch.device` (default
`"cuda"`, see device.py).  Tensors on a CUDA device run the hand-written
CUDA kernels under `csrc/`; tensors on the CPU run each kernel's plain
PyTorch version.  Nothing is built or launched at import.
"""

from blaze_tpu_torch import config  # noqa: F401

__all__ = ["config"]
