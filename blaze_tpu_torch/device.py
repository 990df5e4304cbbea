"""The port's device, from the `auron.torch.device` conf key.

`resolve()` is the one place that turns the key into a `torch.device`.
Asking for CUDA where `torch.cuda.is_available()` is False raises: nothing
carries on quietly on the CPU.  The CPU tests set the key to `"cpu"`.
"""

from __future__ import annotations

import threading

import torch

from blaze_tpu_torch import config


def resolve() -> torch.device:
    """The configured device; raises when it is a CUDA device and no card
    is visible."""
    name = str(config.TORCH_DEVICE.get()).strip().lower() or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"auron.torch.device={name!r} but torch.cuda.is_available() is "
            f"False; set auron.torch.device=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"auron.torch.device={name!r}: expected cuda or cpu")
    return dev


#: Held by a CUDA graph capture (runtime/loop.py) for its whole length.
#: The capture runs in the default (global) error mode, where a CUDA call
#: from ANOTHER thread that may synchronise or allocate (cudaMalloc,
#: cudaHostAlloc, an event query or wait, work on the legacy default
#: stream) invalidates the capture or fails; so a background thread that
#: issues CUDA work while the caller may capture (the prefetch worker's
#: staging, batch.py `DeviceStager`) takes this lock around that work.
CAPTURE_LOCK = threading.RLock()
