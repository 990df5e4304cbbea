"""The port's device, from the `auron.torch.device` conf key.

`resolve()` is the one place that turns the key into a `torch.device`.
Asking for CUDA where `torch.cuda.is_available()` is False raises: nothing
carries on quietly on the CPU.  The CPU tests set the key to `"cpu"`.
"""

from __future__ import annotations

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
