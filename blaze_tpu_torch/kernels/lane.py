"""Kernel routing for the port (counterpart of blaze_tpu/kernels/lane.py).

The rule is one line: a tensor on a CUDA device goes to the hand-written
CUDA kernel; a tensor on the CPU goes to the kernel's plain PyTorch
version.  There is no knob, and no `try` that gives way to the plain
version when a build or launch fails: the error propagates.

Not carried over from blaze_tpu/kernels/lane.py, because they are TPU
concerns:
  * the `auron.tpu.kernels.pallas` knob (auto/on/off) and its interpret
    lane: Mosaic compiles only on a TPU, so the JAX package needed a
    switch between the Pallas kernel and the scatter formulation;
  * the VMEM decline (`vmem_budget`/`decline`): the Pallas kernels keep
    their whole working set in VMEM and refuse larger footprints; the
    CUDA kernels keep their tables in device memory and run at every
    size;
  * the `pallas-kernel` fault site, which scripted lane failures that
    degraded to the scatter formulation.
"""

from __future__ import annotations

import torch


def route(t: torch.Tensor) -> str:
    """'cuda' for a tensor on a CUDA device, 'plain' for a CPU tensor."""
    if t.device.type == "cuda":
        return "cuda"
    if t.device.type == "cpu":
        return "plain"
    raise ValueError(f"no kernel route for device {t.device}")
