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

from typing import Optional

import torch

from blaze_tpu_torch.bridge import device_stats


def route(t: torch.Tensor, kind: Optional[str] = None) -> str:
    """'cuda' for a tensor on a CUDA device, 'plain' for a CPU tensor.
    A `kind` (hash, partition) counts the resolution in
    bridge/device_stats.py under the reference's lane names: the hand
    kernel is its `pallas` lane, the plain version its `scatter`
    formulation."""
    if t.device.type == "cuda":
        lane = "cuda"
    elif t.device.type == "cpu":
        lane = "plain"
    else:
        raise ValueError(f"no kernel route for device {t.device}")
    if kind is not None:
        device_stats.note_scatter_lane(
            kind, "pallas" if lane == "cuda" else "scatter")
    return lane
