"""The memory budget and the spill tiers (port of blaze_tpu/memory)."""

from blaze_tpu_torch.memory.manager import (MemConsumer, MemManager,
                                            default_budget_bytes)
from blaze_tpu_torch.memory.spill import (FileSpill, HostMemSpill,
                                          HostSpillUnavailable, Spill,
                                          SpillMetrics,
                                          set_host_spill_factory,
                                          try_new_spill)

__all__ = ["MemConsumer", "MemManager", "default_budget_bytes",
           "FileSpill", "HostMemSpill", "HostSpillUnavailable", "Spill",
           "SpillMetrics", "set_host_spill_factory", "try_new_spill"]
