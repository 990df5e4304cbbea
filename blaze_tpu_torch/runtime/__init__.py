"""Device stage runtime of the PyTorch port.

`plan/stage_compiler.py` decides what compiles (a StageProgram per
eligible stage); this package runs it: a loop that folds a partition's
batches in chunks, one CUDA graph replay per chunk on a CUDA device
(loop.py).
"""

from blaze_tpu_torch.runtime.loop import (StageLoopFallback, drain_device,
                                          execute_loop, run_partition)

__all__ = ["StageLoopFallback", "drain_device", "execute_loop",
           "run_partition"]
