"""Plan wire, planner and the fused aggregation of the PyTorch port."""

from blaze_tpu_torch.plan.planner import create_plan, decode_task_definition

__all__ = ["create_plan", "decode_task_definition"]
