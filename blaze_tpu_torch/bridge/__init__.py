"""Host bridge of the PyTorch port: task context, metrics, resource map
and the per-task runtime."""
