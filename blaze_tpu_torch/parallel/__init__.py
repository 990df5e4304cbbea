"""Parallel execution kernels of the PyTorch port (this slice: the device
hash-aggregation table)."""
