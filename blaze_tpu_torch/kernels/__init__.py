"""Kernels of the PyTorch port: plain tensor code (hashing.py) and the two
hand-written CUDA kernels with their plain versions (hash_update.py,
radix.py; sources under ../csrc, built by build.py, routed by lane.py)."""
