"""Vendored wire contract (a copy of blaze_tpu/plan/proto).

`auron.proto` is the reference's plan/expr serde contract, copied
verbatim; `auron_pb2.py` is its generated module
(`protoc --python_out=. auron.proto` from this directory).  Both are
byte-identical to the JAX package's copies, so the two packages share one
descriptor when a process loads both.
"""

from blaze_tpu_torch.plan.proto import auron_pb2  # noqa: F401
