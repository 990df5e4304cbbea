"""Data and plans for driving the port end to end.

Importing the package registers the breadth queries of queries_ext.py and
queries_ext2.py into `queries.QUERIES`, as the reference's itest package
does."""

from blaze_tpu_torch.itest import queries_ext  # noqa: E402,F401
from blaze_tpu_torch.itest import queries_ext2  # noqa: E402,F401
