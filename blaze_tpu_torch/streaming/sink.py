"""The exactly-once streaming sink: per-epoch parquet files behind a
first-wins commit (port of blaze_tpu/streaming/sink.py).

Every execution of an epoch, a replay after recovery too, writes its rows
under a FRESH attempt name, and only the attempt that the epoch's
committed checkpoint manifest references is promoted to the final
``epoch-NNNNNN.parquet`` name.  A losing attempt (the replay of an epoch
whose manifest exists) is discarded, so a reader of the sink directory
sees each epoch's output once, however many times the epoch ran.
Promotion is idempotent: recovery promotes the manifest's attempt again
if the process died between the commit and the rename.
"""

from __future__ import annotations

import itertools
import os
from typing import List, Optional

import pyarrow as pa
import pyarrow.parquet as pq

from blaze_tpu_torch.ops.sink import write_parquet_atomic
from blaze_tpu_torch.streaming.checkpoint import fsync_dir

_FINAL = "epoch-{epoch:06d}.parquet"


class ExactlyOnceParquetSink:

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)
        self._attempt_ids = itertools.count()

    def _final_path(self, epoch: int) -> str:
        return os.path.join(self.dir, _FINAL.format(epoch=epoch))

    # -- the two-phase protocol -----------------------------------------
    def write_attempt(self, epoch: int, table: pa.Table) -> str:
        """Phase 1: land this execution's rows under an attempt name
        (crash-safe, never visible to readers).  Returns the path the
        checkpoint manifest references."""
        attempt = os.path.join(
            self.dir,
            f"epoch-{epoch:06d}.a{next(self._attempt_ids)}.parquet")
        write_parquet_atomic(table, attempt)
        return attempt

    def promote(self, epoch: int, attempt_path: str) -> bool:
        """Phase 2, after the manifest committed: publish the winning
        attempt under the final name.  True when this call published it."""
        final = self._final_path(epoch)
        if os.path.exists(final):
            self.discard(attempt_path)
            return False
        os.replace(attempt_path, final)
        fsync_dir(self.dir)  # the rename must survive power loss too
        return True

    def discard(self, attempt_path: str) -> None:
        """Drop a losing attempt (its epoch was committed earlier)."""
        try:
            os.unlink(attempt_path)
        except OSError:
            pass

    def repair(self, epoch: int, attempt_path: Optional[str]) -> None:
        """Recovery: `epoch`'s manifest is committed; publish its sink file
        if the final name is still missing."""
        if attempt_path and os.path.exists(attempt_path):
            self.promote(epoch, attempt_path)

    # -- readers ---------------------------------------------------------
    def committed_epochs(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if (name.startswith("epoch-") and name.endswith(".parquet")
                    and ".a" not in name):
                out.append(int(name[len("epoch-"):-len(".parquet")]))
        return sorted(out)

    def committed_table(self) -> pa.Table:
        """Every committed epoch's output, concatenated in epoch order.
        Raises only when NO epoch has committed; epochs that committed
        empty give an empty table of the sink's schema."""
        epochs = self.committed_epochs()
        if not epochs:
            raise FileNotFoundError(f"no committed epochs in {self.dir}")
        tables = [pq.read_table(self._final_path(e)) for e in epochs]
        non_empty = [t for t in tables if t.num_rows]
        if non_empty:
            return pa.concat_tables(non_empty)
        return tables[0]  # a legitimately empty stream output
