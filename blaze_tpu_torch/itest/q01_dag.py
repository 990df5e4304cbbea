"""Full TPC-DS q01 through the port's stage DAG (plan/stages.py), with a
lineage probe: the data, a scheduler that corrupts one committed map
output, and the counters a run is checked by.

q01 (itest/queries.py) splits into six stages: two map stages
(store_returns joined to date_dim by broadcast, a fused partial agg,
hashed by (customer, store)), two `ctr` final-agg stages (each hashed by
store: `ctr` is referenced twice and subtrees are not shared), the join
stage (a sort-merge join of `ctr` with the average by store, the
`> 1.2 * avg` filter, broadcast joins to the TN stores and to customer,
the projection to c_customer_id, one output partition) and the result
stage (a sort with fetch, then limit 100).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from blaze_tpu_torch.plan.stages import DagScheduler


#: q01's four tables (itest/tpcds_data.py `make_tables`)
TABLES = ("store_returns", "date_dim", "store", "customer")


def corrupt_block(data_file: str, index_file: str) -> Optional[int]:
    """Flip one payload byte of the first non-empty partition of a
    committed map output (inside its first frame, past the 9-byte
    header); the frame's CRC32C then fails on read.  Returns the byte's
    offset, or None for an output with no frame to corrupt."""
    from blaze_tpu_torch.shuffle.exchange import read_index_file
    offsets = read_index_file(index_file, data_file=data_file)
    parts = [i for i in range(len(offsets) - 1)
             if offsets[i + 1] - offsets[i] > 12]
    if not parts:
        return None
    at = offsets[parts[0]] + 12
    with open(data_file, "r+b") as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xFF]))
    return at


class CorruptingScheduler(DagScheduler):
    """A DagScheduler that corrupts one byte of a committed `.data` of
    stage `stage_id` right after its map task commits: map task `map_id`,
    or with None the first map task whose output is not empty (q01's
    store_returns files are date-ordered, so some map tasks write
    nothing).  It does so the first `times` times that task runs: the
    consuming stage fails its read, and lineage recovery re-runs exactly
    that map task."""

    def __init__(self, stage_id: int, map_id: Optional[int] = None,
                 times: int = 1, **kw):
        super().__init__(**kw)
        self.stage_id = stage_id
        self.map_id = map_id
        self.left = times
        self.corrupted_at: Optional[int] = None

    @property
    def target(self) -> Tuple[int, Optional[int]]:
        return self.stage_id, self.map_id

    def _run_map_task(self, stage, part, m):
        super()._run_map_task(stage, part, m)
        if stage.sid != self.stage_id or self.left <= 0 \
                or self.map_id not in (None, m):
            return
        data = self._map_data_path(stage.sid, m)
        at = corrupt_block(data, data[:-5] + ".index")
        if at is not None:
            self.map_id, self.left, self.corrupted_at = m, self.left - 1, at


def stage_counters(sched: DagScheduler, names) -> Dict[int, Dict[str, int]]:
    """Per stage: the counters `names` summed over its merged operator
    metric tree."""
    out = {}
    for sid, tree in sched.stage_metrics.items():
        acc = {k: 0 for k in names}

        def add(node):
            for k in names:
                acc[k] += node.values.get(k, 0)
            for c in node.children:
                add(c)
        add(tree)
        out[sid] = acc
    return out

