"""Sort-merge join over key-sorted children (port of the merge of
blaze_tpu/ops/joins/smj.py, vectorized).

Both inputs arrive sorted ascending, nulls first, on the join keys.  The
JAX package walks equal-key RUNS with two cursors, one Python step and
one emitted batch per run; this port computes the same walk with array
operations over the runs it holds, so its cost does not grow with the
number of runs (a distinct-key full outer join of a million rows per side
is a million runs):

  * each side is read a batch at a time into a buffer and split into runs
    where its host order keys (ops/sort.py `host_sort_keys`) change: a
    null equals a null, a NaN a NaN and -0.0 equals 0.0, as in the
    cursor's key tuples.  A side's last run may go on in its next batch;
  * a run whose key has a null never matches.  The other runs of both
    sides get codes from the same order keys, so code order is the
    cursor's key order and equal codes are matching runs;
  * the walk's order is a ranking of EVENTS: a matched pair of runs, an
    unmatched run or a null-key run.  Runs rank by the merged code
    position, each side's null-key runs right after the run before them
    on their side (the left side's first).  The events that rank below
    both sides' last runs are final and leave the buffers; the side
    holding the lowest last run reads its next batch;
  * final events are joined in slices of at most `auron.batch.size`
    candidate pairs and rows, several small events at once (their rows
    ordered by event, then pairs, left rows and right rows), one large
    event alone with its pairs cut into batch-sized pieces, so a skewed
    hot key never materializes its cross product.

The rows of every join type, and the join filter's verdict on each
candidate pair, are those of the run walk, in its order.  The key columns
are evaluated on the port's device and read back as Arrow arrays.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import pyarrow as pa

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch
from blaze_tpu_torch.exprs import PhysicalExpr
from blaze_tpu_torch.ops.sort import host_sort_keys, lexsort_host
from blaze_tpu_torch.schema import Schema


def _order_keys(arrays: List[pa.Array]) -> List[np.ndarray]:
    """Host order keys (ascending, nulls first) of key columns: two rows
    have equal keys exactly when the run cursor's key tuples are equal
    (a null equals a null, a NaN a NaN, -0.0 equals 0.0)."""
    n = len(arrays)
    rb = pa.RecordBatch.from_arrays(arrays,
                                    names=[f"k{i}" for i in range(n)])
    return host_sort_keys(rb, list(range(n)), [False] * n, [True] * n)


def _changes(keys: List[np.ndarray], n: int) -> np.ndarray:
    """Rows whose keys differ from the row before (row 0 always)."""
    change = np.zeros(n, dtype=bool)
    if n:
        change[0] = True
    for k in keys:
        change[1:] |= k[1:] != k[:-1]
    return change


def _dense_rank(keys: List[np.ndarray], n: int) -> np.ndarray:
    """Each row's rank among the distinct key tuples (0 = smallest)."""
    order = lexsort_host(keys)
    rank = np.empty(n, dtype=np.int64)
    rank[order] = np.cumsum(_changes([k[order] for k in keys], n)) - 1
    return rank


class _Side:
    """One key-sorted input, read a batch at a time.  The buffer holds
    the rows not yet joined (`table`), their runs of equal keys (`starts`,
    `ends`), each run's order keys (`run_keys`) and whether its key has a
    null (`null_run`); its last run may go on in the next batch until the
    input is `done`."""

    def __init__(self, batches: Iterator[ColumnBatch],
                 key_exprs: Sequence[PhysicalExpr], schema: Schema):
        self._batches = iter(batches)
        self._key_exprs = list(key_exprs)
        self.schema = schema
        self.done = False
        self.table = pa.Table.from_batches([], schema=schema.to_arrow())
        self._order: List[np.ndarray] = []
        self._null_row = np.zeros(0, dtype=bool)
        self._index()

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    def pull(self) -> None:
        """Buffer the next non-empty batch, or mark the input done."""
        for b in self._batches:
            b = b.compact()
            if b.num_rows == 0:
                continue
            arrays = [e.evaluate(b).to_host(b.num_rows)
                      for e in self._key_exprs]
            null_row = np.zeros(b.num_rows, dtype=bool)
            for a in arrays:
                if a.null_count:
                    null_row |= ~np.asarray(a.is_valid())
            order = _order_keys(arrays)
            rows = pa.Table.from_batches([b.to_arrow()])
            if self.num_rows:
                self.table = pa.concat_tables([self.table, rows]) \
                    .combine_chunks()
                self._order = [np.concatenate([a, k])
                               for a, k in zip(self._order, order)]
                self._null_row = np.concatenate([self._null_row, null_row])
            else:
                self.table, self._order = rows, order
                self._null_row = null_row
            self._index()
            return
        self.done = True

    def _index(self) -> None:
        self.starts = np.flatnonzero(_changes(self._order, self.num_rows))
        self.ends = np.append(self.starts[1:], self.num_rows) \
            .astype(np.int64)
        self.run_keys = [k[self.starts] for k in self._order]
        self.null_run = self._null_row[self.starts]

    def run_rows(self, runs: np.ndarray) -> np.ndarray:
        """The rows of each run at `runs` (-1: none, 0 rows)."""
        return np.append(self.ends - self.starts, 0)[runs]

    def drop(self, runs: int) -> None:
        """Forget the first `runs` runs (joined)."""
        if not runs:
            return
        r = int(self.ends[runs - 1])
        self.table = self.table.slice(r)
        self._order = [k[r:] for k in self._order]
        self._null_row = self._null_row[r:]
        self.starts = self.starts[runs:] - r
        self.ends = self.ends[runs:] - r
        self.run_keys = [k[runs:] for k in self.run_keys]
        self.null_run = self.null_run[runs:]

    def take(self, idx: np.ndarray) -> List[pa.Array]:
        """Buffered rows at `idx` (-1: a null row), column by column."""
        if self.num_rows == 0:
            return [pa.nulls(len(idx), f.data_type.to_arrow())
                    for f in self.schema]
        ia = pa.array(idx, type=pa.int64(), mask=idx < 0)
        return [c.take(ia).combine_chunks() for c in self.table.columns]


def _codes(left: _Side, right: _Side) -> Tuple[np.ndarray, np.ndarray]:
    """Order codes of the non-null runs of both sides: equal codes for
    equal keys, code order the key order."""
    lr = np.flatnonzero(~left.null_run)
    rr = np.flatnonzero(~right.null_run)
    if not len(lr) or not len(rr):
        return np.arange(len(lr)), np.arange(len(rr)) + len(lr)
    keys = [np.concatenate([a[lr], b[rr]])
            for a, b in zip(left.run_keys, right.run_keys)]
    codes = _dense_rank(keys, len(lr) + len(rr))
    return codes[:len(lr)], codes[len(lr):]


def _event_keys(pos: np.ndarray, null_run: np.ndarray,
                side: int) -> List[np.ndarray]:
    """Event keys (position, after, side, run) of one side's runs: a
    null-key run follows the last non-null run before it on its side."""
    n = len(pos)
    prev = np.maximum.accumulate(pos) if n else pos
    return [np.where(null_run, prev, pos), null_run.astype(np.int64),
            np.where(null_run, side, 0), np.where(null_run, np.arange(n), 0)]


def _events(left: _Side, right: _Side) -> Tuple[np.ndarray, np.ndarray]:
    """The walk's events over the buffered runs: for each event in order,
    its left run and its right run (-1: none)."""
    lc, rc = _codes(left, right)
    union = np.union1d(lc, rc)
    l_pos = np.full(len(left.starts), -1, dtype=np.int64)
    r_pos = np.full(len(right.starts), -1, dtype=np.int64)
    l_pos[~left.null_run] = np.searchsorted(union, lc)
    r_pos[~right.null_run] = np.searchsorted(union, rc)
    keys = [np.concatenate([a, b]) for a, b in
            zip(_event_keys(l_pos, left.null_run, 0),
                _event_keys(r_pos, right.null_run, 1))]
    nl = len(l_pos)
    rank = _dense_rank(keys, nl + len(r_pos))
    n_ev = int(rank.max()) + 1 if len(rank) else 0
    l_of = np.full(n_ev, -1, dtype=np.int64)
    r_of = np.full(n_ev, -1, dtype=np.int64)
    l_of[rank[:nl]] = np.arange(nl)
    r_of[rank[nl:]] = np.arange(len(r_pos))
    return l_of, r_of


def _final(l_of: np.ndarray, r_of: np.ndarray, left: _Side,
           right: _Side) -> Tuple[int, List[_Side]]:
    """How many leading events are final, and the sides to read next: an
    event is final once it ranks below the last run of every side that is
    not done, since that run may go on and later runs rank after it."""
    cut, hold = len(l_of), []
    for side, of in ((left, l_of), (right, r_of)):
        if side.done:
            continue
        last = int(np.flatnonzero(of == len(side.starts) - 1)[0]) \
            if len(side.starts) else 0
        if last < cut:
            cut, hold = last, [side]
        elif last == cut:
            hold.append(side)
    return cut, hold


class MergeJoiner:
    """The merge of two sorted sides for every join type (the
    smj/*_join.rs dispatch)."""

    def __init__(self, left_schema: Schema, right_schema: Schema,
                 out_schema: Schema, join_type,
                 join_filter: Optional[PhysicalExpr]):
        from blaze_tpu_torch.ops.joins.exec import JoinType
        self.JT = JoinType
        self.left_schema = left_schema
        self.right_schema = right_schema
        self.out_schema = out_schema
        self.join_type = join_type
        self.join_filter = join_filter
        self._batch_rows = config.BATCH_SIZE.get()
        self._pair = join_type in (JoinType.INNER, JoinType.LEFT,
                                   JoinType.RIGHT, JoinType.FULL)
        # candidate pairs are formed for pair-emitting joins and wherever
        # a filter decides which rows matched
        self._expand = self._pair or join_filter is not None

    def join(self, left: _Side, right: _Side) -> Iterator[pa.RecordBatch]:
        left.pull()
        right.pull()
        while True:
            l_of, r_of = _events(left, right)
            cut, hold = _final(l_of, r_of, left, right)
            yield from self._join_events(left, right, l_of[:cut],
                                         r_of[:cut])
            for side, of in ((left, l_of), (right, r_of)):
                side.drop(int((of[:cut] >= 0).sum()))
            if not hold:
                return
            for side in hold:
                side.pull()

    def _join_events(self, left: _Side, right: _Side, l_of: np.ndarray,
                     r_of: np.ndarray) -> Iterator[pa.RecordBatch]:
        """Final events in slices of at most `auron.batch.size` pairs and
        rows: events costing more than half of it alone, the others
        grouped by where their cost starts in half-batch windows."""
        if not len(l_of):
            return
        na, nb = left.run_rows(l_of), right.run_rows(r_of)
        matched = (l_of >= 0) & (r_of >= 0)
        cost = na + nb + np.where(matched & self._expand, na * nb, 0)
        half = max(1, self._batch_rows // 2)
        big = cost > half
        window = (np.cumsum(cost) - cost) // half
        first = np.ones(len(cost), dtype=bool)
        first[1:] = (window[1:] != window[:-1]) | big[1:] | big[:-1]
        bounds = np.append(np.flatnonzero(first), len(cost))
        for e0, e1 in zip(bounds[:-1], bounds[1:]):
            if big[e0]:
                yield from self._join_large(left, right, int(l_of[e0]),
                                            int(r_of[e0]))
            else:
                yield from self._join_small(left, right, l_of[e0:e1],
                                            r_of[e0:e1])

    def _join_small(self, left: _Side, right: _Side, l_of: np.ndarray,
                    r_of: np.ndarray) -> Iterator[pa.RecordBatch]:
        """Several events at once: their candidate pairs, the filter, the
        rows each emits, ordered by event, then pairs, left rows and right
        rows."""
        def rows_of(side, of):
            ev = np.flatnonzero(of >= 0)
            runs = of[ev]
            if not len(runs):
                return 0, np.zeros(0, dtype=np.int64)
            lens = side.ends[runs] - side.starts[runs]
            return int(side.starts[runs[0]]), np.repeat(ev, lens)
        la, l_ev = rows_of(left, l_of)
        ra, r_ev = rows_of(right, r_of)
        matched = (l_of >= 0) & (r_of >= 0)
        matched_l, matched_r = matched[l_ev], matched[r_ev]
        pe = pl = pr = np.zeros(0, dtype=np.int64)
        m = np.flatnonzero(matched)
        if len(m) and self._expand:
            ls, rs = left.starts[l_of[m]], right.starts[r_of[m]]
            na = left.ends[l_of[m]] - ls
            nb = right.ends[r_of[m]] - rs
            counts = na * nb
            i = np.repeat(np.arange(len(m)), counts)
            t = np.arange(counts.sum()) - np.repeat(
                np.cumsum(counts) - counts, counts)
            pe, pl, pr = m[i], ls[i] + t // nb[i], rs[i] + t % nb[i]
            if self.join_filter is not None:
                keep = self._filter(left, right, pl, pr)
                pe, pl, pr = pe[keep], pl[keep], pr[keep]
                matched_l = np.zeros(len(l_ev), dtype=bool)
                matched_r = np.zeros(len(r_ev), dtype=bool)
                matched_l[pl - la] = True
                matched_r[pr - ra] = True
            if not self._pair:
                pe = pl = pr = np.zeros(0, dtype=np.int64)
        keep_l, keep_r = self._kept(matched_l, matched_r)
        lk, rk = np.flatnonzero(keep_l), np.flatnonzero(keep_r)
        ev = np.concatenate([pe, l_ev[lk], r_ev[rk]])
        section = np.concatenate([np.zeros(len(pe), dtype=np.int8),
                                  np.ones(len(lk), dtype=np.int8),
                                  np.full(len(rk), 2, dtype=np.int8)])
        seq = np.concatenate([np.arange(len(pe)), lk, rk])
        out_l = np.concatenate([pl, la + lk, np.full(len(rk), -1, np.int64)])
        out_r = np.concatenate([pr, np.full(len(lk), -1, np.int64), ra + rk])
        order = np.lexsort((seq, section, ev))
        out_l, out_r = out_l[order], out_r[order]
        exists = (matched_l[out_l - la]
                  if self.join_type == self.JT.EXISTENCE else None)
        yield from self._rows(left, right, out_l, out_r, exists)

    def _join_large(self, left: _Side, right: _Side, li: int, ri: int
                    ) -> Iterator[pa.RecordBatch]:
        """One event alone: its candidate pairs (left rows major) in
        batch-sized pieces, then its left rows, then its right rows."""
        ls, le = (int(left.starts[li]), int(left.ends[li])) if li >= 0 \
            else (0, 0)
        rs, re = (int(right.starts[ri]), int(right.ends[ri])) if ri >= 0 \
            else (0, 0)
        na, nb = le - ls, re - rs
        matched = li >= 0 and ri >= 0
        filtered = matched and self.join_filter is not None
        matched_l = np.full(na, matched and not filtered)
        matched_r = np.full(nb, matched and not filtered)
        bs = self._batch_rows
        if matched and self._expand:
            for t0 in range(0, na * nb, bs):
                t = np.arange(t0, min(t0 + bs, na * nb))
                pl, pr = ls + t // nb, rs + t % nb
                if filtered:
                    keep = self._filter(left, right, pl, pr)
                    pl, pr = pl[keep], pr[keep]
                    matched_l[pl - ls] = True
                    matched_r[pr - rs] = True
                if self._pair:
                    yield from self._rows(left, right, pl, pr, None)
        keep_l, keep_r = self._kept(matched_l, matched_r)
        lk, rk = np.flatnonzero(keep_l), np.flatnonzero(keep_r)
        exists = matched_l if self.join_type == self.JT.EXISTENCE else None
        for off in range(0, len(lk), bs):
            part = lk[off:off + bs]
            yield from self._rows(left, right, ls + part,
                                  np.full(len(part), -1, np.int64),
                                  None if exists is None else exists[part])
        for off in range(0, len(rk), bs):
            part = rk[off:off + bs]
            yield from self._rows(left, right,
                                  np.full(len(part), -1, np.int64),
                                  rs + part, None)

    def _kept(self, matched_l: np.ndarray, matched_r: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
        """The left and right rows a join type emits beside its pairs,
        from whether each matched."""
        JT, jt = self.JT, self.join_type
        if jt == JT.LEFT_SEMI:
            keep_l = matched_l
        elif jt == JT.EXISTENCE:
            keep_l = np.ones(len(matched_l), dtype=bool)
        elif jt in (JT.LEFT_ANTI, JT.LEFT, JT.FULL):
            keep_l = ~matched_l
        else:
            keep_l = np.zeros(len(matched_l), dtype=bool)
        if jt == JT.RIGHT_SEMI:
            keep_r = matched_r
        elif jt in (JT.RIGHT_ANTI, JT.RIGHT, JT.FULL):
            keep_r = ~matched_r
        else:
            keep_r = np.zeros(len(matched_r), dtype=bool)
        return keep_l, keep_r

    def _filter(self, left: _Side, right: _Side, pl: np.ndarray,
                pr: np.ndarray) -> np.ndarray:
        """The join filter's keep mask over candidate pairs, evaluated on
        the joined rows a batch at a time."""
        keep = np.zeros(len(pl), dtype=bool)
        schema = pa.schema([f.to_arrow() for f in self.left_schema] +
                           [f.to_arrow() for f in self.right_schema])
        bs = self._batch_rows
        for off in range(0, len(pl), bs):
            rb = pa.RecordBatch.from_arrays(
                left.take(pl[off:off + bs]) + right.take(pr[off:off + bs]),
                schema=schema)
            cb = ColumnBatch.from_arrow(rb)
            mask = self.join_filter.evaluate(cb).as_mask(cb)
            keep[off:off + bs] = mask.cpu().numpy()[:rb.num_rows]
        return keep

    def _rows(self, left: _Side, right: _Side, out_l: np.ndarray,
              out_r: np.ndarray, exists: Optional[np.ndarray]
              ) -> Iterator[pa.RecordBatch]:
        """The output rows of buffered row pairs (-1: a null row), in
        `auron.batch.size` slices."""
        JT, jt = self.JT, self.join_type
        out_arrow = self.out_schema.to_arrow()
        bs = self._batch_rows
        for off in range(0, len(out_l), bs):
            li, ri = out_l[off:off + bs], out_r[off:off + bs]
            if jt in (JT.LEFT_SEMI, JT.LEFT_ANTI):
                arrays = left.take(li)
            elif jt in (JT.RIGHT_SEMI, JT.RIGHT_ANTI):
                arrays = right.take(ri)
            elif jt == JT.EXISTENCE:
                arrays = left.take(li) + [pa.array(exists[off:off + bs],
                                                   type=pa.bool_())]
            else:
                arrays = left.take(li) + right.take(ri)
            arrays = [a.cast(f.type, safe=False)
                      if not a.type.equals(f.type) else a
                      for a, f in zip(arrays, out_arrow)]
            yield pa.RecordBatch.from_arrays(arrays, schema=out_arrow)
