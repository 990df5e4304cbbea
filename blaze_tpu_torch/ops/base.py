"""Execution operator base, the standard meter, the IO prefetcher and
the batch-coalescing stream (port of blaze_tpu/ops/base.py).

Execution model: synchronous pull iterators of ColumnBatch per partition.
Every subclass's `execute`/`arrow_batches` is wrapped at class creation
with the standard meter (`output_rows`, `output_batches`,
`elapsed_compute_ns`, a cooperative `check_running` at each step, an
`operator:*` span at the end of a stream).  The meter adds no device
synchronisation: a batch's row count comes from `num_rows`, from its
cached selected count, or, for a selection on the card whose count
nobody has read, from a device scalar the node resolves when its metrics
are read (`MetricNode.add_pending`).

`PrefetchIterator` runs a host-IO stream (the scan's decode and its
batch's one host-to-device copy, the shuffle reader's block reads and
decode) on a bounded background worker, so the next batch's IO overlaps
the current batch's compute.
"""

from __future__ import annotations

import functools
import queue
import threading
import time
from typing import Callable, Iterator, List, Optional, Sequence

from blaze_tpu_torch import config
from blaze_tpu_torch.batch import ColumnBatch, bucket_capacity
from blaze_tpu_torch.bridge.context import current_task
from blaze_tpu_torch.bridge.metrics import BASELINE_METRICS, MetricNode
from blaze_tpu_torch.schema import Schema

BatchIterator = Iterator[ColumnBatch]

# Per-thread set of operator-instance ids currently inside a metered
# stream.  Several operators route execute() through their own
# arrow_batches() (or the reverse); the guard lets the inner self-call
# pass through unmetered so rows and time are not counted twice.
_metering = threading.local()


def _active_ids() -> set:
    ids = getattr(_metering, "ids", None)
    if ids is None:
        ids = _metering.ids = set()
    return ids


def _count_rows(item, metrics: MetricNode) -> None:
    """Add `item`'s surviving rows to `output_rows` without a sync: a
    ColumnBatch whose selection lives on the card and whose count was
    never read adds a device scalar, resolved when the metrics are."""
    sel = getattr(item, "selection", None)
    if sel is None or not isinstance(item, ColumnBatch):
        metrics.add("output_rows", getattr(item, "num_rows", 0))
        return
    cached = getattr(item, "_sel_count", None)
    if cached is not None or sel.device.type == "cpu":
        metrics.add("output_rows", item.selected_count())
        return
    import torch
    metrics.add_pending("output_rows",
                        torch.count_nonzero(sel[:item.num_rows]))


class _MeteredIter:
    """Wraps an operator's batch stream: per-next() wall time goes to
    `elapsed_compute_ns` (inclusive of the child pull), rows and batches
    are counted per yield.  Metrics accumulate as the stream goes, so a
    downstream early stop (LimitExec) still records the partial work."""

    __slots__ = ("_it", "_plan", "_key", "_partition", "_kind",
                 "_total_ns", "_done")

    def __init__(self, it, plan, key, partition, kind, setup_ns):
        self._it = iter(it)
        self._plan = plan
        self._key = key
        self._partition = partition
        self._kind = kind
        self._total_ns = setup_ns
        self._done = False

    def __iter__(self):
        return self

    def __next__(self):
        active = _active_ids()
        reenter = self._key in active
        if not reenter:
            # cooperative cancellation at every metered batch step
            current_task().check_running()
            active.add(self._key)
        t0 = time.perf_counter_ns()
        try:
            item = next(self._it)
        except StopIteration:
            self._finish()
            raise
        finally:
            dt = time.perf_counter_ns() - t0
            self._plan.metrics.add("elapsed_compute_ns", dt)
            self._total_ns += dt
            if not reenter:
                active.discard(self._key)
        m = self._plan.metrics
        m.add("output_batches")
        _count_rows(item, m)
        return item

    def close(self):
        """Close the wrapped stream (a prefetcher joins its worker)."""
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    def _finish(self):
        if self._done:
            return
        self._done = True
        from blaze_tpu_torch.bridge import tracing
        if tracing.enabled():
            # the rows resolved so far: resolving a device count here
            # would make the span synchronise to close itself
            tracing.emit_span(
                f"operator:{type(self._plan).__name__}",
                self._total_ns, partition=self._partition,
                kind=self._kind,
                rows=self._plan.metrics.values.get("output_rows", 0))


def _meter_stream(fn, kind: str):
    """Wrap a subclass's execute/arrow_batches with the standard meter."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        active = _active_ids()
        key = id(self)
        if key in active:  # inner self-call (execute <-> arrow_batches)
            return fn(self, *args, **kwargs)
        partition = args[0] if args else kwargs.get("partition", 0)
        active.add(key)
        t0 = time.perf_counter_ns()
        try:
            # the eager call runs under the meter: IpcWriterExec does all
            # its work here and returns an empty iterator
            it = fn(self, *args, **kwargs)
        finally:
            setup_ns = time.perf_counter_ns() - t0
            active.discard(key)
        self.metrics.add("elapsed_compute_ns", setup_ns)
        return _MeteredIter(it, self, key, partition, kind, setup_ns)

    wrapper._blaze_metered = True
    wrapper._blaze_wraps = fn
    return wrapper


class _Raised:
    """A worker-side exception in transit to the consumer."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_DONE = object()


class _Channel:
    """What the prefetch worker shares with its consumer.  The worker
    holds this, never the PrefetchIterator, so a consumer that drops the
    iterator early (a LimitExec above a scan) lets it be collected, and
    its `__del__` stops and joins the worker."""

    __slots__ = ("source", "transform", "queue", "stop", "ctx", "stream")

    def __init__(self, source, transform, depth, ctx):
        self.source = source
        self.transform = transform
        self.queue = queue.Queue(maxsize=depth)
        self.stop = threading.Event()
        self.ctx = ctx
        # the consumer's current CUDA stream (a query service slot's own),
        # which the worker makes its current stream too; None before any
        # CUDA work, when both are the default stream
        import torch
        self.stream = (torch.cuda.current_stream()
                       if torch.cuda.is_initialized() else None)

    def put(self, item) -> bool:
        while not self.stop.is_set():
            try:
                self.queue.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False


def _work(ch: _Channel) -> None:
    import contextlib

    import torch
    from blaze_tpu_torch.bridge.context import task_scope
    try:
        # the worker re-enters the consumer's TaskContext (cancellation
        # checks and task-scoped state are thread-local) and its stream:
        # whatever CUDA work the source or the transform issue here is
        # ordered before the consumer's use of the batch
        with task_scope(ch.ctx), (
                torch.cuda.stream(ch.stream) if ch.stream is not None
                else contextlib.nullcontext()):
            for item in ch.source:
                if ch.transform is not None:
                    item = ch.transform(item)
                if not ch.put(item):
                    return  # closed under us
        ch.put(_DONE)
    except BaseException as exc:
        ch.put(_Raised(exc))
    finally:
        close = getattr(ch.source, "close", None)
        if close is not None:
            try:
                close()
            except BaseException:
                pass


class PrefetchIterator:
    """Bounded-depth background prefetch of a batch stream, at host-IO
    edges (parquet row-group decode with the batch's host-to-device copy,
    shuffle IPC block reads and decode).  One worker thread pulls
    `source`, applies `transform`, and fills a bounded queue.

    Contract (the reference's):
      * order preserved (one worker, FIFO queue);
      * a source or transform exception is re-raised at the consumer, in
        position, after every item produced before it;
      * close() stops AND joins the worker, and is called on early
        downstream termination (from __del__ at the latest);
      * depth <= 0, or the `auron.tpu.io.prefetch` kill-switch off, is a
        synchronous passthrough (no thread).
    """

    def __init__(self, source, depth: Optional[int] = None,
                 transform: Optional[Callable] = None,
                 name: str = "prefetch"):
        if depth is None:
            depth = (config.IO_PREFETCH_DEPTH.get()
                     if config.IO_PREFETCH_ENABLE.get() else 0)
        self._transform = transform
        self._done = False
        if depth <= 0:
            self._source = iter(source)
            self._ch = None
            self._thread = None
            return
        self._ch = _Channel(iter(source), transform, depth, current_task())
        self._thread = threading.Thread(
            target=_work, args=(self._ch,), name=f"blaze-prefetch-{name}",
            daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._ch is None:  # synchronous passthrough
            item = next(self._source)
            return (self._transform(item) if self._transform is not None
                    else item)
        if self._done:
            raise StopIteration
        from blaze_tpu_torch.bridge import device_stats
        t0 = time.perf_counter_ns()
        item = self._ch.queue.get()
        device_stats.note_prefetch(wait_ns=time.perf_counter_ns() - t0)
        if item is _DONE:
            self._done = True
            self._thread.join(timeout=10)
            raise StopIteration
        if isinstance(item, _Raised):
            self._done = True
            self._thread.join(timeout=10)
            raise item.exc
        device_stats.note_prefetch(batches=1)
        return item

    def close(self):
        """Stop and join the worker, draining the queue so a blocked put
        returns.  Idempotent; safe after exhaustion."""
        if self._ch is None or self._done:
            self._done = True
            return
        self._done = True
        self._ch.stop.set()
        while True:
            try:
                self._ch.queue.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)

    def __del__(self):
        try:
            self.close()
        except BaseException:
            pass


def prefetch(source, depth: Optional[int] = None,
             transform: Optional[Callable] = None,
             name: str = "prefetch"):
    """Wrap a host-IO stream with the bounded background prefetcher (see
    PrefetchIterator); the stream's items and order are unchanged."""
    return PrefetchIterator(source, depth=depth, transform=transform,
                            name=name)


class ExecutionPlan:
    """One physical operator node.

    Every subclass's `execute`/`arrow_batches` override is wrapped at
    class creation with the standard meter, so all operators report the
    BASELINE_METRICS vocabulary without bookkeeping of their own;
    operator code adds only extras (pruned_row_groups, cuda_batches,
    ...)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for attr in ("execute", "arrow_batches"):
            fn = cls.__dict__.get(attr)
            if fn is not None and callable(fn) and \
                    not getattr(fn, "_blaze_metered", False):
                setattr(cls, attr, _meter_stream(fn, attr))

    def __init__(self, children: Sequence["ExecutionPlan"] = ()):
        self._children: List[ExecutionPlan] = list(children)
        self.metrics = MetricNode(name=type(self).__name__)
        for m in BASELINE_METRICS:
            self.metrics.values.setdefault(m, 0)

    @property
    def children(self) -> List["ExecutionPlan"]:
        return self._children

    @property
    def schema(self) -> Schema:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        """Output partition count."""
        if self._children:
            return self._children[0].num_partitions
        return 1

    @property
    def reexecutable(self) -> bool:
        """Whether execute(partition) can be called again from scratch
        (the port's sources are file-backed: yes).  The device stage loop
        (plan/stage_compiler.py) admits only stages whose source is
        re-executable, because its wholesale fallback re-runs the
        partition through the staged path.  A one-shot stream overrides
        this to False."""
        if self._children:
            return all(c.reexecutable for c in self._children)
        return True

    def execute(self, partition: int) -> BatchIterator:
        """Pull-stream of batches for one partition."""
        raise NotImplementedError

    def arrow_batches(self, partition: int):
        """Pull-stream of Arrow record batches (compacted, non-empty)."""
        for cb in self.execute(partition):
            cb = cb.compact()
            if cb.num_rows:
                yield cb.to_arrow()

    def execute_collect(self) -> ColumnBatch:
        """Every partition's batches, concatenated (the local mode's and
        the tests' collector)."""
        out = []
        for p in range(self.num_partitions):
            out.extend(self.execute(p))
        if not out:
            import pyarrow as pa
            return ColumnBatch.from_arrow(pa.Table.from_batches(
                [], schema=self.schema.to_arrow()))
        return ColumnBatch.concat(out)

    def collect_metrics(self) -> MetricNode:
        self.metrics.resolve()
        node = MetricNode(name=type(self).__name__,
                          values=dict(self.metrics.values))
        node.children = [c.collect_metrics() for c in self._children]
        return node

    def __repr__(self):
        head = type(self).__name__
        if not self._children:
            return head
        inner = ", ".join(repr(c) for c in self._children)
        return f"{head}({inner})"

    def pretty(self, indent: int = 0) -> str:
        """The tree, one operator class a line, two spaces a level (the
        text the plan-stability goldens hold)."""
        lines = ["  " * indent + type(self).__name__]
        for c in self._children:
            lines.append(c.pretty(indent + 1))
        return "\n".join(lines)


def effective_batch_size(base: Optional[int] = None) -> int:
    """The coalesce target under the active query's degradation ladder
    (serving/context.py): each `shrink-capacity` rung halves it (floor
    256 rows), so a quota-breaching query re-batches smaller and retains
    less state."""
    from blaze_tpu_torch.bridge.context import active_query
    size = base or config.BATCH_SIZE.get()
    q = active_query()
    if q is not None:
        shrink = getattr(q, "capacity_shrink", 0)
        if shrink:
            size = max(256, size >> shrink)
    return size


class CoalesceStream:
    """Re-batches a stream to ~batch_size dense rows, compacting batches
    whose surviving-row density is below `min_density` (same rules as the
    JAX package, so batch boundaries match).  The target is
    `effective_batch_size`, read again at every batch, so a degradation
    rung takes effect at the next batch."""

    def __init__(self, stream: BatchIterator, batch_size: Optional[int] = None,
                 min_density: float = 0.5,
                 metrics: Optional[MetricNode] = None):
        self._stream = stream
        self._batch_size = batch_size or config.BATCH_SIZE.get()
        self._min_density = min_density
        self._metrics = metrics or MetricNode()

    def __iter__(self) -> BatchIterator:
        staged: List[ColumnBatch] = []
        staged_rows = 0
        ctx = current_task()
        for batch in self._stream:
            ctx.check_running()
            target = effective_batch_size(self._batch_size)
            n = batch.selected_count()
            if n == 0:
                continue
            density = n / max(1, batch.capacity)
            if density < self._min_density:
                batch = batch.compact()
            if n >= target // 2 and not staged:
                yield batch
                continue
            staged.append(batch)
            staged_rows += n
            if staged_rows >= target:
                yield ColumnBatch.concat(staged,
                                         bucket_capacity(staged_rows))
                staged, staged_rows = [], 0
        if staged:
            yield ColumnBatch.concat(staged, bucket_capacity(staged_rows))
