"""The spill tiers: a host-RAM tier and a disk-file tier (port of
blaze_tpu/memory/spill.py).

A Spill stores one run of Arrow record batches written through the port's
framed IPC writer (shuffle/ipc.py `IpcCompressionWriter`, the codec of
`io.compression.codec`), so a spilled run holds the JAX package's bytes
for the same batches and shuffle files and spill files share one reader.

  * `HostMemSpill` keeps the framed bytes in host RAM (the reference's
    on-heap tier); the live bytes of every RAM-tier run are counted in
    `_host_spill_bytes` (`_host_spill_account`);
  * `FileSpill` writes them to a temporary file;
  * `try_new_spill` takes the RAM tier while its live bytes stay under
    `auron.onHeapSpill.memoryFraction` of the memory manager's budget,
    then disk; a host engine's spill factory (`set_host_spill_factory`)
    goes first, and its `HostSpillUnavailable` hands over to the local
    tiers.  No caller installs a factory until the host callbacks are
    ported (ROADMAP item 16).

Both tiers count the runs they write in `SPILL_TIERS` (`ram`, `file`).
"""

from __future__ import annotations

import io
import os
import tempfile
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import pyarrow as pa

from blaze_tpu_torch import config

#: runs written, by tier, since the process started
SPILL_TIERS = {"ram": 0, "file": 0}


@dataclass
class SpillMetrics:
    spill_count: int = 0
    spilled_bytes: int = 0        # in-memory bytes released
    spilled_file_bytes: int = 0   # on disk


class Spill:
    """One spilled run of record batches."""

    def write_batches(self, batches: Iterator[pa.RecordBatch]) -> int:
        raise NotImplementedError

    def read_batches(self) -> Iterator[pa.RecordBatch]:
        raise NotImplementedError

    def release(self) -> None:
        pass

    @property
    def stored_bytes(self) -> int:
        raise NotImplementedError


_host_spill_bytes = 0  # live RAM-tier bytes across all spills
_host_spill_lock = threading.Lock()


def _host_spill_account(delta: int) -> None:
    global _host_spill_bytes
    with _host_spill_lock:
        _host_spill_bytes = max(0, _host_spill_bytes + delta)


def _read_run(source) -> Iterator[pa.RecordBatch]:
    from blaze_tpu_torch.shuffle.ipc import IpcCompressionReader
    return IpcCompressionReader(source).read_batches()


def _write_run(sink, batches) -> int:
    # imported here: the shuffle package imports this one
    from blaze_tpu_torch.shuffle.ipc import IpcCompressionWriter
    w = IpcCompressionWriter(sink)
    n = 0
    for b in batches:
        n += w.write_batch(b)
    w.finish()
    return n


class HostMemSpill(Spill):
    """The RAM tier: the run's framed IPC bytes in host memory."""

    def __init__(self):
        self._buf: Optional[bytes] = None

    def write_batches(self, batches) -> int:
        sink = io.BytesIO()
        n = _write_run(sink, batches)
        self._buf = sink.getvalue()
        _host_spill_account(len(self._buf))
        SPILL_TIERS["ram"] += 1
        return n

    def read_batches(self):
        assert self._buf is not None
        yield from _read_run(io.BytesIO(self._buf))

    def release(self):
        if self._buf is not None:
            _host_spill_account(-len(self._buf))
        self._buf = None

    @property
    def stored_bytes(self) -> int:
        return len(self._buf) if self._buf else 0


class FileSpill(Spill):
    """The disk tier: the run's framed IPC bytes in a temporary file."""

    def __init__(self, dir: Optional[str] = None):
        fd, self.path = tempfile.mkstemp(prefix="blaze-spill-",
                                         suffix=".spill", dir=dir)
        os.close(fd)

    def write_batches(self, batches) -> int:
        with open(self.path, "wb") as f:
            n = _write_run(f, batches)
        SPILL_TIERS["file"] += 1
        return n

    def read_batches(self):
        with open(self.path, "rb") as f:
            yield from _read_run(f)

    def release(self):
        try:
            os.unlink(self.path)
        except OSError:
            pass

    @property
    def stored_bytes(self) -> int:
        try:
            return os.path.getsize(self.path)
        except OSError:
            return 0


class HostSpillUnavailable(RuntimeError):
    """The host engine declined a spill allocation; the local tiers take
    over.  Any other exception of the host factory propagates."""


#: the host engine's spill factory, or None
_host_spill_factory = None


def set_host_spill_factory(factory) -> None:
    global _host_spill_factory
    _host_spill_factory = factory


def try_new_spill(prefer_host: bool = True,
                  host_mem_available: Optional[bool] = None) -> Spill:
    """A new spill: the host engine's where it offers one, else the RAM
    tier while the live RAM-tier bytes stay under
    `auron.onHeapSpill.memoryFraction` of the manager's budget, else a
    file."""
    factory = _host_spill_factory
    if factory is not None and prefer_host:
        try:
            return factory()
        except HostSpillUnavailable:
            pass
    if host_mem_available is None:
        if prefer_host:
            from blaze_tpu_torch.memory.manager import MemManager
            cap = (MemManager.get().total *
                   config.ON_HEAP_SPILL_MEMORY_FRACTION.get())
            host_mem_available = _host_spill_bytes < cap
        else:
            host_mem_available = False
    return HostMemSpill() if host_mem_available else FileSpill()
