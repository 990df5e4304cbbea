"""The port's device, from the `auron.torch.device` conf key.

`resolve()` is the one place that turns the key into a `torch.device`.
Asking for CUDA where `torch.cuda.is_available()` is False raises: nothing
carries on quietly on the CPU.  The CPU tests set the key to `"cpu"`.
"""

from __future__ import annotations

import threading

import torch

from blaze_tpu_torch import config


def resolve() -> torch.device:
    """The configured device; raises when it is a CUDA device and no card
    is visible."""
    name = str(config.TORCH_DEVICE.get()).strip().lower() or "cuda"
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"auron.torch.device={name!r} but torch.cuda.is_available() is "
            f"False; set auron.torch.device=cpu to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"auron.torch.device={name!r}: expected cuda or cpu")
    return dev


def private_stream(dev: torch.device):
    """A new CUDA stream of the caller's alone (csrc/streams.cu), as a
    `torch.cuda.ExternalStream`.  `torch.cuda.Stream()` does not make one:
    it hands out the next of PyTorch's shared pool, round robin, which a
    scan's stager or another caller may hold too.  It is never destroyed
    (`lease_stream` reuses it)."""
    import ctypes

    from blaze_tpu_torch.kernels import build
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    handle = ctypes.c_void_p()
    build.check(build.bound("streams", "blaze_stream_create")(
        index, ctypes.byref(handle)), "cudaStreamCreateWithFlags")
    return torch.cuda.ExternalStream(handle.value,
                                     device=torch.device("cuda", index))


_streams_lock = threading.Lock()
_free_streams: dict = {}  # device index -> private streams not leased


def lease_stream(dev: torch.device):
    """A private stream for the caller alone until `release_stream`: a
    released one of the device, else a new one.  The query service leases
    one for each query it runs."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    with _streams_lock:
        free = _free_streams.get(key)
        if free:
            return free.pop()
    return private_stream(torch.device("cuda", key))


def release_stream(stream) -> None:
    """Hand a leased stream back; work still queued on it orders before
    the next lessee's, by the stream's own order."""
    with _streams_lock:
        _free_streams.setdefault(stream.device.index, []).append(stream)


_capture_streams: dict = {}


def capture_stream(dev: torch.device):
    """The device's side stream for graph captures: private, made once,
    and used only under `CAPTURE_LOCK`, so no other work is ever queued
    on it while a capture runs."""
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    with CAPTURE_LOCK:
        stream = _capture_streams.get(key)
        if stream is None:
            stream = _capture_streams[key] = private_stream(
                torch.device("cuda", key))
        return stream


#: Every CUDA graph the port captures (the stage loop's, runtime/loop.py;
#: the expression programs', exprs/program.py) is captured in the
#: thread-local error mode: the capturing thread raises on anything it
#: cannot capture (a sync, an allocation outside the graph's pool, a
#: pageable copy), and every OTHER thread (a prefetch worker, another
#: query's slot in the query service) may allocate, copy, wait on events
#: and synchronise its own streams while the capture runs; a device-wide
#: synchronisation (`torch.cuda.synchronize()`) is the one call that
#: fails beside a capture and breaks it in any mode
#: (itest/capture_modes.py), so the port's library code makes none.
#: A capture runs on `capture_stream`, a private stream no query issues
#: on.  This lock still serialises, process-wide: (1) the captures, each
#: with its eager warm-up, so no two run at once (the expression programs
#: share one graph memory pool per device, which two concurrent captures
#: must not allocate from, and all capture on the one side stream); and
#: (2) the expression programs' replays, which share that pool and each
#: program's static input and output buffers (exprs/program.py).  Nothing
#: else takes it.
CAPTURE_LOCK = threading.RLock()
