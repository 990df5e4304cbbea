"""Build and load the hand-written CUDA kernels under `csrc/` (and the
host-only CRC32C of the shuffle frames, `csrc/crc32c.cu`, and private
streams, `csrc/streams.cu`).

Each source is compiled by `nvcc` for `sm_90a` into its own shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds).  Builds happen at first use, never at import, into
`build/kernels/` at the root of the checkout; the library name carries a
digest of its source, so an edited source is rebuilt.  `build_all` starts
one `nvcc` per source, all at once.  A missing toolchain or a failed build
raises: there is no fallback to the plain PyTorch versions.

Each nvcc build counts in bridge/device_stats.py `compile_report` (under
`nvcc:<library>`, with its wall nanoseconds) and emits a `kernel_build`
trace instant; a library found built counts as a cache hit.

Binding happens once: `load` sets every entry point's `restype` and
`argtypes` from `SIGNATURES` when it first opens a library, and `bound`
hands wrappers the bound function from a module-level cache, so a launch
takes no lock and sets no argument types.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

from blaze_tpu_torch.bridge import device_stats, tracing

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

#: kernel library name -> its source file under csrc/
SOURCES = {
    "hash_update": "hash_update.cu",
    "radix": "radix.cu",
    "window_table": "window_table.cu",
    "crc32c": "crc32c.cu",
    "segment_sum": "segment_sum.cu",
    "streams": "streams.cu",
}

_P, _I = ctypes.c_void_p, ctypes.c_int
#: library -> entry point -> (restype, argtypes); every pointer and the
#: stream are c_void_p, so ctypes never cuts a 64-bit address
SIGNATURES: Dict[str, Dict[str, Tuple[object, list]]] = {
    "hash_update": {
        # h, limbs, mask, used, tab, out, scratch, slots, n, S, L, rounds,
        # h_is64, rollback, stream
        "blaze_place_in_carry": (_I, [_P] * 7 + [_I] * 7 + [_P]),
        # slots, rounds -> cells of the scratch buffer
        "blaze_place_scratch_cells": (ctypes.c_longlong, [_I] * 2),
    },
    "radix": {
        # pid, part, slot, order, counts, state, agg, n, P, capacity,
        # sentinel, parity, stream
        "blaze_radix_partition": (_I, [_P] * 7 + [_I] * 5 + [_P]),
        # cells of the state buffer
        "blaze_radix_state_cells": (ctypes.c_longlong, []),
        "blaze_radix_tile_rows": (_I, []),
    },
    "window_table": {
        # the StepParams block in host memory, stream
        "blaze_window_step": (_I, [_P, _P]),
    },
    "segment_sum": {
        # form, ids, ids_is64, order, values, valid, out, scratch, n, S,
        # short_max, is_f64, stream
        "blaze_segment_sum": (_I, [_I, _P, _I] + [_P] * 5
                              + [ctypes.c_longlong] * 2 + [_I, _I, _P]),
        # out, x, y, n, is_f64, stream: the dependent-add probe
        "blaze_add_chain": (_I, [_P, ctypes.c_double, ctypes.c_double,
                                 ctypes.c_longlong, _I, _P]),
    },
    "crc32c": {
        # data (bytes), n, crc -> crc
        "blaze_crc32c": (ctypes.c_uint32, [ctypes.c_char_p,
                                           ctypes.c_longlong,
                                           ctypes.c_uint32]),
    },
    "streams": {
        # device, out handle
        "blaze_stream_create": (_I, [_I, ctypes.POINTER(_P)]),
    },
}

ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_bound: Dict[Tuple[str, str], Callable] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                       "CUDA kernels of blaze_tpu_torch cannot be built")


def library_path(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile every (or each named) kernel library that is not built yet,
    one nvcc process per source, all started together.  Returns
    {name: {"seconds": wall time, "log": compiler stderr}}; raises
    RuntimeError naming the source when any build fails."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    report: Dict[str, dict] = {}
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        _stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        report[name] = {"seconds": seconds, "log": stderr}
        device_stats.note_compile(f"nvcc:{name}", int(seconds * 1e9))
        tracing.instant("kernel_build", kernel=name, ns=int(seconds * 1e9))
        if proc.returncode != 0:
            failures.append(f"{SOURCES[name]} (nvcc rc={proc.returncode}):\n"
                            f"{stderr}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, building it first if needed; its
    entry points' types are set from `SIGNATURES` as it is opened."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if path.exists():
            device_stats.note_compile_hit(f"nvcc:{name}")
        else:
            build_all([name])
        lib = ctypes.CDLL(str(path))
        for fn_name, (restype, argtypes) in SIGNATURES[name].items():
            fn = getattr(lib, fn_name)
            fn.restype = restype
            fn.argtypes = argtypes
        _libs[name] = lib
        return lib


def bound(name: str, fn_name: str) -> Callable:
    """One entry point of a kernel library, typed and cached: after the
    first call this is a dict lookup."""
    fn = _bound.get((name, fn_name))
    if fn is None:
        fn = _bound.setdefault((name, fn_name), getattr(load(name), fn_name))
    return fn


def stream_of(device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device."""
    import torch
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None and device.index is not None:
        return raw(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, what: str) -> None:
    """Raise on a nonzero cudaGetLastError() returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")
