"""Which CUDA call of another thread breaks a graph capture, by capture
error mode (on the card).

For each capture error mode (`thread_local`, the port's; `global`,
PyTorch's default) and each kind of call a second query thread makes
(an allocation of a size the caching allocator has not cached, a
copy to the host with `.item()`, an event record, wait and query, a
stream synchronisation, each on its own stream; a kernel and an `.item()`
on the legacy default stream; a device-wide synchronisation; a pinned
host allocation; a copy from pinned memory), one process captures a
body of 3,000 small kernels on a side stream over and over for up to
3 s while a second thread makes that call in a loop, and prints one
JSON line: the captures that succeeded and failed, the first capture
error, the other thread's rounds and its error.  Each pair runs in a
process of its own, since a failed capture leaves the caching
allocator's capture state behind.

    python -m blaze_tpu_torch.itest.capture_modes            # all pairs
    python -m blaze_tpu_torch.itest.capture_modes item_legacy thread_local
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

CALLS = ("malloc_own", "item_own", "event_own", "streamsync_own",
         "kernel_legacy", "item_legacy", "device_sync", "pinned_alloc",
         "copy_pinned_own", "none")
MODES = ("thread_local", "global")
BODY_KERNELS = 3000
SECONDS = 3.0


def _call(kind: str, k: int, own, dev) -> None:
    """One round of the other thread's calls of `kind`."""
    import torch
    if kind == "malloc_own":
        with torch.cuda.stream(own):
            t = torch.empty((8 << 20) + k * 4096, dtype=torch.uint8,
                            device=dev)
            del t
    elif kind == "item_own":
        with torch.cuda.stream(own):
            float(torch.ones(16, device=dev).sum().item())
    elif kind == "event_own":
        with torch.cuda.stream(own):
            torch.ones(16, device=dev).mul_(2)
            ev = torch.cuda.Event()
            ev.record(own)
            ev.synchronize()
            ev.query()
    elif kind == "streamsync_own":
        with torch.cuda.stream(own):
            torch.ones(16, device=dev).mul_(2)
            own.synchronize()
    elif kind == "kernel_legacy":
        torch.ones(16, device=dev).mul_(3)
    elif kind == "item_legacy":
        float(torch.ones(16, device=dev).sum().item())
    elif kind == "device_sync":
        torch.cuda.synchronize()
    elif kind == "pinned_alloc":
        t = torch.empty((1 << 20) + k * 4096, dtype=torch.uint8,
                        pin_memory=True)
        del t
    elif kind == "copy_pinned_own":
        p = torch.empty(1 << 20, dtype=torch.uint8, pin_memory=True)
        with torch.cuda.stream(own):
            p.to(dev, non_blocking=True)
            own.synchronize()


def probe(kind: str, mode: str) -> dict:
    import torch
    dev = torch.device("cuda")
    x = torch.zeros(1 << 16, device=dev)
    torch.cuda.synchronize()
    stop, busy = threading.Event(), threading.Event()
    other = {"rounds": 0, "error": None}

    def loop():
        own = torch.cuda.Stream(dev)
        k = 0
        try:
            while not stop.is_set():
                k += 1
                _call(kind, k, own, dev)
                other["rounds"] += 1
                busy.set()
        except BaseException as e:  # noqa: BLE001 - reported
            other["error"] = repr(e)[:300]
            busy.set()

    t = threading.Thread(target=loop)
    t.start()
    busy.wait(30)
    ok, errors = 0, []
    t0 = time.monotonic()
    while time.monotonic() - t0 < SECONDS and not errors:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                graph.capture_begin(capture_error_mode=mode)
                try:
                    for _ in range(BODY_KERNELS):
                        x.add_(1)
                finally:
                    graph.capture_end()
            ok += 1
        except BaseException as e:  # noqa: BLE001 - reported
            errors.append(repr(e)[:200])
        torch.cuda.current_stream(dev).wait_stream(side)
    stop.set()
    t.join(30)
    return {"call": kind, "mode": mode, "captures_ok": ok,
            "captures_failed": len(errors), "capture_error":
            errors[0] if errors else None, "other_rounds": other["rounds"],
            "other_error": other["error"]}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) == 2:
        print(json.dumps(probe(*argv)))
        return 0
    for mode in MODES:
        for kind in CALLS:
            try:
                out = subprocess.run(
                    [sys.executable, "-m", "blaze_tpu_torch.itest."
                     "capture_modes", kind, mode], capture_output=True,
                    text=True, timeout=120)
                line = (out.stdout.strip().splitlines() or ["{}"])[-1]
                if out.returncode:
                    line = json.dumps({"call": kind, "mode": mode,
                                       "rc": out.returncode,
                                       "stderr": out.stderr[-300:]})
            except subprocess.TimeoutExpired:
                line = json.dumps({"call": kind, "mode": mode,
                                   "timeout": True})
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
