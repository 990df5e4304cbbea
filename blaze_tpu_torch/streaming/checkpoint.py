"""Checkpoint manifests of the streaming runtime (port of
blaze_tpu/streaming/checkpoint.py).

One JSON manifest a committed epoch (``ckpt-NNNNNN.json``): the
per-partition source offsets the NEXT epoch reads from, the watermark
clock, the window-state snapshot and the sink attempt the epoch made.  The
commit is FIRST-WINS and atomic: the manifest is written under a temporary
name and ``os.link``ed into place, so a replayed epoch racing its own
earlier attempt never publishes twice.  Recovery reads the highest
committed manifest and restores everything from it; an uncommitted epoch
left no manifest, so its records replay from the previous offsets.

The fault site ``checkpoint-commit`` fires BEFORE the link: a crash
between the sink attempt and the commit, the window where an
at-least-once system emits twice and this design must not.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from blaze_tpu_torch import faults

_PREFIX = "ckpt-"
_SUFFIX = ".json"


def fsync_dir(path: str) -> None:
    """Make a just-linked or renamed directory entry survive power loss:
    the entry lives in the parent directory's metadata, which needs its
    own fsync.  Best effort: some filesystems refuse directory fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


class CheckpointManager:
    """The manifest directory of one streaming query (one writer; a
    crash-versus-replay race is settled by the first-wins link)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, epoch: int) -> str:
        return os.path.join(self.dir, f"{_PREFIX}{epoch:06d}{_SUFFIX}")

    def committed(self, epoch: int) -> bool:
        return os.path.exists(self._path(epoch))

    def commit(self, epoch: int, manifest: dict) -> bool:
        """First-wins commit of one epoch's manifest.  True if this call
        published it, False if the epoch was already committed (a replay:
        the caller discards its side effects)."""
        faults.maybe_fail("checkpoint-commit", epoch=epoch)
        path = self._path(epoch)
        if os.path.exists(path):
            return False
        payload = json.dumps({"epoch": epoch, **manifest},
                             sort_keys=True).encode("utf-8")
        tmp = f"{path}.a{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        try:
            os.link(tmp, path)  # atomic and exclusive: the first one wins
        except FileExistsError:
            return False
        finally:
            try:
                os.unlink(tmp)
            except OSError:
                pass
        fsync_dir(self.dir)  # the manifest's directory entry too
        from blaze_tpu_torch.bridge import device_stats
        device_stats.note_stream_checkpoint(len(payload))
        return True

    def load(self, epoch: int) -> dict:
        with open(self._path(epoch), "rb") as f:
            return json.loads(f.read().decode("utf-8"))

    def epochs(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith(_PREFIX) and name.endswith(_SUFFIX):
                try:
                    out.append(int(name[len(_PREFIX):-len(_SUFFIX)]))
                except ValueError:
                    pass
        return sorted(out)

    def latest(self) -> Optional[Tuple[int, dict]]:
        """The highest committed epoch and its manifest (the recovery
        point), or None before the first commit."""
        epochs = self.epochs()
        if not epochs:
            return None
        e = epochs[-1]
        return e, self.load(e)

    @staticmethod
    def offsets_from(manifest: dict) -> Dict[int, int]:
        return {int(p): int(o)
                for p, o in (manifest.get("offsets") or {}).items()}
