"""Process-wide resource map.

Copy of blaze_tpu/bridge/resource.py, with `created_scope`, which lets
a stage scheduler remove the broadcast build maps its run added.  Parity: the JVM resource map the native side pulls shuffle-read block
iterators, broadcast byte arrays and cached build-side hash maps from
(ref: auron-core/.../jni/JniBridge.java getResource/putResource statics;
consumed at ipc_reader_exec.rs:144 and broadcast_join_exec.rs build-map
caching).  Values are arbitrary Python objects; `remove=True` gets preserve
the reference's take-once semantics for streaming resources.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

_lock = threading.Lock()
_map: Dict[str, Any] = {}
_resolvers: Dict[str, Callable[[str], Any]] = {}


def put_resource(key: str, value: Any) -> None:
    with _lock:
        _map[key] = value


def get_resource(key: str, remove: bool = False) -> Optional[Any]:
    with _lock:
        if remove:
            found = _map.pop(key, None)
        else:
            found = _map.get(key)
        resolvers = list(_resolvers.items()) if found is None else ()
    if found is not None:
        return found
    # prefix resolvers let the host engine lazily materialize resources
    # (e.g. udf://<name> through the C-ABI udf_eval callback)
    for prefix, factory in resolvers:
        if key.startswith(prefix):
            return factory(key)
    return None


def register_resolver(prefix: str, factory: Callable[[str], Any]) -> None:
    """Lazy fallback for keys under `prefix` not present in the map."""
    with _lock:
        _resolvers[prefix] = factory


def unregister_resolver(prefix: str) -> None:
    with _lock:
        _resolvers.pop(prefix, None)


_created = threading.local()


class created_scope:
    """`with created_scope() as keys:` lists the keys `get_or_create`
    adds on this thread inside the block (a stage scheduler's run, whose
    broadcast build maps it removes at its cleanup: in a long-lived
    process the reference's cache would keep every query's)."""

    def __init__(self):
        self._prev = None
        self.keys: list = []

    def __enter__(self) -> list:
        self._prev = getattr(_created, "keys", None)
        _created.keys = self.keys
        return self.keys

    def __exit__(self, *exc):
        _created.keys = self._prev
        return False


def get_or_create(key: str, factory: Callable[[], Any]) -> Any:
    """Cache for shared build artifacts (broadcast hash maps).

    The factory runs OUTSIDE the lock: building one broadcast map may
    recursively build another (nested broadcast joins), and holding the
    non-reentrant lock across the factory self-deadlocks.  Two racing
    threads may both build; setdefault keeps exactly one.  A key this
    call adds is listed in the thread's `created_scope`, if any."""
    with _lock:
        if key in _map:
            return _map[key]
    value = factory()
    with _lock:
        if key in _map:
            return _map[key]
        _map[key] = value
    keys = getattr(_created, "keys", None)
    if keys is not None:
        keys.append(key)
    return value


def remove_resource(key: str) -> None:
    with _lock:
        _map.pop(key, None)


def clear_resources(prefix: str = "") -> None:
    with _lock:
        if not prefix:
            _map.clear()
        else:
            for k in [k for k in _map if k.startswith(prefix)]:
                del _map[k]
