"""Persistent compiled-trigger cache: a second engine over a structurally
identical program reuses the first engine's trigger callables.

A trigger fn is a pure function of (program fingerprint, trigger kind,
input, bucket rank, plan partition, device, compile options) — none of it
engine-local: the port's fns close over the trigger IR, the dims binding
and the device, and hold no view state.  So the callable can outlive the
``IncrementalEngine`` that first built it.  The cache stores callables
under exactly that key: a second engine over the same program at the
same sizes, on the same device, executing the same plan, gets the *same*
function object back and rebuilds nothing.

The reference keys on the JAX backend options (``apply_backend``,
``jit``, ``donate``) so that a jitted executable is reused; the port has
none of them, and carries the device (type and index) in their place: a
CPU engine and a card engine never share an entry.

Process-level: engines use the process-global instance whenever they
execute a plan; pass ``trigger_cache=TriggerCache()`` for an isolated
one (tests).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Tuple


class TriggerCache:
    """Thread-safe (key → trigger callable) map with hit/miss counters.
    Keys are hashable tuples; values are the callables the codegen
    builders produce.  Every access holds the lock; ``get_or_build``
    builds outside it (building is slow) and lets the first writer win.
    """

    def __init__(self):
        self._fns: Dict[Tuple, Callable] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get_or_build(self, key: Tuple, builder: Callable[[], Callable]
                     ) -> Callable:
        """Return the cached callable for ``key``, building (and
        retaining) it on first use."""
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self.hits += 1
                return fn
        fn = builder()  # build outside the lock: compiling the IR is slow
        with self._lock:
            won = self._fns.setdefault(key, fn)
            if won is fn:
                self.misses += 1
            else:
                self.hits += 1
        return won

    def __len__(self) -> int:
        with self._lock:
            return len(self._fns)


_GLOBAL = TriggerCache()


def global_trigger_cache() -> TriggerCache:
    """The process-wide cache engines share by default."""
    return _GLOBAL


def mesh_cache_key(mesh, axis: Optional[str] = None) -> Optional[Tuple]:
    """Hashable identity of a mesh for trigger-cache keying: ``None``
    without one.  The port has no sharded engine yet, so a mesh has
    nothing to key and is refused (ROADMAP.md Queue 1 item 12, dist/)."""
    if mesh is None:
        return None
    raise NotImplementedError(
        "mesh_cache_key: the port has no sharded engine yet (ROADMAP.md "
        "Queue 1 item 12, dist/)")
