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
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple


class TriggerCache:
    """Thread-safe (key → trigger callable) map with hit/miss counters.
    Keys are hashable tuples; values are the callables the codegen
    builders produce.

    Fleet workers read AND populate this concurrently (N tenants share
    one cache), so every access — including ``len``/``in``/``stats`` —
    holds the lock; ``get_or_build`` builds outside it (building is slow)
    and lets the first writer win.  ``capacity`` bounds the entry count
    with LRU eviction (``None`` = unbounded, the default): a multi-tenant
    service over many distinct programs must not grow built-trigger state
    without bound.
    """

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be ≥ 1, got {capacity}")
        self.capacity = capacity
        self._fns: "OrderedDict[Tuple, Callable]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get_or_build(self, key: Tuple, builder: Callable[[], Callable]
                     ) -> Callable:
        """Return the cached callable for ``key``, building (and
        retaining) it on first use."""
        with self._lock:
            fn = self._fns.get(key)
            if fn is not None:
                self.hits += 1
                self._fns.move_to_end(key)
                return fn
        fn = builder()  # build outside the lock: compiling the IR is slow
        with self._lock:
            won = self._fns.setdefault(key, fn)
            self._fns.move_to_end(key)
            if won is fn:
                self.misses += 1
                self._evict_over_capacity()
            else:
                self.hits += 1
        return won

    def _evict_over_capacity(self) -> None:
        # caller holds the lock
        while self.capacity is not None and len(self._fns) > self.capacity:
            self._fns.popitem(last=False)
            self.evictions += 1

    def evict(self, key: Tuple) -> bool:
        """Drop one entry (e.g. a retired tenant's program); True if it
        was present.  The callable itself stays valid for holders — only
        future lookups rebuild."""
        with self._lock:
            return self._fns.pop(key, None) is not None

    def __len__(self) -> int:
        with self._lock:
            return len(self._fns)

    def __contains__(self, key: Tuple) -> bool:
        with self._lock:
            return key in self._fns

    def clear(self) -> None:
        with self._lock:
            self._fns.clear()
            self.hits = 0
            self.misses = 0
            self.evictions = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._fns), "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}


_GLOBAL = TriggerCache()


def global_trigger_cache() -> TriggerCache:
    """The process-wide cache engines share by default."""
    return _GLOBAL


def mesh_cache_key(mesh, axis: Optional[str] = None) -> Optional[Tuple]:
    """Hashable identity of a mesh (a ``torch.distributed``
    ``DeviceMesh``) for trigger-cache keying: ``None`` without one.

    The mesh's shape by axis name, the row axis, the device type and the
    ranks in order, as the reference keys on device ids in order: a
    sharded firing is pinned to that placement, so two meshes of one
    shape over other ranks (or a permutation) must not share entries,
    and two meshes over the same ranks do."""
    if mesh is None:
        return None
    names = tuple(mesh.mesh_dim_names)
    return (tuple(zip(names, (int(s) for s in mesh.shape))),
            axis or names[0], mesh.device_type,
            tuple(int(r) for r in mesh.mesh.flatten().tolist()))
