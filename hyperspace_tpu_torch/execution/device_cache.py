"""Device-resident index columns: upload a column once, serve every
repeat query from card memory (counterpart of
hyperspace_tpu/execution/device_cache.py).

A process-wide, byte-budgeted LRU of POST-DECODE device tensors (what
``io.columnar.to_device_numeric`` gives, already on the card), keyed by
``(device, files_fingerprint, column, kind)``.  The fingerprint hashes a
scan's resolved file list with each file's size and mtime, so an
overwritten, refreshed or compacted index can never serve stale
columns: its fingerprint differs, and the dead entries age out.  The
device is in the key because the port's sessions each carry their own
device: a ``cpu`` and a ``cuda`` session can share a process, and a hit
never returns a tensor on another device than the asking session's.

Residency changes ROUTING, not only speed: once every column an
operation reads is resident, the executor compares its rows with
``conf.resident_min_rows(kind)`` instead of the cold threshold
``conf.device_min_rows(kind)``.  Population policy
(``conf.device_cache_policy``):

  - ``auto`` (default): cache whenever the device path runs anyway.
  - ``eager``: route eligible scans to the device on first use even
    where the cold threshold would keep them on the host, so repeats
    are served from card memory; a column the budget rejected stops
    lowering the threshold (see ``ByteBudgetLRU.was_rejected``).
  - ``off``: never cache.

Cached tensors are shared by every later query: no consumer may write
into one (the query ops only read their inputs and gather from them).
The cache also feeds the process metrics registry (telemetry/metrics.py):
``cache.device.hits``, ``.misses`` and ``.evictions`` counters and the
``cache.device.bytes`` gauge, from which the registry derives
``cache.device.hit_ratio``.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterable, Optional, Tuple

# (device, files fingerprint, column name, kind)
Key = Tuple[str, str, str, str]


def files_fingerprint(paths: Iterable[str]) -> Optional[str]:
    """Content identity of a resolved scan file list: the paths in order,
    each with its size and mtime_ns.  None when a file cannot be stat-ed
    (a race with vacuum: better not to cache than to key on a guess)."""
    h = hashlib.md5()
    try:
        for p in paths:
            st = os.stat(p)
            h.update(p.encode())
            h.update(f":{st.st_size}:{st.st_mtime_ns};".encode())
    except OSError:
        return None
    return h.hexdigest()


class ByteBudgetLRU:
    """Thread-safe LRU within an explicit byte budget: the least recently
    used entries are evicted to make room, an entry larger than the whole
    budget is rejected and its key tombstoned."""

    _REJECTED_MAX = 4096  # bound the tombstone set; clear it on overflow

    def __init__(self, metric_prefix: Optional[str] = None) -> None:
        self._entries: "OrderedDict[object, object]" = OrderedDict()
        self._nbytes: Dict[object, int] = {}
        # Keys whose values did not fit the budget: a caller that routes
        # by residency (the eager policy) must stop retrying them, or
        # every repeat pays the full upload forever.
        self._rejected: set = set()
        self._lock = threading.Lock()
        # Counters and the bytes gauge go to the metrics registry under
        # this prefix, when set.
        self._prefix = metric_prefix
        self.bytes_cached = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _inc(self, name: str) -> None:
        if self._prefix is not None:
            from hyperspace_tpu_torch.telemetry import metrics

            metrics.inc(f"{self._prefix}.{name}")

    def get(self, key):
        with self._lock:
            value = self._entries.get(key)
            if value is None:
                self.misses += 1
                self._inc("misses")
                return None
            self._entries.move_to_end(key)
            self.hits += 1
            self._inc("hits")
            return value

    def contains(self, key) -> bool:
        """Presence, without hit/miss accounting."""
        with self._lock:
            return key in self._entries

    def peek(self, key):
        """The value without hit/miss accounting or a recency update."""
        with self._lock:
            return self._entries.get(key)

    def was_rejected(self, key) -> bool:
        with self._lock:
            return key in self._rejected

    def put(self, key, value, nbytes: int, budget_bytes: int) -> bool:
        """Insert ``value`` accounted at ``nbytes``, evicting LRU entries
        to stay within ``budget_bytes``.  False (and the key tombstoned)
        when the entry can never fit."""
        nbytes = int(nbytes or 0)
        if nbytes <= 0 or nbytes > budget_bytes:
            with self._lock:
                if len(self._rejected) >= self._REJECTED_MAX:
                    self._rejected.clear()
                self._rejected.add(key)
            return False
        with self._lock:
            if key in self._entries:
                self._entries.move_to_end(key)
                return True
            while self.bytes_cached + nbytes > budget_bytes and self._entries:
                old_key, _old = self._entries.popitem(last=False)
                self.bytes_cached -= self._nbytes.pop(old_key)
                self.evictions += 1
                self._inc("evictions")
            self._entries[key] = value
            self._nbytes[key] = nbytes
            self.bytes_cached += nbytes
            if self._prefix is not None:
                from hyperspace_tpu_torch.telemetry import metrics

                metrics.set_gauge(f"{self._prefix}.bytes", self.bytes_cached)
        return True

    def pop(self, key) -> None:
        """Drop one entry (invalidation) and its tombstone."""
        with self._lock:
            if key in self._entries:
                del self._entries[key]
                self.bytes_cached -= self._nbytes.pop(key)
            self._rejected.discard(key)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._nbytes.clear()
            self._rejected.clear()
            self.bytes_cached = 0

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions,
                    "rejected": len(self._rejected),
                    "entries": len(self._entries),
                    "bytes": self.bytes_cached}


class DeviceColumnCache(ByteBudgetLRU):
    """The LRU of device tensors; an entry costs its tensor's bytes."""

    def __init__(self) -> None:
        super().__init__(metric_prefix="cache.device")

    def put(self, key: Key, tensor, budget_bytes: int) -> bool:  # type: ignore[override]
        return super().put(key, tensor,
                           tensor.numel() * tensor.element_size(),
                           budget_bytes)


# One cache per process: device memory is a process-wide resource, and the
# keys are content-based (and name the device), so sessions share entries.
_CACHE = DeviceColumnCache()


def global_cache() -> DeviceColumnCache:
    return _CACHE
