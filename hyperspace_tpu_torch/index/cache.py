"""The listing cache: the latest stable entries, cached for
``conf.cache_expiry_seconds`` and cleared by every lifecycle verb, so a
session always sees its own writes (counterpart of
hyperspace_tpu/index/cache.py).  ``session.index_collection_manager``
returns a ``CachingIndexCollectionManager``; the cache lives on the
session."""

from __future__ import annotations

import time
from typing import List, Optional

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.manager import IndexCollectionManager


class CreationTimeBasedCache:
    """One cached listing and the time it was made."""

    def __init__(self) -> None:
        self._entries: Optional[List[IndexLogEntry]] = None
        self._created_at = 0.0

    def get(self, expiry_seconds: float) -> Optional[List[IndexLogEntry]]:
        if self._entries is None:
            return None
        if time.monotonic() - self._created_at > expiry_seconds:
            return None
        return self._entries

    def set(self, entries: List[IndexLogEntry]) -> None:
        self._entries = entries
        self._created_at = time.monotonic()

    def clear(self) -> None:
        self._entries = None


class CachingIndexCollectionManager(IndexCollectionManager):
    """An ``IndexCollectionManager`` whose ``get_indexes`` serves from the
    session's cache; each lifecycle verb clears it before and after."""

    def __init__(self, session) -> None:
        super().__init__(session)
        if not hasattr(session, "_index_entry_cache"):
            session._index_entry_cache = CreationTimeBasedCache()
        self._cache: CreationTimeBasedCache = session._index_entry_cache

    def get_indexes(self, states=None) -> List[IndexLogEntry]:
        cached = self._cache.get(self.session.conf.cache_expiry_seconds)
        if cached is None:
            cached = super().get_indexes(None)
            # A degraded listing is never cached: it would hide a
            # repaired log for the TTL, and keep strict mode from raising.
            if not self.last_listing_degraded:
                self._cache.set(cached)
        if states is None:
            return list(cached)
        return [e for e in cached if e.state in states]

    def clear_cache(self) -> None:
        self._cache.clear()

    def _cleared(self, verb, *args):
        self.clear_cache()
        try:
            return verb(*args)
        finally:
            self.clear_cache()

    def create(self, dataset, config) -> None:
        self._cleared(super().create, dataset, config)

    def delete(self, name: str) -> None:
        self._cleared(super().delete, name)

    def restore(self, name: str) -> None:
        self._cleared(super().restore, name)

    def vacuum(self, name: str) -> None:
        self._cleared(super().vacuum, name)

    def cancel(self, name: str) -> None:
        self._cleared(super().cancel, name)

    def refresh(self, name: str, mode: str = "full"):
        return self._cleared(super().refresh, name, mode)

    def optimize(self, name: str, mode: str = "quick"):
        return self._cleared(super().optimize, name, mode)
