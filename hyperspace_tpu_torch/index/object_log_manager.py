"""The operation log over a store without atomic rename (counterpart of
hyperspace_tpu/index/object_log_manager.py).

``IndexLogManager`` needs two POSIX guarantees: an ``O_EXCL`` create for
numbered entries and an atomic rename for the ``latestStable`` pointer.
An object store offers per-key generations and conditional puts
instead, and this manager builds the same protocol from them, as Delta
Lake's log does:

  - a numbered entry commits with ``put_if_absent``: exactly one writer
    wins an id, decided by the store;
  - ``latestStable`` moves by a generation compare-and-swap: read the
    pointer and its generation, then ``put_if_generation_match``.  A
    lost swap reads again; a pointer that already names a stable entry
    with an id at least ours wins outright, so the pointer only moves
    forward.  At most ``_CAS_ATTEMPTS`` rounds: past them the pointer
    stays behind, which the reverse scan of ``get_latest_stable_log``
    absorbs (the numbered entries are the truth, the pointer a cache);
  - a listing may lag the puts (the store's window), so ``get_latest_id``
    and ``log_ids`` take it as a hint and probe forward by point reads,
    which are strongly consistent, to the first missing id.  A stale id
    collides at ``put_if_absent`` and the transaction loop rebases.

A torn put (the store accepted half the payload) burns its id: every
reader skips it, and the next entry takes the following id.  Every
store call runs under the conf's retry policy (``retry``).  The store
class is ``conf.log_store_class``, its window
``conf.object_store_stale_list_ms``, read in ``configure``; the layout
(keys ``<id>`` and ``latestStable`` under ``<index>/_hyperspace_log``,
with the store's ``.g`` sidecars) is the JAX package's.
"""

from __future__ import annotations

import json
import os
import random
import time
from typing import List, Optional

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.index.log_manager import (
    HYPERSPACE_LOG_DIR,
    LATEST_STABLE,
    IndexLogManager,
    _refuse_hypothetical,
)
from hyperspace_tpu_torch.io.log_store import LogStore

# Rounds of the pointer's compare-and-swap: each lost round means another
# writer moved the pointer between our read and our swap.
_CAS_ATTEMPTS = 16


class ObjectStoreLogManager(IndexLogManager):
    """``IndexLogManager`` over a ``LogStore``.  The constructor takes
    the index path only; the collection manager passes the conf to
    ``configure`` after it."""

    store_class: str = "hyperspace_tpu_torch.io.log_store.EmulatedObjectStore"
    stale_list_s: float = 0.0

    def __init__(self, index_path: str) -> None:
        super().__init__(index_path)
        self._store: Optional[LogStore] = None

    def configure(self, conf) -> None:
        self.store_class = conf.log_store_class
        self.stale_list_s = float(conf.object_store_stale_list_ms) / 1000.0

    @property
    def store(self) -> LogStore:
        if self._store is None:
            from hyperspace_tpu_torch.utils.reflection import load_class

            cls = load_class(self.store_class, LogStore, HyperspaceError)
            self._store = cls(os.path.join(self.index_path,
                                           HYPERSPACE_LOG_DIR),
                              stale_list_s=self.stale_list_s)
        return self._store

    @staticmethod
    def _parse(data: Optional[bytes]) -> Optional[IndexLogEntry]:
        """None for an absent key and for a torn or corrupt payload."""
        if data is None:
            return None
        try:
            return IndexLogEntry.from_dict(json.loads(data.decode("utf-8")))
        except (ValueError, KeyError, UnicodeDecodeError):
            return None

    def get_log(self, log_id: int) -> Optional[IndexLogEntry]:
        def attempt() -> Optional[IndexLogEntry]:
            try:
                return self._parse(self.store.read(str(log_id)))
            except FileNotFoundError:
                return None

        return self.retry.call(attempt)

    def _probe_past(self, latest: Optional[int]) -> Optional[int]:
        """Point reads past ``latest`` to the first missing id.  Ids are
        contiguous, but an action never writes id 0: an empty hint probes
        from 0 and then from 1 before the log counts as empty."""
        starts = [0, 1] if latest is None else [latest + 1]
        for start in starts:
            probe = start
            while self.store.exists(str(probe)):
                latest = probe
                probe += 1
            if latest is not None:
                break
        return latest

    def get_latest_id(self) -> Optional[int]:
        def attempt() -> Optional[int]:
            ids = [int(k) for k in self.store.list_keys() if k.isdigit()]
            return self._probe_past(max(ids) if ids else None)

        return self.retry.call(attempt)

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        def read_pointer() -> Optional[IndexLogEntry]:
            try:
                return self._parse(self.store.read(LATEST_STABLE))
            except FileNotFoundError:
                return None

        entry = self.retry.call(read_pointer)
        if entry is not None and entry.state in States.STABLE:
            return entry
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            entry = self.get_log(log_id)
            if entry is not None and entry.state in States.STABLE:
                return entry
        return None

    def log_ids(self) -> List[int]:
        def attempt() -> List[int]:
            ids = {int(k) for k in self.store.list_keys() if k.isdigit()}
            # The ids a stale listing hides, by point reads.
            latest = self._probe_past(max(ids) if ids else None)
            if latest is not None:
                ids.update(i for i in range(latest + 1)
                           if i in ids or self.store.exists(str(i)))
            return sorted(ids)

        return self.retry.call(attempt)

    def write_log(self, log_id: int, entry: IndexLogEntry) -> bool:
        _refuse_hypothetical(entry)
        entry.id = log_id
        payload = json.dumps(entry.to_dict(), indent=2).encode("utf-8")
        return self.retry.call(
            lambda: self.store.put_if_absent(str(log_id), payload))

    def create_latest_stable_log(self, log_id: int) -> bool:
        """Point ``latestStable`` at entry ``log_id`` by compare-and-swap.
        The pointer only moves to a stable entry whose id is at least its
        current one; a torn pointer is overwritten (the generation check
        keeps that safe against racers)."""
        try:
            payload = self.retry.call(lambda: self.store.read(str(log_id)))
        except FileNotFoundError:
            return False
        rng = random.Random()
        for attempt in range(_CAS_ATTEMPTS):
            cur, gen = self.retry.call(
                lambda: self.store.read_with_generation(LATEST_STABLE))
            cur_entry = self._parse(cur)
            if cur_entry is not None and cur_entry.state in States.STABLE \
                    and (cur_entry.id or 0) >= log_id:
                return True  # a newer stable pointer already won
            if self.retry.call(lambda: self.store.put_if_generation_match(
                    LATEST_STABLE, payload, gen)):
                return True
            time.sleep(self.retry.delay_s(min(attempt, 4), rng))
        return False

    def delete_latest_stable_log(self) -> bool:
        """A no-op: every caller sets the pointer again at once, and the
        swap in ``create_latest_stable_log`` replaces it with no window
        in which the pointer is absent."""
        return True
