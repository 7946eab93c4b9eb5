"""Per-file quarantine: the containment layer of the integrity loop
(counterpart of hyperspace_tpu/index/quarantine.py).

An index data file that fails verification (actions/verify.py) or whose
read fails in a query (``Dataset.collect``'s containment) is recorded
here.  The rewrite rules then drop its whole bucket from the index side
and read that bucket's rows from the source (rules/hybrid.py), and
``refresh_index(mode="repair")`` rebuilds exactly the quarantined
buckets and clears their records.

The records live in a ``LogStore`` rooted at
``<indexPath>/_hyperspace_quarantine/``: one key per file, the file's
path relative to the index directory percent-encoded (keys hold no
``/``), the value a small JSON record (reason, size, time).
``put_if_absent`` makes quarantining idempotent between concurrent
discoverers.  The store is of the class ``conf.log_store_class`` names;
keys and records are the JAX package's, so either package reads what the
other quarantined through the same store class.

Under an object store's listing window (``conf.object_store_stale_list_ms``)
a fresh record is not listed yet, so the readers that know which files
can be quarantined (the rules, verify, repair, the daemon and the
vacuum) pass them as ``candidates`` and each is probed by a point read,
which is strongly consistent.  Without a window the listing alone
answers, as in the JAX package.
"""

from __future__ import annotations

import json
import os
import time
import urllib.parse
from typing import Dict, Iterable, List, Optional, Set

from hyperspace_tpu_torch.io.log_store import LogStore, store_from_conf

QUARANTINE_DIR = "_hyperspace_quarantine"


def quarantine_manager_for(conf, index_path: str) -> "QuarantineManager":
    """The quarantine of the index at ``index_path``, in a store of the
    class ``conf.log_store_class`` names."""
    return QuarantineManager(index_path, store_from_conf(
        conf, os.path.join(index_path, QUARANTINE_DIR)))


class QuarantineManager:
    def __init__(self, index_path: str, store: LogStore) -> None:
        self.index_path = os.path.abspath(index_path)
        self.store = store

    def _key(self, file_path: str) -> str:
        rel = os.path.relpath(os.path.abspath(file_path), self.index_path)
        return urllib.parse.quote(rel, safe="")

    def _path_of_key(self, key: str) -> str:
        return os.path.join(self.index_path, urllib.parse.unquote(key))

    def add(self, file_path: str, reason: str,
            size: Optional[int] = None) -> bool:
        """Quarantine ``file_path``; False when it already was (the
        first record stays)."""
        record = {"reason": reason, "ts": time.time()}
        if size is not None:
            record["size"] = int(size)
        payload = json.dumps(record).encode("utf-8")
        return self.store.put_if_absent(self._key(file_path), payload)

    def remove(self, file_path: str) -> None:
        self.store.delete(self._key(file_path))

    def clear(self) -> None:
        for key in self.store.list_keys():
            self.store.delete(key)

    def clear_version(self, version: int,
                      candidates: Iterable[str] = ()) -> None:
        """Drop the records of files under ``v__=<version>/``, so deleting
        a version leaves no orphaned record; ``candidates`` are the
        version's files, for the records a listing window hides."""
        from hyperspace_tpu_torch.index.data_manager import (
            INDEX_VERSION_DIR_PREFIX,
        )

        prefix = f"{INDEX_VERSION_DIR_PREFIX}{version}{os.sep}"
        keys = {k for k in self.store.list_keys()
                if urllib.parse.unquote(k).startswith(prefix)}
        keys.update(self._key(p) for p in self._probed(candidates))
        for key in sorted(keys):
            self.store.delete(key)

    def _keys(self, candidates: Optional[Iterable[str]]) -> List[str]:
        """The listed keys and, under a listing window, those of the
        ``candidates`` a point read finds."""
        keys = set(self.store.list_keys())
        keys.update(self._key(p) for p in self._probed(candidates, keys))
        return sorted(keys)

    def _probed(self, candidates: Optional[Iterable[str]],
                listed: Set[str] = frozenset()) -> List[str]:
        """The unlisted ``candidates`` that are quarantined; none without
        a listing window, where the listing is complete."""
        if candidates is None or self.store.stale_list_s <= 0.0:
            return []
        return [p for p in candidates if self._key(p) not in listed
                and self.store.exists(self._key(p))]

    def paths(self, candidates: Optional[Iterable[str]] = None) -> Set[str]:
        """Absolute paths of every quarantined file (of the listed ones,
        and under a listing window of the ``candidates``)."""
        return {self._path_of_key(k) for k in self._keys(candidates)}

    def records(self, candidates: Optional[Iterable[str]] = None
                ) -> List[Dict]:
        """[{"path": absolute path, "reason": ..., ...}] per file."""
        out: List[Dict] = []
        for key in self._keys(candidates):
            rec: Dict = {"path": self._path_of_key(key)}
            try:
                rec.update(json.loads(self.store.read(key).decode("utf-8")))
            except (FileNotFoundError, ValueError, UnicodeDecodeError):
                rec.setdefault("reason", "unreadable quarantine record")
            out.append(rec)
        return out

    def is_quarantined(self, file_path: str) -> bool:
        return self.store.exists(self._key(file_path))
