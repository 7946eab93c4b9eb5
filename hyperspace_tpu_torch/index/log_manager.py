"""Append-only, id-numbered JSON operation log with optimistic concurrency
(counterpart of hyperspace_tpu/index/log_manager.py).

  - the log lives under ``<indexPath>/_hyperspace_log/<id>``, one JSON
    file per id;
  - ``write_log(id, entry)`` fails if the id already exists: multi-writer
    safety comes from exactly this create-if-absent write;
  - ``latestStable`` is a copy of the newest entry whose state is stable,
    with ``get_latest_stable_log`` falling back to a reverse scan.

The failure envelope (io/faults.py, utils/retry.py):

  - transient IO errors of a write, the pointer's rename and the id
    listing retry under ``retry`` (bounded, jittered backoff);
  - a torn or corrupt entry (a writer died mid-write) is skipped by every
    reader, never repaired in place; its id stays burned;
  - a crash on either side of the pointer's rename leaves the old
    pointer, no pointer or the new one, and all three resolve (the
    numbered entries are the truth, the pointer a cache).

A hypothetical entry (the advisor's what-if, advisor/hypothetical.py) is
refused at the write.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional

from hyperspace_tpu_torch.exceptions import (
    ConcurrentWriteError,
    HyperspaceError,
)
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.io import faults
from hyperspace_tpu_torch.io.files import list_dir
from hyperspace_tpu_torch.utils.retry import RetryPolicy

HYPERSPACE_LOG_DIR = "_hyperspace_log"
LATEST_STABLE = "latestStable"


def _refuse_hypothetical(entry: IndexLogEntry) -> None:
    """What-if entries have no data files: persisting one would make later
    queries trust an index that cannot serve a row."""
    if entry.is_hypothetical:
        raise HyperspaceError(
            f"Refusing to persist hypothetical index entry "
            f"{entry.name!r}: what-if entries are never written to the "
            f"operation log")


class IndexLogManager:
    """Manages the operation log of one index."""

    # The transient-IO budget; the collection manager sets it from the
    # session conf on each instance.
    retry: RetryPolicy = RetryPolicy()

    def __init__(self, index_path: str) -> None:
        self.index_path = index_path
        self.log_dir = os.path.join(index_path, HYPERSPACE_LOG_DIR)

    def configure(self, conf) -> None:
        """Hook run after construction with the session conf; the POSIX
        log reads nothing from it."""

    @staticmethod
    def _read(path: str) -> Optional[IndexLogEntry]:
        try:
            with open(path, "r", encoding="utf-8") as f:
                return IndexLogEntry.from_dict(json.load(f))
        except FileNotFoundError:
            return None
        except (ValueError, KeyError):
            return None  # torn/corrupt entry

    def get_log(self, log_id: int) -> Optional[IndexLogEntry]:
        """Entry ``log_id``, or None when missing or torn."""
        return self._read(os.path.join(self.log_dir, str(log_id)))

    def get_latest_id(self) -> Optional[int]:
        """Highest id present; torn entries count (their id is burned)."""
        ids = self.log_ids()
        return ids[-1] if ids else None

    def get_latest_log(self) -> Optional[IndexLogEntry]:
        """Newest parseable entry."""
        latest = self.get_latest_id()
        if latest is None:
            return None
        for log_id in range(latest, -1, -1):
            entry = self.get_log(log_id)
            if entry is not None:
                return entry
        return None

    def get_latest_stable_log(self) -> Optional[IndexLogEntry]:
        """The latestStable pointer if valid, else a reverse scan."""
        entry = self._read(os.path.join(self.log_dir, LATEST_STABLE))
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

    def write_log(self, log_id: int, entry: IndexLogEntry) -> bool:
        """Atomically create log file ``log_id``; False if it exists.  A
        transient error retries: each failed attempt unlinks its partial
        file first, so the create-if-absent probe stays honest; a crash
        leaves it (the torn state the readers survive)."""
        _refuse_hypothetical(entry)
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, str(log_id))
        entry.id = log_id
        payload = json.dumps(entry.to_dict(), indent=2).encode("utf-8")

        def attempt() -> bool:
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                return False
            try:
                with os.fdopen(fd, "wb") as f:
                    faults.write_payload(f, payload, "log.write")
                    f.flush()
                    os.fsync(f.fileno())
            except faults.InjectedCrash:
                raise  # a real crash runs no cleanup
            except BaseException:
                os.unlink(path)
                raise
            return True

        return self.retry.call(attempt)

    def write_log_or_raise(self, log_id: int, entry: IndexLogEntry) -> None:
        if not self.write_log(log_id, entry):
            raise ConcurrentWriteError(
                f"Log id {log_id} for index at {self.index_path!r} was "
                "committed by a concurrent writer")

    def create_latest_stable_log(self, log_id: int) -> bool:
        """Copy entry ``log_id`` to the latestStable pointer (tmp + atomic
        rename through the ``log.rename`` site)."""
        src = os.path.join(self.log_dir, str(log_id))
        if not os.path.isfile(src):
            return False
        dst = os.path.join(self.log_dir, LATEST_STABLE)
        tmp = dst + ".tmp"

        def attempt() -> bool:
            with open(src, "rb") as f_in, open(tmp, "wb") as f_out:
                f_out.write(f_in.read())
                f_out.flush()
                os.fsync(f_out.fileno())
            faults.atomic_replace(tmp, dst, "log.rename")
            return True

        return self.retry.call(attempt)

    def delete_latest_stable_log(self) -> bool:
        try:
            os.unlink(os.path.join(self.log_dir, LATEST_STABLE))
        except FileNotFoundError:
            pass
        return True

    def log_ids(self) -> List[int]:
        """Every numbered id present, ascending, listed under ``retry``."""
        return sorted(int(n) for n in list_dir(self.log_dir, self.retry)
                      if n.isdigit())
