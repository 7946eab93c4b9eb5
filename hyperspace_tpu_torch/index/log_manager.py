"""Append-only, id-numbered JSON operation log with optimistic concurrency
(counterpart of hyperspace_tpu/index/log_manager.py).

  - the log lives under ``<indexPath>/_hyperspace_log/<id>``, one JSON
    file per id;
  - ``write_log(id, entry)`` fails if the id already exists: multi-writer
    safety comes from exactly this create-if-absent write;
  - ``latestStable`` is a copy of the newest entry whose state is stable,
    with ``get_latest_stable_log`` falling back to a reverse scan;
  - a torn or corrupt entry (a writer died mid-write) is skipped by every
    reader; its id stays burned.
"""

from __future__ import annotations

import json
import os
from typing import Optional

from hyperspace_tpu_torch.exceptions import ConcurrentWriteError
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.io.files import list_dir

HYPERSPACE_LOG_DIR = "_hyperspace_log"
LATEST_STABLE = "latestStable"


class IndexLogManager:
    """Manages the operation log of one index."""

    def __init__(self, index_path: str) -> None:
        self.index_path = index_path
        self.log_dir = os.path.join(index_path, HYPERSPACE_LOG_DIR)

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
        ids = [int(n) for n in list_dir(self.log_dir) if n.isdigit()]
        return max(ids) if ids else None

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
        """Atomically create log file ``log_id``; False if it exists."""
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, str(log_id))
        entry.id = log_id
        payload = json.dumps(entry.to_dict(), indent=2).encode("utf-8")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
        except BaseException:
            os.unlink(path)
            raise
        return True

    def write_log_or_raise(self, log_id: int, entry: IndexLogEntry) -> None:
        if not self.write_log(log_id, entry):
            raise ConcurrentWriteError(
                f"Log id {log_id} for index at {self.index_path!r} was "
                "committed by a concurrent writer")

    def create_latest_stable_log(self, log_id: int) -> bool:
        """Copy entry ``log_id`` to the latestStable pointer (tmp + atomic
        rename)."""
        src = os.path.join(self.log_dir, str(log_id))
        if not os.path.isfile(src):
            return False
        dst = os.path.join(self.log_dir, LATEST_STABLE)
        tmp = dst + ".tmp"
        with open(src, "rb") as f_in, open(tmp, "wb") as f_out:
            f_out.write(f_in.read())
            f_out.flush()
            os.fsync(f_out.fileno())
        os.replace(tmp, dst)
        return True

    def delete_latest_stable_log(self) -> None:
        try:
            os.unlink(os.path.join(self.log_dir, LATEST_STABLE))
        except FileNotFoundError:
            pass
