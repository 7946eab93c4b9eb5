"""The Delta transaction log (counterpart of
hyperspace_tpu/sources/delta/log.py): read and write ``_delta_log``.

A Delta table is a directory of Parquet data files and an ordered log of
JSON commits under ``_delta_log/``; the files of version N are the replay
of the add and remove actions through commit N.  This module speaks the
open protocol (20-digit zero-padded ``N.json`` commits of one action
object per line, ``N.checkpoint.parquet`` and ``_last_checkpoint``), so
it reads tables other Delta writers made as well as its own.

``snapshot(version)`` replays from the newest checkpoint at or below the
version and raises when a commit between them is missing; a file's
``modification_time`` is the add action's ``modificationTime`` (ms),
never the file's stat.  Removed files stay as tombstones until a
checkpoint drops the expired ones.  A torn commit or checkpoint raises
``CorruptMetadataError`` naming the file.  ``write_commit`` creates a
commit exclusively: of two writers racing for one version, one wins.
pyarrow is imported inside the checkpoint reader only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import urllib.parse
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.exceptions import CorruptMetadataError

DELTA_LOG_DIR = "_delta_log"
_COMMIT_RE = re.compile(r"^(\d{20})\.json$")
_CHECKPOINT_RE = re.compile(r"^(\d{20})\.checkpoint\.parquet$")


@dataclasses.dataclass(frozen=True)
class AddFile:
    """One data file of a snapshot (absolute path)."""

    path: str
    size: int
    modification_time: int  # ms, from the log


@dataclasses.dataclass(frozen=True)
class RemoveFile:
    """The tombstone of a removed data file (absolute path): kept until
    the retention window expires, so a reader of an older version still
    resolves the file."""

    path: str
    deletion_timestamp: int  # ms


@dataclasses.dataclass
class DeltaMetadata:
    schema_string: str = ""
    partition_columns: List[str] = dataclasses.field(default_factory=list)
    configuration: Dict[str, str] = dataclasses.field(default_factory=dict)
    id: str = ""  # the table's stable id; a schema change keeps it


@dataclasses.dataclass
class Snapshot:
    version: int
    files: List[AddFile]
    metadata: DeltaMetadata
    tombstones: List[RemoveFile] = dataclasses.field(default_factory=list)


class DeltaLog:
    """The ``_delta_log`` of one table."""

    def __init__(self, table_path: str) -> None:
        self.table_path = os.path.abspath(table_path)
        self.log_path = os.path.join(self.table_path, DELTA_LOG_DIR)

    def exists(self) -> bool:
        return os.path.isdir(self.log_path) and bool(
            self.commit_versions() or self.checkpoint_versions())

    def _versions(self, pattern: re.Pattern) -> List[int]:
        if not os.path.isdir(self.log_path):
            return []
        return sorted(int(m.group(1)) for name in os.listdir(self.log_path)
                      if (m := pattern.match(name)))

    def commit_versions(self) -> List[int]:
        return self._versions(_COMMIT_RE)

    def checkpoint_versions(self) -> List[int]:
        return self._versions(_CHECKPOINT_RE)

    def latest_version(self) -> int:
        versions = self.commit_versions() + self.checkpoint_versions()
        if not versions:
            raise FileNotFoundError(f"Not a Delta table: {self.table_path}")
        return max(versions)

    def version_for_timestamp(self, timestamp_ms: int) -> int:
        """The latest version committed at or before ``timestamp_ms``
        (how ``timestampAsOf`` resolves)."""
        best: Optional[int] = None
        for v in self.commit_versions():
            ts = self._commit_timestamp(v)
            if ts is not None and ts > timestamp_ms:
                break  # commit timestamps are monotonic
            if ts is not None:
                best = v
        if best is None:
            raise ValueError(
                f"No commit at or before timestamp {timestamp_ms} in "
                f"{self.table_path}")
        return best

    def _commit_timestamp(self, version: int) -> Optional[int]:
        """The commit's ``commitInfo.timestamp``, else its file's mtime;
        None for a commit a checkpoint superseded."""
        path = self._commit_path(version)
        if not os.path.isfile(path):
            return None
        for action in self._commit_actions(version):
            info = action.get("commitInfo")
            if info and "timestamp" in info:
                return int(info["timestamp"])
        return int(os.stat(path).st_mtime * 1000)

    def snapshot(self, version: Optional[int] = None) -> Snapshot:
        latest = self.latest_version()
        if version is None:
            version = latest
        if version > latest or version < 0:
            raise ValueError(
                f"Version {version} does not exist in {self.table_path} "
                f"(latest is {latest})")
        active: Dict[str, AddFile] = {}
        tombstones: Dict[str, RemoveFile] = {}
        metadata = DeltaMetadata()
        start = 0
        usable = [c for c in self.checkpoint_versions() if c <= version]
        if usable:
            metadata, active, tombstones = self._read_checkpoint(usable[-1])
            start = usable[-1] + 1
        commits = [v for v in self.commit_versions() if start <= v <= version]
        expect = list(range(start, version + 1))
        if commits != expect:
            missing = sorted(set(expect) - set(commits))
            raise ValueError(
                f"Delta log is missing commits {missing} for version "
                f"{version} of {self.table_path}")
        for v in commits:
            for action in self._commit_actions(v):
                self._apply(action, active, metadata, tombstones)
        return Snapshot(version, sorted(active.values(), key=lambda f: f.path),
                        metadata,
                        sorted(tombstones.values(), key=lambda f: f.path))

    def _apply(self, action: Dict[str, Any], active: Dict[str, AddFile],
               metadata: DeltaMetadata,
               tombstones: Dict[str, RemoveFile]) -> None:
        if action.get("add"):
            a = action["add"]
            path = self._absolute(a["path"])
            active[path] = AddFile(path, int(a["size"]),
                                   int(a.get("modificationTime", 0)))
            tombstones.pop(path, None)
        elif action.get("remove"):
            r = action["remove"]
            path = self._absolute(r["path"])
            active.pop(path, None)
            tombstones[path] = RemoveFile(
                path, int(r.get("deletionTimestamp") or 0))
        elif action.get("metaData"):
            m = action["metaData"]
            metadata.schema_string = m.get("schemaString", "")
            metadata.partition_columns = list(m.get("partitionColumns", []))
            metadata.configuration = dict(m.get("configuration", {}))
            metadata.id = m.get("id", "")

    def _absolute(self, path: str) -> str:
        path = urllib.parse.unquote(path)
        if os.path.isabs(path):
            return path
        return os.path.join(self.table_path, path)

    def _commit_path(self, version: int) -> str:
        return os.path.join(self.log_path, f"{version:020d}.json")

    def _commit_actions(self, version: int) -> List[Dict[str, Any]]:
        path = self._commit_path(version)
        out: List[Dict[str, Any]] = []
        with open(path, "r", encoding="utf-8") as f:
            for lineno, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError as e:
                    raise CorruptMetadataError(
                        f"Truncated or corrupt Delta log entry {path!r} "
                        f"(action line {lineno}): {e}") from e
        return out

    def _read_checkpoint(self, version: int):
        import pyarrow as pa

        from hyperspace_tpu_torch.io.parquet import read_parquet_file

        path = os.path.join(self.log_path,
                            f"{version:020d}.checkpoint.parquet")
        try:
            table = read_parquet_file(path, None)
        except pa.ArrowInvalid as e:
            raise CorruptMetadataError(
                f"Truncated or corrupt Delta checkpoint {path!r}: {e}") from e
        metadata = DeltaMetadata()
        active: Dict[str, AddFile] = {}
        tombstones: Dict[str, RemoveFile] = {}
        for row in table.to_pylist():
            self._apply({k: v for k, v in row.items() if v is not None},
                        active, metadata, tombstones)
        return metadata, active, tombstones

    def write_commit(self, version: int, actions: List[Dict[str, Any]]) -> str:
        """Create commit ``version``; ``FileExistsError`` when another
        writer made it first."""
        os.makedirs(self.log_path, exist_ok=True)
        path = self._commit_path(version)
        body = "\n".join(json.dumps(a, separators=(",", ":")) for a in actions)
        with open(path, "x", encoding="utf-8") as f:
            f.write(body + "\n")
        return path
