"""Iceberg table metadata (counterpart of
hyperspace_tpu/sources/iceberg/metadata.py): the reader of a
HadoopTables-style table.

A table directory holds ``metadata/``, numbered ``v<N>.metadata.json``
files and a ``version-hint.text`` naming the newest, and ``data/``, its
Parquet files.  Each snapshot names a manifest list (Avro) whose entries
name manifests (Avro) whose entries are the data files.  Planning a scan
reads the metadata, resolves the snapshot, reads its manifest list and
keeps the entries of each manifest that are not deleted, sorted by path.

The metadata takes the format-v1 ``schema`` and ``partition-spec`` keys
or the format-v2 ``schemas``/``current-schema-id`` and
``partition-specs``/``default-spec-id``.  A truncated metadata JSON,
manifest list or manifest raises ``CorruptMetadataError`` naming the file
(and, for the Avro files, their role).  Paths are absolute; a relative
path is under the table, a ``file:`` URI loses its scheme.  No pyarrow:
the Avro files go through ``io/avro.py``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Any, Dict, List, Optional

from hyperspace_tpu_torch.exceptions import CorruptMetadataError
from hyperspace_tpu_torch.io import avro

METADATA_DIR = "metadata"
VERSION_HINT = "version-hint.text"
_METADATA_RE = re.compile(r"^v(\d+)\.metadata\.json$")

# A manifest list's entry (the Iceberg spec's format-v1 fields).
MANIFEST_LIST_SCHEMA: Dict[str, Any] = {
    "type": "record",
    "name": "manifest_file",
    "fields": [
        {"name": "manifest_path", "type": "string", "field-id": 500},
        {"name": "manifest_length", "type": "long", "field-id": 501},
        {"name": "partition_spec_id", "type": "int", "field-id": 502},
        {"name": "added_snapshot_id", "type": ["null", "long"], "default": None,
         "field-id": 503},
        {"name": "added_data_files_count", "type": ["null", "int"],
         "default": None, "field-id": 504},
        {"name": "existing_data_files_count", "type": ["null", "int"],
         "default": None, "field-id": 505},
        {"name": "deleted_data_files_count", "type": ["null", "int"],
         "default": None, "field-id": 506},
    ],
}

# A manifest's entry: its status and the data file's record.
MANIFEST_ENTRY_SCHEMA: Dict[str, Any] = {
    "type": "record",
    "name": "manifest_entry",
    "fields": [
        {"name": "status", "type": "int", "field-id": 0},
        {"name": "snapshot_id", "type": ["null", "long"], "default": None,
         "field-id": 1},
        {"name": "data_file", "field-id": 2, "type": {
            "type": "record",
            "name": "r2",
            "fields": [
                {"name": "file_path", "type": "string", "field-id": 100},
                {"name": "file_format", "type": "string", "field-id": 101},
                {"name": "record_count", "type": "long", "field-id": 103},
                {"name": "file_size_in_bytes", "type": "long", "field-id": 104},
            ],
        }},
    ],
}

STATUS_EXISTING = 0
STATUS_ADDED = 1
STATUS_DELETED = 2


@dataclasses.dataclass(frozen=True)
class DataFile:
    """One live data file of a snapshot (absolute path)."""

    path: str
    size: int
    record_count: int


@dataclasses.dataclass
class IcebergSnapshot:
    snapshot_id: int
    timestamp_ms: int
    manifest_list: str
    summary: Dict[str, str] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TableMetadata:
    location: str
    table_uuid: str
    current_snapshot_id: Optional[int]
    snapshots: List[IcebergSnapshot]
    schema: Dict[str, Any]          # the Iceberg schema JSON, with field ids
    partition_spec: List[Dict[str, Any]]
    properties: Dict[str, str]
    last_column_id: int
    metadata_version: int

    def snapshot_by_id(self, snapshot_id: int) -> IcebergSnapshot:
        for s in self.snapshots:
            if s.snapshot_id == snapshot_id:
                return s
        raise ValueError(f"Snapshot {snapshot_id} not found in {self.location}")

    def current_snapshot(self) -> Optional[IcebergSnapshot]:
        if self.current_snapshot_id is None:
            return None
        return self.snapshot_by_id(self.current_snapshot_id)

    def snapshot_for_timestamp(self, timestamp_ms: int) -> IcebergSnapshot:
        """The latest snapshot committed at or before ``timestamp_ms``
        (``as-of-timestamp``)."""
        best: Optional[IcebergSnapshot] = None
        for s in sorted(self.snapshots, key=lambda s: s.timestamp_ms):
            if s.timestamp_ms <= timestamp_ms:
                best = s
        if best is None:
            raise ValueError(
                f"No snapshot at or before timestamp {timestamp_ms} in "
                f"{self.location}")
        return best


class IcebergTable:
    """The metadata of one HadoopTables-style Iceberg table."""

    def __init__(self, table_path: str) -> None:
        self.table_path = os.path.abspath(table_path)
        self.metadata_path = os.path.join(self.table_path, METADATA_DIR)

    def exists(self) -> bool:
        return bool(self.metadata_versions())

    def metadata_versions(self) -> List[int]:
        if not os.path.isdir(self.metadata_path):
            return []
        return sorted(int(m.group(1)) for m in map(
            _METADATA_RE.match, os.listdir(self.metadata_path)) if m)

    def latest_metadata_version(self) -> int:
        """``version-hint.text``'s version, else the highest
        ``v<N>.metadata.json``."""
        hint = os.path.join(self.metadata_path, VERSION_HINT)
        if os.path.isfile(hint):
            with open(hint, "r", encoding="utf-8") as f:
                try:
                    return int(f.read().strip())
                except ValueError:
                    pass
        versions = self.metadata_versions()
        if not versions:
            raise FileNotFoundError(f"Not an Iceberg table: {self.table_path}")
        return versions[-1]

    def load_metadata(self, version: Optional[int] = None) -> TableMetadata:
        if version is None:
            version = self.latest_metadata_version()
        path = os.path.join(self.metadata_path, f"v{version}.metadata.json")
        with open(path, "r", encoding="utf-8") as f:
            try:
                raw = json.load(f)
            except ValueError as e:
                raise CorruptMetadataError(
                    f"Truncated or corrupt Iceberg metadata {path!r}: "
                    f"{e}") from e
        snapshots = [
            IcebergSnapshot(
                snapshot_id=int(s["snapshot-id"]),
                timestamp_ms=int(s["timestamp-ms"]),
                manifest_list=self._absolute(s["manifest-list"]),
                summary={k: str(v) for k, v in s.get("summary", {}).items()},
            )
            for s in raw.get("snapshots", [])
        ]
        schema = raw.get("schema")
        if schema is None:
            schemas = raw.get("schemas", [])
            current = raw.get("current-schema-id", 0)
            schema = next((s for s in schemas if s.get("schema-id") == current),
                          schemas[0] if schemas else {"type": "struct",
                                                      "fields": []})
        spec = raw.get("partition-spec")
        if spec is None:
            specs = raw.get("partition-specs", [])
            default = raw.get("default-spec-id", 0)
            spec_obj = next((s for s in specs if s.get("spec-id") == default),
                            None)
            spec = spec_obj.get("fields", []) if spec_obj else []
        return TableMetadata(
            location=raw.get("location", self.table_path),
            table_uuid=raw.get("table-uuid", ""),
            current_snapshot_id=raw.get("current-snapshot-id")
            if raw.get("current-snapshot-id", -1) != -1 else None,
            snapshots=snapshots,
            schema=schema,
            partition_spec=spec,
            properties={k: str(v) for k, v in raw.get("properties", {}).items()},
            last_column_id=int(raw.get("last-column-id", 0)),
            metadata_version=version,
        )

    def plan_files(self, snapshot: Optional[IcebergSnapshot] = None,
                   metadata: Optional[TableMetadata] = None) -> List[DataFile]:
        """The live data files of ``snapshot`` (default: the current
        one), sorted by path."""
        metadata = metadata or self.load_metadata()
        snapshot = snapshot or metadata.current_snapshot()
        if snapshot is None:
            return []
        out: List[DataFile] = []
        for mf in self._read_manifest_avro(snapshot.manifest_list,
                                           "manifest list"):
            manifest_path = self._absolute(mf["manifest_path"])
            for entry in self._read_manifest_avro(manifest_path, "manifest"):
                if entry["status"] == STATUS_DELETED:
                    continue
                df = entry["data_file"]
                out.append(DataFile(self._absolute(df["file_path"]),
                                    int(df["file_size_in_bytes"]),
                                    int(df["record_count"])))
        return sorted(out, key=lambda f: f.path)

    @staticmethod
    def _read_manifest_avro(path: str, kind: str):
        """An Avro container's records; a torn file (io/avro raises
        EOFError, ValueError, KeyError, IndexError or TypeError part way
        through a decode) names the file and its role."""
        try:
            return avro.read_container(path)
        except (ValueError, KeyError, EOFError, IndexError, TypeError) as e:
            raise CorruptMetadataError(
                f"Truncated or corrupt Iceberg {kind} {path!r}: {e}") from e

    def _absolute(self, path: str) -> str:
        if os.path.isabs(path):
            return path
        if path.startswith("file:"):
            return re.sub(r"^file:/{0,2}(/)", r"\1", path)
        return os.path.join(self.table_path, path)
