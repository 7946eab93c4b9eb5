"""The Iceberg source provider (counterpart of
hyperspace_tpu/sources/iceberg/provider.py): indexes over snapshotted
tables, and time travel served by older index versions.

  - A relation of format "iceberg" has one table path; its files are the
    snapshot's planned files (the manifests', never a listing: replaced
    and deleted files stay on disk), read as Parquet.  A file's size is
    the manifest's, its mtime the file's own (``os.stat``, in ms), so an
    in-place rewrite shows as a changed file without a new snapshot.
    The planned list is cached on the relation.
  - ``snapshot-id`` picks the snapshot, else ``as-of-timestamp`` (epoch
    ms: the latest snapshot at or before it), else the current one.  The
    signature is the snapshot id and the table's location.
  - ``schema`` is the table's schema JSON, or the first file's when that
    schema has no fields.
  - ``create_relation_metadata`` records ``snapshot-id`` and
    ``as-of-timestamp`` of the indexed snapshot;
    ``refresh_relation_metadata`` drops both, so a refresh sees the
    latest snapshot; ``enrich_index_properties`` appends
    ``indexLogVersion:snapshotId`` to the ``icebergSnapshots`` history.
  - ``closest_index`` places the recorded snapshots on the table's
    timeline (ordered by ``timestamp-ms``; an expired snapshot is
    skipped, and of several index versions on one snapshot the highest
    is kept) and picks through the shared
    ``FileBasedRelation._select_closest_version``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    Relation,
)
from hyperspace_tpu_torch.io.schemas import arrow_schema_from_iceberg
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.sources.iceberg.metadata import (
    IcebergSnapshot,
    IcebergTable,
    TableMetadata,
)
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
)

ICEBERG_FORMAT = "iceberg"
ICEBERG_VERSION_HISTORY_PROPERTY = "icebergSnapshots"
INDEX_LOG_VERSION_PROPERTY = "indexLogVersion"


class IcebergRelation(FileBasedRelation):
    def __init__(self, scan: Scan, conf: HyperspaceConf, session=None) -> None:
        super().__init__(scan)
        self._conf = conf
        self._session = session
        if len(self.root_paths) != 1:
            raise ValueError("An Iceberg relation has exactly one table path")
        self._table = IcebergTable(self.root_paths[0])
        self._metadata_cache: Optional[TableMetadata] = None
        self._snapshot_cache: Optional[IcebergSnapshot] = None
        self._files_cache: Optional[List[FileInfo]] = None

    def _metadata(self) -> TableMetadata:
        if self._metadata_cache is None:
            self._metadata_cache = self._table.load_metadata()
        return self._metadata_cache

    def _snapshot(self) -> Optional[IcebergSnapshot]:
        if self._snapshot_cache is None:
            opts = self.options
            md = self._metadata()
            if "snapshot-id" in opts:
                self._snapshot_cache = md.snapshot_by_id(
                    int(opts["snapshot-id"]))
            elif "as-of-timestamp" in opts:
                self._snapshot_cache = md.snapshot_for_timestamp(
                    int(opts["as-of-timestamp"]))
            else:
                self._snapshot_cache = md.current_snapshot()
        return self._snapshot_cache

    @property
    def snapshot_id(self) -> Optional[int]:
        snap = self._snapshot()
        return snap.snapshot_id if snap else None

    def all_files(self, tracker: Optional[FileIdTracker] = None
                  ) -> List[FileInfo]:
        if self._files_cache is None:
            self._files_cache = [
                FileInfo(f.path, f.size,
                         int(os.stat(f.path).st_mtime * 1000)
                         if os.path.isfile(f.path) else 0, -1)
                for f in self._table.plan_files(self._snapshot(),
                                                self._metadata())]
        if tracker is None:
            return list(self._files_cache)
        return [FileInfo(f.name, f.size, f.mtime,
                         tracker.add_file(f.name, f.size, f.mtime))
                for f in self._files_cache]

    def schema(self) -> Dict[str, str]:
        if self._metadata().schema.get("fields"):
            return arrow_schema_from_iceberg(self._metadata().schema)
        files = self.all_files()
        if not files:
            raise FileNotFoundError(
                f"Iceberg table {self.root_paths[0]} has no schema and no files")
        from hyperspace_tpu_torch.io.parquet import read_schema

        return read_schema(files[0].name, "parquet")

    def signature(self) -> str:
        return f"{self.snapshot_id}{self._metadata().location}"

    def create_relation_metadata(self, tracker: FileIdTracker) -> Relation:
        files = self.all_files(tracker)
        snap = self._snapshot()
        opts = {k: v for k, v in self.options.items() if k != "path"}
        if snap is not None:
            opts["snapshot-id"] = str(snap.snapshot_id)
            opts["as-of-timestamp"] = str(snap.timestamp_ms)
        return Relation(
            root_paths=[self._table.table_path],
            content=Content.from_leaf_files(files)
            or Content.from_directory(self._table.table_path, tracker),
            schema=self.schema(),
            file_format=ICEBERG_FORMAT,
            options=opts,
        )

    def _snapshot_order(self) -> Dict[int, int]:
        """snapshot id -> its position on the timestamp-ordered timeline."""
        return {s.snapshot_id: i for i, s in enumerate(
            sorted(self._metadata().snapshots,
                   key=lambda s: s.timestamp_ms))}

    def _version_history(self, entry: IndexLogEntry,
                         order: Dict[int, int]) -> List[Tuple[int, int]]:
        """[(index log version, snapshot position)] ascending by
        position; a snapshot no longer in the table is skipped, and of
        several index versions of one snapshot (an optimize) the highest
        is kept."""
        raw = entry.properties.get(ICEBERG_VERSION_HISTORY_PROPERTY, "")
        if not raw:
            return []
        by_pos: Dict[int, int] = {}
        for pair in raw.split(","):
            index_v, snap_id = (int(x) for x in pair.split(":"))
            pos = order.get(snap_id)
            if pos is not None:
                by_pos[pos] = max(index_v, by_pos.get(pos, -1))
        return sorted(((iv, pos) for pos, iv in by_pos.items()),
                      key=lambda t: t[1])

    def closest_index(self, entry: IndexLogEntry) -> IndexLogEntry:
        snap = self._snapshot()
        if snap is None:
            return entry
        order = self._snapshot_order()
        return self._select_closest_version(
            entry, self._session, self._version_history(entry, order),
            order.get(snap.snapshot_id))


class IcebergSource(FileBasedSourceProvider):
    name = "iceberg"

    def __init__(self, conf: HyperspaceConf) -> None:
        self._conf = conf
        self._session = None

    def bind_session(self, session) -> None:
        """The session whose index manager ``closest_index`` reads."""
        self._session = session

    def is_supported_relation(self, scan: Scan) -> Optional[bool]:
        return True if scan.relation.file_format.lower() == ICEBERG_FORMAT \
            else None

    def get_relation(self, scan: Scan) -> Optional[FileBasedRelation]:
        if not self.is_supported_relation(scan):
            return None
        return IcebergRelation(scan, self._conf, self._session)

    def internal_file_format_name(self, relation: Relation) -> Optional[str]:
        return "parquet" if relation.file_format == ICEBERG_FORMAT else None

    def refresh_relation_metadata(self, relation: Relation
                                  ) -> Optional[Relation]:
        if relation.file_format != ICEBERG_FORMAT:
            return None
        opts = {k: v for k, v in relation.options.items()
                if k not in ("snapshot-id", "as-of-timestamp")}
        return dataclasses.replace(relation, options=opts)

    def enrich_index_properties(self, relation: Relation,
                                properties: Dict[str, str]
                                ) -> Optional[Dict[str, str]]:
        if relation.file_format != ICEBERG_FORMAT:
            return None
        out = dict(properties)
        index_version = properties.get(INDEX_LOG_VERSION_PROPERTY)
        snap_id = relation.options.get("snapshot-id")
        if index_version is not None and snap_id is not None:
            pair = f"{index_version}:{snap_id}"
            history = properties.get(ICEBERG_VERSION_HISTORY_PROPERTY)
            out[ICEBERG_VERSION_HISTORY_PROPERTY] = \
                f"{history},{pair}" if history else pair
        return out
