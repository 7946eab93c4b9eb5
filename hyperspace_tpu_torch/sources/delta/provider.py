"""The Delta Lake source provider (counterpart of
hyperspace_tpu/sources/delta/provider.py): indexes over versioned tables,
and time travel served by older index versions.

  - A relation of format "delta" has one table path; its files are the
    snapshot's (the log's, never a listing: removed and overwritten
    files stay on disk), read as Parquet, and each file's mtime is its
    add action's ``modificationTime``.
  - ``versionAsOf`` (a version) or ``timestampAsOf`` (epoch ms or an ISO
    timestamp, UTC when it names no zone) pick the snapshot; the latest
    otherwise.  The signature is the table version and the path.
  - ``create_relation_metadata`` records ``versionAsOf``, the indexed
    version; ``refresh_relation_metadata`` drops both pins, so a refresh
    sees the latest version; ``enrich_index_properties`` appends
    ``indexLogVersion:deltaVersion`` to the ``deltaVersions`` history.
  - ``closest_index`` picks, for a read of another version, the index
    log version recorded for it or nearest to it (the shared
    ``FileBasedRelation._select_closest_version``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    Relation,
)
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.sources.delta.log import DeltaLog, Snapshot
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
)

DELTA_FORMAT = "delta"
DELTA_VERSION_HISTORY_PROPERTY = "deltaVersions"
INDEX_LOG_VERSION_PROPERTY = "indexLogVersion"


def _timestamp_ms(value: str) -> int:
    """``timestampAsOf`` as epoch ms: an integer, or an ISO timestamp
    ("yyyy-MM-dd[ HH:mm:ss]" too), UTC when it names no zone."""
    try:
        return int(value)
    except ValueError:
        pass
    from datetime import datetime, timezone

    try:
        dt = datetime.fromisoformat(value.strip().replace(" ", "T"))
    except ValueError:
        raise ValueError(
            f"Cannot parse timestampAsOf value {value!r}: expected epoch "
            f"milliseconds or an ISO timestamp") from None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return int(dt.timestamp() * 1000)


class DeltaLakeRelation(FileBasedRelation):
    def __init__(self, scan: Scan, conf: HyperspaceConf, session=None) -> None:
        super().__init__(scan)
        self._conf = conf
        self._session = session
        if len(self.root_paths) != 1:
            raise ValueError("A Delta relation has exactly one table path")
        self._log = DeltaLog(self.root_paths[0])
        self._snapshot_cache: Optional[Snapshot] = None

    @property
    def table_version(self) -> int:
        return self._snapshot().version

    def _snapshot(self) -> Snapshot:
        if self._snapshot_cache is None:
            opts = self.options
            version: Optional[int] = None
            if "versionAsOf" in opts:
                version = int(opts["versionAsOf"])
            elif "timestampAsOf" in opts:
                version = self._log.version_for_timestamp(
                    _timestamp_ms(opts["timestampAsOf"]))
            self._snapshot_cache = self._log.snapshot(version)
        return self._snapshot_cache

    def all_files(self, tracker: Optional[FileIdTracker] = None
                  ) -> List[FileInfo]:
        return [FileInfo(f.path, f.size, f.modification_time,
                         tracker.add_file(f.path, f.size, f.modification_time)
                         if tracker is not None else -1)
                for f in self._snapshot().files]

    def schema(self) -> Dict[str, str]:
        """The snapshot's ``metaData`` schema; a table with none takes
        its first file's."""
        meta = self._snapshot().metadata
        if meta.schema_string:
            from hyperspace_tpu_torch.io.schemas import arrow_schema_from_spark

            return arrow_schema_from_spark(meta.schema_string)
        files = self.all_files()
        if not files:
            raise FileNotFoundError(
                f"Delta table {self.root_paths[0]} has no schema and no files")
        from hyperspace_tpu_torch.io.parquet import read_schema

        return read_schema(files[0].name, "parquet")

    def signature(self) -> str:
        return f"{self.table_version}{self._log.table_path}"

    def create_relation_metadata(self, tracker: FileIdTracker) -> Relation:
        files = self.all_files(tracker)
        opts = {k: v for k, v in self.options.items()
                if k not in ("path", "timestampAsOf")}
        opts["versionAsOf"] = str(self.table_version)
        return Relation(
            root_paths=[self._log.table_path],
            content=Content.from_leaf_files(files)
            or Content.from_directory(self._log.table_path, tracker),
            schema=self.schema(),
            file_format=DELTA_FORMAT,
            options=opts,
        )

    def _version_history(self, entry: IndexLogEntry) -> List[Tuple[int, int]]:
        """[(index log version, delta version)] ascending by delta
        version; of several index versions of one delta version (an
        optimize), the highest."""
        raw = entry.properties.get(DELTA_VERSION_HISTORY_PROPERTY, "")
        if not raw:
            return []
        by_delta: Dict[int, int] = {}
        for pair in raw.split(","):
            index_v, delta_v = (int(x) for x in pair.split(":"))
            by_delta[delta_v] = max(index_v, by_delta.get(delta_v, -1))
        return sorted(((iv, dv) for dv, iv in by_delta.items()),
                      key=lambda t: t[1])

    def closest_index(self, entry: IndexLogEntry) -> IndexLogEntry:
        return self._select_closest_version(
            entry, self._session, self._version_history(entry),
            self.table_version)


class DeltaLakeSource(FileBasedSourceProvider):
    name = "delta"

    def __init__(self, conf: HyperspaceConf) -> None:
        self._conf = conf
        self._session = None

    def bind_session(self, session) -> None:
        """The session whose index manager ``closest_index`` reads."""
        self._session = session

    def is_supported_relation(self, scan: Scan) -> Optional[bool]:
        return True if scan.relation.file_format.lower() == DELTA_FORMAT \
            else None

    def get_relation(self, scan: Scan) -> Optional[FileBasedRelation]:
        if not self.is_supported_relation(scan):
            return None
        return DeltaLakeRelation(scan, self._conf, self._session)

    def internal_file_format_name(self, relation: Relation) -> Optional[str]:
        return "parquet" if relation.file_format == DELTA_FORMAT else None

    def refresh_relation_metadata(self, relation: Relation
                                  ) -> Optional[Relation]:
        if relation.file_format != DELTA_FORMAT:
            return None
        opts = {k: v for k, v in relation.options.items()
                if k not in ("versionAsOf", "timestampAsOf")}
        return dataclasses.replace(relation, options=opts)

    def enrich_index_properties(self, relation: Relation,
                                properties: Dict[str, str]
                                ) -> Optional[Dict[str, str]]:
        if relation.file_format != DELTA_FORMAT:
            return None
        out = dict(properties)
        index_version = properties.get(INDEX_LOG_VERSION_PROPERTY)
        delta_version = relation.options.get("versionAsOf")
        if index_version is not None and delta_version is not None:
            pair = f"{index_version}:{delta_version}"
            history = properties.get(DELTA_VERSION_HISTORY_PROPERTY)
            out[DELTA_VERSION_HISTORY_PROPERTY] = \
                f"{history},{pair}" if history else pair
        return out
