"""The source-provider plug-in (counterpart of
hyperspace_tpu/sources/interfaces.py): how the engine talks to a format.

A ``FileBasedRelation`` wraps one leaf scan of a plan: its files, schema,
signature and hive partition columns, the relation snapshot an index log
entry records, the lineage pairs, and ``closest_index``, the hook a
versioned source uses to pick an older index log version for a
time-travelled read.  A ``FileBasedSourceProvider`` answers, for a scan
or a recorded relation, whether it owns it (None when it does not); the
manager (sources/manager.py) dispatches each call to exactly one.

``LAKE_DATA_FORMATS`` names the table formats whose data files are of
another format (Delta and Iceberg tables hold Parquet files); every read
path maps a relation's format through ``physical_read_format``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from hyperspace_tpu_torch.index.log_entry import (
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    Relation,
)
from hyperspace_tpu_torch.plan.nodes import Scan

LAKE_DATA_FORMATS = {"delta": "parquet", "iceberg": "parquet"}


def physical_read_format(file_format: str) -> str:
    """The format a relation's data files are read in."""
    return LAKE_DATA_FORMATS.get(file_format.lower(), file_format)


class FileBasedRelation:
    """One supported leaf relation of a plan."""

    def __init__(self, scan: Scan) -> None:
        self.scan = scan
        self._spec_cache: Optional[Dict[str, str]] = None

    @property
    def root_paths(self) -> List[str]:
        return list(self.scan.relation.root_paths)

    @property
    def file_format(self) -> str:
        return self.scan.relation.file_format

    @property
    def options(self) -> Dict[str, str]:
        return self.scan.relation.options_dict

    @property
    def read_format(self) -> str:
        return physical_read_format(self.file_format)

    def all_files(self, tracker: Optional[FileIdTracker] = None
                  ) -> List[FileInfo]:
        """Every data file; registered with ``tracker`` when given."""
        raise NotImplementedError

    def schema(self) -> Dict[str, str]:
        raise NotImplementedError

    def signature(self) -> str:
        """The relation's own validity signature."""
        raise NotImplementedError

    def create_relation_metadata(self, tracker: FileIdTracker) -> Relation:
        """The snapshot an index log entry records."""
        raise NotImplementedError

    def partition_spec(self) -> Dict[str, str]:
        """The hive partition columns below the root paths and their
        types, from one walk of the directory tree per relation object."""
        if self._spec_cache is None:
            from hyperspace_tpu_torch.io.partitions import (
                partition_spec_for_roots,
            )

            self._spec_cache = partition_spec_for_roots(self.root_paths)
        return self._spec_cache

    def lineage_pairs(self, tracker: FileIdTracker) -> List[Tuple[str, int]]:
        """(file path, file id) of every file, for the lineage column."""
        return [(f.name, f.id) for f in self.all_files(tracker)]

    def closest_index(self, entry: IndexLogEntry) -> IndexLogEntry:
        """The entry of ``entry``'s index that best serves this relation;
        a source without versions keeps ``entry``."""
        return entry

    def _select_closest_version(self, entry: IndexLogEntry, session,
                                versions, current_pos) -> IndexLogEntry:
        """Pick among the index log versions recorded for a versioned
        source.  ``versions`` is [(index log version, source position)]
        ascending by position, ``current_pos`` the read snapshot's
        position.  At or past the newest indexed position: ``entry``.
        Before the first: the first.  On an indexed position: that one.
        Between two: the one whose recorded files differ from the current
        ones by fewer bytes (ties to the later), so hybrid scan has less
        to patch."""
        if not versions or session is None or current_pos is None:
            return entry

        def load(log_version: int) -> Optional[IndexLogEntry]:
            return session.index_collection_manager.get_index(
                entry.name, log_version)

        floor_i = -1
        for i, (_, pos) in enumerate(versions):
            if pos <= current_pos:
                floor_i = i
        if floor_i == len(versions) - 1:
            return entry
        if floor_i == -1:
            return load(versions[0][0]) or entry
        if versions[floor_i][1] == current_pos:
            return load(versions[floor_i][0]) or entry
        current = {(f.name, f.size, f.mtime): f.size
                   for f in self.all_files()}
        total = sum(current.values())

        def diff_bytes(candidate: IndexLogEntry) -> int:
            keys = {(f.name, f.size, f.mtime)
                    for f in candidate.source_file_infos()}
            common = sum(size for key, size in current.items() if key in keys)
            return (total - common) + (candidate.source_files_size() - common)

        prev_log = load(versions[floor_i][0])
        next_log = load(versions[floor_i + 1][0])
        if prev_log is None or next_log is None:
            return next_log or prev_log or entry
        return prev_log if diff_bytes(prev_log) < diff_bytes(next_log) \
            else next_log


class FileBasedSourceProvider:
    """A format plug-in.  Each method returns None for a relation the
    provider does not own."""

    name: str = ""

    def is_supported_relation(self, scan: Scan) -> Optional[bool]:
        raise NotImplementedError

    def get_relation(self, scan: Scan) -> Optional[FileBasedRelation]:
        raise NotImplementedError

    def internal_file_format_name(self, relation: Relation) -> Optional[str]:
        raise NotImplementedError

    def refresh_relation_metadata(self, relation: Relation
                                  ) -> Optional[Relation]:
        """``relation`` without the options that pin a snapshot, so a
        refresh sees the latest data."""
        raise NotImplementedError

    def enrich_index_properties(self, relation: Relation,
                                properties: Dict[str, str]
                                ) -> Optional[Dict[str, str]]:
        raise NotImplementedError
