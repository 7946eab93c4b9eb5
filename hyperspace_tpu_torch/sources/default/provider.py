"""Default file-based source: a directory (or a glob of directories) of
Parquet, CSV, JSON, ORC, Avro or text files, hive-partitioned or not
(counterpart of hyperspace_tpu/sources/default/provider.py).  Listing
is a recursive walk; the relation snapshot records every file with its
tracker id, and its signature is the md5 fold over every file's (size,
mtime, path).  The formats come from ``conf.supported_file_formats``;
a relation of another format belongs to another provider."""

from __future__ import annotations

from typing import Dict, List, Optional

from hyperspace_tpu_torch.config import HyperspaceConf
from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    FileIdTracker,
    FileInfo,
    Relation,
)
from hyperspace_tpu_torch.io.files import expand_globs, list_data_files
from hyperspace_tpu_torch.io.parquet import read_schema
from hyperspace_tpu_torch.plan.nodes import Scan
from hyperspace_tpu_torch.sources.interfaces import (
    FileBasedRelation,
    FileBasedSourceProvider,
)
from hyperspace_tpu_torch.utils.hashing import fold_md5
from hyperspace_tpu_torch.utils.paths import normalize_path


class DefaultFileBasedRelation(FileBasedRelation):
    def __init__(self, scan: Scan, conf: HyperspaceConf) -> None:
        super().__init__(scan)
        self._conf = conf
        self._files_cache: Optional[List[FileInfo]] = None
        self._schema_cache: Optional[Dict[str, str]] = None

    def all_files(self, tracker: Optional[FileIdTracker] = None) -> List[FileInfo]:
        """Every data file, listed once per relation object; registering
        with a tracker reuses the cached listing."""
        if self._files_cache is None:
            self._files_cache = list_data_files(self.root_paths)
        if tracker is None:
            return self._files_cache
        return [FileInfo(f.name, f.size, f.mtime,
                         tracker.add_file(f.name, f.size, f.mtime))
                for f in self._files_cache]

    def schema(self) -> Dict[str, str]:
        """The first file's columns, read in the relation's format, then
        the partition columns the files do not hold."""
        if self._schema_cache is None:
            files = self.all_files()
            if not files:
                raise FileNotFoundError(
                    f"No data files under {self.root_paths!r}")
            schema = read_schema(files[0].name, self.file_format,
                                 self.options)
            for k, t in self.partition_spec().items():
                schema.setdefault(k, t)
            self._schema_cache = schema
        return self._schema_cache

    def signature(self) -> str:
        return fold_md5(f"{f.size}{f.mtime}{f.name}"
                        for f in self.all_files())

    def create_relation_metadata(self, tracker: FileIdTracker) -> Relation:
        files = self.all_files(tracker)
        return Relation(
            root_paths=self._logged_root_paths(),
            content=Content.from_leaf_files(files) or Content.from_directory(
                self.root_paths[0], tracker),
            schema=self.schema(),
            file_format=self.file_format,
            options=self.options,
        )

    def _logged_root_paths(self) -> List[str]:
        """The root paths the log entry records: with
        ``conf.globbing_pattern`` set, the patterns themselves (a refresh
        expands them again and finds directories that appeared since),
        after checking that they cover every root of the relation."""
        pattern = (self._conf.globbing_pattern or "").strip()
        if not pattern:
            return self.root_paths
        patterns = [p.strip() for p in pattern.split(",") if p.strip()]
        expanded = {normalize_path(p) for p in expand_globs(patterns)}
        # A root that is one of the patterns (a refresh of a relation
        # recorded with them) matches as it is.
        unmatched = [r for r in self.root_paths
                     if r not in patterns and normalize_path(r) not in expanded]
        if unmatched:
            raise HyperspaceError(
                f"Some root paths of the relation do not match the globbing "
                f"pattern {pattern!r}: {unmatched}")
        return patterns


class DefaultFileBasedSource(FileBasedSourceProvider):
    name = "default"

    def __init__(self, conf: HyperspaceConf) -> None:
        self._conf = conf

    def _supported_formats(self) -> List[str]:
        return [f.strip().lower()
                for f in self._conf.supported_file_formats.split(",")]

    def is_supported_relation(self, scan: Scan) -> bool:
        return scan.relation.file_format.lower() in self._supported_formats()

    def get_relation(self, scan: Scan) -> Optional[DefaultFileBasedRelation]:
        if not self.is_supported_relation(scan):
            return None
        return DefaultFileBasedRelation(scan, self._conf)

    def _owns(self, relation: Relation) -> bool:
        return relation.file_format.lower() in self._supported_formats()

    def internal_file_format_name(self, relation: Relation) -> Optional[str]:
        return relation.file_format.lower() if self._owns(relation) else None

    def refresh_relation_metadata(self, relation: Relation
                                  ) -> Optional[Relation]:
        # Plain files pin no snapshot.
        return relation if self._owns(relation) else None

    def enrich_index_properties(self, relation: Relation,
                                properties: Dict[str, str]
                                ) -> Optional[Dict[str, str]]:
        return properties if self._owns(relation) else None
