"""Default file-based source: a directory of Parquet files (counterpart
of hyperspace_tpu/sources/default/provider.py).  Listing is a recursive
walk; the relation snapshot records every file with its tracker id."""

from __future__ import annotations

from typing import Dict, List, Optional

from hyperspace_tpu_torch.index.log_entry import (
    Content,
    FileIdTracker,
    FileInfo,
    Relation,
)
from hyperspace_tpu_torch.io.files import list_data_files
from hyperspace_tpu_torch.io.parquet import read_schema
from hyperspace_tpu_torch.plan.nodes import Scan

SUPPORTED_FORMATS = ("parquet",)


class DefaultFileBasedRelation:
    """One supported leaf relation of a plan."""

    def __init__(self, scan: Scan) -> None:
        self.scan = scan
        self._files_cache: Optional[List[FileInfo]] = None
        self._schema_cache: Optional[Dict[str, str]] = None

    @property
    def root_paths(self) -> List[str]:
        return list(self.scan.relation.root_paths)

    @property
    def file_format(self) -> str:
        return self.scan.relation.file_format

    @property
    def options(self) -> Dict[str, str]:
        return self.scan.relation.options_dict

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
        if self._schema_cache is None:
            files = self.all_files()
            if not files:
                raise FileNotFoundError(
                    f"No data files under {self.root_paths!r}")
            self._schema_cache = read_schema(files[0].name)
        return self._schema_cache

    def create_relation_metadata(self, tracker: FileIdTracker) -> Relation:
        files = self.all_files(tracker)
        return Relation(
            root_paths=self.root_paths,
            content=Content.from_leaf_files(files) or Content.from_directory(
                self.root_paths[0], tracker),
            schema=self.schema(),
            file_format=self.file_format,
            options=self.options,
        )


class DefaultFileBasedSource:
    name = "default"

    def is_supported_relation(self, scan: Scan) -> bool:
        return scan.relation.file_format.lower() in SUPPORTED_FORMATS

    def get_relation(self, scan: Scan) -> Optional[DefaultFileBasedRelation]:
        if not self.is_supported_relation(scan):
            return None
        return DefaultFileBasedRelation(scan)
