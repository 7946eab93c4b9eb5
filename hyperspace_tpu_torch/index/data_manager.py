"""Versioned index-data directories (counterpart of
hyperspace_tpu/index/data_manager.py).  Each rebuild's data lives in a
hive-style ``v__=<N>/`` subdirectory of the index path:

    <systemPath>/<indexName>/
      _hyperspace_log/0,1,...,latestStable
      v__=0/part-*.parquet
"""

from __future__ import annotations

import os
from typing import List, Optional

from hyperspace_tpu_torch.io.files import remove_tree

INDEX_VERSION_DIR_PREFIX = "v__="


class IndexDataManager:
    def __init__(self, index_path: str, quarantine=None) -> None:
        self.index_path = index_path
        # The index's QuarantineManager (index/quarantine.py), which the
        # collection manager attaches: deleting a version drops its
        # quarantine records too.
        self.quarantine = quarantine

    def version_path(self, version: int) -> str:
        return os.path.join(self.index_path, f"{INDEX_VERSION_DIR_PREFIX}{version}")

    def versions(self) -> List[int]:
        if not os.path.isdir(self.index_path):
            return []
        out = []
        for name in os.listdir(self.index_path):
            if name.startswith(INDEX_VERSION_DIR_PREFIX):
                suffix = name[len(INDEX_VERSION_DIR_PREFIX):]
                # Directories only: a stray file named v__=N must not
                # inflate the version counter.
                if suffix.isdigit() and os.path.isdir(
                        os.path.join(self.index_path, name)):
                    out.append(int(suffix))
        return sorted(out)

    def get_latest_version(self) -> Optional[int]:
        versions = self.versions()
        return versions[-1] if versions else None

    def get_next_version(self) -> int:
        latest = self.get_latest_version()
        return 0 if latest is None else latest + 1

    def delete(self, version: int) -> None:
        """Remove version ``version``'s data directory, if it exists, and
        its quarantine records."""
        path = self.version_path(version)
        files = [os.path.join(d, n) for d, _, names in os.walk(path)
                 for n in names]
        if os.path.isdir(path):
            remove_tree(path)
        if self.quarantine is not None:
            # The files are gone: a record of one would read as
            # "missing" to every later scrub.
            self.quarantine.clear_version(version, files)
