"""User-visible index statistics (counterpart of
hyperspace_tpu/index/statistics.py): one summary row per index, with
name, indexed and included columns, bucket count, schema, location,
state and the index files' count and size; the extended set adds the
kind, lineage, and the source, appended and deleted files' counts and
sizes.  ``indexLocation`` falls back to the index root for an entry that
lists no content files.  pyarrow is imported when the table is built.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional

from hyperspace_tpu_torch.index.log_entry import IndexLogEntry

INDEX_SUMMARY_COLUMNS = [
    "name", "indexedColumns", "includedColumns", "numBuckets", "schema",
    "indexLocation", "state", "numIndexFiles", "sizeIndexFiles",
]

EXTENDED_COLUMNS = INDEX_SUMMARY_COLUMNS + [
    "kind", "hasLineage",
    "numSourceFiles", "sizeSourceFiles", "numAppendedFiles",
    "sizeAppendedFiles", "numDeletedFiles", "sizeDeletedFiles",
    "indexContentPaths",
]


def index_statistics_table(entries: List[IndexLogEntry],
                           extended: bool = False,
                           index_path: Optional[Callable[[str], str]] = None):
    """A pyarrow table of ``entries``' statistics; ``index_path`` maps an
    index name to its root, the location of an entry with no files."""
    import pyarrow as pa

    rows = {c: [] for c in (EXTENDED_COLUMNS if extended
                            else INDEX_SUMMARY_COLUMNS)}
    for e in entries:
        index_files = e.content.file_infos()
        location = os.path.dirname(index_files[0].name) if index_files else ""
        if not location and index_path is not None:
            location = index_path(e.name)
        rows["name"].append(e.name)
        rows["indexedColumns"].append(e.indexed_columns)
        rows["includedColumns"].append(e.included_columns)
        rows["numBuckets"].append(e.num_buckets)
        rows["schema"].append(str(e.derived_dataset.schema))
        rows["indexLocation"].append(location)
        rows["state"].append(e.state)
        rows["numIndexFiles"].append(len(index_files))
        rows["sizeIndexFiles"].append(sum(f.size for f in index_files))
        if extended:
            source_files = e.source_file_infos()
            appended = e.appended_files()
            deleted = e.deleted_files()
            rows["kind"].append(e.derived_dataset.KIND)
            rows["hasLineage"].append(e.has_lineage_column())
            rows["numSourceFiles"].append(len(source_files))
            rows["sizeSourceFiles"].append(sum(f.size for f in source_files))
            rows["numAppendedFiles"].append(len(appended))
            rows["sizeAppendedFiles"].append(sum(f.size for f in appended))
            rows["numDeletedFiles"].append(len(deleted))
            rows["sizeDeletedFiles"].append(sum(f.size for f in deleted))
            rows["indexContentPaths"].append(
                sorted({os.path.dirname(f.name) for f in index_files}))
    return pa.table(rows)
