"""Data-skipping index actions: build and refresh per-file sketches
(counterpart of hyperspace_tpu/actions/data_skipping.py).

A data-skipping index stores one row per source data file, with the
min, max and null count (and, by sketch type, the distinct values or a
bloom filter) of each sketched column, in one Parquet sketch file under
the index's ``v__=N`` directory.  The query rule (rules/data_skipping.py)
drops the files whose sketch cannot satisfy the predicate; no source data
is copied.  Covering builds write the same per-file min/max over their
own index files as ``_sketch.parquet`` (``write_index_file_sketch``),
which FilterIndexRule prunes index files by.

Sketches are host work (Parquet footers, arrow and numpy); pyarrow is
imported when a function runs.  A sketch file's content digest is
recorded as it lands (``io/integrity.record_file``), so verify_index
scrubs it.  A source of another format than Parquet is sketched from a
read of each file, and a hive partition column as min == max == the
file's path value, with no data read.
"""

from __future__ import annotations

import os
import uuid
from typing import Dict, List, Optional, Sequence

import numpy as np

from hyperspace_tpu_torch.actions.create import CreateActionBase
from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.index.index_config import DataSkippingIndexConfig
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    DataSkippingIndex,
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    LogicalPlanFingerprint,
    Source,
    States,
)
from hyperspace_tpu_torch.io import integrity
from hyperspace_tpu_torch.telemetry.events import (
    CreateActionEvent,
    RefreshActionEvent,
)
from hyperspace_tpu_torch.utils.resolver import resolve_or_raise

# Sketch-table metadata columns (underscored like the lineage column).
SKETCH_FILE_NAME = "_ds_file_name"
SKETCH_FILE_SIZE = "_ds_file_size"
SKETCH_FILE_MTIME = "_ds_file_mtime"
SKETCH_ROW_COUNT = "_ds_row_count"
INDEX_FILE_SKETCH = "_sketch.parquet"


def _min_col(c: str) -> str:
    return f"min__{c}"


def _max_col(c: str) -> str:
    return f"max__{c}"


def _null_col(c: str) -> str:
    return f"nulls__{c}"


def _values_col(c: str) -> str:
    return f"values__{c}"


def _bloom_col(c: str) -> str:
    return f"bloom__{c}"


VALUE_LIST_MAX = 64  # beyond this the list is null and min/max governs
BLOOM_BITS = 8192    # 1 KiB per file and column: ~0.3% false positives
# at 500 distinct values with 4 hashes
BLOOM_HASHES = 4


def bloom_positions(values_array) -> np.ndarray:
    """(n, BLOOM_HASHES) bit positions of each value of an arrow array,
    shared by the build and the probe so membership never gives a false
    negative: double hashing over the canonical hash words
    (``io/columnar.to_hash_words``), which hash equal values equally
    whatever their chunking or encoding."""
    from hyperspace_tpu_torch.io.columnar import to_hash_words

    words = np.asarray(to_hash_words(values_array), dtype=np.uint64)
    h1, h2 = words[:, 0], words[:, 1] | np.uint64(1)  # odd step
    i = np.arange(BLOOM_HASHES, dtype=np.uint64)[:, None]
    return ((h1[None, :] + i * h2[None, :]) % np.uint64(BLOOM_BITS)).T


def _bloom_bytes(col) -> Optional[bytes]:
    """Bloom filter over the column's distinct non-null values."""
    import pyarrow.compute as pc

    if col is None:
        return None
    vals = pc.unique(col).drop_null()
    bits = np.zeros(BLOOM_BITS, dtype=bool)
    if len(vals):
        bits[bloom_positions(vals).ravel()] = True
    return np.packbits(bits).tobytes()


def bloom_may_contain(bloom: bytes, probe_positions) -> bool:
    """True when every hash position of some probe value is set."""
    bits = np.unpackbits(np.frombuffer(bloom, dtype=np.uint8)).astype(bool)
    return bool(np.all(bits[probe_positions], axis=1).any())


def _sketch_from_parquet_footer(path: str,
                                columns: Sequence[str]) -> Optional[Dict]:
    """min, max and null count from the Parquet footer's row-group
    statistics, without reading the data; None when a sketched column
    lacks statistics in some row group (the caller reads the file)."""
    import pyarrow.parquet as pq

    md = pq.ParquetFile(path).metadata
    name_to_ix = {md.schema.column(i).name: i for i in range(md.num_columns)}
    out: Dict = {SKETCH_ROW_COUNT: md.num_rows}
    for c in columns:
        ix = name_to_ix.get(c)
        if ix is None:
            out[_min_col(c)] = None
            out[_max_col(c)] = None
            out[_null_col(c)] = md.num_rows
            continue
        mins, maxs, nulls = [], [], 0
        for rg in range(md.num_row_groups):
            stats = md.row_group(rg).column(ix).statistics
            if stats is None or not stats.has_min_max \
                    or stats.null_count is None:
                return None
            nulls += stats.null_count
            if md.row_group(rg).num_rows > stats.null_count:
                mins.append(stats.min)
                maxs.append(stats.max)
        out[_min_col(c)] = min(mins) if mins else None
        out[_max_col(c)] = max(maxs) if maxs else None
        out[_null_col(c)] = nulls
    return out


def sketch_rows_for_files(files: Sequence[FileInfo], columns: Sequence[str],
                          read_format: str = "parquet",
                          options: Optional[Dict[str, str]] = None,
                          partition_roots: Optional[Sequence[str]] = None,
                          sketch_types: Optional[Sequence[str]] = None
                          ) -> List[Dict]:
    """One sketch row per file: min, max and null count per sketched
    column, from the Parquet footer when it has statistics, else from a
    read of the file (every file of another format).  A hive partition
    column of ``partition_roots`` sketches as min == max == the file's
    path value, with no data read.  Columns of type "ValueList" also
    record their distinct values when there are at most VALUE_LIST_MAX
    of them, and "BloomFilter" columns a bloom filter (both read that
    column)."""
    import pyarrow.compute as pc

    from hyperspace_tpu_torch.io.parquet import read_table
    from hyperspace_tpu_torch.io.partitions import (
        partition_spec_for_roots,
        partition_values,
        typed_value,
    )
    from hyperspace_tpu_torch.utils.parallel_map import parallel_map_ordered

    options = options or {}
    types = list(sketch_types) if sketch_types is not None \
        else ["MinMax"] * len(columns)
    value_list_cols = [c for c, t in zip(columns, types) if t == "ValueList"]
    bloom_cols = [c for c, t in zip(columns, types) if t == "BloomFilter"]
    spec = partition_spec_for_roots(partition_roots) \
        if partition_roots else {}

    def read(path: str, cols):
        return read_table([path], read_format, list(cols), options,
                          partition_roots=partition_roots,
                          partition_spec=spec)

    def sketch_one(f: FileInfo) -> Dict:
        row: Dict = {
            SKETCH_FILE_NAME: f.name,
            SKETCH_FILE_SIZE: f.size,
            SKETCH_FILE_MTIME: f.mtime,
        }
        stats = _sketch_from_parquet_footer(
            f.name, [c for c in columns if c not in spec]) \
            if read_format == "parquet" else None
        if stats is not None:
            raw = partition_values(f.name, partition_roots or [])
            for c in columns:
                if c in spec:
                    value = typed_value(raw.get(c), spec[c])
                    stats[_min_col(c)] = value
                    stats[_max_col(c)] = value
                    stats[_null_col(c)] = stats[SKETCH_ROW_COUNT] \
                        if value is None else 0
            row.update(stats)
            wanted = value_list_cols + bloom_cols
            if wanted:
                _fill_data_sketches(row, read(f.name, wanted),
                                    value_list_cols, bloom_cols)
            return row
        t = read(f.name, columns)
        row[SKETCH_ROW_COUNT] = t.num_rows
        for c in columns:
            col = t.column(c) if c in t.column_names else None
            if col is None or col.null_count == len(col) or t.num_rows == 0:
                row[_min_col(c)] = None
                row[_max_col(c)] = None
                row[_null_col(c)] = t.num_rows
            else:
                mm = pc.min_max(col)
                row[_min_col(c)] = mm["min"].as_py()
                row[_max_col(c)] = mm["max"].as_py()
                row[_null_col(c)] = col.null_count
        _fill_data_sketches(row, t, value_list_cols, bloom_cols)
        return row

    # Few workers: a file without statistics is read whole, per worker.
    return parallel_map_ordered(sketch_one, list(files), max_workers=4)


def _distinct_or_none(col) -> Optional[List]:
    """Sorted distinct non-null values, or None when absent or too many."""
    import pyarrow.compute as pc

    if col is None:
        return None
    vals = pc.unique(col).drop_null()
    if len(vals) > VALUE_LIST_MAX:
        return None
    return sorted(vals.to_pylist())


def _fill_data_sketches(row: Dict, t, value_list_cols: Sequence[str],
                        bloom_cols: Sequence[str]) -> None:
    """The sketch families that read the data: ValueList and Bloom."""
    for c in value_list_cols:
        col = t.column(c) if c in t.column_names else None
        row[_values_col(c)] = _distinct_or_none(col)
    for c in bloom_cols:
        col = t.column(c) if c in t.column_names else None
        row[_bloom_col(c)] = _bloom_bytes(col)


def write_index_file_sketch(out_dir: str, columns: Sequence[str]) -> None:
    """The per-index-file min/max sketch (``_sketch.parquet``) of a
    version directory of bucket files, shared by the covering builds,
    refreshes and optimize so its format cannot drift between them."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from hyperspace_tpu_torch.io.files import list_data_files

    files = list_data_files([out_dir], extension=".parquet")
    if not files:
        return
    rows = sketch_rows_for_files(files, columns)
    pq.write_table(pa.Table.from_pylist(rows),
                   os.path.join(out_dir, INDEX_FILE_SKETCH))


def write_sketch(rows: List[Dict], out_dir: str) -> str:
    """A data-skipping index's sketch file in ``out_dir``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"sketch-{uuid.uuid4().hex[:12]}.parquet")
    pq.write_table(pa.Table.from_pylist(rows), path)
    # The sketch is a data-skipping index's data: its digest lets
    # verify_index scrub both kinds of index.
    integrity.record_file(path)
    return path


def read_sketch(entry: IndexLogEntry):
    """The sketch rows of a data-skipping entry as one arrow table."""
    import pyarrow as pa

    from hyperspace_tpu_torch.io.parquet import read_table

    files = [f.name for f in entry.content.file_infos()]
    if not files:
        return pa.table({})
    return pa.concat_tables([read_table([p]) for p in files],
                            promote_options="default")


class CreateDataSkippingAction(CreateActionBase):
    event_class = CreateActionEvent
    transient_state = States.CREATING
    final_state = States.ACTIVE

    def _resolved_config(self) -> DataSkippingIndexConfig:
        schema = list(self._relation().schema())
        sketched = resolve_or_raise(self.config.sketched_columns, schema,
                                     "sketched column")
        return DataSkippingIndexConfig(self.config.index_name, sketched,
                                       self.config.sketch_types)

    def validate(self) -> None:
        if self.previous_log_entry is not None and \
                self.previous_log_entry.state != States.DOESNOTEXIST:
            raise HyperspaceError(
                f"Another index with name {self.config.index_name!r} already "
                f"exists in state {self.previous_log_entry.state}")
        leaves = self.plan.leaf_relations()
        if len(leaves) != 1 or not \
                self.session.source_provider_manager.is_supported_relation(leaves[0]):
            raise HyperspaceError("Only plans over one supported file-based "
                                  "relation can be indexed")
        self._resolved_config()

    def _build_sketch(self, file_names: Optional[List[str]] = None,
                      carry_rows: Optional[List[Dict]] = None) -> None:
        integrity.configure_from_conf(self.conf)
        relation = self._relation()
        resolved = self._resolved_config()
        files = relation.all_files(self._file_id_tracker)
        if file_names is not None:
            wanted = set(file_names)
            files = [f for f in files if f.name in wanted]
        rows = list(carry_rows or [])
        rows.extend(sketch_rows_for_files(
            files, resolved.sketched_columns, relation.read_format,
            relation.options, partition_roots=relation.root_paths,
            sketch_types=resolved.sketch_types))
        if not rows:
            raise HyperspaceError("No source data files to sketch")
        version = self.data_manager.get_next_version()
        write_sketch(rows, self.data_manager.version_path(version))
        self._written_version = version
        schema = relation.schema()
        self._index_schema = {c: schema[c] for c in resolved.sketched_columns
                              if c in schema}

    def _derived_dataset(self) -> DataSkippingIndex:
        resolved = self._resolved_config()
        return DataSkippingIndex(
            sketched_columns=resolved.sketched_columns,
            sketch_types=list(resolved.sketch_types),
            schema=self._index_schema,
        )

    def _source(self, tracker: FileIdTracker) -> Source:
        return Source(
            relations=[self._relation().create_relation_metadata(tracker)],
            fingerprint=LogicalPlanFingerprint([self._signature()]))

    def log_entry_for_begin(self) -> IndexLogEntry:
        return IndexLogEntry(
            name=self.config.index_name,
            derived_dataset=self._derived_dataset(),
            content=Content.from_directory(self.data_manager.index_path,
                                           FileIdTracker()),
            source=self._source(FileIdTracker()),
        )

    def op(self) -> None:
        self._build_sketch()

    def log_entry(self) -> IndexLogEntry:
        source = self._source(self._file_id_tracker)
        # A refresh carries the previous entry's properties forward, the
        # providers' histories (Delta's deltaVersions) with them.
        prev = self._previous_entry
        properties: Dict[str, str] = dict(prev.properties) if prev else {}
        properties["lineage"] = "false"
        properties["indexLogVersion"] = str(self.base_id + 2)
        properties = self.session.source_provider_manager \
            .enrich_index_properties(source.relations[0], properties)
        return IndexLogEntry(
            name=self.config.index_name,
            derived_dataset=self._derived_dataset(),
            content=Content.from_directory(
                self.data_manager.version_path(self._written_version),
                FileIdTracker()),
            source=source,
            properties=properties,
        )


class RefreshDataSkippingAction(CreateDataSkippingAction):
    """Refresh a sketch: sketch the appended files, drop the rows of the
    deleted ones, carry the rest forward.  It serves the full and the
    incremental mode alike: sketching an unchanged file again would give
    the same row."""

    transient_state = States.REFRESHING
    event_class = RefreshActionEvent

    def __init__(self, log_manager, data_manager, session,
                 previous: Optional[IndexLogEntry] = None) -> None:
        from hyperspace_tpu_torch.lifecycle.change_detector import recorded_scan

        prev = previous if previous is not None \
            else log_manager.get_latest_stable_log()
        if prev is None:
            raise HyperspaceError("Refresh: index does not exist")
        plan = recorded_scan(session, prev.relations[0])
        config = DataSkippingIndexConfig(
            prev.name, prev.derived_dataset.sketched_columns,
            prev.derived_dataset.sketch_types)
        super().__init__(log_manager, data_manager, session, plan, config)
        self._previous_entry = prev
        self._file_id_tracker = FileIdTracker.from_log_entry(prev)

    def _rebase(self) -> None:
        """After a conflict, sketch against the stable entry the winning
        writer committed (``RefreshActionBase._rebase``'s contract)."""
        super()._rebase()
        stable = self.log_manager.get_latest_stable_log()
        if stable is not None:
            self._previous_entry = stable
            self._file_id_tracker = FileIdTracker.from_log_entry(stable)

    def _changed_files(self):
        from hyperspace_tpu_torch.lifecycle.change_detector import diff_file_sets

        current = self._relation().all_files(self._file_id_tracker)
        appended, deleted, _ = diff_file_sets(
            current, self._previous_entry.source_file_infos())
        return appended, {(f.name, f.size, f.mtime) for f in deleted}

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.ACTIVE:
            raise HyperspaceError(
                f"Refresh is only supported in {States.ACTIVE} state")
        appended, deleted = self._changed_files()
        if not appended and not deleted:
            raise NoChangesError("Source data is unchanged; refresh is a no-op")

    def log_entry_for_begin(self) -> IndexLogEntry:
        import copy

        return copy.deepcopy(self._previous_entry)

    def op(self) -> None:
        appended, deleted_keys = self._changed_files()
        old = read_sketch(self._previous_entry)
        carry: List[Dict] = []
        if old.num_rows:
            for row in old.to_pylist():
                key = (row[SKETCH_FILE_NAME], row[SKETCH_FILE_SIZE],
                       row[SKETCH_FILE_MTIME])
                if key not in deleted_keys:
                    carry.append(row)
        self._build_sketch(file_names=[f.name for f in appended],
                           carry_rows=carry)
