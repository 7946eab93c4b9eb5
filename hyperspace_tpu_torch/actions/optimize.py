"""OptimizeAction: compact an index's files bucket by bucket
(counterpart of hyperspace_tpu/actions/optimize.py).

  - mode "quick": only files below ``conf.optimize_file_size_threshold``
    are candidates; mode "full": every file;
  - a bucket is merged when it has more files than it needs (one, or
    ``ceil(rows / index_max_rows_per_file)``) or a file over that row
    cap; the bucket id comes from the file name;
  - ``op()`` reads each merged bucket's candidate files, sorts them
    stably by the indexed columns and writes them into a new version
    directory, with its ``_sketch.parquet``; a Z-order index's merged
    files are sorted into Morton order by their own ranks and cut at
    cell boundaries (``io.parquet.write_zorder_run``), on the host as in
    the JAX package; the committed entry keeps
    the other files and swaps the merged ones.  The source and its
    fingerprint are untouched.  The build report gets the ``read``,
    ``sort``, ``write`` and ``sketch`` phases and the bytes read and
    written.

A data-skipping index is refused: it has nothing to compact.

Each new file carries the content digest its writer recorded
(``io/integrity.py``).  pyarrow is imported when a function runs.
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

from hyperspace_tpu_torch.actions.base import Action
from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    FileInfo,
    IndexLogEntry,
    States,
)
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.io import integrity
from hyperspace_tpu_torch.io.parquet import (
    bucket_id_of_file,
    read_table,
    sort_permutation_host,
    write_bucket_run,
    write_zorder_run,
)
from hyperspace_tpu_torch.telemetry.events import OptimizeActionEvent


@dataclasses.dataclass(frozen=True)
class OptimizeSummary:
    """What an optimize did: ``outcome`` is "ok" for a committed
    compaction and "noop" when no bucket held files to merge; ``version``
    is the committed log id, or None for a no-op."""

    index: str
    mode: str                   # quick | full
    outcome: str                # "ok" | "noop"
    compacted_files: int = 0    # files merged away
    compacted_buckets: int = 0  # buckets rewritten
    written_files: int = 0      # files the merge wrote
    version: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class OptimizeAction(Action):
    event_class = OptimizeActionEvent
    transient_state = States.OPTIMIZING
    final_state = States.ACTIVE

    def __init__(self, log_manager: IndexLogManager, data_manager: IndexDataManager,
                 session, mode: str = "quick") -> None:
        super().__init__(log_manager)
        self.data_manager = data_manager
        self.session = session
        self.mode = mode
        self._new_files: List[str] = []
        self._retained: List[FileInfo] = []
        self._candidates_cache: Optional[Dict[int, List[FileInfo]]] = None

    def _candidates(self) -> Dict[int, List[FileInfo]]:
        """Bucket -> the files to merge; memoised, since validate() and
        op() both need it and it reads Parquet footers."""
        import pyarrow.parquet as pq

        if self._candidates_cache is not None:
            return self._candidates_cache
        conf = self.session.conf
        by_bucket: Dict[int, List[FileInfo]] = defaultdict(list)
        retained: List[FileInfo] = []
        for f in self.previous_log_entry.content.file_infos():
            bucket = bucket_id_of_file(f.name)
            if bucket is None or (self.mode == "quick"
                                  and f.size >= conf.optimize_file_size_threshold):
                retained.append(f)
            else:
                by_bucket[bucket].append(f)
        max_rows = conf.index_max_rows_per_file
        mergeable: Dict[int, List[FileInfo]] = {}
        for b, fs in by_bucket.items():
            if max_rows > 0:
                # Merge while the bucket has more files than
                # ceil(rows / max_rows) or a file over the cap; a bucket
                # that meets both is left alone, so optimize converges.
                per_file = [pq.ParquetFile(f.name).metadata.num_rows
                            for f in fs]
                minimal = -(-sum(per_file) // max_rows)
                worth_merging = (len(fs) > minimal
                                 or any(r > max_rows for r in per_file))
            else:
                worth_merging = len(fs) > 1
            if worth_merging:
                mergeable[b] = fs
            else:
                retained.extend(fs)
        self._retained = retained
        self._candidates_cache = mergeable
        return mergeable

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.ACTIVE:
            raise HyperspaceError(
                f"Optimize is only supported in {States.ACTIVE} state")
        if not self.previous_log_entry.is_covering:
            raise HyperspaceError("Optimize applies to covering indexes only")
        if not self._candidates():
            raise NoChangesError(
                "No index files eligible for optimization (every bucket has "
                "a single file or files exceed the size threshold)")

    def op(self) -> None:
        import pyarrow as pa

        from hyperspace_tpu_torch.actions.data_skipping import (
            write_index_file_sketch,
        )

        conf = self.session.conf
        integrity.configure_from_conf(conf)
        entry = self.previous_log_entry
        report = self.build_report
        version = self.data_manager.get_next_version()
        out_dir = self.data_manager.version_path(version)
        os.makedirs(out_dir, exist_ok=True)
        layout = entry.derived_dataset.properties.get("layout",
                                                      "lexicographic")
        for bucket, files in sorted(self._candidates().items()):
            t0 = time.perf_counter()
            merged = read_table([f.name for f in files])
            report.add_phase("read", time.perf_counter() - t0)
            report.add_bytes(read=merged.nbytes)
            t0 = time.perf_counter()
            if layout == "zorder":
                # Morton order AND cell-aligned cuts, or the files' min/max
                # widen on every dimension but the first.
                new = write_zorder_run(merged, bucket, out_dir,
                                       conf.index_max_rows_per_file,
                                       entry.indexed_columns,
                                       compression=conf.index_file_compression)
                self._new_files.extend(new)
                report.add_phase("write", time.perf_counter() - t0)
                report.add_bytes(written=sum(os.stat(p).st_size for p in new),
                                 files=len(new))
                continue
            perm = sort_permutation_host(merged, entry.indexed_columns)
            merged = merged.take(pa.array(perm))
            report.add_phase("sort", time.perf_counter() - t0)
            t0 = time.perf_counter()
            new = write_bucket_run(merged, bucket, out_dir,
                                   conf.index_max_rows_per_file,
                                   compression=conf.index_file_compression)
            self._new_files.extend(new)
            report.add_phase("write", time.perf_counter() - t0)
            report.add_bytes(written=sum(os.stat(p).st_size for p in new),
                             files=len(new))
        t0 = time.perf_counter()
        write_index_file_sketch(out_dir, entry.indexed_columns)
        report.add_phase("sketch", time.perf_counter() - t0)

    def log_entry(self) -> IndexLogEntry:
        entry = copy.deepcopy(self.previous_log_entry)
        new_infos = []
        for path in self._new_files:
            st = os.stat(path)
            new_infos.append(FileInfo(path, st.st_size, int(st.st_mtime_ns), -1,
                                      integrity.recorded_digest(path)))
        entry.content = Content.from_leaf_files(self._retained + new_infos)
        return entry

    def summary(self, outcome: str) -> OptimizeSummary:
        """The summary of a run that returned ``outcome``."""
        mergeable = self._candidates_cache or {}
        return OptimizeSummary(
            index=self.index_name, mode=self.mode, outcome=outcome,
            compacted_files=sum(len(fs) for fs in mergeable.values()),
            compacted_buckets=len(mergeable),
            written_files=len(self._new_files),
            version=self.base_id + 2 if outcome == "ok" else None)
