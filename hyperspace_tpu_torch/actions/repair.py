"""RepairAction: rebuild only the quarantined buckets of an index
(counterpart of hyperspace_tpu/actions/repair.py).

After a scrub or a failed query quarantined damaged index data files
(index/quarantine.py), ``refresh_index(name, mode="repair")`` derives
exactly those buckets' rows again from the RECORDED source snapshot and
commits an entry whose content keeps every healthy file and swaps the
damaged buckets for new ones: an index-only commit shaped like an
optimize, not a full rebuild.  After the commit the quarantine records
the entry no longer references are cleared, so later queries read the
index alone again.

A repaired bucket must hold the rows the original build put there, so
``validate`` requires every recorded source file to exist with its
recorded (size, mtime); a source that changed since is a refresh's job.

``op`` reads the snapshot through the build's own ``_read_chunk`` (the
same schema normalisation and lineage ids as create and refresh), then
on the session's device, from ``conf.device_min_rows("build")`` rows:

  - the bucket of every row by ``ops/hash.bucket_ids``, the hash kernel
    on the card (below the threshold the bit-equal host mirror
    ``bucket_ids_np``);
  - the rows of the target buckets, ordered stably by bucket;
  - the run offsets by ``io/parquet.bucket_offsets``, the bucket
    histogram kernel on the card;

and per bucket the build's within-bucket sort (``sort_permutation_host``)
and writer (``write_bucket_run``, which records each file's digest),
then the version's ``_sketch.parquet``.  A Z-order index has one bucket,
so its repair rebuilds every file: the whole snapshot's rows go through
``write_zorder_run`` (Morton order by the snapshot's ranks, which are
the build's, and cell-aligned cuts, on the host as in the JAX package),
so the repaired files equal the build's.  The phases (``read_s``,
``kernel_s``, ``write_s``, ``sketch_s``) go to the build report and
``session.build_stats_log``.
"""

from __future__ import annotations

import copy
import os
import time
from typing import List, Optional

import torch

from hyperspace_tpu_torch.actions.refresh import RefreshActionBase
from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.execution import sync_guard
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import (
    Content,
    FileInfo,
    IndexLogEntry,
    States,
)
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.index.quarantine import (
    QuarantineManager,
    quarantine_manager_for,
)
from hyperspace_tpu_torch.io import columnar, integrity
from hyperspace_tpu_torch.io.parquet import (
    bucket_id_of_file,
    bucket_offsets,
    sort_permutation_host,
    write_bucket_run,
    write_zorder_run,
)
from hyperspace_tpu_torch.ops.hash import bucket_ids, bucket_ids_np


class RepairAction(RefreshActionBase):
    """Partial rebuild of the quarantined buckets: REFRESHING while it
    runs (it is a refresh mode), ACTIVE after."""

    transient_state = States.REFRESHING
    final_state = States.ACTIVE
    mode_name = "repair"

    def __init__(self, log_manager: IndexLogManager,
                 data_manager: IndexDataManager, session,
                 previous: Optional[IndexLogEntry] = None,
                 quarantine: Optional[QuarantineManager] = None) -> None:
        super().__init__(log_manager, data_manager, session, previous)
        self.quarantine = quarantine if quarantine is not None \
            else quarantine_manager_for(session.conf, data_manager.index_path)
        self._new_files: List[str] = []
        self._retained: List[FileInfo] = []
        self._target_buckets: tuple = ()

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.ACTIVE:
            raise HyperspaceError(
                f"Repair is only supported in {States.ACTIVE} state")
        entry = self._previous_entry
        if not entry.is_covering:
            raise HyperspaceError(
                "Repair applies to covering indexes; rebuild a "
                "data-skipping index with refresh_index(mode='full')")
        infos = entry.content.file_infos()
        qpaths = self.quarantine.paths([f.name for f in infos])
        flagged = [f for f in infos if f.name in qpaths]
        if not flagged:
            raise NoChangesError(
                "no quarantined index files; nothing to repair")
        buckets = {bucket_id_of_file(f.name) for f in flagged}
        if None in buckets:
            raise HyperspaceError(
                "cannot map a quarantined file to its bucket; run "
                "refresh_index(mode='full') instead")
        for f in entry.source_file_infos():
            try:
                st = os.stat(f.name)
            except OSError:
                raise HyperspaceError(
                    f"repair needs the indexed source snapshot, but "
                    f"{f.name!r} is gone; run refresh_index instead")
            if st.st_size != f.size or int(st.st_mtime_ns) != f.mtime:
                raise HyperspaceError(
                    f"source file {f.name!r} changed since indexing; "
                    f"repair would mix snapshots — run refresh_index "
                    f"(mode='full' or 'incremental') instead")
        self._target_buckets = tuple(sorted(buckets))

    def _target_rows(self, table, indexed_columns):
        """(positions of the target buckets' rows ordered stably by
        bucket, (num_buckets + 1,) run offsets among them)."""
        word_cols = [columnar.to_hash_words(table.column(c))
                     for c in indexed_columns]
        device = self.session.device
        if self._host_route(table.num_rows):
            ids = torch.from_numpy(bucket_ids_np(word_cols, self.num_buckets))
        else:
            ids = bucket_ids([torch.from_numpy(w).to(device) for w in word_cols],
                             self.num_buckets)
        targets = torch.tensor(self._target_buckets, dtype=ids.dtype,
                               device=ids.device)
        rows = torch.nonzero(torch.isin(ids, targets)).squeeze(1)
        sub = ids[rows]
        order = torch.sort(sub, stable=True).indices
        offsets = bucket_offsets(sub, self.num_buckets)
        return sync_guard.pull(rows[order], "repair.rows"), offsets

    def op(self) -> None:
        import pyarrow as pa

        integrity.configure_from_conf(self.conf)
        entry = self._previous_entry
        resolved = self._resolved_config()
        relation = self._relation()
        affected = set(self._target_buckets)
        self._retained = [f for f in entry.content.file_infos()
                          if bucket_id_of_file(f.name) not in affected]
        # One monolithic read: repair runs off the query path, and the
        # rows it keeps are the damaged buckets' share of the source.
        table = pa.concat_tables(
            [self._read_chunk(f, resolved.all_columns, relation,
                              self.lineage_enabled)
             for f in entry.source_file_infos()],
            promote_options="default")
        t0 = time.perf_counter()
        positions, offsets = self._target_rows(table,
                                               resolved.indexed_columns)
        self._phase("kernel_s", time.perf_counter() - t0)
        routed = table.take(pa.array(positions))

        version = self.data_manager.get_next_version()
        out_dir = self.data_manager.version_path(version)
        os.makedirs(out_dir, exist_ok=True)
        t0 = time.perf_counter()
        new_files: List[str] = []
        for b in self._target_buckets:
            lo, hi = int(offsets[b]), int(offsets[b + 1])
            if hi == lo:
                continue
            bt = routed.slice(lo, hi - lo)
            if resolved.layout == "zorder":
                new_files.extend(write_zorder_run(
                    bt, b, out_dir, self.conf.index_max_rows_per_file,
                    resolved.indexed_columns,
                    compression=self.conf.index_file_compression))
                continue
            bt = bt.take(pa.array(sort_permutation_host(
                bt, resolved.indexed_columns)))
            new_files.extend(write_bucket_run(
                bt, b, out_dir, self.conf.index_max_rows_per_file,
                compression=self.conf.index_file_compression))
        self._phase("write_s", time.perf_counter() - t0)
        self.build_report.add_bytes(
            written=sum(os.path.getsize(p) for p in new_files),
            files=len(new_files))
        # The repaired buckets keep their per-file min/max pruning.
        self._write_index_file_sketch(out_dir, resolved)
        self._written_version = version
        self._new_files = new_files
        self._publish_build_stats()

    def log_entry(self) -> IndexLogEntry:
        entry = copy.deepcopy(self._previous_entry)
        new_infos = []
        for path in self._new_files:
            st = os.stat(path)
            new_infos.append(FileInfo(path, st.st_size, int(st.st_mtime_ns),
                                      -1, integrity.recorded_digest(path)))
        entry.content = Content.from_leaf_files(self._retained + new_infos)
        return entry

    def run(self) -> str:
        outcome = super().run()
        # Committed or a no-op: clear every record the current entry no
        # longer references (the repaired files, or stale leftovers).  A
        # record naming a referenced file is kept.
        latest = self.log_manager.get_latest_stable_log()
        referenced = {f.name for f in latest.content.file_infos()} \
            if latest is not None else set()
        repaired = [f.name for f in self._previous_entry.content.file_infos()]
        for path in self.quarantine.paths(repaired):
            if path not in referenced:
                self.quarantine.remove(path)
        return outcome
