"""Refresh actions: bring an index up to date with its changed source
(counterpart of hyperspace_tpu/actions/refresh.py).

``RefreshActionBase`` rebuilds the source plan from the relation the
previous entry recorded, diffs the source files against the recorded
ones into appended and deleted sets, and pins the bucket count, the
lineage column and the layout to the previous entry's (a Z-order index
is never rebuilt lexicographic).  An unchanged source is a benign
no-op (``NoChangesError``, outcome "noop").

  - ``RefreshAction`` (full): rebuilds through the create build
    (``_build_index_data``), monolithic or spilled by the source's size.
  - ``RefreshIncrementalAction``: indexes only what changed.  With
    deleted files it rewrites the old index minus the rows whose
    ``_data_file_id`` was deleted (which needs the lineage column); the
    appended files are read as the build reads them; the union goes
    through one monolithic ``_write_table_bucketed``, whatever
    ``device_batch_rows`` says, as in the JAX package.  The new entry's
    content is the old tree merged with the new version's only when no
    file was deleted.
  - ``RefreshQuickAction``: metadata only; it records the appended and
    deleted files and the new fingerprint, and hybrid scan handles them
    at query time.

The diff's mode and counts go into the build report's ``properties``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional, Tuple

from hyperspace_tpu_torch.actions.create import (
    DATA_FILE_ID_COLUMN,
    CreateActionBase,
    _PrefetchReader,
)
from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import (
    FileIdTracker,
    FileInfo,
    IndexLogEntry,
    LogicalPlanFingerprint,
    States,
)
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.io import integrity
from hyperspace_tpu_torch.io.parquet import read_table
from hyperspace_tpu_torch.lifecycle.change_detector import (
    diff_file_sets,
    recorded_scan,
)
from hyperspace_tpu_torch.telemetry.events import RefreshActionEvent


@dataclasses.dataclass(frozen=True)
class RefreshSummary:
    """What a refresh did: ``outcome`` is "ok" for a committed refresh and
    "noop" when the source was unchanged; ``version`` is the committed log
    id, or None for a no-op."""

    index: str
    mode: str
    outcome: str
    appended: int = 0      # source files the diff saw appended
    deleted: int = 0       # source files the diff saw deleted
    version: Optional[int] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class RefreshActionBase(CreateActionBase):
    event_class = RefreshActionEvent
    transient_state = States.REFRESHING
    final_state = States.ACTIVE
    mode_name = "full"

    def __init__(self, log_manager: IndexLogManager, data_manager: IndexDataManager,
                 session, previous: Optional[IndexLogEntry] = None) -> None:
        prev = previous if previous is not None \
            else log_manager.get_latest_stable_log()
        if prev is None:
            raise HyperspaceError("Refresh: index does not exist")
        if len(prev.relations) != 1:
            raise HyperspaceError("Refresh supports single-relation indexes")
        plan = recorded_scan(session, prev.relations[0])
        config = IndexConfig(
            prev.name, prev.indexed_columns, prev.included_columns,
            layout=prev.derived_dataset.properties.get("layout",
                                                       "lexicographic"))
        super().__init__(log_manager, data_manager, session, plan, config)
        self._previous_entry = prev
        # Unchanged files keep their ids.
        self._file_id_tracker = FileIdTracker.from_log_entry(prev)
        self._diff_counts = (0, 0)

    @property
    def num_buckets(self) -> int:
        return self._previous_entry.num_buckets

    @property
    def lineage_enabled(self) -> bool:
        return self._previous_entry.has_lineage_column()

    def _diff(self) -> Tuple[List[FileInfo], List[FileInfo]]:
        """(appended, deleted) source files; the appended ones carry ids
        from the tracker seeded with the previous entry's."""
        appended, deleted, _ = diff_file_sets(
            self._relation().all_files(self._file_id_tracker),
            self._previous_entry.source_file_infos())
        return appended, deleted

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.ACTIVE:
            raise HyperspaceError(
                f"Refresh is only supported in {States.ACTIVE} state")
        appended, deleted = self._diff()
        self._diff_counts = (len(appended), len(deleted))
        self.build_report.properties.update(
            refresh_mode=self.mode_name, refresh_appended=len(appended),
            refresh_deleted=len(deleted))
        if not appended and not deleted:
            raise NoChangesError("Source data is unchanged; refresh is a no-op")

    def summary(self, outcome: str) -> RefreshSummary:
        """The summary of a run that returned ``outcome``."""
        appended, deleted = self._diff_counts
        return RefreshSummary(
            index=self.index_name, mode=self.mode_name, outcome=outcome,
            appended=appended, deleted=deleted,
            version=self.base_id + 2 if outcome == "ok" else None)

    def log_entry_for_begin(self) -> IndexLogEntry:
        return copy.deepcopy(self._previous_entry)

    def _rebase(self) -> None:
        """After a conflict, diff and merge against the stable entry the
        winning writer committed, not the one captured at construction:
        the retry must not index files the winner already covered."""
        super()._rebase()
        stable = self.log_manager.get_latest_stable_log()
        if stable is not None:
            self._previous_entry = stable
            self._file_id_tracker = FileIdTracker.from_log_entry(stable)


class RefreshAction(RefreshActionBase):
    """Full rebuild."""

    def op(self) -> None:
        self._build_index_data()

    def log_entry(self) -> IndexLogEntry:
        return self._build_log_entry()


class RefreshIncrementalAction(RefreshActionBase):
    """Index only what changed."""

    mode_name = "incremental"
    _had_deletes = False

    def validate(self) -> None:
        super().validate()
        if self._diff()[1] and not self.lineage_enabled:
            raise HyperspaceError(
                "Refreshing an index incrementally with deleted source files "
                "requires lineage (hyperspace.index.lineage.enabled=true at "
                "creation time)")

    def op(self) -> None:
        import pyarrow as pa
        import pyarrow.compute as pc

        integrity.configure_from_conf(self.conf)
        appended, deleted = self._diff()
        resolved = self._resolved_config()
        parts: List = []
        if deleted:
            # The old index minus the rows of the deleted files, in the
            # old content's file order (the tie order of the rewrite).
            old = read_table([f.name for f in
                              self._previous_entry.content.file_infos()])
            deleted_ids = pa.array(sorted({f.id for f in deleted}),
                                   type=old.schema.field(DATA_FILE_ID_COLUMN).type)
            keep = pc.invert(pc.is_in(old.column(DATA_FILE_ID_COLUMN),
                                      value_set=deleted_ids))
            parts.append(old.filter(keep))
        if appended:
            depth = max(1, int(self.conf.build_prefetch_depth)) \
                if self.conf.build_pipeline_enabled else 0
            reader = _PrefetchReader(self, appended, resolved.all_columns,
                                     self._relation(), self.lineage_enabled,
                                     depth)
            try:
                parts.extend(reader)
            finally:
                reader.close()
        combined = pa.concat_tables(parts, promote_options="default")
        self._write_table_bucketed(combined, resolved)
        self._had_deletes = bool(deleted)
        self._publish_build_stats()

    def log_entry(self) -> IndexLogEntry:
        entry = self._build_log_entry()
        if not self._had_deletes:
            # The old index files stay valid beside the new version's.
            entry.content = self._previous_entry.content.merge(entry.content)
        return entry


class RefreshQuickAction(RefreshActionBase):
    """Metadata only: record the diff for hybrid scan."""

    mode_name = "quick"

    def op(self) -> None:
        pass

    def log_entry(self) -> IndexLogEntry:
        appended, deleted = self._diff()
        return self._previous_entry.copy_with_update(
            LogicalPlanFingerprint([self._signature()]), appended, deleted)
