"""Full refresh: rebuild an index over its source as it is now
(counterpart of hyperspace_tpu/actions/refresh.py, its full mode).

``RefreshActionBase`` rebuilds the source plan from the relation the
previous entry recorded, diffs the source files against the recorded
ones, and pins the bucket count to the previous entry's.  An unchanged
source is a benign no-op (``NoChangesError``, outcome "noop").
``RefreshAction`` rebuilds through the create build
(``_build_index_data``), monolithic or spilled by the source's size.

Incremental and quick refresh need the lineage column and
``Directory.merge``, which are not ported.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Optional

from hyperspace_tpu_torch.actions.create import CreateActionBase
from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.index_config import IndexConfig
from hyperspace_tpu_torch.index.log_entry import (
    FileIdTracker,
    IndexLogEntry,
    States,
)
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.lifecycle.change_detector import diff_file_sets
from hyperspace_tpu_torch.plan.nodes import Scan, ScanRelation


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
        layout = prev.derived_dataset.properties.get("layout", "lexicographic")
        if layout != "lexicographic" or \
                prev.properties.get("lineage", "false").lower() == "true":
            raise HyperspaceError(
                f"Refresh of an index with layout {layout!r} or a lineage "
                f"column is not ported to hyperspace_tpu_torch")
        # The port's one source provider pins no snapshot: the recorded
        # relation is the source to list again.
        rel = prev.relations[0]
        plan = Scan(ScanRelation(root_paths=tuple(rel.root_paths),
                                 file_format=rel.file_format,
                                 options=tuple(sorted(rel.options.items()))))
        config = IndexConfig(prev.name, prev.indexed_columns,
                             prev.included_columns)
        super().__init__(log_manager, data_manager, session, plan, config)
        self._previous_entry = prev
        # Unchanged files keep their ids.
        self._file_id_tracker = FileIdTracker.from_log_entry(prev)
        self._diff_counts = (0, 0)

    @property
    def num_buckets(self) -> int:
        return self._previous_entry.num_buckets

    def validate(self) -> None:
        if self.previous_log_entry is None or \
                self.previous_log_entry.state != States.ACTIVE:
            raise HyperspaceError(
                f"Refresh is only supported in {States.ACTIVE} state")
        appended, deleted, _ = diff_file_sets(
            self._relation().all_files(self._file_id_tracker),
            self._previous_entry.source_file_infos())
        self._diff_counts = (len(appended), len(deleted))
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


class RefreshAction(RefreshActionBase):
    """Full rebuild."""

    def op(self) -> None:
        self._build_index_data()

    def log_entry(self) -> IndexLogEntry:
        return self._build_log_entry()
