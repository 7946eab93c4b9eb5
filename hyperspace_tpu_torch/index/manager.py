"""Index collection manager (counterpart of
hyperspace_tpu/index/manager.py): name -> log, data and quarantine
managers, dispatch to the actions (create, delete, restore, vacuum,
cancel, the full, incremental, quick and repair refresh, optimize,
verify; a data-skipping index's create and refresh go to its own
actions), and listing of the indexes under the system path.  Not
ported: auto-recovery and the conflict-retry settings."""

from __future__ import annotations

import os
from typing import List, Optional

from hyperspace_tpu_torch.exceptions import HyperspaceError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.index.statistics import index_statistics_table
from hyperspace_tpu_torch.io.files import list_dir

DEFAULT_SYSTEM_DIR = "spark-warehouse/indexes"


class IndexCollectionManager:
    def __init__(self, session) -> None:
        self.session = session

    @property
    def system_path(self) -> str:
        path = self.session.conf.system_path or os.path.join(
            os.getcwd(), DEFAULT_SYSTEM_DIR)
        return os.path.abspath(path)

    def index_path(self, name: str) -> str:
        """Case-insensitive match against existing index directories,
        else the given name."""
        root = self.system_path
        lowered = name.lower()
        for existing in list_dir(root):
            if existing.lower() == lowered:
                return os.path.join(root, existing)
        return os.path.join(root, name)

    def _log_manager(self, name: str) -> IndexLogManager:
        return IndexLogManager(self.index_path(name))

    def _data_manager(self, name: str) -> IndexDataManager:
        # Deleting a version (vacuum) drops its quarantine records too.
        return IndexDataManager(self.index_path(name),
                                quarantine=self.quarantine_manager(name))

    def quarantine_manager(self, name: str):
        """The index's quarantine set (index/quarantine.py)."""
        from hyperspace_tpu_torch.index.quarantine import (
            quarantine_manager_for,
        )

        return quarantine_manager_for(self.session.conf, self.index_path(name))

    def verify(self, name: str, mode: str = "quick"):
        """Scrub ``name``'s data files against its log entry
        (actions/verify.py); returns the per-file report table."""
        from hyperspace_tpu_torch.actions.verify import VerifyIndexAction

        return VerifyIndexAction(self._log_manager(name),
                                 self._data_manager(name),
                                 self.quarantine_manager(name),
                                 mode=mode).run()

    def create(self, dataset, config) -> None:
        """Build the index ``config`` describes: an ``IndexConfig``
        (covering) or a ``DataSkippingIndexConfig``."""
        from hyperspace_tpu_torch.actions.create import CreateAction
        from hyperspace_tpu_torch.actions.data_skipping import (
            CreateDataSkippingAction,
        )
        from hyperspace_tpu_torch.index.index_config import (
            DataSkippingIndexConfig,
        )

        cls = CreateDataSkippingAction \
            if isinstance(config, DataSkippingIndexConfig) else CreateAction
        cls(self._log_manager(config.index_name),
            self._data_manager(config.index_name),
            self.session, dataset.plan, config).run()

    def delete(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.delete import DeleteAction

        DeleteAction(self._log_manager(name)).run()

    def restore(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.restore import RestoreAction

        RestoreAction(self._log_manager(name)).run()

    def vacuum(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.vacuum import VacuumAction

        VacuumAction(self._log_manager(name), self._data_manager(name)).run()

    def cancel(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.cancel import CancelAction

        CancelAction(self._log_manager(name)).run()

    def refresh(self, name: str, mode: str = "full"):
        """Run one refresh ("full", "incremental", "quick" or "repair");
        returns its ``RefreshSummary`` (outcome "noop" for an unchanged
        source, or a repair with nothing quarantined)."""
        from hyperspace_tpu_torch.actions.data_skipping import (
            RefreshDataSkippingAction,
        )
        from hyperspace_tpu_torch.actions.refresh import (
            RefreshAction,
            RefreshIncrementalAction,
            RefreshQuickAction,
            RefreshSummary,
        )

        if mode == "repair":
            # Rebuild only the quarantined buckets and clear their
            # records (actions/repair.py).
            from hyperspace_tpu_torch.actions.repair import RepairAction

            log_manager = self._log_manager(name)
            action = RepairAction(
                log_manager, self._data_manager(name), self.session,
                previous=log_manager.get_latest_stable_log(),
                quarantine=self.quarantine_manager(name))
            return action.summary(action.run())
        cls = {"full": RefreshAction,
               "incremental": RefreshIncrementalAction,
               "quick": RefreshQuickAction}.get(mode)
        if cls is None:
            raise HyperspaceError(f"Unknown refresh mode {mode!r}")
        log_manager = self._log_manager(name)
        stable = log_manager.get_latest_stable_log()
        # A data-skipping sketch is patched by its own action in the full
        # and incremental modes; the quick refresh is metadata only.
        if stable is not None and not stable.is_covering and mode != "quick":
            action = RefreshDataSkippingAction(
                log_manager, self._data_manager(name), self.session,
                previous=stable)
            outcome = action.run()
            return RefreshSummary(
                index=name, mode=mode, outcome=outcome,
                version=action.base_id + 2 if outcome == "ok" else None)
        action = cls(log_manager, self._data_manager(name), self.session,
                     previous=stable)
        return action.summary(action.run())

    def optimize(self, name: str, mode: str = "quick"):
        """Run one compaction ("quick" or "full"); returns its
        ``OptimizeSummary`` (outcome "noop" when no bucket held files to
        merge)."""
        from hyperspace_tpu_torch.actions.optimize import OptimizeAction

        if mode not in ("quick", "full"):
            raise HyperspaceError(f"Unknown optimize mode {mode!r}")
        action = OptimizeAction(self._log_manager(name),
                                self._data_manager(name), self.session, mode)
        return action.summary(action.run())

    def get_indexes(self, states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        """Latest stable entry of every index, optionally of ``states``
        only.  Underscore-prefixed directories are system state."""
        root = self.system_path
        out: List[IndexLogEntry] = []
        for name in sorted(list_dir(root)):
            if name.startswith("_") or not os.path.isdir(os.path.join(root, name)):
                continue
            entry = self._log_manager(name).get_latest_stable_log()
            if entry is not None and (states is None or entry.state in states):
                out.append(entry)
        return out

    def get_index(self, name: str) -> Optional[IndexLogEntry]:
        return self._log_manager(name).get_latest_stable_log()

    def indexes(self):
        """The summary table of every index (index/statistics.py), a
        pyarrow Table, as the JAX package's ``indexes()`` gives it."""
        return index_statistics_table(self.get_indexes(),
                                      index_path=self.index_path)
