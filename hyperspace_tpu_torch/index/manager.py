"""Index collection manager (counterpart of
hyperspace_tpu/index/manager.py): name -> log, data and quarantine
managers, dispatch to the actions (create, delete, restore, vacuum,
cancel, the full, incremental, quick and repair refresh, optimize,
verify; a data-skipping index's create and refresh go to its own
actions), and listing of the indexes under the system path.

The failure envelope:

  - every log manager retries transient IO under the conf's
    ``io_retry_*`` policy (utils/retry.py);
  - with ``conf.auto_recovery_enabled``, each lifecycle verb but cancel
    first rolls back a transient latest entry (a prior action died
    mid-flight): an implicit ``cancel()``;
  - ``get_indexes``, the query path's one way to index metadata, skips
    an index whose log is unreadable or torn past recovery and emits an
    ``IndexDegradedEvent`` (a ``degraded`` decision in the run report), so a
    damaged index stops accelerating queries without breaking them; with
    ``conf.degraded_fallback_to_source`` off it raises
    ``DegradedIndexError`` instead.  Only index-side errors degrade
    (``execution.containment.is_index_side_error``): a device or kernel
    error propagates.

Every action the manager dispatches is armed with
``conf.concurrency_max_retries`` and the ``io_retry_*`` backoff, so a
write conflict rebases and retries (actions/base.py).  A degraded index
emits an ``IndexDegradedEvent`` (telemetry/events.py).  The log
manager is the class ``conf.log_manager_class`` names (the POSIX
``IndexLogManager`` by default, or ``ObjectStoreLogManager`` over the
``conf.log_store_class`` store)."""

from __future__ import annotations

import os
from typing import List, Optional

from hyperspace_tpu_torch.exceptions import DegradedIndexError, HyperspaceError
from hyperspace_tpu_torch.index.data_manager import IndexDataManager
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry, States
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.index.statistics import index_statistics_table
from hyperspace_tpu_torch.io.files import list_dir
from hyperspace_tpu_torch.telemetry.events import (
    IndexDegradedEvent,
    emit_event,
)
from hyperspace_tpu_torch.utils.retry import policy_from_conf

DEFAULT_SYSTEM_DIR = "spark-warehouse/indexes"


def system_path_of(conf) -> str:
    """The absolute system path: ``conf.system_path``, or the default
    directory under the working directory."""
    return os.path.abspath(conf.system_path or os.path.join(
        os.getcwd(), DEFAULT_SYSTEM_DIR))


class IndexCollectionManager:
    def __init__(self, session) -> None:
        self.session = session
        # Whether the last get_indexes skipped an unreadable index: the
        # caching manager never caches such a listing.
        self.last_listing_degraded = False

    @property
    def system_path(self) -> str:
        return system_path_of(self.session.conf)

    def index_path(self, name: str) -> str:
        """Case-insensitive match against existing index directories,
        else the given name."""
        root = self.system_path
        if os.path.isdir(root):
            lowered = name.lower()
            for existing in os.listdir(root):
                if existing.lower() == lowered:
                    return os.path.join(root, existing)
        return os.path.join(root, name)

    def _log_manager(self, name: str) -> IndexLogManager:
        from hyperspace_tpu_torch.utils.reflection import load_class

        cls = load_class(self.session.conf.log_manager_class,
                         IndexLogManager, HyperspaceError)
        mgr = cls(self.index_path(name))
        # The constructor takes the index path only: the retry policy and
        # the conf (an object-store log's store class and window) follow.
        mgr.retry = policy_from_conf(self.session.conf)
        mgr.configure(self.session.conf)
        return mgr

    def _dispatch(self, action) -> str:
        """Arm the action's transaction loop from the conf, then run it:
        a ``ConcurrentWriteError`` rebases, re-validates and retries after
        a jittered backoff up to ``conf.concurrency_max_retries`` times
        (actions/base.py).  Returns the run's outcome ("ok" or "noop")."""
        action.concurrency_max_retries = int(
            self.session.conf.concurrency_max_retries)
        action.conflict_backoff = policy_from_conf(self.session.conf)
        return action.run()

    def _maybe_recover(self, name: str) -> None:
        """With ``conf.auto_recovery_enabled``, roll a transient latest
        entry back to the last stable state before a verb runs.  A slow
        (not dead) action and the rollback race for the same log id, and
        the create-if-absent write decides."""
        if not self.session.conf.auto_recovery_enabled:
            return
        from hyperspace_tpu_torch.actions.cancel import CancelAction

        mgr = self._log_manager(name)
        latest = mgr.get_latest_log()
        if latest is not None and latest.state not in States.STABLE:
            self._dispatch(CancelAction(mgr))

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

        self._maybe_recover(config.index_name)
        cls = CreateDataSkippingAction \
            if isinstance(config, DataSkippingIndexConfig) else CreateAction
        self._dispatch(cls(self._log_manager(config.index_name),
                           self._data_manager(config.index_name),
                           self.session, dataset.plan, config))

    def delete(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.delete import DeleteAction

        self._maybe_recover(name)
        self._dispatch(DeleteAction(self._log_manager(name)))

    def restore(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.restore import RestoreAction

        self._maybe_recover(name)
        self._dispatch(RestoreAction(self._log_manager(name)))

    def vacuum(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.vacuum import VacuumAction

        self._maybe_recover(name)
        self._dispatch(VacuumAction(self._log_manager(name),
                                    self._data_manager(name)))

    def cancel(self, name: str) -> None:
        from hyperspace_tpu_torch.actions.cancel import CancelAction

        self._dispatch(CancelAction(self._log_manager(name)))

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

            self._maybe_recover(name)
            log_manager = self._log_manager(name)
            action = RepairAction(
                log_manager, self._data_manager(name), self.session,
                previous=log_manager.get_latest_stable_log(),
                quarantine=self.quarantine_manager(name))
            return action.summary(self._dispatch(action))
        cls = {"full": RefreshAction,
               "incremental": RefreshIncrementalAction,
               "quick": RefreshQuickAction}.get(mode)
        if cls is None:
            raise HyperspaceError(f"Unknown refresh mode {mode!r}")
        self._maybe_recover(name)
        log_manager = self._log_manager(name)
        stable = log_manager.get_latest_stable_log()
        # A data-skipping sketch is patched by its own action in the full
        # and incremental modes; the quick refresh is metadata only.
        if stable is not None and not stable.is_covering and mode != "quick":
            action = RefreshDataSkippingAction(
                log_manager, self._data_manager(name), self.session,
                previous=stable)
            outcome = self._dispatch(action)
            return RefreshSummary(
                index=name, mode=mode, outcome=outcome,
                version=action.base_id + 2 if outcome == "ok" else None)
        action = cls(log_manager, self._data_manager(name), self.session,
                     previous=stable)
        return action.summary(self._dispatch(action))

    def optimize(self, name: str, mode: str = "quick"):
        """Run one compaction ("quick" or "full"); returns its
        ``OptimizeSummary`` (outcome "noop" when no bucket held files to
        merge)."""
        from hyperspace_tpu_torch.actions.optimize import OptimizeAction

        if mode not in ("quick", "full"):
            raise HyperspaceError(f"Unknown optimize mode {mode!r}")
        self._maybe_recover(name)
        action = OptimizeAction(self._log_manager(name),
                                self._data_manager(name), self.session, mode)
        return action.summary(self._dispatch(action))

    def _degrade(self, name: str, reason: str) -> None:
        """Emit one index's degradation (an ``IndexDegradedEvent``), or
        raise ``DegradedIndexError`` when the fallback is off."""
        if not self.session.conf.degraded_fallback_to_source:
            raise DegradedIndexError(
                f"Index {name!r} is unreadable ({reason}) and "
                "conf.degraded_fallback_to_source is off")
        self.last_listing_degraded = True
        emit_event(IndexDegradedEvent(
            index_name=name, reason=reason,
            message=f"index {name!r} skipped: {reason}"))

    def get_indexes(self, states: Optional[List[str]] = None) -> List[IndexLogEntry]:
        """Latest stable entry of every readable index, optionally of
        ``states`` only.  Underscore-prefixed directories are system
        state (the advisor's workload among them)."""
        from hyperspace_tpu_torch.execution.containment import (
            is_index_side_error,
        )

        self.last_listing_degraded = False
        root = self.system_path
        out: List[IndexLogEntry] = []
        try:
            names = sorted(n for n in list_dir(root)
                           if not n.startswith("_")
                           and os.path.isdir(os.path.join(root, n)))
        except OSError as e:
            self._degrade("", f"system path listing failed: {e}")
            return out
        for name in names:
            mgr = self._log_manager(name)
            try:
                entry = mgr.get_latest_stable_log()
                if entry is None and mgr.log_ids() \
                        and mgr.get_latest_log() is None:
                    # Entries exist and none parses: torn past recovery
                    # (an empty log, or one mid-lifecycle, is not).
                    self._degrade(name, "operation log torn past recovery")
                    continue
            except DegradedIndexError:
                raise
            except Exception as e:  # noqa: BLE001 - narrowed just below
                if not is_index_side_error(e):
                    raise
                self._degrade(name, f"operation log unreadable: {e}")
                continue
            if entry is not None and (states is None or entry.state in states):
                out.append(entry)
        return out

    def get_index(self, name: str,
                  version: Optional[int] = None) -> Optional[IndexLogEntry]:
        """The latest stable entry, or the entry at log ``version``."""
        if version is None:
            return self._log_manager(name).get_latest_stable_log()
        return self._log_manager(name).get_log(version)

    def indexes(self):
        """The summary table of every index (index/statistics.py), a
        pyarrow Table, as the JAX package's ``indexes()`` gives it."""
        return index_statistics_table(self.get_indexes(),
                                      index_path=self.index_path)
