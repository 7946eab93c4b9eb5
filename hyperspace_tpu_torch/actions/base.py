"""The action state machine: begin -> op -> end with optimistic
concurrency (counterpart of hyperspace_tpu/actions/base.py).

  - ``base_id`` is captured from the latest log id when the action is
    made;
  - ``begin()`` writes a transient-state entry at ``base_id + 1``; the
    create-if-absent write is what detects a concurrent writer;
  - ``op()`` does the work;
  - ``end()`` writes the final-state entry at ``base_id + 2`` and moves
    the ``latestStable`` pointer to it.

An action that dies mid-flight leaves the transient entry as the latest
log record; ``cancel()`` rolls it back, and so does the manager's auto
recovery before the next verb.  The ``action.commit`` fault site
(io/faults.py) sits between ``op()`` and ``end()``.  ``run()`` returns
"ok" for a committed run and "noop" when ``validate()`` raised
``NoChangesError`` (nothing is written).  The JAX package's
conflict-retry loop is not ported: a concurrent writer's conflict
propagates.

Each action owns a ``BuildReport`` (telemetry/build_report.py): ``run()``
times itself, ``validate`` and ``commit`` are phases, and the finished
report is published with its outcome, "error" for a run that raised.
"""

from __future__ import annotations

import copy
import time
from typing import Optional

from hyperspace_tpu_torch.exceptions import HyperspaceError, NoChangesError
from hyperspace_tpu_torch.index.log_entry import IndexLogEntry
from hyperspace_tpu_torch.index.log_manager import IndexLogManager
from hyperspace_tpu_torch.io import faults
from hyperspace_tpu_torch.telemetry import build_report


class Action:
    # Subclasses set these.
    transient_state: str = ""
    final_state: str = ""

    def __init__(self, log_manager: IndexLogManager) -> None:
        self.log_manager = log_manager
        latest = self.log_manager.get_latest_id()
        self.base_id: int = 0 if latest is None else latest
        self.previous_log_entry: Optional[IndexLogEntry] = \
            self.log_manager.get_latest_log()
        # Owned by the action, so the spill build's worker threads record
        # into it; run() finishes and publishes it.
        self.build_report = build_report.BuildReport(action=type(self).__name__)

    @property
    def index_name(self) -> str:
        entry = self.previous_log_entry
        return entry.name if entry is not None else ""

    def validate(self) -> None:
        """Raise HyperspaceError (NoChangesError for a benign no-op)
        before any state is written."""

    def log_entry_for_begin(self) -> IndexLogEntry:
        """The entry begin() writes: by default a copy of the previous
        one (actions on an existing index); create builds a fresh one."""
        if self.previous_log_entry is None:
            raise HyperspaceError("No existing index log entry for this action")
        return copy.deepcopy(self.previous_log_entry)

    def op(self) -> None:
        raise NotImplementedError

    def log_entry(self) -> IndexLogEntry:
        """The entry committed by end(), built after op()."""
        raise NotImplementedError

    def begin(self) -> None:
        entry = self.log_entry_for_begin()
        entry.state = self.transient_state
        self.log_manager.write_log_or_raise(self.base_id + 1, entry)

    def end(self) -> None:
        entry = self.log_entry()
        entry.state = self.final_state
        self.log_manager.delete_latest_stable_log()
        self.log_manager.write_log_or_raise(self.base_id + 2, entry)
        self.log_manager.create_latest_stable_log(self.base_id + 2)

    def run(self) -> str:
        report = self.build_report
        # The report times run() itself, not the action's construction.
        report._t0 = time.perf_counter()
        report.started_at = time.time()
        report.index = self.index_name
        try:
            outcome = self._attempt()
        except Exception as e:
            # A failed run still reports.
            self._finish_report("error", str(e))
            raise
        self._finish_report(outcome, "")
        return outcome

    def _attempt(self) -> str:
        report = self.build_report
        t0 = time.perf_counter()
        try:
            self.validate()
        except NoChangesError:
            return "noop"
        finally:
            report.add_phase("validate", time.perf_counter() - t0)
        t0 = time.perf_counter()
        self.begin()
        report.add_phase("commit", time.perf_counter() - t0)
        self.op()
        # Crash checkpoint: the work is done, the final entry is not
        # committed; the state a killed process leaves, which cancel()
        # and auto recovery roll back.
        faults.check("action.commit")
        t0 = time.perf_counter()
        self.end()
        report.add_phase("commit", time.perf_counter() - t0)
        return "ok"

    def _finish_report(self, outcome: str, error: str) -> None:
        """Finish and publish this run's report; an action made without a
        session publishes it process-wide only."""
        report = self.build_report
        report.index = report.index or self.index_name
        session = getattr(self, "session", None)
        if session is None or build_report.profiling_enabled(session.conf):
            report.sample_memory(getattr(session, "device", None))
        report.finish(outcome, error)
        build_report.publish(report, session)
